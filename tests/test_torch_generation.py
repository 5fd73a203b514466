"""Port parity: the generation engine and sampling helpers against the JAX
package. Greedy tokens from the port's OtterGenerator must equal the JAX
engine's on a ragged left-padded batch with int8 weights, an int8 KV cache
and decode_kernel="auto"; `stream_generate` must yield what `generate`
returns for one request."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.config import GenerationConfig as JGen
from otter_tpu.generation import engine as jengine
from otter_tpu.generation import sampling as jsampling
from otter_tpu_torch.config import GenerationConfig as TGen
from otter_tpu_torch.generation import engine as tengine
from otter_tpu_torch.generation import sampling as tsampling
from torch_parity_helpers import inputs, jax_tiny, llama_vlm_pair, torch_tiny


def _ragged_batch(cfg):
    vx, ids = inputs(cfg, 20, 3, 12)
    mask = np.ones_like(ids)
    mask[0, 9:] = 0
    mask[1, 5:] = 0
    return vx, ids, mask


def test_left_pad_matches_jax():
    ids = np.arange(15).reshape(3, 5)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]])
    for a, r in zip(tengine.left_pad(ids, mask, target_len=6, pad_id=9),
                    jengine.left_pad(ids, mask, target_len=6, pad_id=9)):
        np.testing.assert_array_equal(a, r)


def test_greedy_generate_identical_to_jax():
    cfg, jmodel, params, _ = jax_tiny()
    vx, ids, mask = _ragged_batch(cfg)
    lang_x, attn = tengine.left_pad(ids, mask)
    ref = jengine.OtterGenerator(jmodel, params, cfg, cache_dtype="int8"
                                 ).generate(jnp.asarray(vx),
                                            jnp.asarray(lang_x),
                                            jnp.asarray(attn),
                                            gen=JGen(max_new_tokens=6))
    out = tengine.OtterGenerator(torch_tiny(), cache_dtype=torch.int8
                                 ).generate(vx, lang_x, attn,
                                            gen=TGen(max_new_tokens=6))
    assert out.shape == ref.shape == (3, 12 + 6)
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_cache_dtype_memo_per_request_shape():
    """The engine picks the cache dtype once per (b, cache_len), as the JAX
    engine's `_cache_dtypes` memo does: a budget that fits an int8 cache
    but not a bf16 one degrades the request, and the degraded int8 cache
    gives the JAX int8 engine's tokens; the key keeps its dtype when the
    budget changes later; another key is chosen afresh."""
    cfg, jmodel, params, _ = jax_tiny()
    vx, ids, mask = _ragged_batch(cfg)
    lang_x, attn = tengine.left_pad(ids, mask)
    model = torch_tiny()
    b, cache_len = lang_x.shape[0], 128      # 12 + 6 tokens round up to 128
    need = tengine.cache_bytes(cfg.text, b, cache_len, torch.bfloat16)
    params_b = sum(t.numel() * t.element_size() for t in
                   list(model.parameters()) + list(model.buffers()))
    eng = tengine.OtterGenerator(model, hbm_bytes=5e9 + params_b + need - 1)
    with pytest.warns(UserWarning, match="bf16 -> int8"):
        out = eng.generate(vx, lang_x, attn, gen=TGen(max_new_tokens=6))
    assert eng._cache_dtypes == {(b, cache_len): torch.int8}
    ref = jengine.OtterGenerator(jmodel, params, cfg, cache_dtype="int8"
                                 ).generate(jnp.asarray(vx),
                                            jnp.asarray(lang_x),
                                            jnp.asarray(attn),
                                            gen=JGen(max_new_tokens=6))
    np.testing.assert_array_equal(out, np.asarray(ref))
    eng.hbm_bytes = 1e15
    assert eng._cache_dtype_for(b, cache_len) == torch.int8
    assert eng._cache_dtype_for(b, 2 * cache_len) == torch.bfloat16


def test_llama_greedy_generate_identical_to_jax():
    """The tiny llama VLM (rope, RMSNorm, SwiGLU, untied int8 head, int8
    cache): a ragged left-padded batch, where rope goes wrong first if the
    positions count the padding. Every decode step's head goes through
    `int8_matmul` on both sides."""
    cfg, jmodel, params, tmodel = llama_vlm_pair()
    vx, ids = inputs(cfg, 24, 2, 12)
    mask = np.ones_like(ids)
    mask[0, 7:] = 0
    lang_x, attn = tengine.left_pad(ids, mask)
    assert attn.sum(-1).tolist() == [7, 12]
    ref = jengine.OtterGenerator(jmodel, params, cfg, cache_dtype="int8"
                                 ).generate(jnp.asarray(vx),
                                            jnp.asarray(lang_x),
                                            jnp.asarray(attn),
                                            gen=JGen(max_new_tokens=6))
    out = tengine.OtterGenerator(tmodel, cache_dtype=torch.int8
                                 ).generate(vx, lang_x, attn,
                                            gen=TGen(max_new_tokens=6))
    assert out.shape == ref.shape == (2, 12 + 6)
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_llama_stream_generate_identical_to_jax():
    """One left-padded request through both `stream_generate`s (decode
    positions real_len + t)."""
    cfg, jmodel, params, tmodel = llama_vlm_pair()
    vx, ids = inputs(cfg, 25, 1, 12)
    mask = np.ones_like(ids)
    mask[0, 9:] = 0
    lang_x, attn = tengine.left_pad(ids, mask)
    gen_kw = dict(max_new_tokens=6, eos_token_id=-1)
    ref = list(jengine.OtterGenerator(
        jmodel, params, cfg, cache_dtype="int8").stream_generate(
            jnp.asarray(vx), jnp.asarray(lang_x), jnp.asarray(attn),
            gen=JGen(**gen_kw)))
    engine = tengine.OtterGenerator(tmodel, cache_dtype=torch.int8)
    out = list(engine.stream_generate(vx, lang_x, attn, gen=TGen(**gen_kw)))
    assert out == ref and len(out) == 6
    full = engine.generate(vx, lang_x, attn, gen=TGen(**gen_kw))
    assert full[0, 12:].tolist() == out


def test_sampled_generate_reproducible_with_generator():
    cfg, _, _, _ = jax_tiny()
    vx, ids, mask = _ragged_batch(cfg)
    lang_x, attn = tengine.left_pad(ids, mask)
    engine = tengine.OtterGenerator(torch_tiny(), cache_dtype=torch.int8)
    gen = TGen(max_new_tokens=5, do_sample=True, temperature=0.8, top_k=20,
               top_p=0.9)
    outs = [engine.generate(vx, lang_x, attn, gen=gen,
                            generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0][:, :12], lang_x)
    assert ((outs[0] >= 0) & (outs[0] < cfg.text.total_vocab)).all()


def _one_request(cfg):
    vx, ids = inputs(cfg, 23, 1, 10)
    return vx, ids.astype(np.int64), np.ones_like(ids)


@pytest.mark.parametrize("sampled", [False, True])
def test_stream_generate_yields_what_generate_returns(sampled):
    cfg, _, _, _ = jax_tiny()
    vx, lang_x, attn = _one_request(cfg)
    engine = tengine.OtterGenerator(torch_tiny(), cache_dtype=torch.int8)
    gen = TGen(max_new_tokens=6, no_repeat_ngram_size=2,
               bad_words_ids=((3,),), do_sample=sampled, temperature=0.9,
               top_k=30)
    rng = lambda: torch.Generator().manual_seed(5) if sampled else None
    full = engine.generate(vx, lang_x, attn, gen=gen, generator=rng())
    stream = engine.stream_generate(vx, lang_x, attn, gen=gen,
                                    generator=rng())
    first = next(stream)
    assert isinstance(first, int)
    assert not torch.is_inference_mode_enabled()   # nothing leaks out
    assert [first] + list(stream) == full[0, 10:].tolist()


def test_stream_generate_stops_at_eos():
    cfg, _, _, _ = jax_tiny()
    vx, lang_x, attn = _one_request(cfg)
    engine = tengine.OtterGenerator(torch_tiny(), cache_dtype=torch.int8)
    free = engine.generate(vx, lang_x, attn, gen=TGen(
        max_new_tokens=6, no_repeat_ngram_size=1))[0, 10:].tolist()
    # the fourth token as eos: three are yielded, eos itself is not
    gen = TGen(max_new_tokens=6, no_repeat_ngram_size=1,
               eos_token_id=free[3])
    assert list(engine.stream_generate(vx, lang_x, attn, gen=gen)) == free[:3]
    out = engine.generate(vx, lang_x, attn, gen=gen)[0, 10:].tolist()
    assert out == free[:4] + [gen.pad_token_id] * 2


def test_stream_generate_serves_one_request():
    cfg, _, _, _ = jax_tiny()
    vx, ids, mask = _ragged_batch(cfg)
    engine = tengine.OtterGenerator(torch_tiny(), cache_dtype=torch.int8)
    with pytest.raises(ValueError, match="one request"):
        next(engine.stream_generate(vx, ids, mask))


def test_entry_points_default_to_cuda():
    cfg, _, _, _ = jax_tiny()
    from otter_tpu_torch.models.otter import OtterVLM
    from torch_parity_helpers import port_cfg
    if torch.cuda.is_available():
        assert OtterVLM(port_cfg(cfg)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OtterVLM(port_cfg(cfg))


@pytest.mark.parametrize("k,p", [(5, 1.0), (0, 0.7), (8, 0.5)])
def test_top_k_top_p_match_jax(k, p):
    rng = np.random.default_rng(21)
    logits = rng.standard_normal((3, 40)).astype(np.float32)
    ref = jsampling.apply_top_p(jsampling.apply_top_k(jnp.asarray(logits), k),
                                p)
    out = tsampling.apply_top_p(
        tsampling.apply_top_k(torch.from_numpy(logits), k), p)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_process_logits_matches_jax():
    rng = np.random.default_rng(22)
    b, l, v = 2, 16, 12
    tokens = rng.integers(0, 4, (b, l)).astype(np.int32)
    logits = rng.standard_normal((b, v)).astype(np.float32)
    gen_kw = dict(no_repeat_ngram_size=2, bad_words_ids=((3,), (1, 2)))
    cur, vfrom = np.array([12, 10]), np.array([0, 3])
    ref = jsampling.process_logits(jnp.asarray(logits), jnp.asarray(tokens),
                                   jnp.asarray(cur), JGen(**gen_kw),
                                   jnp.asarray(vfrom))
    out = tsampling.process_logits(
        torch.from_numpy(logits), torch.from_numpy(tokens).long(),
        torch.from_numpy(cur), TGen(**gen_kw), torch.from_numpy(vfrom))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_cache_bytes_match_jax(dtype):
    cfg, _, _, _ = jax_tiny()
    jdt = jnp.bfloat16 if dtype == "bf16" else "int8"
    tdt = torch.bfloat16 if dtype == "bf16" else torch.int8
    assert tengine.cache_bytes(cfg.text, 3, 256, tdt) == \
        jengine.cache_bytes(cfg.text, 3, 256, jdt)


def test_select_cache_dtype_degrades_to_fit():
    cfg, _, _, _ = jax_tiny()
    need_bf16 = tengine.cache_bytes(cfg.text, 4, 256, torch.bfloat16)
    cuda = torch.device("cuda")
    # the budget (hbm - headroom - params) fits int8 but not bf16
    with pytest.warns(UserWarning, match="bf16 -> int8"):
        got = tengine.select_cache_dtype(
            cfg.text, 4, 256, torch.bfloat16, device=cuda,
            hbm_bytes=need_bf16 - 1, headroom_bytes=0)
    assert got == torch.int8
    assert tengine.select_cache_dtype(
        cfg.text, 4, 256, torch.bfloat16, device=cuda,
        hbm_bytes=need_bf16, headroom_bytes=0) == torch.bfloat16
    assert tengine.select_cache_dtype(
        cfg.text, 4, 256, torch.bfloat16,
        device=torch.device("cpu")) == torch.bfloat16
