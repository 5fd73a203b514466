"""Port parity: FuyuVLM (image patches projected into the token stream of a
Persimmon decoder) and its generation loop against the JAX package, tiny
size, f32 on the CPU, same weights through `load_flax_params`. Tolerance:
logits within 1e-3 max-abs (the BASELINE.md logit-parity bar); greedy tokens
equal. The loop's step on device counters (`FuyuGenerator`'s entry body,
called with no host step index, int8 and bf16 caches), its entries (leased,
given back by an abandoned stream, bounded) and the graph setting refused
on the CPU are held here too."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.generation import sampling as jsampling
from otter_tpu.models.decoder import init_cache as jinit_cache
from otter_tpu_torch.config import GenerationConfig
from otter_tpu_torch.generation.fuyu import fuyu_cache_len, fuyu_generate
from otter_tpu_torch.models.convert import export_flax_params
from otter_tpu_torch.tools.random_weights import fuyu_request
from torch_parity_helpers import fuyu_pair

LOGIT_TOL = 1e-3


def _request(cfg, left_pad=2, prompt=5, seed=0):
    """A 12x8-pixel image (3 x 2 patches of 4) and a prompt, left-padded."""
    return fuyu_request(cfg, 12, 8, prompt, seed, left_pad=left_pad)


def test_fuyu_request_is_laid_out_as_the_processor_lays_it_out():
    cfg, _, _, _ = fuyu_pair()
    ids, patches, idx, mask = _request(cfg)
    ph, nl = cfg.image_placeholder_id, cfg.image_newline_id
    assert ids[0, :11].tolist() == [0, 0, ph, ph, nl, ph, ph, nl, ph, ph, nl]
    assert idx[0].tolist() == [-1, -1, 0, 1, -1, 2, 3, -1, 4, 5, -1] + [-1] * 5
    assert mask[0].tolist() == [0, 0] + [1] * 14
    assert patches.shape == (1, 6, 48) and ids.shape == (1, 16)
    assert (ids[0, 11:] < min(ph, nl)).all()


@pytest.mark.parametrize("height,width", [(448, 448), (100, 70)])
def test_fuyu_request_matches_the_jax_processor(height, width):
    """The same token stream and patch indices as the JAX package's
    `FuyuProcessor.encode_sample` gives for an image of that size (448 x
    448: 15 x 15 patches of 30 and 15 newlines, 240 image tokens)."""
    from PIL import Image
    from otter_tpu.data.fuyu_processor import FuyuProcessor
    from otter_tpu_torch.config import FuyuConfig

    class Tok:
        bos_token_id = None

        def __call__(self, text, **kw):
            return {"input_ids": [int(t) for t in text.split()]}

    cfg = FuyuConfig()
    ids, patches, idx, mask = fuyu_request(cfg, height, width, 16, seed=1)
    text = " ".join(str(t) for t in ids[0, -16:])
    ref = FuyuProcessor(Tok()).encode_sample(
        text, Image.new("RGB", (width, height)))
    np.testing.assert_array_equal(ids[0], ref["input_ids"])
    np.testing.assert_array_equal(idx[0], ref["image_patches_indices"])
    assert patches.shape == (1,) + ref["image_patches"].shape
    assert mask.all()
    if height == 448:
        assert patches.shape[1] == 225 and ids.shape[1] == 240 + 16


@pytest.mark.parametrize("quant,quant_embed", [(None, False), ("int8", True)])
def test_fuyu_logits_match_jax(quant, quant_embed):
    cfg, jmodel, params, tmodel = fuyu_pair(quant, quant_embed)
    ids, patches, idx, mask = _request(cfg)
    positions = np.clip(np.cumsum(mask, -1) - 1, 0, None)
    ref, _ = jax.jit(jmodel.apply)(
        params, jnp.asarray(ids, jnp.int32),
        image_patches=jnp.asarray(patches),
        image_patches_indices=jnp.asarray(idx, jnp.int32),
        attention_mask=jnp.asarray(mask), positions=jnp.asarray(positions))
    with torch.no_grad():
        out, _ = tmodel(torch.from_numpy(ids),
                        image_patches=torch.from_numpy(patches),
                        image_patches_indices=torch.from_numpy(idx),
                        attention_mask=torch.from_numpy(mask),
                        positions=torch.from_numpy(positions))
        text_only, _ = tmodel(torch.from_numpy(ids),
                              attention_mask=torch.from_numpy(mask),
                              positions=torch.from_numpy(positions))
    assert out.shape == (1, 16, cfg.text.total_vocab)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    # the patches were merged: without them the logits move
    assert float((out - text_only).abs().max()) > 10 * LOGIT_TOL


def _jax_generate(cfg, jmodel, params, req, max_new, cache_dtype):
    """The greedy loop of the JAX package's Fuyu worker, from `model.apply`:
    prefill with positions from the mask and the logits of every position,
    then single-token steps with kv_valid and positions advanced."""
    ids, patches, idx, mask = req
    b, s = ids.shape
    cache_len = fuyu_cache_len(s, max_new)
    cache = jinit_cache(cfg.text, 1, cache_len, cache_dtype)
    positions = jnp.clip(jnp.cumsum(jnp.asarray(mask), -1) - 1, 0, None
                         ).astype(jnp.int32)
    logits, cache = jax.jit(jmodel.apply)(
        params, jnp.asarray(ids, jnp.int32),
        image_patches=jnp.asarray(patches),
        image_patches_indices=jnp.asarray(idx, jnp.int32),
        attention_mask=jnp.asarray(mask), positions=positions, cache=cache)
    logits = logits[:, -1]
    step = jax.jit(lambda tok, cache, cpos, kv_valid, pos: jmodel.apply(
        params, tok, cache=cache, cache_pos=cpos, kv_valid=kv_valid,
        positions=pos))
    real_len = int(mask.sum())
    kv_valid = np.zeros((b, cache_len), bool)
    kv_valid[:, :s] = mask.astype(bool)
    out, rng = [], jax.random.PRNGKey(0)
    for t in range(max_new):
        tok = int(jsampling.sample_token(rng, logits, do_sample=False,
                                         temperature=1.0, top_k=0,
                                         top_p=1.0)[0])
        out.append(tok)
        if t == max_new - 1:
            break
        kv_valid[:, s + t] = True
        logits, cache = step(jnp.full((b, 1), tok, jnp.int32), cache, s + t,
                             jnp.asarray(kv_valid),
                             jnp.full((b, 1), real_len + t, jnp.int32))
        logits = logits[:, -1]
    return out


@pytest.mark.parametrize("quant,cache", [(None, "f32"), ("int8", "int8")])
def test_fuyu_generate_tokens_equal_the_jax_loop(quant, cache):
    """Greedy, one left-padded request with an image; with int8 weights the
    head of every step goes through `int8_matmul` on both sides, the MLPs
    through `int8_mlp` with biases and squared ReLU, over an int8 cache."""
    cfg, jmodel, params, tmodel = fuyu_pair(quant, quant == "int8")
    req = _request(cfg, seed=3)
    jdt, tdt = ((jnp.int8, torch.int8) if cache == "int8"
                else (jnp.float32, torch.float32))
    ref = _jax_generate(cfg, jmodel, params, req, 6, jdt)
    out = list(fuyu_generate(tmodel, *req,
                             gen=GenerationConfig(max_new_tokens=6),
                             cache_dtype=tdt))
    assert out == ref and len(out) == 6


def test_fuyu_generate_stops_at_eos_and_takes_no_image():
    cfg, _, _, tmodel = fuyu_pair()
    ids, _, _, mask = _request(cfg, seed=4)
    gen = GenerationConfig(max_new_tokens=5)
    free = list(fuyu_generate(tmodel, ids, None, None, mask, gen,
                              cache_dtype=torch.float32))
    assert len(free) == 5
    stop = free.index(free[2])   # its first occurrence ends the stream
    gen = GenerationConfig(max_new_tokens=5, eos_token_id=free[2])
    assert list(fuyu_generate(tmodel, ids, None, None, mask, gen,
                              cache_dtype=torch.float32)) == free[:stop]


@pytest.mark.parametrize("prompt,new,want", [(100, 28, 128), (100, 29, 256),
                                             (1000, 25, 1536), (2356, 32, 2560)])
def test_fuyu_cache_len_rounds_as_the_jax_worker(prompt, new, want):
    assert fuyu_cache_len(prompt, new) == want


def test_fuyu_params_round_trip_under_the_flax_names():
    cfg, _, params, tmodel = fuyu_pair("int8", True)
    from flax import traverse_util
    flat = traverse_util.flatten_dict(params["params"], sep="/")
    out = export_flax_params(tmodel)
    assert sorted(out) == sorted(flat)
    for key in ("language_model/wte_q", "language_model/lm_head/kernel_q",
                "language_model/layers_0/attn/q_ln/scale",
                "language_model/layers_1/ffn/up_proj/bias",
                "vision_embed_tokens/kernel"):
        np.testing.assert_array_equal(out[key], np.asarray(flat[key]))


# ── the step on device counters, the entries ─────────────────────────

NEW = 6
_CACHES = {"int8": (jnp.int8, torch.int8), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}


@pytest.fixture(scope="module")
def jax_fuyu_loops():
    """The JAX worker loop's greedy tokens for the request of seed 3 with
    int8 weights over an int8 cache and with f32 weights over a bf16
    cache, NEW new tokens, computed once."""
    out = {}
    for quant, cache in (("int8", "int8"), (None, "bf16")):
        cfg, jmodel, params, _ = fuyu_pair(quant, quant == "int8")
        out[quant, cache] = _jax_generate(cfg, jmodel, params,
                                          _request(cfg, seed=3), NEW,
                                          _CACHES[cache][0])
    return out


@pytest.mark.parametrize("quant,cache", [("int8", "int8"), (None, "bf16")])
def test_fuyu_step_body_on_device_counters_gives_jax_tokens(jax_fuyu_loops,
                                                            quant, cache):
    """The prefill fills a leased entry; the step is then the entry's
    body, called NEW - 1 times with no argument: the host's step count
    and prompt width are wiped first, so the body can only read the
    device counters. The tokens equal the JAX worker loop's."""
    from otter_tpu_torch.generation.fuyu import FuyuGenerator
    cfg, _, _, tmodel = fuyu_pair(quant, quant == "int8")
    engine = FuyuGenerator(tmodel, _CACHES[cache][1])
    assert not engine.cuda_graph
    st = engine._prefill(*_request(cfg, seed=3),
                         GenerationConfig(max_new_tokens=NEW))
    p = st.p
    st.t = st.p = None
    got = [int(st.tok[0])]
    with torch.inference_mode():
        for _ in range(NEW - 1):
            st.entry.body()
            got.append(int(st.tok[0]))
    assert int(st.t_dev) == NEW and int(st.p_dev) == p
    st.t, st.p = NEW, p
    engine._finish(st)
    assert got == jax_fuyu_loops[quant, cache]
    # and through fuyu_generate on the same engine: its entry again
    entry = engine._entries[-1]
    assert list(fuyu_generate(engine, *_request(cfg, seed=3),
                              GenerationConfig(max_new_tokens=NEW))) == got
    assert engine._entries == [entry] and not entry.busy


def test_fuyu_prefill_computes_the_last_row_of_logits_only():
    """`head_last_only` at the prefill: the head sees one row a step, the
    prefill's included, not the prompt's S rows."""
    cfg, _, _, tmodel = fuyu_pair()
    seen = []
    hook = tmodel.language_model.lm_head.register_forward_pre_hook(
        lambda mod, args: seen.append(tuple(args[0].shape)))
    try:
        out = list(fuyu_generate(tmodel, *_request(cfg, seed=3),
                                 GenerationConfig(max_new_tokens=3),
                                 cache_dtype=torch.float32))
    finally:
        hook.remove()
    assert len(out) == 3
    assert seen == [(1, 1, cfg.text.hidden_size)] * 3


def test_fuyu_entries_are_leased_released_and_bounded(monkeypatch):
    """With a bound of 2: a request of a kept key reuses its entry (its
    cache the same tensor); a stream abandoned after its first token
    gives its entry back; streams that run at once each lease their own
    entry; three keys one after another leave the two most recent."""
    from otter_tpu_torch.generation import engine as tengine
    from otter_tpu_torch.generation.fuyu import FuyuGenerator
    monkeypatch.setattr(tengine, "MAX_ENTRIES", 2)
    cfg, _, _, tmodel = fuyu_pair()
    req = _request(cfg, seed=5)
    engine = FuyuGenerator(tmodel, torch.float32)
    gen = lambda eos: GenerationConfig(max_new_tokens=4, eos_token_id=eos)
    want = list(engine.generate(*req, gen(-1)))
    entry = engine._entries[-1]
    cache = entry.st.cache["k"]
    assert entry.key == (1, 128, str(torch.float32),
                         dataclasses.replace(gen(-1), max_new_tokens=0))
    stream = engine.generate(*req, gen(-1))
    assert next(stream) == want[0] and entry.busy
    stream.close()
    assert not entry.busy and engine._entries == [entry]
    assert entry.st.cache["k"] is cache
    a, b = engine.generate(*req, gen(-1)), engine.generate(*req, gen(-1))
    assert next(a) == next(b) == want[0]
    assert len(engine._entries) == 2 and all(e.busy for e in
                                             engine._entries)
    assert list(a) == list(b) == want[1:]
    assert not any(e.busy for e in engine._entries)
    for eos in (-2, -3):
        assert list(engine.generate(*req, gen(eos))) == want
    assert [e.key[3].eos_token_id for e in engine._entries] == [-2, -3]


def test_fuyu_graph_is_refused_where_it_cannot_run():
    """No graph on the CPU and none on a sharded model: asking for one
    raises; the default is off there. An engine's cache dtype is its own:
    `fuyu_generate` over an engine refuses another."""
    from otter_tpu_torch.generation.fuyu import FuyuGenerator
    cfg, _, _, tmodel = fuyu_pair()
    assert FuyuGenerator(tmodel).cuda_graph is False
    assert FuyuGenerator(tmodel).cache_dtype == torch.float32
    with pytest.raises(ValueError, match="CUDA model"):
        FuyuGenerator(tmodel, cuda_graph=True)
    tmodel._shard_layouts = {}
    try:
        assert FuyuGenerator(tmodel).cuda_graph is False
        with pytest.raises(ValueError, match="sharded"):
            FuyuGenerator(tmodel, cuda_graph=True)
    finally:
        del tmodel._shard_layouts
    with pytest.raises(ValueError, match="cache_dtype"):
        next(fuyu_generate(FuyuGenerator(tmodel), *_request(cfg),
                           cache_dtype=torch.int8))


def test_fuyu_sampled_request_repeats_by_seed():
    """A sampled request draws from its entry's generator with the
    request's state copied in; the request's generator takes the state
    back, so one seed repeats the tokens and leaves the generator where
    the first run left it."""
    from otter_tpu_torch.generation.fuyu import FuyuGenerator
    cfg, _, _, tmodel = fuyu_pair()
    req = _request(cfg, seed=6)
    engine = FuyuGenerator(tmodel, torch.float32)
    gen = GenerationConfig(max_new_tokens=NEW, do_sample=True,
                           temperature=4.0, eos_token_id=-1)
    runs, states = [], []
    for _ in range(2):
        g = torch.Generator().manual_seed(13)
        runs.append(list(engine.generate(*req, gen, generator=g)))
        states.append(g.get_state())
    assert runs[0] == runs[1] and len(runs[0]) == NEW
    assert torch.equal(states[0], states[1])
    assert not torch.equal(states[0],
                           torch.Generator().manual_seed(13).get_state())
