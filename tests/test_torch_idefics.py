"""Port parity of the IDEFICS model: the image-attention windows, the
perceiver, the gated cross-attention block, the prefill logits, cached
decoding and `OtterGenerator` against the JAX `IdeficsVLM` built from the
same weights (the tiny config, f32 on the CPU; non-zero tanh gates, moved
norms)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from otter_tpu.config import GenerationConfig as JaxGenerationConfig
from otter_tpu.generation.engine import OtterGenerator as JaxGenerator
from otter_tpu.models import idefics as jid
from otter_tpu.models.decoder import init_cache as jinit_cache
from otter_tpu.ops.masks import DEFAULT_MASK_VALUE
from otter_tpu_torch.config import GenerationConfig
from otter_tpu_torch.generation.engine import OtterGenerator
from otter_tpu_torch.models import idefics as tid
from otter_tpu_torch.models.decoder import init_cache
from torch_parity_helpers import idefics_inputs, idefics_pair

MODULE_TOL = 1e-4
LOGIT_TOL = 1e-3   # the BASELINE.md logit-parity bar
IMG, EOS = 126, 2


def _close(out, ref, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


# ids drawn from {pad 0, eos, image, ordinary}, in batches of 3 x 16
_TOKENS = st.sampled_from([0, EOS, IMG, 5, 7, 119])


@settings(max_examples=60, deadline=None)
@given(st.lists(st.lists(_TOKENS, min_size=16, max_size=16), min_size=3,
                max_size=3), st.integers(1, 4))
def test_image_attention_windows_match_jax(rows, n_images):
    """`image_attention_incremental` and `incremental_to_binary` equal the
    JAX functions exactly, on id sequences with images, eos and padding
    (more images than `n_images` included)."""
    ids = np.asarray(rows, np.int32)
    ref = np.asarray(jid.image_attention_incremental(jnp.asarray(ids), IMG,
                                                     EOS))
    out = tid.image_attention_incremental(torch.from_numpy(ids), IMG, EOS)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        tid.incremental_to_binary(out, n_images).numpy(),
        np.asarray(jid.incremental_to_binary(jnp.asarray(ref), n_images)))


@pytest.fixture(scope="module")
def pair():
    return idefics_pair()


def test_perceiver_matches_jax(pair):
    cfg, _, params, tmodel = pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, cfg.vision.num_patches + 1,
                             cfg.vision.hidden_size)).astype(np.float32)
    ref = jid.IdeficsPerceiver(cfg.perceiver, cfg.vision.hidden_size).apply(
        {"params": params["params"]["perceiver"]}, jnp.asarray(x))
    with torch.no_grad():
        out = tmodel.perceiver(torch.from_numpy(x))
    _close(out, ref, MODULE_TOL)


def test_gated_xattn_matches_jax(pair):
    """One block over two images of m latents, tokens 0-2 attending image
    0, 3-5 image 1 and 6-7 none (zeroed by keep_gate)."""
    cfg, _, params, tmodel = pair
    rng = np.random.default_rng(2)
    b, s, m = 2, 8, cfg.perceiver.n_latents
    x = rng.standard_normal((b, s, cfg.text.hidden_size)).astype(np.float32)
    img = rng.standard_normal((b, 2 * m, cfg.vision.hidden_size)).astype(
        np.float32)
    which = np.asarray([0, 0, 0, 1, 1, 1, -1, -1])
    iam = np.repeat((which[:, None] == np.arange(2)[None])[None], b, 0)
    iam_lat = np.repeat(iam, m, axis=-1)
    bias = np.where(iam_lat, 0.0, DEFAULT_MASK_VALUE)[:, None].astype(
        np.float32)
    keep = iam_lat.any(-1)
    ref = jid.IdeficsGatedXAttn(cfg).apply(
        {"params": params["params"]["xattn_0"]}, jnp.asarray(x),
        jnp.asarray(img), jnp.asarray(bias), jnp.asarray(keep))
    with torch.no_grad():
        out = tmodel.xattn_0(torch.from_numpy(x), torch.from_numpy(img),
                             torch.from_numpy(bias), torch.from_numpy(keep))
    _close(out, ref, MODULE_TOL)


def test_blind_rows_are_image_independent(pair):
    """Rows whose image window is empty (after an eos) give the same block
    output whatever the image; the others do not (the counterpart of the
    JAX test `test_gated_xattn_blind_tokens_are_image_independent`)."""
    cfg, _, _, tmodel = pair
    rng = np.random.default_rng(3)
    b, s, m = 1, 4, cfg.perceiver.n_latents
    x = torch.from_numpy(rng.standard_normal(
        (b, s, cfg.text.hidden_size)).astype(np.float32))
    img_a, img_b = (torch.from_numpy(rng.standard_normal(
        (b, m, cfg.vision.hidden_size)).astype(np.float32)) for _ in range(2))
    keep = torch.tensor([[True, True, False, False]])
    zero = torch.zeros(())
    bias = torch.where(keep[:, :, None], zero, DEFAULT_MASK_VALUE)[:, None]
    bias = bias.expand(b, 1, s, m)
    with torch.no_grad():
        out_a = tmodel.xattn_0(x, img_a, bias, keep)
        out_b = tmodel.xattn_0(x, img_b, bias, keep)
    np.testing.assert_allclose(out_a[:, 2:].numpy(), out_b[:, 2:].numpy(),
                               atol=1e-5)
    assert float((out_a[:, :2] - out_b[:, :2]).abs().max()) > 1e-3


def _prefill_ref(jmodel, params, vx, ids, mask):
    positions = np.clip(np.cumsum(mask, -1) - 1, 0, None).astype(np.int32)
    out, _, _ = jax.jit(lambda p, vx, ids, m, pos: jmodel.apply(
        p, vx, ids, attention_mask=m, positions=pos))(
        params, jnp.asarray(vx), jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(positions))
    return out, positions


@pytest.mark.parametrize("quant", [None, "int8"])
def test_prefill_logits_match_jax(quant):
    """The whole forward: two images, an eos that blanks row 0's window,
    left padding on row 1, a token of the additional vocab. The int8
    model is the JAX one under `quantize_params(...,
    patterns=FROZEN_DECODER_PATTERNS)`. The image moves the logits."""
    cfg, jmodel, params, tmodel = idefics_pair(quant)
    vx, ids = idefics_inputs(cfg, 4)
    mask = np.ones_like(ids)
    mask[1, :1] = 0
    ref, positions = _prefill_ref(jmodel, params, vx, ids, mask)
    with torch.no_grad():
        out, _, lat = tmodel(torch.from_numpy(vx), torch.from_numpy(ids),
                             attention_mask=torch.from_numpy(mask),
                             positions=torch.from_numpy(positions).long())
        other, _, _ = tmodel(torch.from_numpy(vx[:, ::-1].copy()),
                             torch.from_numpy(ids),
                             attention_mask=torch.from_numpy(mask),
                             positions=torch.from_numpy(positions).long())
    assert out.shape == (2, ids.shape[1], cfg.text.vocab_size
                         + cfg.additional_vocab_size)
    assert lat.shape == (2, 2, cfg.perceiver.n_latents,
                         cfg.vision.hidden_size)
    _close(out, ref, LOGIT_TOL)
    assert float((out - other).abs().max()) > 1e-2


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_cached_decode_matches_jax(cache_dtype):
    """Prefill into the stacked cache, then three cached steps whose
    tokens attend the last prompt image, against the JAX model, over a
    bf16 cache (the dense path) and an int8 cache (`decode_kernel="auto"`
    takes the decode-attention kernel: its plain version here, the JAX
    Pallas kernel in interpret mode there). As in
    `test_torch_vlm.py::test_cached_decode_matches_jax[int8]`, an int8
    entry near a half may quantize one step apart in the two frameworks,
    and a bf16 entry near a rounding tie may round one bf16 step apart
    (2^-7 of its value at most): the port's cache takes the JAX entries
    (checked to be at most one step away) after each comparison."""
    cfg, jmodel, params, tmodel = idefics_pair("int8")
    b, L = 2, 128
    vx, ids = idefics_inputs(cfg, 5)
    p = ids.shape[1]
    mask = np.ones_like(ids)
    mask[1, :1] = 0
    positions = np.clip(np.cumsum(mask, -1) - 1, 0, None).astype(np.int32)
    jdt, tdt = ((jnp.int8, torch.int8) if cache_dtype == "int8"
                else (jnp.bfloat16, torch.bfloat16))
    jcache = jinit_cache(cfg.text, b, L, jdt)
    tcache = init_cache(tmodel.cfg.text, b, L, tdt, "cpu")
    prefill = jax.jit(lambda vx, ids, m, pos, cache: jmodel.apply(
        params, vx, ids, attention_mask=m, positions=pos, cache=cache,
        head_last_only=True))
    step = jax.jit(lambda tok, lat, cache, cp, kv_valid, pos, counts:
                   jmodel.apply(params, None, tok, vis_latents=lat,
                                cache=cache, cache_pos=cp, kv_valid=kv_valid,
                                positions=pos, media_counts=counts))
    jl, jcache, jlat = prefill(jnp.asarray(vx), jnp.asarray(ids),
                               jnp.asarray(mask), jnp.asarray(positions),
                               jcache)
    with torch.no_grad():
        tl, tcache, tlat = tmodel(
            torch.from_numpy(vx), torch.from_numpy(ids),
            attention_mask=torch.from_numpy(mask),
            positions=torch.from_numpy(positions).long(), cache=tcache,
            head_last_only=True)
    _close(tl, jl, MODULE_TOL)

    def check_cache(n):
        for key in tcache:
            ref = np.array(jcache[key][:, :, :, :n], np.float32)
            got = tcache[key][:, :, :, :n].float().numpy()
            if key.endswith("scale"):
                _close(got, ref, MODULE_TOL)
            elif cache_dtype == "bf16":
                np.testing.assert_allclose(got, ref, atol=MODULE_TOL,
                                           rtol=2 ** -7)
            else:
                _close(got, ref, 1.0)
            tcache[key][:, :, :, :n] = torch.from_numpy(ref).to(
                tcache[key].dtype)

    check_cache(p)
    counts = (ids == cfg.media_token_id).sum(-1).astype(np.int32)
    kv_valid = np.zeros((b, L), bool)
    kv_valid[:, :p] = mask.astype(bool)
    real = mask.sum(-1)
    for t in range(3):
        tok = np.full((b, 1), 9 + 2 * t, np.int32)
        pos = (real + t)[:, None].astype(np.int32)
        kv_valid[:, p + t] = True
        jl, jcache, _ = step(jnp.asarray(tok), jlat, jcache, p + t,
                             jnp.asarray(kv_valid), jnp.asarray(pos),
                             jnp.asarray(counts))
        with torch.no_grad():
            tl, tcache, _ = tmodel(
                None, torch.from_numpy(tok), vis_latents=tlat,
                cache=tcache, cache_pos=p + t,
                kv_valid=torch.from_numpy(kv_valid.copy()),
                positions=torch.from_numpy(pos).long(),
                media_counts=torch.from_numpy(counts))
        _close(tl, jl, LOGIT_TOL)
        check_cache(p + t + 1)


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_generate_matches_jax(cache_dtype):
    """`OtterGenerator.generate` drives the port's IdeficsVLM to JAX's
    greedy tokens, left-padded ragged prompts with two images each."""
    cfg, jmodel, params, tmodel = idefics_pair("int8")
    vx, ids = idefics_inputs(cfg, 6)
    mask = np.ones_like(ids)
    mask[1, :2] = 0
    ids[1, :2] = 0
    gen = dict(max_new_tokens=6, eos_token_id=-1)
    jeng = JaxGenerator(jmodel, params, cfg, cache_dtype=(
        "int8" if cache_dtype == "int8" else jnp.bfloat16))
    ref = jeng.generate(jnp.asarray(vx), ids, attention_mask=mask,
                        gen=JaxGenerationConfig(**gen))
    teng = OtterGenerator(tmodel, cache_dtype=(
        torch.int8 if cache_dtype == "int8" else torch.bfloat16))
    out = teng.generate(vx, ids, attention_mask=mask,
                        gen=GenerationConfig(**gen))
    np.testing.assert_array_equal(out, np.asarray(ref))
    # stream_generate yields generate's continuation for one request
    streamed = list(teng.stream_generate(vx[:1], ids[:1],
                                         gen=GenerationConfig(**gen)))
    assert streamed == out[0, ids.shape[1]:].tolist()


def test_int8_load_keeps_the_head_where_jax_default_patterns_raise():
    """The pinned divergence from the JAX worker (ROADMAP Queue 3): its
    int8 load quantizes with `DEFAULT_QUANT_PATTERNS`, which take
    `lm_head/kernel`, and its `IdeficsVLM` (a plain Dense head) then raises
    at the first apply. The port's load, `quantize_decoder`, quantizes the
    decoder layers only (int4 alike): the model loads, its head and xattn
    stay float, and its logits are the JAX model's under
    `FROZEN_DECODER_PATTERNS`."""
    from flax import traverse_util
    from flax.errors import ScopeParamNotFoundError
    from otter_tpu.ops.quant import quantize_params
    from otter_tpu_torch.models.convert import load_flax_params
    from torch_parity_helpers import idefics_flat, idefics_port_cfg
    cfg, jmodel, _, frozen_model = idefics_pair("int8")
    flat = idefics_flat()
    vx, ids = idefics_inputs(cfg, 7)
    default = quantize_params(traverse_util.unflatten_dict(dict(flat),
                                                           sep="/"))
    with pytest.raises(ScopeParamNotFoundError, match="lm_head"):
        jmodel.apply(default, jnp.asarray(vx), jnp.asarray(ids))
    with torch.no_grad():
        ref, _, _ = frozen_model(torch.from_numpy(vx), torch.from_numpy(ids))
    for quant in ("int8", "int4"):
        pcfg = idefics_port_cfg(cfg.replace(
            text=cfg.text.replace(quant=quant)))
        loaded = tid.quantize_decoder(pcfg, flat)
        assert "params/lm_head/kernel" in loaded
        assert "params/xattn_0/q_proj/kernel" in loaded
        assert "params/layers_0/ffn/gate_proj/kernel_q" in loaded
        model = tid.IdeficsVLM(pcfg, dtype=torch.float32, device="cpu")
        load_flax_params(model, loaded)
        with torch.no_grad():
            out, _, _ = model(torch.from_numpy(vx), torch.from_numpy(ids))
        np.testing.assert_array_equal(out.numpy(), ref.numpy())
