"""Port parity: the int4 KV cache (k and v fused by nibble in one `kv`
array) and the int4 serving path as a whole against the JAX package:
cache quantization byte for byte, the decode-attention kernel's plain
version against the Pallas kernel in interpret mode, the tiny int4 model's
prefill and cached steps, per-row cache offsets, greedy `generate` and
`stream_generate`, and the cache-precision ladder down to int4."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.config import GenerationConfig as JGen
from otter_tpu.generation import engine as jengine
from otter_tpu.models.decoder import init_cache as jinit_cache
from otter_tpu.ops import quant as jquant
from otter_tpu.ops.decode_attention import decode_attention as jdecode
from otter_tpu.ops.masks import alibi_slopes
from otter_tpu_torch.config import GenerationConfig as TGen
from otter_tpu_torch.generation import engine as tengine
from otter_tpu_torch.models.convert import export_flax_params
from otter_tpu_torch.models.decoder import (cache_len_of, init_cache,
                                            write_cache)
from otter_tpu_torch.ops import quant as tquant
from otter_tpu_torch.ops.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from torch_parity_helpers import inputs, jax_tiny_int4, torch_tiny_int4

TOL = 1e-5
MODULE_TOL = 1e-4
LOGIT_TOL = 1e-3   # the BASELINE.md logit-parity bar


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, tol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("shape", [(2, 3, 16, 64), (4, 128)])
def test_quantize_kv_int4_byte_identical(shape):
    rng = np.random.default_rng(2)
    k = rng.standard_normal(shape).astype(np.float32)
    v = (3 * rng.standard_normal(shape)).astype(np.float32)
    k[..., 0, :] = 0.0                 # zero rows keep scale 1
    kv, ks, vs = tquant.quantize_kv_int4(_t(k), _t(v))
    jkv, jks, jvs = jquant.quantize_kv_int4(jnp.asarray(k), jnp.asarray(v))
    assert kv.dtype == torch.int8 and kv.shape == shape
    assert kv.numpy().tobytes() == np.asarray(jkv).tobytes()
    assert ks.numpy().tobytes() == np.asarray(jks).tobytes()
    assert vs.numpy().tobytes() == np.asarray(jvs).tobytes()
    for out, ref in zip(tquant.dequantize_kv_int4(kv, ks, vs, torch.float32),
                        jquant.dequantize_kv_int4(jkv, jks, jvs,
                                                  jnp.float32)):
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _decode_inputs(seed, b=3, nl=3, h=4, L=256, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, nl, h, L, d)).astype(np.float32)
    v = rng.standard_normal((b, nl, h, L, d)).astype(np.float32)
    lengths = np.asarray([200, 17, 256][:b], np.int32)
    starts = np.asarray([0, 5, 130][:b], np.int32)
    bias = (np.arange(L)[None, None, :] * np.asarray(alibi_slopes(h))[
        None, :, None]).astype(np.float32)
    kv, ks, vs = (np.asarray(a) for a in jquant.quantize_kv_int4(
        jnp.asarray(k), jnp.asarray(v)))
    return q, kv, ks, vs, lengths, starts, bias


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("layer", [0, 2, None])
def test_plain_decode_int4_matches_jax_kernel(layer, with_bias):
    """Stacked cache with the layer by index, and one layer alone."""
    q, kv, ks, vs, lengths, starts, bias = _decode_inputs(layer or 5)
    if layer is None:
        kv, ks, vs = kv[:, 1], ks[:, 1], vs[:, 1]
    bias = bias if with_bias else None
    jkv = jnp.asarray(kv)
    ref = jdecode(jnp.asarray(q), jkv, jkv, jnp.asarray(lengths),
                  None if bias is None else jnp.asarray(bias),
                  starts=jnp.asarray(starts), k_scale=jnp.asarray(ks),
                  v_scale=jnp.asarray(vs), kv_bits=4, layer=layer,
                  block_k=128, interpret=True)
    tkv = _t(kv)
    before = decode_attention.launches
    out = decode_attention(_t(q), tkv, tkv, _t(lengths),
                           None if bias is None else _t(bias),
                           starts=_t(starts), k_scale=_t(ks), v_scale=_t(vs),
                           kv_bits=4, layer=layer)
    assert decode_attention.launches == before   # CPU: the plain version
    _close(out, ref, TOL)


def test_plain_decode_int4_equals_dequantized_cache():
    q, kv, ks, vs, lengths, starts, bias = _decode_inputs(9)
    tkv = _t(kv)
    out = decode_attention_plain(_t(q), tkv, tkv, _t(lengths), _t(bias),
                                 _t(starts), k_scale=_t(ks), v_scale=_t(vs),
                                 kv_bits=4, layer=1)
    k, v = tquant.dequantize_kv_int4(tkv, _t(ks), _t(vs), torch.float32)
    ref = decode_attention_plain(_t(q), k, v, _t(lengths), _t(bias),
                                 _t(starts), layer=1)
    _close(out, ref, MODULE_TOL)


def test_init_cache_int4_layout_and_bytes():
    cfg, _, _, _ = jax_tiny_int4()
    cache = init_cache(cfg.text, 3, 256, "int4", "cpu")
    ref = jinit_cache(cfg.text, 3, 256, "int4")
    assert set(cache) == set(ref) == {"kv", "k_scale", "v_scale"}
    for key in cache:
        assert tuple(cache[key].shape) == ref[key].shape
        assert str(cache[key].dtype).split(".")[-1] == str(ref[key].dtype)
    assert cache_len_of(cache) == 256
    assert cache_len_of(init_cache(cfg.text, 1, 128, torch.int8, "cpu")) == 128
    assert tengine.cache_bytes(cfg.text, 3, 256, "int4") == \
        jengine.cache_bytes(cfg.text, 3, 256, "int4")


@pytest.fixture(scope="module")
def pair():
    cfg, jmodel, params, _ = jax_tiny_int4()
    return cfg, jmodel, params, torch_tiny_int4()


def test_int4_params_load_one_to_one():
    """`kernel_q4` leaves land in the port's `Int4Dense` buffers, and the
    port exports exactly the leaves it was given."""
    _, _, _, flat = jax_tiny_int4()
    assert any(k.endswith("ffn/up_proj/kernel_q4") for k in flat)
    assert any(k.endswith("ff_up/kernel_q4") for k in flat)
    back = export_flax_params(torch_tiny_int4())
    assert sorted(back) == sorted(k[len("params/"):] for k in flat)
    for k, v in back.items():
        if k.endswith(("kernel_q4", "kernel_q", "scale_q")):
            assert v.tobytes() == flat["params/" + k].tobytes(), k


def _check_cache(tcache, jcache, upto):
    """Scales close; the nibbles may differ by one step at a rounding tie."""
    for key in ("k_scale", "v_scale"):
        _close(tcache[key][:, :, :, :upto],
               np.asarray(jcache[key][:, :, :, :upto]), MODULE_TOL)
    tk, tv = tquant._nibbles(tcache["kv"][:, :, :, :upto])
    jk, jv = tquant._nibbles(_t(np.asarray(jcache["kv"][:, :, :, :upto])))
    assert int((tk.int() - jk.int()).abs().max()) <= 1
    assert int((tv.int() - jv.int()).abs().max()) <= 1


@pytest.mark.parametrize("decode_kernel", ["auto", False])
def test_int4_model_cached_decode_matches_jax(decode_kernel):
    """int4 weights and an int4 cache in f32: prefill (Int4Dense), then
    three cached steps (`int4_mlp`, and the decode-attention kernel with
    "auto" or the dense route over the dequantized slice with False)."""
    cfg, jmodel, params, _ = jax_tiny_int4(0, decode_kernel)
    tmodel = torch_tiny_int4(0, decode_kernel)
    b, p, L = 2, 10, 128
    vx, ids = inputs(cfg, 16, b, p)
    mask = np.ones_like(ids)
    mask[0, :3] = 0
    jcache = jinit_cache(cfg.text, b, L, "int4")
    tcache = init_cache(tmodel.cfg.text, b, L, "int4", "cpu")
    prefill = jax.jit(lambda vx, ids, mask, cache: jmodel.apply(
        params, vx, ids, attention_mask=mask, cache=cache,
        head_last_only=True))
    step = jax.jit(lambda tok, lat, cache, pos, kv_valid, counts: jmodel.apply(
        params, None, tok, vis_latents=lat, cache=cache, cache_pos=pos,
        kv_valid=kv_valid, media_counts=counts))
    jl, jcache, jlat = prefill(jnp.asarray(vx), jnp.asarray(ids),
                               jnp.asarray(mask), jcache)
    with torch.no_grad():
        tl, tcache, tlat = tmodel(_t(vx), _t(ids).long(),
                                  attention_mask=_t(mask), cache=tcache,
                                  head_last_only=True)
    _close(tl, jl, LOGIT_TOL)
    _check_cache(tcache, jcache, p)
    counts = (ids == cfg.media_token_id).sum(-1).astype(np.int32)
    kv_valid = np.zeros((b, L), bool)
    kv_valid[:, :p] = mask.astype(bool)
    for t in range(3):
        tok = np.full((b, 1), 7 + t, np.int32)
        kv_valid[:, p + t] = True
        jl, jcache, _ = step(jnp.asarray(tok), jlat, jcache, p + t,
                             jnp.asarray(kv_valid), jnp.asarray(counts))
        with torch.no_grad():
            tl, tcache, _ = tmodel(
                None, _t(tok).long(), vis_latents=tlat, cache=tcache,
                cache_pos=p + t, kv_valid=_t(kv_valid),
                media_counts=_t(counts))
        _close(tl, jl, LOGIT_TOL)
    _check_cache(tcache, jcache, p + 3)


def test_per_row_cache_pos_matches_jax(pair):
    """A decode step whose rows write at different offsets (`cache_pos`
    [B]), as the JAX decoder's `write_cache` scatters them."""
    cfg, jmodel, params, tmodel = pair
    b, p, L = 2, 8, 128
    vx, ids = inputs(cfg, 17, b, p)
    jcache = jinit_cache(cfg.text, b, L, "int4")
    tcache = init_cache(tmodel.cfg.text, b, L, "int4", "cpu")
    _, jcache, jlat = jax.jit(lambda vx, ids, cache: jmodel.apply(
        params, vx, ids, cache=cache, head_last_only=True))(
            jnp.asarray(vx), jnp.asarray(ids), jcache)
    with torch.no_grad():
        _, tcache, tlat = tmodel(_t(vx), _t(ids).long(), cache=tcache,
                                 head_last_only=True)
    pos = np.asarray([p, p + 5], np.int32)
    kv_valid = np.zeros((b, L), bool)
    kv_valid[:, :p] = True
    kv_valid[np.arange(b), pos] = True
    tok = np.asarray([[11], [12]], np.int32)
    counts = np.ones(b, np.int32)
    jl, jcache, _ = jax.jit(
        lambda tok, lat, cache, pos, kv_valid, counts: jmodel.apply(
            params, None, tok, vis_latents=lat, cache=cache, cache_pos=pos,
            kv_valid=kv_valid, media_counts=counts))(
                jnp.asarray(tok), jlat, jcache, jnp.asarray(pos),
                jnp.asarray(kv_valid), jnp.asarray(counts))
    with torch.no_grad():
        tl, tcache, _ = tmodel(None, _t(tok).long(), vis_latents=tlat,
                               cache=tcache, cache_pos=_t(pos).long(),
                               kv_valid=_t(kv_valid), media_counts=_t(counts))
    _close(tl, jl, LOGIT_TOL)
    _check_cache(tcache, jcache, L)
    assert int(tcache["kv"][0, :, :, p + 5].abs().max()) == 0
    assert int(tcache["kv"][1, :, :, p + 5].abs().max()) > 0


@pytest.mark.parametrize("dtype", ["int4", "int8", torch.float32])
def test_write_cache_per_row_windows(dtype):
    """S = 2 positions a row at per-row offsets equal the same rows written
    one at a time at scalar offsets."""
    cfg, _, _, _ = jax_tiny_int4()
    c = cfg.text
    rng = np.random.default_rng(18)
    b, s = 3, 2
    k = _t(rng.standard_normal((b, c.kv_heads, s, c.head_dim)).astype(
        np.float32))
    v = _t(rng.standard_normal(k.shape).astype(np.float32))
    pos = torch.tensor([4, 0, 9])
    got = init_cache(c, b, 16, dtype, "cpu")
    want = init_cache(c, b, 16, dtype, "cpu")
    write_cache(got, 1, k, v, pos)
    for r in range(b):
        one = {key: val[r:r + 1] for key, val in want.items()}   # views
        write_cache(one, 1, k[r:r + 1], v[r:r + 1], int(pos[r]))
    for key in want:
        assert torch.equal(got[key], want[key]), key
        assert got[key][:, 0].abs().max() == 0    # other layers untouched


def test_greedy_generate_int4_identical_to_jax(pair):
    cfg, jmodel, params, tmodel = pair
    vx, ids = inputs(cfg, 20, 3, 12)
    mask = np.ones_like(ids)
    mask[0, 9:] = 0
    mask[1, 5:] = 0
    lang_x, attn = tengine.left_pad(ids, mask)
    ref = jengine.OtterGenerator(jmodel, params, cfg, cache_dtype="int4"
                                 ).generate(jnp.asarray(vx),
                                            jnp.asarray(lang_x),
                                            jnp.asarray(attn),
                                            gen=JGen(max_new_tokens=6))
    out = tengine.OtterGenerator(tmodel, cache_dtype="int4").generate(
        vx, lang_x, attn, gen=TGen(max_new_tokens=6))
    assert out.shape == ref.shape == (3, 12 + 6)
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_ladder_walks_down_to_int4():
    cfg, _, _, _ = jax_tiny_int4()
    need = {n: tengine.cache_bytes(cfg.text, 4, 256, n)
            for n in ("bf16", "int8", "int4")}
    assert need["bf16"] > need["int8"] > need["int4"]
    cuda = torch.device("cuda")
    pick = lambda req, hbm: tengine.select_cache_dtype(
        cfg.text, 4, 256, req, device=cuda, hbm_bytes=hbm, headroom_bytes=0)
    with pytest.warns(UserWarning, match="bf16 -> int8"):
        assert pick(torch.bfloat16, need["int8"]) == torch.int8
    with pytest.warns(UserWarning, match="bf16 -> int4"):
        assert pick(torch.bfloat16, need["int4"]) == "int4"
    with pytest.warns(UserWarning, match="int8 -> int4"):
        assert pick(torch.int8, need["int8"] - 1) == "int4"
    with pytest.warns(UserWarning, match="even at int4"):
        assert pick(torch.bfloat16, need["int4"] - 1) == "int4"
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # a request that fits: no warning
        assert pick("int4", need["int4"]) == "int4"
        assert pick(torch.int8, need["int8"]) == torch.int8
