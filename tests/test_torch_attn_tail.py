"""Port parity: the fused decode-layer tail's plain version against the JAX
`int8_attn_tail` (Pallas in interpret mode), and the port's `DecoderLayer`
with `fused_tail=True` against the JAX one on real quantized kernels, on
the CPU in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from otter_tpu import config as jcfg
from otter_tpu.models import decoder as jdec
from otter_tpu.ops import quant as jquant
from otter_tpu_torch import config as tcfg
from otter_tpu_torch.models import decoder as tdec
from otter_tpu_torch.models.convert import load_flax_params
from otter_tpu_torch.ops import quant as tquant

TOL = 1e-4   # f32: sums in another order; the JAX kernel's erf is a
             # polynomial within 1.5e-7 of the exact one used here
D, HID = 64, 128


def _tail_inputs(seed, m):
    rng = np.random.default_rng(seed)
    qk = lambda r, c: tquant.quantize_kernel(
        (0.1 * rng.standard_normal((r, c))).astype(np.float32))
    (wo, so), (w1, s1), (w2, s2) = qk(D, D), qk(D, HID), qk(HID, D)
    a = rng.standard_normal((m, D)).astype(np.float32)
    r = rng.standard_normal((m, D)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    return a, r, wo, so, g, w1, s1, w2, s2


@pytest.mark.parametrize("m", [1, 5, 32])
def test_attn_tail_plain_matches_jax(m):
    args = _tail_inputs(20 + m, m)
    ref = jquant.int8_attn_tail(*map(jnp.asarray, args), interpret=True)
    out = tquant.int8_attn_tail(*map(torch.from_numpy, args))
    assert out.shape == (m, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("act", ["relu", "silu"])
def test_attn_tail_plain_other_activations(act):
    args = _tail_inputs(30, 4)
    ref = jquant.int8_attn_tail(*map(jnp.asarray, args), act=act,
                                interpret=True)
    out = tquant.int8_attn_tail(*map(torch.from_numpy, args), act=act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_attn_tail_equals_composed_chain():
    """out-proj + residual, LayerNorm, `int8_mlp` + residual, composed from
    the port's own pieces, is the tail's function."""
    from otter_tpu_torch.ops.layers import layer_norm
    a, r, wo, so, g, w1, s1, w2, s2 = map(torch.from_numpy,
                                          _tail_inputs(31, 6))
    y = r + (a @ wo.float()) * so
    want = y + tquant.int8_mlp(layer_norm(y, g, None), w1, s1, w2, s2)
    out = tquant.int8_attn_tail(a, r, wo, so, g, w1, s1, w2, s2)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("bad", ["resid", "w2", "act"])
def test_attn_tail_refuses_bad_inputs(bad):
    a, r, wo, so, g, w1, s1, w2, s2 = map(torch.from_numpy,
                                          _tail_inputs(32, 3))
    kw = {}
    if bad == "resid":
        r = r[:, :D - 1]
    elif bad == "w2":
        w2 = w2[: HID - 1]
    else:
        kw["act"] = "sq_relu"
    with pytest.raises(ValueError):
        tquant.int8_attn_tail(a, r, wo, so, g, w1, s1, w2, s2, **kw)


def _layer_params(jlayer, x1, kwargs, seed):
    """The JAX layer's parameters with real quantized kernels and non-unit
    norm scales (flat numpy)."""
    params = jlayer.init(jax.random.PRNGKey(0), x1, **kwargs)
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        params["params"], sep="/").items()}
    rng = np.random.default_rng(seed)
    for k in list(flat):
        if k.endswith("kernel_q"):
            q, s = jquant.quantize_kernel(
                (0.1 * rng.standard_normal(flat[k].shape)).astype(np.float32))
            flat[k], flat[k[:-len("kernel_q")] + "scale_q"] = q, s
        elif k.endswith("/scale"):
            flat[k] = (1 + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    return flat


@pytest.mark.parametrize("fused", [True, False])
def test_decoder_layer_fused_tail_matches_jax(fused):
    """One cached decode step of a single MPT layer, b=2: the port's layer
    against the JAX layer with the same `fused_tail` setting, and so (both
    settings within 1e-4 of their JAX twin, which the JAX package holds
    together itself) the fused route against the composed one."""
    kw = dict(arch="mpt", vocab_size=64, hidden_size=D,
              intermediate_size=HID, num_hidden_layers=1,
              num_attention_heads=4, max_seq_len=32, act="gelu",
              no_bias=True, quant="int8", pos="alibi", fused_tail=fused)
    jc, tc = jcfg.TextConfig(**kw), tcfg.TextConfig(**kw)
    jlayer = jdec.DecoderLayer(jc, dtype=jnp.float32, fused_tail=fused)
    b, L, pos = 2, 16, 4
    rng = np.random.default_rng(40)
    x1 = rng.standard_normal((b, 1, D)).astype(np.float32)
    cache = {k: rng.standard_normal((b, 1, 4, L, D // 4)).astype(np.float32)
             for k in ("k", "v")}
    kv_valid = np.repeat(np.arange(L)[None, :] <= pos, b, 0)
    slopes = np.asarray(
        tdec.alibi_slopes(4, tc.alibi_bias_max), np.float32)
    bias = (np.arange(L, dtype=np.float32)[None, None, None, :]
            * slopes[None, :, None, None])
    jkw = dict(positions=jnp.full((b, 1), pos, jnp.int32),
               cache={k: jnp.asarray(v) for k, v in cache.items()},
               kv_valid=jnp.asarray(kv_valid), cache_pos=pos,
               bias=jnp.asarray(bias))
    flat = _layer_params(jlayer, jnp.asarray(x1), jkw, 41)
    params = {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}
    ref, jcache = jlayer.apply(params, jnp.asarray(x1), **jkw)

    tlayer = tdec.DecoderLayer(tc, torch.float32, "cpu")
    load_flax_params(tlayer, flat)
    calls = []
    real = tquant.int8_attn_tail
    tquant.int8_attn_tail = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
        with torch.no_grad():
            out = tlayer(torch.from_numpy(x1), layer=0,
                         bias=torch.from_numpy(bias), cache=tcache,
                         cache_pos=pos, kv_valid=torch.from_numpy(kv_valid))
    finally:
        tquant.int8_attn_tail = real
    assert len(calls) == int(fused)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5,
                                   rtol=1e-5)
