"""Port parity: the decode-attention kernel's plain version against the JAX
stacked-cache `decode_attention` (Pallas in interpret mode), with f32 and
int8 caches, left padding (`starts`) and an ALiBi column bias."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.ops.decode_attention import decode_attention as jdecode
from otter_tpu.ops.masks import alibi_slopes
from otter_tpu.ops.quant import quantize_kv
from otter_tpu_torch.ops.decode_attention import (decode_attention,
                                                  decode_attention_plain)

TOL = 1e-5


def _inputs(seed, int8, b=3, nl=3, h=4, L=256, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, nl, h, L, d)).astype(np.float32)
    v = rng.standard_normal((b, nl, h, L, d)).astype(np.float32)
    lengths = np.asarray([200, 17, 256][:b], np.int32)
    starts = np.asarray([0, 5, 130][:b], np.int32)
    bias = (np.arange(L)[None, None, :] * np.asarray(alibi_slopes(h))[
        None, :, None]).astype(np.float32)
    kw = {}
    if int8:
        kq, ks = quantize_kv(jnp.asarray(k))
        vq, vs = quantize_kv(jnp.asarray(v))
        k, v = np.asarray(kq), np.asarray(vq)
        kw = dict(k_scale=np.asarray(ks), v_scale=np.asarray(vs))
    return q, k, v, lengths, bias, starts, kw


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("layer", [0, 2])
def test_plain_decode_matches_jax_kernel(int8, layer):
    q, k, v, lengths, bias, starts, kw = _inputs(layer, int8)
    ref = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(lengths), jnp.asarray(bias),
                  starts=jnp.asarray(starts), layer=layer, block_k=128,
                  interpret=True,
                  **{n: jnp.asarray(a) for n, a in kw.items()})
    t = lambda a: torch.from_numpy(np.array(a))
    before = decode_attention.launches
    out = decode_attention(t(q), t(k), t(v), t(lengths), t(bias),
                           starts=t(starts), layer=layer,
                           **{n: t(a) for n, a in kw.items()})
    assert decode_attention.launches == before   # CPU: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_unstacked_cache_matches_stacked_layer():
    q, k, v, lengths, bias, starts, _ = _inputs(7, False)
    t = lambda a: torch.from_numpy(np.array(a))
    stacked = decode_attention_plain(t(q), t(k), t(v), t(lengths), t(bias),
                                     t(starts), layer=1)
    single = decode_attention_plain(t(q), t(k[:, 1]), t(v[:, 1]),
                                    t(lengths), t(bias), t(starts))
    # the einsum may sum a strided slice in another order: f32 rounding
    np.testing.assert_allclose(stacked.numpy(), single.numpy(), atol=TOL,
                               rtol=TOL)
