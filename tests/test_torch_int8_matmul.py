"""Port parity: `int8_matmul` (the decode-shaped product of an untied int8
`lm_head`) against the JAX package's Pallas kernel in interpret mode, on the
same x, weight and scales made from a numpy seed. On the CPU the wrapper
runs its plain version, which rounds where the kernel rounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.ops import quant as jquant
from otter_tpu_torch.ops import quant as tquant

F32_TOL = 2e-3   # as the JAX package's own test of its kernel
K = 256


def _case(seed, m, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, K)).astype(np.float32)
    wq, scale = jquant.quantize_kernel(
        rng.standard_normal((K, n)).astype(np.float32))
    return x, np.asarray(wq), np.asarray(scale)


def _jax_kernel(x, wq, scale):
    return jquant.int8_matmul(x, jnp.asarray(wq), jnp.asarray(scale),
                              block_out=128, block_in=128, interpret=True)


@pytest.mark.parametrize("n", [384, 130])   # 130: no multiple of 16
@pytest.mark.parametrize("m", [1, 3, 8, 32])
def test_plain_int8_matmul_matches_jax_kernel_f32(m, n):
    """f32 inputs, atol = rtol = 2e-3 (the sums run in another order)."""
    x, wq, scale = _case(m * 1000 + n, m, n)
    ref = _jax_kernel(jnp.asarray(x), wq, scale)
    before = tquant.int8_matmul.launches
    out = tquant.int8_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                             torch.from_numpy(scale))
    assert tquant.int8_matmul.launches == before   # CPU: the plain version
    assert out.shape == (m, n) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("m,n", [(1, 130), (8, 384), (32, 130)])
def test_plain_int8_matmul_matches_jax_kernel_bf16(m, n):
    """bf16 inputs and output: |err| <= 2e-2 + 2e-2 |ref| (one bf16
    rounding of the result, sums in another order)."""
    x, wq, scale = _case(7 + m + n, m, n)
    ref = np.asarray(_jax_kernel(jnp.asarray(x, jnp.bfloat16), wq, scale
                                 ).astype(jnp.float32))
    out = tquant.int8_matmul(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(wq), torch.from_numpy(scale))
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref)
    assert (err <= 2e-2 + 2e-2 * np.abs(ref)).all(), err.max()


def test_int8_matmul_takes_a_strided_weight_view():
    x, wq, scale = _case(11, 3, 130)
    wide = np.zeros((K, 140), np.int8)
    wide[:, 5:135] = wq
    view = torch.from_numpy(wide)[:, 5:135]
    assert not view.is_contiguous()
    out = tquant.int8_matmul(torch.from_numpy(x), view,
                             torch.from_numpy(scale))
    ref = tquant.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(wq),
                                   torch.from_numpy(scale))
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


@pytest.mark.parametrize("bad", ["k", "scale", "rank"])
def test_int8_matmul_rejects_mismatched_shapes(bad):
    x = torch.zeros(2, 64)
    w = torch.zeros(64 if bad != "k" else 32, 16, dtype=torch.int8)
    s = torch.ones(16 if bad != "scale" else 8)
    if bad == "rank":
        x = x[None]
    with pytest.raises(ValueError, match="int8_matmul"):
        tquant.int8_matmul(x, w, s)
