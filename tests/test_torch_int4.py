"""Port parity: int4 weight packing (byte for byte), `Int4Dense` /
`Int4AttnDense`, and the plain versions of the `int4_mlp` and `int4_matmul`
kernels against the JAX package (Pallas in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from otter_tpu.ops import quant as jquant
from otter_tpu_torch.ops import quant as tquant

TOL = 1e-5
# bf16 in and out: the two sides add their f32 partial sums in another
# order, which can move a bf16 rounding of a hidden unit or of the result
# by one step (2^-8 relative)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    return _t(np.asarray(a, np.float32)).to(torch.bfloat16)


def _f32(t):
    return t.float().numpy()


def _pair(seed, k=64, h=256, n=64):
    rng = np.random.default_rng(seed)
    w1 = (0.1 * rng.standard_normal((k, h))).astype(np.float32)
    w2 = (0.1 * rng.standard_normal((h, n))).astype(np.float32)
    return rng, jquant.quantize_kernel_int4(w1, 0), \
        jquant.quantize_kernel_int4(w2, 1)


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_kernel_int4_byte_identical(axis):
    rng = np.random.default_rng(axis)
    w = rng.standard_normal((48, 96)).astype(np.float32)
    w[:, 3] = 0.0                      # an all-zero column takes scale 1
    q, s = tquant.quantize_kernel_int4(w, axis)
    jq, js = jquant.quantize_kernel_int4(w, axis)
    assert q.dtype == np.int8 and s.dtype == np.float32
    assert q.shape == ((24, 96) if axis == 0 else (48, 48))
    assert q.tobytes() == np.asarray(jq).tobytes()
    assert s.tobytes() == np.asarray(js).tobytes()
    # a tensor goes the same way and stays a tensor
    tq, ts = tquant.quantize_kernel_int4(torch.from_numpy(w), axis)
    np.testing.assert_array_equal(tq.numpy(), q)
    np.testing.assert_array_equal(ts.numpy(), s)


@pytest.mark.parametrize("axis", [0, 1])
def test_unpack_int4_matches_jax(axis):
    # every byte value, so both nibbles take every value including -8
    packed = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    out = tquant.unpack_int4(torch.from_numpy(packed), axis)
    ref = np.asarray(jquant.unpack_int4(jnp.asarray(packed), axis))
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), ref)


def test_quantize_kernel_int4_rejects_odd_axis():
    with pytest.raises(ValueError):
        tquant.quantize_kernel_int4(np.zeros((5, 8), np.float32), 0)


def test_quantize_params_int4_matches_jax():
    rng = np.random.default_rng(3)
    w = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    tree = {"params": {"lang_encoder": {
        # a plain pair packs; its attention stays int8
        "layers_0": {"attn": {"Wqkv": {"kernel": w(8, 24)}},
                     "ffn": {"up_proj": {"kernel": w(8, 32)},
                             "down_proj": {"kernel": w(32, 8)}},
                     "norm_1": {"scale": np.ones(8, np.float32)}},
        # a biased pair stays int8
        "layers_1": {"ffn": {
            "up_proj": {"kernel": w(8, 32), "bias": w(32)},
            "down_proj": {"kernel": w(32, 8), "bias": w(8)}}},
        # a gate/up/down triple stays int8
        "layers_2": {"ffn": {"gate_proj": {"kernel": w(8, 32)},
                             "up_proj": {"kernel": w(8, 32)},
                             "down_proj": {"kernel": w(32, 8)}}},
        "xattn_1": {"ff_up": {"kernel": w(8, 32)},
                    "ff_down": {"kernel": w(32, 8)},
                    "attn": {"to_q": {"kernel": w(8, 8)}}},
        "lm_head": {"kernel": w(8, 16)}},
        "perceiver": {"layers_0": {"to_q": {"kernel": w(8, 8)}}}}}
    ref = traverse_util.flatten_dict(jquant.quantize_params_int4(tree),
                                     sep="/")
    out = tquant.quantize_params_int4(
        traverse_util.flatten_dict(tree, sep="/"))
    assert sorted(out) == sorted(ref)
    assert sum(k.endswith("kernel_q4") for k in out) == 4
    for k, v in out.items():
        assert np.asarray(v).tobytes() == np.asarray(ref[k]).tobytes(), k


@pytest.mark.parametrize("axis", [0, 1])
def test_int4_dense_matches_jax(axis):
    rng = np.random.default_rng(4)
    w = (0.1 * rng.standard_normal((16, 24))).astype(np.float32)
    x = rng.standard_normal((5, 16)).astype(np.float32)
    q, s = jquant.quantize_kernel_int4(w, axis)
    ref = jquant.Int4Dense(24, pack_axis=axis, dtype=jnp.float32).apply(
        {"params": {"kernel_q4": jnp.asarray(q), "scale_q": jnp.asarray(s)}},
        jnp.asarray(x))
    dense = tquant.Int4Dense(16, 24, axis, dtype=torch.float32, device="cpu")
    assert dense.kernel_q4.shape == q.shape
    dense.kernel_q4.copy_(_t(q))
    dense.scale_q.copy_(_t(s))
    np.testing.assert_allclose(dense(_t(x)).numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("tokens", [(3,), (5, 8)])
def test_int4_attn_dense_matches_jax(tokens):
    """Up to 32 tokens through `int4_matmul` (the JAX module runs its Pallas
    kernel in interpret mode on the CPU), 40 through unpack-and-multiply."""
    rng = np.random.default_rng(5)
    w = (0.1 * rng.standard_normal((64, 128))).astype(np.float32)
    x = rng.standard_normal(tokens + (64,)).astype(np.float32)
    q, s = jquant.quantize_kernel_int4(w, 0)
    ref = jquant.Int4AttnDense(128, dtype=jnp.float32).apply(
        {"params": {"kernel_q4": jnp.asarray(q), "scale_q": jnp.asarray(s)}},
        jnp.asarray(x))
    dense = tquant.Int4AttnDense(64, 128, dtype=torch.float32, device="cpu")
    dense.kernel_q4.copy_(_t(q))
    dense.scale_q.copy_(_t(s))
    out = dense(_t(x))
    assert out.shape == tokens + (128,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("m", [1, 8, 32])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
def test_plain_int4_mlp_matches_jax_kernel(act, m):
    # K = 64 and 96: multiples of 32 that are not of 128, which the CUDA
    # kernel takes (96: 48 packed rows, not a whole 32-row step either)
    for k in (64, 96):
        rng, (q1, s1), (q2, s2) = _pair(6, k=k)
        x = rng.standard_normal((m, k)).astype(np.float32)
        ref = jquant.int4_mlp(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(q1), jnp.asarray(s1),
            jnp.asarray(q2), jnp.asarray(s2), act=act, block_h=128,
            interpret=True)
        before = tquant.int4_mlp.launches
        out = tquant.int4_mlp(_bf16(x), _t(q1), _t(s1), _t(q2), _t(s2),
                              act=act)
        assert tquant.int4_mlp.launches == before   # CPU: the plain version
        assert out.dtype == torch.bfloat16 and out.shape == (m, 64)
        np.testing.assert_allclose(_f32(out), np.asarray(ref, np.float32),
                                   **BF16_TOL)


def test_plain_int4_mlp_matches_jax_kernel_f32():
    """In f32 the two sides agree to rounding (the TPU kernel's gelu uses
    an erf approximation, |err| <= 1.5e-7)."""
    rng, (q1, s1), (q2, s2) = _pair(7)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    ref = jquant.int4_mlp(jnp.asarray(x), jnp.asarray(q1), jnp.asarray(s1),
                          jnp.asarray(q2), jnp.asarray(s2), block_h=128,
                          interpret=True)
    out = tquant.int4_mlp(_t(x), _t(q1), _t(s1), _t(q2), _t(s2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("m", [1, 8, 32])
def test_plain_int4_matmul_matches_jax_kernel(m):
    rng = np.random.default_rng(8)
    w = (0.1 * rng.standard_normal((64, 256))).astype(np.float32)
    x = rng.standard_normal((m, 64)).astype(np.float32)
    q, s = jquant.quantize_kernel_int4(w, 0)
    ref = jquant.int4_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q),
                             jnp.asarray(s), block_out=128, interpret=True)
    before = tquant.int4_matmul.launches
    out = tquant.int4_matmul(_bf16(x), _t(q), _t(s))
    assert tquant.int4_matmul.launches == before   # CPU: the plain version
    assert out.dtype == torch.bfloat16 and out.shape == (m, 256)
    np.testing.assert_allclose(_f32(out), np.asarray(ref, np.float32),
                               **BF16_TOL)


def test_int4_wrappers_reject_what_they_cannot_take():
    x = torch.zeros(2, 8)
    w1 = torch.zeros(4, 16, dtype=torch.int8)
    w2 = torch.zeros(16, 4, dtype=torch.int8)
    ones = torch.ones
    with pytest.raises(ValueError):      # s1 of the wrong length
        tquant.int4_mlp(x, w1, ones(8), w2, ones(8))
    with pytest.raises(ValueError):      # w1p is not [K/2, H]
        tquant.int4_mlp(x, w2, ones(16), w2, ones(8))
    with pytest.raises(ValueError):      # the int4 kernel has no sq_relu
        tquant.int4_mlp(x, w1, ones(16), w2, ones(8), act="sq_relu")
    with pytest.raises(ValueError):      # wp is not [K/2, N]
        tquant.int4_matmul(x, w2, ones(4))


def test_int4_matmul_splits_fill_the_card_in_whole_stages():
    # the serving widths: qkv and out-proj of MPT-7B; `split_k` counts
    # streamed rows, which for the packed product are K / 2
    assert tquant.split_k(4096 // 2, 12288) == 4
    assert tquant.split_k(4096 // 2, 4096) == 8
    for k, n in ((4096, 12288), (4096, 4096), (128, 128), (384, 256)):
        splits = tquant.split_k(k // 2, n)
        assert (k // 2) % (64 * splits) == 0
    # the int8 products of the fused decode layer stream K rows
    assert tquant.split_k(4096, 12288) == 4
    assert tquant.split_k(4096, 4096) == 8
    assert tquant.split_k(64, 128) == 1


@pytest.mark.parametrize("k", [128, 384, 1024, 4096, 4544 * 2, 16384])
def test_int4_matmul_plan_is_whole_stages_for_every_width(k):
    """The kernel's plan (`split_k` over the K / 2 packed rows) is a pure
    function of (K, N), the same for every M, and gives every split a
    whole number of 64-row stages and at most 16 splits, for every N the
    wrapper takes (N % 128 == 0); past one wave of 256 CTAs it adds
    none."""
    for n in range(128, 64 * 128 + 1, 128):
        splits = tquant.split_k(k // 2, n)
        assert splits >= 1 and splits & (splits - 1) == 0 and splits <= 16
        assert (k // 2) % (64 * splits) == 0
        if splits > 1:
            assert (n // 128) * splits // 2 < 256
