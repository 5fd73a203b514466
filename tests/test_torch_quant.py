"""Port parity: int8 quantization transforms (byte for byte), Int8Dense,
and the fused int8 MLP's plain version against the JAX package (Pallas in
interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from otter_tpu.ops import quant as jquant
from otter_tpu_torch.ops import quant as tquant

TOL = 1e-5


def _weights(seed, k, h, n):
    rng = np.random.default_rng(seed)
    w1 = (0.1 * rng.standard_normal((k, h))).astype(np.float32)
    w2 = (0.1 * rng.standard_normal((h, n))).astype(np.float32)
    x = rng.standard_normal((5, k)).astype(np.float32)
    return x, w1, w2


def test_quantize_kernel_byte_identical():
    _, w1, _ = _weights(0, 48, 96, 8)
    w1[:, 3] = 0.0                     # an all-zero column takes scale 1
    q, s = tquant.quantize_kernel(w1)
    jq, js = jquant.quantize_kernel(w1)
    assert q.dtype == np.int8 and s.dtype == np.float32
    assert q.tobytes() == np.asarray(jq).tobytes()
    assert s.tobytes() == np.asarray(js).tobytes()


def test_quantize_kernel_tensor_matches_numpy():
    _, w1, _ = _weights(1, 32, 64, 8)
    q, s = tquant.quantize_kernel(torch.from_numpy(w1))
    nq, ns = tquant.quantize_kernel(w1)
    np.testing.assert_array_equal(q.numpy(), nq)
    np.testing.assert_array_equal(s.numpy(), ns)


@pytest.mark.parametrize("shape", [(2, 3, 16, 64), (4, 128)])
def test_quantize_kv_byte_identical(shape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 0, :] = 0.0                 # zero rows keep scale 1
    q, s = tquant.quantize_kv(torch.from_numpy(x))
    jq, js = jquant.quantize_kv(jnp.asarray(x))
    assert q.numpy().tobytes() == np.asarray(jq).tobytes()
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(
        tquant.dequantize_kv(q, s, torch.float32).numpy(),
        np.asarray(jquant.dequantize_kv(jq, js, jnp.float32)))


def test_quantize_params_matches_jax():
    rng = np.random.default_rng(3)
    tree = {"params": {
        "lang_encoder": {
            "layers_0": {"attn": {"Wqkv": {"kernel": rng.standard_normal(
                (8, 24)).astype(np.float32)}},
                "norm_1": {"scale": np.ones(8, np.float32)}},
            "xattn_1": {"ff_up": {"kernel": rng.standard_normal(
                (8, 32)).astype(np.float32)}}},
        "perceiver": {"layers_0": {"to_q": {"kernel": rng.standard_normal(
            (8, 8)).astype(np.float32)}}}}}
    ref = traverse_util.flatten_dict(jquant.quantize_params(tree), sep="/")
    out = tquant.quantize_params(traverse_util.flatten_dict(tree, sep="/"))
    assert sorted(out) == sorted(ref)
    for k, v in out.items():
        assert np.asarray(v).tobytes() == np.asarray(ref[k]).tobytes(), k


def test_quantize_embed_byte_identical():
    rng = np.random.default_rng(8)
    table = rng.standard_normal((40, 16)).astype(np.float32)
    table[3] = 0.0                     # an all-zero row keeps a tiny scale
    tree = {"params": {"language_model": {
        "wte": {"embedding": table},
        "norm_f": {"scale": np.ones(16, np.float32)}}}}
    ref = traverse_util.flatten_dict(jquant.quantize_embed(tree), sep="/")
    flat = traverse_util.flatten_dict(tree, sep="/")
    out = tquant.quantize_embed(flat)
    assert sorted(out) == sorted(ref)
    assert "params/language_model/wte_q" in out
    for k, v in out.items():
        assert v.dtype == np.asarray(ref[k]).dtype, k
        assert np.asarray(v).tobytes() == np.asarray(ref[k]).tobytes(), k
    # tensors stay tensors and give the same bytes
    tens = tquant.quantize_embed({k: torch.from_numpy(v)
                                  for k, v in flat.items()})
    for k, v in tens.items():
        assert v.numpy().tobytes() == np.asarray(ref[k]).tobytes(), k


@pytest.mark.parametrize("arch", ["llama", "persimmon"])
def test_quantize_params_int4_keeps_gated_and_biased_mlps_int8(arch):
    """A `silu_glu` triple (llama) and an ffn with biases (persimmon) stay
    int8 under `quantize_params_int4`, as in the JAX package: same leaves,
    same bytes, and no packed `kernel_q4` among them."""
    rng = np.random.default_rng(9)
    w = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    if arch == "llama":
        ffn = {"gate_proj": {"kernel": w(8, 16)},
               "up_proj": {"kernel": w(8, 16)},
               "down_proj": {"kernel": w(16, 8)}}
        attn = {"q_proj": {"kernel": w(8, 8)}}
    else:
        ffn = {"up_proj": {"kernel": w(8, 16), "bias": w(16)},
               "down_proj": {"kernel": w(16, 8), "bias": w(8)}}
        attn = {"Wqkv": {"kernel": w(8, 24), "bias": w(24)}}
    tree = {"params": {"layers_0": {"ffn": ffn, "attn": attn},
                       "lm_head": {"kernel": w(8, 12)}}}
    ref = traverse_util.flatten_dict(jquant.quantize_params_int4(tree),
                                     sep="/")
    out = tquant.quantize_params_int4(traverse_util.flatten_dict(tree,
                                                                 sep="/"))
    assert sorted(out) == sorted(ref)
    assert not any(k.endswith("kernel_q4") for k in out)
    assert "params/lm_head/kernel_q" in out
    for k, v in out.items():
        assert np.asarray(v).tobytes() == np.asarray(ref[k]).tobytes(), k


def test_int8_dense_matches_jax():
    x, w1, _ = _weights(4, 16, 24, 8)
    q, s = jquant.quantize_kernel(w1)
    params = {"params": {"kernel_q": jnp.asarray(q),
                         "scale_q": jnp.asarray(s)}}
    ref = jquant.Int8Dense(24, use_bias=False, dtype=jnp.float32).apply(
        params, jnp.asarray(x))
    dense = tquant.Int8Dense(16, 24, dtype=torch.float32, device="cpu")
    dense.kernel_q.copy_(torch.from_numpy(np.asarray(q)))
    dense.scale_q.copy_(torch.from_numpy(np.asarray(s)))
    np.testing.assert_allclose(dense(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("act,bias", [("gelu", False), ("sq_relu", True),
                                      ("silu", False)])
def test_plain_int8_mlp_matches_jax_kernel(act, bias):
    x, w1, w2 = _weights(5, 64, 256, 48)
    q1, s1 = jquant.quantize_kernel(w1)
    q2, s2 = jquant.quantize_kernel(w2)
    rng = np.random.default_rng(6)
    b1 = rng.standard_normal(256).astype(np.float32) if bias else None
    b2 = rng.standard_normal(48).astype(np.float32) if bias else None
    ref = jquant.int8_mlp(
        jnp.asarray(x), jnp.asarray(q1), jnp.asarray(s1), jnp.asarray(q2),
        jnp.asarray(s2), act=act, b1=None if b1 is None else jnp.asarray(b1),
        b2=None if b2 is None else jnp.asarray(b2), block_h=128,
        interpret=True)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    before = tquant.int8_mlp.launches
    out = tquant.int8_mlp(t(x), t(q1), t(s1), t(q2), t(s2), act=act,
                          b1=t(b1), b2=t(b2))
    assert tquant.int8_mlp.launches == before   # CPU: the plain version
    # the TPU kernel's gelu uses an erf approximation (|err| <= 1.5e-7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_int8_mlp_rejects_mismatched_shapes():
    x = torch.zeros(2, 8)
    w = torch.zeros(8, 16, dtype=torch.int8)
    with pytest.raises(ValueError):
        tquant.int8_mlp(x, w, torch.ones(16), w, torch.ones(16))
