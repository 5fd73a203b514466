"""Port parity: the decode megakernel's plain version, the whole-layer
wrapper and `add_fused_wqo` against the JAX package (the Pallas kernel in
interpret mode), on the same numpy inputs made from a seed, on the CPU;
the position as a host int and as a 0-d tensor (JAX's traced under jit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from otter_tpu.ops import megakernel as jmk
from otter_tpu.ops import quant as jquant
from otter_tpu_torch.ops import megakernel as tmk
from otter_tpu_torch.ops import quant as tquant

B, H, DH, L, NL = 3, 4, 16, 32, 3
D = H * DH


def _quant_cols(rng, shape):
    w = rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[0])
    return tquant.quantize_kernel(w)


def _setup(seed, pos, stacked, dtype=np.float32):
    """numpy inputs; cache rows at and past `pos` hold 1e4 (garbage the
    function must not read)."""
    rng = np.random.default_rng(seed)
    shape = (B, NL, H, L, DH) if stacked else (B, H, L, DH)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    kc[..., pos:, :] = 1e4
    vc[..., pos:, :] = 1e4
    wq, sq = _quant_cols(rng, (D, 3 * D))
    wo, so = _quant_cols(rng, (D, D))
    return dict(
        x=rng.standard_normal((B, D)).astype(np.float32), kc=kc, vc=vc,
        bias=(0.1 * rng.standard_normal((H, L))).astype(np.float32),
        ln1=(1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
        wqo=np.concatenate([wq, wo], axis=1), sqo=np.concatenate([sq, so]))


def _both(a, pos, layer, jdt=jnp.float32, tdt=torch.float32):
    ref = jmk.decode_attn_megakernel(
        jnp.asarray(a["x"], jdt), jnp.asarray(a["kc"], jdt),
        jnp.asarray(a["vc"], jdt), pos, jnp.asarray(a["bias"]),
        jnp.asarray(a["ln1"]), jnp.asarray(a["wqo"]), jnp.asarray(a["sqo"]),
        layer=layer, interpret=True)
    t = lambda k, dt=None: torch.from_numpy(a[k]).to(dt or torch.float32)
    out = tmk.decode_attn_megakernel(
        t("x", tdt), t("kc", tdt), t("vc", tdt), pos, t("bias"), t("ln1"),
        torch.from_numpy(a["wqo"]), t("sqo"), layer=layer)
    return ([np.asarray(r, np.float32) for r in ref],
            [o.float().numpy() for o in out])


@pytest.mark.parametrize("pos", [0, 13, L - 1])
@pytest.mark.parametrize("stacked", [False, True])
def test_megakernel_plain_matches_jax(stacked, pos):
    """f32: y within 1e-4, k_new / v_new within 1e-5 (sums in another
    order; no rounding points in f32)."""
    a = _setup(10 + pos, pos, stacked)
    (y_ref, kn_ref, vn_ref), (y, kn, vn) = _both(a, pos, 1 if stacked else None)
    assert y.shape == (B, D) and kn.shape == vn.shape == (B, H, DH)
    np.testing.assert_allclose(kn, kn_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(vn, vn_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y, y_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("pos", [0, 13, L - 1])
@pytest.mark.parametrize("stacked", [False, True])
def test_megakernel_plain_with_a_tensor_pos_matches_jax_traced(stacked, pos,
                                                               dtype):
    """The position as a 0-d tensor (what a captured decode step passes)
    against the JAX function under `jax.jit` with `pos` traced (its
    scalar-prefetch operand, interpret mode): the same tolerances as the
    host-int case, and the port's outputs bit-equal to its host-int call."""
    a = _setup(10 + pos, pos, stacked)
    layer = 1 if stacked else None
    j = lambda k: jnp.asarray(a[k])
    ref = jax.jit(lambda p: jmk.decode_attn_megakernel(
        j("x"), j("kc"), j("vc"), p, j("bias"), j("ln1"), j("wqo"),
        j("sqo"), layer=layer, interpret=True))(jnp.int32(pos))
    t = lambda k: torch.from_numpy(a[k])
    args = (t("bias"), t("ln1"), t("wqo"), t("sqo"))
    out = tmk.decode_attn_megakernel(t("x"), t("kc"), t("vc"),
                                     torch.tensor(pos, dtype=dtype), *args,
                                     layer=layer)
    host = tmk.decode_attn_megakernel(t("x"), t("kc"), t("vc"), pos, *args,
                                      layer=layer)
    for o, h in zip(out, host):
        assert torch.equal(o, h)
    (y_ref, kn_ref, vn_ref), (y, kn, vn) = (
        [np.asarray(r, np.float32) for r in ref],
        [o.float().numpy() for o in out])
    np.testing.assert_allclose(kn, kn_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(vn, vn_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y, y_ref, atol=1e-4, rtol=1e-4)


def test_megakernel_plain_matches_jax_bf16():
    """bf16 activations and cache: the rounding points of the two agree up
    to the tolerances of the JAX package's own megakernel test (k_new /
    v_new 2e-2, y 5e-2)."""
    pos = 13
    a = _setup(3, pos, True)
    (y_ref, kn_ref, vn_ref), (y, kn, vn) = _both(
        a, pos, 1, jnp.bfloat16, torch.bfloat16)
    np.testing.assert_allclose(kn, kn_ref, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(vn, vn_ref, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(y, y_ref, atol=5e-2, rtol=5e-2)


def test_megakernel_stacked_equals_sliced_layer():
    pos, layer = 7, 2
    a = _setup(4, pos, True)
    t = lambda k: torch.from_numpy(a[k])
    args = (pos, t("bias"), t("ln1"), t("wqo"), t("sqo"))
    stacked = tmk.decode_attn_megakernel(t("x"), t("kc"), t("vc"), *args,
                                         layer=layer)
    sliced = tmk.decode_attn_megakernel(
        t("x"), t("kc")[:, layer].contiguous(),
        t("vc")[:, layer].contiguous(), *args)
    for s, r in zip(stacked, sliced):
        assert torch.equal(s, r)


@pytest.mark.parametrize("stacked", [False, True])
def test_decode_layer_megakernel_appends_at_pos(stacked):
    """The whole layer against the JAX `mpt_decode_layer_megakernel`: the
    output within 1e-4, the new k/v at `pos` within 1e-5, slot `pos + 1`
    and everything else of the cache untouched."""
    _decode_layer_case(stacked, tensor_pos=False)


@pytest.mark.parametrize("stacked", [False, True])
def test_decode_layer_megakernel_appends_at_a_tensor_pos(stacked):
    """The same with `pos` a 0-d tensor (appended by `index_copy_`)."""
    _decode_layer_case(stacked, tensor_pos=True)


def _decode_layer_case(stacked, tensor_pos):
    pos, layer = 9, (1 if stacked else None)
    a = _setup(5, pos, stacked)
    rng = np.random.default_rng(6)
    hid = 2 * D
    w1, s1 = _quant_cols(rng, (D, hid))
    w2, s2 = _quant_cols(rng, (hid, D))
    ln2 = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    j = jnp.asarray
    ref, kref, vref = jmk.mpt_decode_layer_megakernel(
        j(a["x"]), j(a["kc"]), j(a["vc"]), pos, j(a["bias"]), j(a["ln1"]),
        j(a["wqo"]), j(a["sqo"]), j(ln2), j(w1), j(s1), j(w2), j(s2),
        layer=layer, interpret=True)
    t = torch.from_numpy
    kc, vc = t(a["kc"].copy()), t(a["vc"].copy())
    out, kout, vout = tmk.mpt_decode_layer_megakernel(
        t(a["x"]), kc, vc, torch.tensor(pos) if tensor_pos else pos,
        t(a["bias"]), t(a["ln1"]), t(a["wqo"]),
        t(a["sqo"]), t(ln2), t(w1), t(s1), t(w2), t(s2), layer=layer)
    assert kout is kc and vout is vc          # appended in place
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    for new, before, jax_new in ((kc, a["kc"], kref), (vc, a["vc"], vref)):
        new = new.numpy()
        np.testing.assert_allclose(new, np.asarray(jax_new), atol=1e-5,
                                   rtol=1e-5)
        changed = new != before
        expect = np.zeros_like(changed)
        if stacked:
            expect[:, layer, :, pos] = True
        else:
            expect[:, :, pos] = True
        assert (changed == expect).all()      # pos + 1 still holds 1e4


def test_add_fused_wqo_byte_identical_to_jax():
    rng = np.random.default_rng(7)
    tree = {"params": {"lang_encoder": {}}}
    for i in range(2):
        attn = {}
        for name, n in (("Wqkv", 3 * D), ("out_proj", D)):
            q, s = _quant_cols(rng, (D, n))
            attn[name] = {"kernel_q": q, "scale_q": s}
        tree["params"]["lang_encoder"][f"layers_{i}"] = {
            "attn": attn, "norm_1": {"scale": np.ones(D, np.float32)}}
    # a layer without an out_proj is left alone
    q, s = _quant_cols(rng, (D, 3 * D))
    tree["params"]["lang_encoder"]["layers_2"] = {
        "attn": {"Wqkv": {"kernel_q": q, "scale_q": s}}}
    flat = traverse_util.flatten_dict(tree, sep="/")
    ref = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jquant.add_fused_wqo(tree), sep="/").items()}
    out = tquant.add_fused_wqo(flat)
    assert set(out) == set(ref) and len(out) == len(flat) + 4
    for k in ref:
        assert out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape
        assert out[k].tobytes() == ref[k].tobytes(), k
    wqo = out["params/lang_encoder/layers_1/attn/wqo_q"]
    assert wqo.shape == (D, 4 * D) and wqo.dtype == np.int8
    # tensors in, tensors out, the same bytes
    tout = tquant.add_fused_wqo({k: torch.from_numpy(v)
                                 for k, v in flat.items()})
    for k in ref:
        assert tout[k].numpy().tobytes() == ref[k].tobytes()


@pytest.mark.parametrize("bad", ["pos", "tensor pos", "pos shape",
                                 "pos dtype", "wqo", "bias", "cache",
                                 "dtype"])
def test_megakernel_refuses_bad_inputs(bad):
    a = _setup(8, 5, False)
    t = lambda k: torch.from_numpy(a[k])
    x, kc, vc, bias, wqo = t("x"), t("kc"), t("vc"), t("bias"), t("wqo")
    pos, err = 5, ValueError
    if bad == "pos":
        pos = L
    elif bad == "tensor pos":
        pos = torch.tensor(L)
    elif bad == "pos shape":
        pos = torch.tensor([5])
    elif bad == "pos dtype":
        pos = torch.tensor(5.0)
    elif bad == "wqo":
        wqo = wqo[:, :3 * D]
    elif bad == "bias":
        bias = bias[:, :L - 1]
    elif bad == "cache":
        vc = vc[:, :, :L - 1]
    else:
        wqo, err = wqo.float(), TypeError
    with pytest.raises(err):
        tmk.decode_attn_megakernel(x, kc, vc, pos, bias, t("ln1"), wqo,
                                   t("sqo"))
