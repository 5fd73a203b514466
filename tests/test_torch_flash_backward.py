"""Port parity: the flash-attention backward (the port's autograd.Function
with its plain forward and plain backward, as CPU tensors take them)
against `jax.vjp` of the JAX package's flash attention (Pallas in
interpret mode), in f32 on the CPU, plus gradcheck of the plain pair in
f64.

Rows that may attend no key: the JAX Pallas kernels give them p = 0 in
the backward (and average v over their 128-padded key axis in the
forward), the port gives them the derivative of its forward (p = 1/S_k,
no gradient into q or k), as `jax.vjp` of the JAX reference path
(`attention_ref.mha_reference`) does. So the upstream gradient is zeroed
on those rows for the comparison with the kernels, and the full gradient
is compared with the reference path (ROADMAP Queue 3).
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.ops import attention as jattn
from otter_tpu.ops import masks as jmasks
from otter_tpu.ops.flash_attention import flash_attention as jflash
from otter_tpu_torch.ops import flash_attention as fa

TOL = 2e-4   # f32 on both sides; summation order and exp differ


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _case(name):
    """(q, k, v, bias, q_ids, kv_ids), kwargs."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name in ("causal_alibi_pad_d64", "causal_alibi_pad_d16"):
        # decoder self-attention: causal + ALiBi column bias + padding ids
        d = 64 if name.endswith("d64") else 16
        b, h, s = 2, 4, 40
        slopes = np.asarray(jmasks.alibi_slopes(h))
        bias = (np.arange(1 - s, 1)[None, None, None, :]
                * slopes[None, :, None, None]).astype(np.float32)
        ids = np.ones((b, s), np.int32)
        ids[1, 27:] = 0   # right padding, as training batches are padded
        return ((_rand(rng, b, h, s, d), _rand(rng, b, h, s, d),
                 _rand(rng, b, h, s, d), bias, ids, ids), dict(causal=True))
    if name in ("ragged_d16", "ragged_d64"):
        # perceiver / CLIP: not causal, S_q != S_k, neither a multiple of 128
        d = 16 if name.endswith("d16") else 64
        b, h = 2, 3
        return ((_rand(rng, b, h, 9, d), _rand(rng, b, h, 137, d),
                 _rand(rng, b, h, 137, d), None, None, None),
                dict(causal=False))
    if name in ("media_eq", "media_ge"):
        # gated cross-attention: text_time against two media of 8 latents;
        # text before the first media attends no key
        b, h, s, d = 2, 2, 12, 16
        loc = np.zeros((b, s), bool)
        loc[0, [0, 6]] = True
        loc[1, [3, 4]] = True
        q_ids, kv_ids, _ = jmasks.media_attention_ids(
            jnp.asarray(loc), 2, 8,
            only_attend_immediate_media=name == "media_eq")
        return ((_rand(rng, b, h, s, d), _rand(rng, b, h, 16, d),
                 _rand(rng, b, h, 16, d), None, np.asarray(q_ids),
                 np.asarray(kv_ids)),
                dict(causal=False, ids_mode=name[-2:]))
    raise KeyError(name)


def _dead_rows(arrays, kw):
    """[B, S_q] bool: the query rows that may attend no key."""
    q, q_ids, kv_ids = arrays[0], arrays[4], arrays[5]
    if q_ids is None:
        return np.zeros((q.shape[0], q.shape[2]), bool)
    if kw.get("ids_mode", "eq") == "eq":
        ok = q_ids[:, :, None] == kv_ids[:, None, :]
    else:
        ok = q_ids[:, :, None] >= kv_ids[:, None, :]
    return ~ok.any(-1)


def _port_grads(arrays, do, kw):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    rest = [None if a is None else torch.from_numpy(np.array(a))
            for a in arrays[3:]]
    out = fa.flash_attention(q, k, v, *rest, **kw)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]


def _jax_grads(fn, arrays, do):
    rest = [None if a is None else jnp.asarray(a) for a in arrays[3:]]
    out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, *rest),
                       *(jnp.asarray(a) for a in arrays[:3]))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _jax_kernel(kw):
    return lambda q, k, v, bias, qi, ki: jflash(
        q, k, v, bias, qi, ki, interpret=True, **kw)


def _close(a, b):
    np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


NAMED_CASES = ["causal_alibi_pad_d64", "causal_alibi_pad_d16", "ragged_d16",
               "ragged_d64", "media_eq", "media_ge"]


@functools.lru_cache(maxsize=None)
def _kernel_case(name):
    """(arrays, kw, do, live, JAX kernels' out, JAX kernels' grads) of a
    named case, once a process: the upstream gradient is zeroed on rows
    that attend nothing, which the JAX kernels give no gradient (p = 0)."""
    arrays, kw = _case(name)
    do = _rand(np.random.default_rng(7), *arrays[0].shape)
    live = ~_dead_rows(arrays, kw)[:, None, :, None]
    do = do * live
    ref_out, ref_grads = _jax_grads(_jax_kernel(kw), arrays, do)
    return arrays, kw, do, live, ref_out, ref_grads


@pytest.mark.parametrize("name", NAMED_CASES)
def test_backward_matches_jax_kernels(name):
    arrays, kw, do, live, ref_out, ref_grads = _kernel_case(name)
    out, grads = _port_grads(arrays, do, kw)
    _close(np.where(live, out, 0), np.where(live, ref_out, 0))
    for g, r in zip(grads, ref_grads):
        _close(g, r)


def _dq_bf16_ds(arrays, do, kw):
    """dq as the dQ kernel computes it, in plain f32 on the CPU: dS /
    sm_scale = p (dp - di), 0 wherever the mask holds, rounded to bf16 for
    dq += dS k, and sm_scale applied to the f32 sum."""
    q, k, v, bias, q_ids, kv_ids = (
        None if a is None else torch.from_numpy(np.array(a)) for a in arrays)
    do = torch.from_numpy(do)
    causal, mode = kw["causal"], kw.get("ids_mode", "eq")
    out, lse = fa.flash_attention(q, k, v, bias, q_ids, kv_ids,
                                  return_lse=True, causal=causal,
                                  ids_mode=mode)
    di = (out * do).sum(-1)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, v) - di[..., None])
    mask = fa._attend_mask(q, k, q_ids, kv_ids, causal, mode)
    if mask is not None:
        ds = torch.where(mask, ds, torch.zeros_like(ds))
    ds = ds.to(torch.bfloat16).float()
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale).numpy()


@pytest.mark.parametrize("name", NAMED_CASES)
def test_dq_with_bf16_ds_matches_jax_kernel(name):
    """The dQ kernel's numerics (dS rounded to bf16 for the product, the
    sum in f32) against the JAX `_bwd_dq_kernel`'s dq (f32 ds), within the
    backward limit 2e-2 max|plain| + 2e-2 |plain|."""
    arrays, kw, do, _, _, ref_grads = _kernel_case(name)
    dq = _dq_bf16_ds(arrays, do, kw)
    ref = ref_grads[0]
    bound = 2e-2 * np.abs(dq).max() + 2e-2 * np.abs(dq)
    assert (np.abs(dq - ref) <= bound).all(), np.abs(dq - ref).max()
    # the rounding moves dq: the f32 plain and the JAX kernel agree to TOL
    assert np.abs(dq - ref).max() > TOL or not dq.any()


@pytest.mark.parametrize("name", ["media_eq", "media_ge",
                                  "causal_alibi_pad_d16"])
def test_backward_matches_jax_reference_path(name):
    """Every row, rows that attend nothing included, against jax.vjp of the
    JAX reference path (f32 logits, masked with where(), softmax)."""
    arrays, kw = _case(name)
    assert name.startswith("causal") or _dead_rows(arrays, kw).any()
    do = _rand(np.random.default_rng(8), *arrays[0].shape)

    def ref(q, k, v, bias, qi, ki):
        return jattn.multi_head_attention(
            q, k, v, bias=bias, q_ids=qi, kv_ids=ki,
            ids_mode=kw.get("ids_mode", "eq"), causal=kw["causal"],
            impl="ref")

    out, grads = _port_grads(arrays, do, kw)
    ref_out, ref_grads = _jax_grads(ref, arrays, do)
    _close(out, ref_out)
    for g, r in zip(grads, ref_grads):
        _close(g, r)


def test_kernel_wrappers_take_the_plain_backward_on_cpu():
    """flash_bwd_dkv / flash_bwd_dq on CPU tensors return the plain
    backward's pieces and count no launch."""
    arrays, kw = _case("causal_alibi_pad_d16")
    q, k, v, bias, qi, ki = (None if a is None else torch.from_numpy(a)
                             for a in arrays)
    out, lse = fa.flash_attention(q, k, v, bias, qi, ki, return_lse=True,
                                  **kw)
    do = torch.from_numpy(_rand(np.random.default_rng(9), *q.shape))
    di = (out * do).sum(-1)
    before = (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    dk, dv = fa.flash_bwd_dkv(q, k, v, bias, qi, ki, lse, di, do, **kw)
    dq = fa.flash_bwd_dq(q, k, v, bias, qi, ki, lse, di, do, **kw)
    ref = fa.flash_attention_bwd_plain(q, k, v, bias, qi, ki, out, lse, do,
                                       **kw)
    for a, r in zip((dq, dk, dv), ref):
        torch.testing.assert_close(a, r, atol=0, rtol=0)
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == before


def test_no_graph_without_grad():
    """Inputs that need no gradient (the frozen CLIP tower) save nothing."""
    q, k, v = (torch.randn(1, 2, 9, 16) for _ in range(3))
    assert fa.flash_attention(q, k, v).grad_fn is None
    q.requires_grad_()
    assert fa.flash_attention(q, k, v).grad_fn is not None
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None


@pytest.mark.parametrize("mode", ["causal_bias_ids", "ge_dead_rows"])
def test_gradcheck_plain_pair(mode):
    """The plain backward is the derivative of the plain forward (f64),
    rows that attend nothing included."""
    g = torch.Generator().manual_seed(3)
    b, h, d = 1, 2, 4
    if mode == "causal_bias_ids":
        s_q = s_k = 6
        bias = torch.randn(1, h, 1, s_k, generator=g, dtype=torch.float64)
        q_ids = kv_ids = torch.tensor([[1, 1, 1, 1, 0, 0]], dtype=torch.int32)
        kw = dict(causal=True)
    else:
        s_q, s_k = 5, 4
        bias = None
        q_ids = torch.tensor([[0, 1, 1, 2, 0]], dtype=torch.int32)
        kv_ids = torch.tensor([[1, 1, 2, 2]], dtype=torch.int32)
        kw = dict(ids_mode="ge")
    q = torch.randn(b, h, s_q, d, generator=g, dtype=torch.float64,
                    requires_grad=True)
    k, v = (torch.randn(b, h, s_k, d, generator=g, dtype=torch.float64,
                        requires_grad=True) for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.flash_attention(q, k, v, bias, q_ids, kv_ids,
                                           **kw), (q, k, v))
