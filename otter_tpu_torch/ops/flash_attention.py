"""Flash attention, forward and backward (counterpart of
`otter_tpu/ops/flash_attention.py`).

`flash_attention` is differentiable: under autograd it runs through
`_FlashAttention`, a `torch.autograd.Function` whose forward saves
(q, k, v, bias, ids, out, lse [B, H, S_q] f32) as `fa_fwd` does and whose
backward computes di = rowsum(out * dout) in f32 and launches the dK/dV
and dQ kernels (`csrc/flash_bwd.cu`), as `fa_bwd` / `_bwd` do. Bias and
ids get no gradient (`None`), as the JAX VJP returns zeros for them. CPU
tensors go through the same Function with the plain forward and the plain
backward; CUDA tensors launch the hand-written kernels
(`csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`) or raise. `return_lse=True` is
not differentiable, as in the JAX package.

It covers what the TPU kernels cover: causal masking, an additive f32 bias
[B|1, H|1, S_q|1, S_k] (ALiBi), and int32 id masks compared per (q, kv)
pair ("eq": padding and only-immediate media; "ge": attend-previous media).

Forward numerics follow `_fwd` / `_fwd_kernel`: q is pre-scaled by
sm_scale*log2(e) in q's dtype, the bias by log2(e), the biased logit held
at or above `mask_value` (a bias that masks, -0.7 f32-max, is -inf once
scaled, and a key tile masked whole must leave the online softmax's
running max finite); the softmax is base 2
with f32 statistics; the mask replaces the biased logit with `mask_value`;
p is cast to v's dtype before p.v; rows with l == 0 divide by 1; the
returned LSE is in natural-log units. The TPU's 128-row and 128-lane
padding is not carried over: keys past S_k are never attended, as the
padded keys' PAD_ID made sure there.

Backward numerics follow `_bwd_dkv_kernel` / `_bwd_dq_kernel`: s = q.k in
f32 (q unscaled), times sm_scale, plus the bias, masked to `mask_value`;
p = exp(s - lse) stays f32; dp = do.v^T in f32; ds = p * (dp - di) *
sm_scale; f32 accumulators cast to the input dtype at the store. Two
choices where the JAX kernels' answer is not the function's derivative:

  - A row that may attend no key (its LSE is ~0.69 * mask_value: the
    forward's log2(l) is lost next to it in f32, so exp(s - lse) cannot
    give its p back) had p = 1/S_k in the forward, which averaged v over
    the real keys. The backward gives it that p again, as the JAX
    reference path's autograd does; the Pallas kernels give it p = 0
    there (ROADMAP Queue 3).
  - ds is 0 wherever the mask holds: a masked logit is the constant
    `mask_value`, so it has no gradient. On rows that attend some key
    p is already 0 there; on rows that attend none this keeps dq and dk
    at 0, as the reference's where() does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from otter_tpu_torch import _build
from otter_tpu_torch.ops.masks import DEFAULT_MASK_VALUE

LOG2E = 1.4426950408889634
# head dims the kernels take: every multiple of the tensor cores' k16 step
KERNEL_HEAD_DIMS = tuple(range(16, 129, 16))
_IDS_MODES = {"eq": 1, "ge": 2}
_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
_SIGNATURES = {"flash_fwd_bf16": (
    [_P, _P, _P, _P, _LL, _LL, _LL, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
     _I, _F, _F, _P], _I)}
# q, k, v, bias, 3 bias strides, q_ids, kv_ids, ids_mode, lse, di, do,
# out(s), B, H, S_q, S_k, D, causal, sm_scale, mask_value, stream
_BWD_ARGS = [_P, _P, _P, _P, _LL, _LL, _LL, _P, _P, _I, _P, _P, _P]
_BWD_TAIL = [_I, _I, _I, _I, _I, _I, _F, _F, _P]
_BWD_SIGNATURES = {
    "flash_bwd_dkv_bf16": (_BWD_ARGS + [_P, _P] + _BWD_TAIL, _I),
    "flash_bwd_dq_bf16": (_BWD_ARGS + [_P] + _BWD_TAIL, _I),
}


def _check_args(q, k, v, bias, q_ids, kv_ids, causal, ids_mode):
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must be "
                         "[B, H, S, D] with matching B, H, D")
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError("causal flash attention requires s_q == s_k "
                         "(use the decode kernel for cached decoding)")
    if (q_ids is None) != (kv_ids is None):
        raise ValueError("q_ids and kv_ids go together")
    if q_ids is not None and ids_mode not in _IDS_MODES:
        raise ValueError(f"ids_mode={ids_mode!r}")
    if bias is not None and bias.dim() != 4:
        raise ValueError("bias must be [B|1, H|1, S_q|1, S_k]")


def _wide(x):
    """x in at least f32 (f64 stays f64, for gradcheck)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _attend_mask(q, k, q_ids, kv_ids, causal, ids_mode):
    """Bool [B|1, 1, S_q, S_k], True where a query may attend a key, or
    None when every pair may."""
    s_q, s_k = q.shape[2], k.shape[2]
    mask = None
    if q_ids is not None:
        qi = q_ids.int()[:, None, :, None]
        ki = kv_ids.int()[:, None, None, :]
        mask = (qi == ki) if ids_mode == "eq" else (qi >= ki)
    if causal:
        rows = torch.arange(s_q, device=q.device)[:, None]
        cols = torch.arange(s_k, device=q.device)[None, :]
        cm = (cols <= rows)[None, None]
        mask = cm if mask is None else mask & cm
    return mask


def flash_attention_plain(q, k, v, bias=None, q_ids=None, kv_ids=None, *,
                          causal=False, sm_scale=None, ids_mode="eq",
                          mask_value=DEFAULT_MASK_VALUE, return_lse=False):
    """The forward kernel's function in plain PyTorch, one tile covering
    all keys."""
    _check_args(q, k, v, bias, q_ids, kv_ids, causal, ids_mode)
    d = q.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    qs = q * torch.tensor(sm_scale * LOG2E, dtype=q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", _wide(qs), _wide(k))
    if bias is not None:
        # a masking bias (-0.7 f32-max) is -inf once scaled: held at
        # mask_value, as the kernel holds it
        s = torch.clamp_min(s + _wide(bias) * LOG2E, mask_value)
    mask = _attend_mask(q, k, q_ids, kv_ids, causal, ids_mode)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, mask_value))
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", _wide(p.to(v.dtype)), _wide(v))
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / l).to(q.dtype)
    if return_lse:
        lse = 0.6931471805599453 * (m + torch.log2(l))
        return out, lse[..., 0]
    return out


def _bwd_plain(q, k, v, bias, q_ids, kv_ids, lse, di, do, *, causal,
               sm_scale, ids_mode, mask_value):
    """(dq, dk, dv) from the saved LSE and di, in plain PyTorch."""
    s_k = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", _wide(q), _wide(k)) * sm_scale
    if bias is not None:
        s = s + _wide(bias)
    lse = _wide(lse)[..., None]
    p = torch.exp(s - lse)
    mask = _attend_mask(q, k, q_ids, kv_ids, causal, ids_mode)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
        # rows that attend no key: the forward's p was 1/S_k on every key
        p = torch.where(lse < 0.5 * mask_value, torch.full_like(p, 1 / s_k),
                        p)
    dof = _wide(do)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, _wide(v))
    ds = p * (dp - _wide(di)[..., None]) * sm_scale
    if mask is not None:
        ds = torch.where(mask, ds, torch.zeros_like(ds))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _wide(q))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _wide(k))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, bias, q_ids, kv_ids, o, lse, do, *,
                              causal=False, sm_scale=None, ids_mode="eq",
                              mask_value=DEFAULT_MASK_VALUE):
    """`_bwd`'s arithmetic in plain PyTorch: (dq, dk, dv) of the attention
    whose forward returned `o` and `lse`, for the upstream gradient `do`."""
    _check_args(q, k, v, bias, q_ids, kv_ids, causal, ids_mode)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[3] ** 0.5)
    di = (_wide(o) * _wide(do)).sum(-1)
    return _bwd_plain(q, k, v, bias, q_ids, kv_ids, lse, di, do,
                      causal=causal, sm_scale=sm_scale, ids_mode=ids_mode,
                      mask_value=mask_value)


def check_kernel_inputs(head_dim: int, *dtypes: torch.dtype) -> None:
    """Raise unless the flash kernels (forward, dK/dV and dQ alike) take
    q/k/v of this head dim and these dtypes: bf16 only (TypeError), D a
    multiple of 16 from 16 to 128 (ValueError)."""
    if any(dt != torch.bfloat16 for dt in dtypes):
        raise TypeError(f"flash_attention kernels take bf16 q/k/v, not "
                        f"{dtypes}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernels: head dim {head_dim} "
                         f"(a multiple of 16 up to 128)")


def _aligned(x):
    """x contiguous, on a 16-byte boundary (the kernels' vector loads).
    Each torch call here costs the small shapes' time on the host, so a
    tensor that already is so is returned without one."""
    if not x.is_contiguous():
        x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _f32(x):
    """x as a contiguous f32 tensor (no torch call when it is one)."""
    if x.dtype != torch.float32:
        x = x.float()
    return x if x.is_contiguous() else x.contiguous()


def _ids(ids, b, s):
    """int32 ids as a contiguous [b, s] tensor."""
    if ids.dtype != torch.int32:
        ids = ids.int()
    if ids.shape != (b, s):
        ids = ids.expand(b, s)
    return ids if ids.is_contiguous() else ids.contiguous()


def _kernel_args(q, k, v, bias, q_ids, kv_ids, ids_mode):
    """Checks a CUDA call and lays out its operands as the kernels take
    them: contiguous, 16-byte aligned bf16 q/k/v, f32 bias read through
    broadcast strides, contiguous int32 ids [B, S]."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    check_kernel_inputs(d, q.dtype, k.dtype, v.dtype)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    bias_ptr, bstrides = None, (0, 0, 0)
    if bias is not None:
        if bias.dtype != torch.float32:
            bias = bias.float()
        bb, bh, bq, bk = bias.shape
        if bb not in (1, b) or bh not in (1, h) or bq not in (1, s_q) \
                or bk != s_k:
            raise ValueError(f"bias {tuple(bias.shape)} does not broadcast "
                             f"to [{b}, {h}, {s_q}, {s_k}]")
        if bias.stride(3) != 1:
            bias = bias.contiguous()
        # broadcast dims read with stride 0
        bstrides = tuple(0 if n == 1 else st for n, st in
                         zip(bias.shape[:3], bias.stride()[:3]))
        bias_ptr = bias.data_ptr()
    mode = 0
    qid_ptr = kid_ptr = None
    if q_ids is not None:
        q_ids, kv_ids = _ids(q_ids, b, s_q), _ids(kv_ids, b, s_k)
        qid_ptr, kid_ptr = q_ids.data_ptr(), kv_ids.data_ptr()
        mode = _IDS_MODES[ids_mode]
    # the tensors are returned so the caller holds them over the launch
    alive = (q, k, v, bias, q_ids, kv_ids)
    return alive, (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
                  *bstrides, qid_ptr, kid_ptr, mode)


@functools.lru_cache(maxsize=64)
def _bf16_q_scale(sm_scale: float) -> float:
    """sm_scale * log2(e) rounded to bf16: q is pre-scaled in its own dtype,
    so the constant is rounded to bf16 too."""
    return float(torch.tensor(sm_scale * LOG2E, dtype=torch.bfloat16))


def flash_attention_fwd(q, k, v, bias=None, q_ids=None, kv_ids=None, *,
                        causal=False, sm_scale=None, ids_mode="eq",
                        mask_value=DEFAULT_MASK_VALUE, return_lse=False):
    """The forward: the kernel for CUDA tensors (counted in
    `flash_attention.launches`), the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, bias, q_ids, kv_ids, causal=causal, sm_scale=sm_scale,
            ids_mode=ids_mode, mask_value=mask_value, return_lse=return_lse)
    _check_args(q, k, v, bias, q_ids, kv_ids, causal, ids_mode)
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    alive, args = _kernel_args(q, k, v, bias, q_ids, kv_ids, ids_mode)
    out = torch.empty_like(alive[0])
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_fwd", _SIGNATURES)
    err = lib.flash_fwd_bf16(
        *args, out.data_ptr(), lse.data_ptr(), b, h, s_q, s_k, d,
        int(causal), _bf16_q_scale(float(sm_scale)), float(mask_value),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_fwd")
    _build.count_launch(flash_attention)
    return (out, lse) if return_lse else out


def _bwd_launch(fn_name, outs, q, k, v, bias, q_ids, kv_ids, lse, di, do,
                causal, sm_scale, mask_value, ids_mode):
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    _alive, args = _kernel_args(q, k, v, bias, q_ids, kv_ids, ids_mode)
    lse, di = _f32(lse), _f32(di)
    do = _aligned(do if do.dtype == torch.bfloat16 else do.bfloat16())
    if lse.shape != (b, h, s_q) or di.shape != (b, h, s_q) \
            or do.shape != q.shape:
        raise ValueError("flash backward: lse/di must be [B, H, S_q] and do "
                         "shaped like q")
    lib = _build.library("flash_bwd", _BWD_SIGNATURES)
    err = getattr(lib, fn_name)(
        *args, lse.data_ptr(), di.data_ptr(), do.data_ptr(),
        *(o.data_ptr() for o in outs), b, h, s_q, s_k, d, int(causal),
        float(sm_scale), float(mask_value),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, fn_name)


def flash_bwd_dkv(q, k, v, bias, q_ids, kv_ids, lse, di, do, *,
                  causal=False, sm_scale=None, ids_mode="eq",
                  mask_value=DEFAULT_MASK_VALUE):
    """(dk, dv) from the saved LSE and di = rowsum(o * do): the dK/dV
    kernel for CUDA tensors, the plain version for CPU tensors."""
    _check_args(q, k, v, bias, q_ids, kv_ids, causal, ids_mode)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[3] ** 0.5)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, bias, q_ids, kv_ids, lse, di, do,
                          causal=causal, sm_scale=sm_scale,
                          ids_mode=ids_mode, mask_value=mask_value)[1:]
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch("flash_bwd_dkv_bf16", (dk, dv), q, k, v, bias, q_ids,
                kv_ids, lse, di, do, causal, sm_scale, mask_value, ids_mode)
    _build.count_launch(flash_bwd_dkv)
    return dk, dv


def flash_bwd_dq(q, k, v, bias, q_ids, kv_ids, lse, di, do, *,
                 causal=False, sm_scale=None, ids_mode="eq",
                 mask_value=DEFAULT_MASK_VALUE):
    """dq from the saved LSE and di: the dQ kernel for CUDA tensors, the
    plain version for CPU tensors."""
    _check_args(q, k, v, bias, q_ids, kv_ids, causal, ids_mode)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[3] ** 0.5)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, bias, q_ids, kv_ids, lse, di, do,
                          causal=causal, sm_scale=sm_scale,
                          ids_mode=ids_mode, mask_value=mask_value)[0]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("flash_bwd_dq_bf16", (dq,), q, k, v, bias, q_ids, kv_ids,
                lse, di, do, causal, sm_scale, mask_value, ids_mode)
    _build.count_launch(flash_bwd_dq)
    return dq


def flash_attention_bwd(q, k, v, bias, q_ids, kv_ids, o, lse, do, *,
                        causal=False, sm_scale=None, ids_mode="eq",
                        mask_value=DEFAULT_MASK_VALUE):
    """(dq, dk, dv): the two backward kernels for CUDA tensors, the plain
    backward for CPU tensors. di = rowsum(o * do) is taken in f32 outside
    the kernels, as `_bwd` does."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, bias, q_ids, kv_ids, o, lse, do, causal=causal,
            sm_scale=sm_scale, ids_mode=ids_mode, mask_value=mask_value)
    di = (o.float() * do.float()).sum(-1)
    kw = dict(causal=causal, sm_scale=sm_scale, ids_mode=ids_mode,
              mask_value=mask_value)
    dk, dv = flash_bwd_dkv(q, k, v, bias, q_ids, kv_ids, lse, di, do, **kw)
    dq = flash_bwd_dq(q, k, v, bias, q_ids, kv_ids, lse, di, do, **kw)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """`fa` with `fa_fwd` / `fa_bwd` (`flash_attention.py:737-765`). The
    forward and backward are looked up at call time, so swapping
    `flash_attention_fwd` / `flash_attention_bwd` on this module swaps
    what runs."""

    @staticmethod
    def forward(ctx, q, k, v, bias, q_ids, kv_ids, opts):
        out, lse = flash_attention_fwd(q, k, v, bias, q_ids, kv_ids,
                                       return_lse=True, **opts)
        ctx.save_for_backward(q, k, v, bias, q_ids, kv_ids, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, q_ids, kv_ids, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, q_ids, kv_ids, o, lse,
                                         do, **ctx.opts)
        # biases and ids are not trained: no gradient, as the JAX VJP's zeros
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    q_ids: Optional[torch.Tensor] = None,
                    kv_ids: Optional[torch.Tensor] = None, *,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    ids_mode: str = "eq",
                    mask_value: float = DEFAULT_MASK_VALUE,
                    return_lse: bool = False):
    """q [B, H, S_q, D], k/v [B, H, S_k, D] -> out [B, H, S_q, D]
    (and lse [B, H, S_q] f32 with return_lse, not differentiable). CUDA
    tensors must be bf16 with D a multiple of 16 up to 128. Differentiable in
    q, k and v. The arguments are checked where the forward runs
    (`flash_attention_fwd`), once a call."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    opts = dict(causal=causal, sm_scale=float(sm_scale), ids_mode=ids_mode,
                mask_value=float(mask_value))
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if return_lse or not needs_grad:
        # no graph: nothing is saved (the frozen CLIP tower, inference)
        return flash_attention_fwd(q, k, v, bias, q_ids, kv_ids,
                                   return_lse=return_lse, **opts)
    return _FlashAttention.apply(q, k, v, bias, q_ids, kv_ids, opts)


flash_attention.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0
