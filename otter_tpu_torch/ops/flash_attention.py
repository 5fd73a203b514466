"""Flash-attention forward (counterpart of `otter_tpu/ops/flash_attention.py`).

`flash_attention` launches the hand-written CUDA kernel `csrc/flash_fwd.cu`
for CUDA tensors and runs `flash_attention_plain`, the same function in
plain PyTorch, for CPU tensors. It covers what the TPU kernel covers on the
forward path: causal masking, an additive f32 bias [B|1, H|1, S_q|1, S_k]
(ALiBi), and int32 id masks compared per (q, kv) pair ("eq": padding and
only-immediate media; "ge": attend-previous media).

Numerics follow `_fwd` / `_fwd_kernel`: q is pre-scaled by sm_scale*log2(e)
in q's dtype, the bias by log2(e); the softmax is base 2 with f32
statistics; the mask replaces the biased logit with `mask_value`; p is
cast to v's dtype before p.v; rows with l == 0 divide by 1; the returned
LSE is in natural-log units. The TPU's 128-row and 128-lane padding is
not carried over: keys past S_k are never attended, as the padded keys'
PAD_ID made sure there.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from otter_tpu_torch import _build
from otter_tpu_torch.ops.masks import DEFAULT_MASK_VALUE

LOG2E = 1.4426950408889634
_IDS_MODES = {"eq": 1, "ge": 2}
_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
_SIGNATURES = {"flash_fwd_bf16": (
    [_P, _P, _P, _P, _LL, _LL, _LL, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
     _I, _F, _F, _P], _I)}


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


def flash_attention_plain(q, k, v, bias=None, q_ids=None, kv_ids=None, *,
                          causal=False, sm_scale=None, ids_mode="eq",
                          mask_value=DEFAULT_MASK_VALUE, return_lse=False):
    """The kernel's function in plain PyTorch, one tile covering all keys."""
    _check_args(q, k, v, bias, q_ids, kv_ids, causal, ids_mode)
    s_q, s_k, d = q.shape[2], k.shape[2], q.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    qs = q * torch.tensor(sm_scale * LOG2E, dtype=q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    if bias is not None:
        s = s + bias.float() * LOG2E
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
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, mask_value))
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / l).to(q.dtype)
    if return_lse:
        lse = 0.6931471805599453 * (m + torch.log2(l))
        return out, lse[..., 0]
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    q_ids: Optional[torch.Tensor] = None,
                    kv_ids: Optional[torch.Tensor] = None, *,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    ids_mode: str = "eq",
                    mask_value: float = DEFAULT_MASK_VALUE,
                    return_lse: bool = False):
    """q [B, H, S_q, D], k/v [B, H, S_k, D] -> out [B, H, S_q, D]
    (and lse [B, H, S_q] f32 with return_lse). CUDA tensors must be bf16
    with D in {16, 32, 64, 128}."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, bias, q_ids, kv_ids, causal=causal, sm_scale=sm_scale,
            ids_mode=ids_mode, mask_value=mask_value, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_args(q, k, v, bias, q_ids, kv_ids, causal, ids_mode)
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes bf16 q/k/v")
    if d not in (16, 32, 64, 128):
        raise ValueError(f"flash_attention kernel: head dim {d} unsupported")
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bias_ptr, bstrides = None, (0, 0, 0)
    if bias is not None:
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
        q_ids = q_ids.to(torch.int32).expand(b, s_q).contiguous()
        kv_ids = kv_ids.to(torch.int32).expand(b, s_k).contiguous()
        qid_ptr, kid_ptr = q_ids.data_ptr(), kv_ids.data_ptr()
        mode = _IDS_MODES[ids_mode]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    # q is pre-scaled in its own dtype: the constant is rounded to bf16 too
    q_scale = float(torch.tensor(sm_scale * LOG2E, dtype=q.dtype))
    lib = _build.library("flash_fwd", _SIGNATURES)
    err = lib.flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, *bstrides,
        qid_ptr, kid_ptr, mode, out.data_ptr(), lse.data_ptr(), b, h, s_q,
        s_k, d, int(causal), q_scale, float(mask_value),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_fwd")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
