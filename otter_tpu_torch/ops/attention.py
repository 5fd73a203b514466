"""Attention dispatcher (counterpart of `otter_tpu/ops/attention.py`).

The models call this one entry point. `impl="kernel"` takes the flash
kernel (`ops/flash_attention.py`), `impl="ref"` the plain reference
(`ops/attention_ref.py`). The default is the kernel for CUDA tensors and
the reference elsewhere, as the JAX package takes Pallas on a TPU and the
reference elsewhere. Sub-tile shapes (q <= 8 and kv <= 256: decode-time
cross-attention) go to the reference even on CUDA: a launch costs more
than the math there. The ring (sequence-parallel) path is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from otter_tpu_torch.ops import attention_ref
from otter_tpu_torch.ops import flash_attention as fa
from otter_tpu_torch.ops.masks import DEFAULT_MASK_VALUE


def multi_head_attention(
    q: torch.Tensor,                         # [B, H, S_q, D]
    k: torch.Tensor,                         # [B, H_kv, S_k, D]
    v: torch.Tensor,                         # [B, H_kv, S_k, D]
    *,
    bias: Optional[torch.Tensor] = None,     # [B|1, H|1, S_q|1, S_k]
    q_ids: Optional[torch.Tensor] = None,    # int32 [B, S_q]
    kv_ids: Optional[torch.Tensor] = None,   # int32 [B, S_k]
    ids_mode: str = "eq",
    causal: bool = False,
    sm_scale: Optional[float] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    impl = impl or ("kernel" if q.is_cuda else "ref")
    h, h_kv = q.shape[1], k.shape[1]
    if h_kv != h:
        k = k.repeat_interleave(h // h_kv, dim=1)
        v = v.repeat_interleave(h // h_kv, dim=1)
    if impl == "kernel" and q.shape[2] <= 8 and k.shape[2] <= 256:
        impl = "ref"
    if impl == "kernel":
        return fa.flash_attention(
            q, k, v, bias, q_ids, kv_ids, causal=causal, sm_scale=sm_scale,
            ids_mode=ids_mode)
    if impl == "ref":
        mask = None
        if q_ids is not None:
            qi = q_ids[:, None, :, None].int()
            ki = kv_ids[:, None, None, :].int()
            mask = (qi == ki) if ids_mode == "eq" else (qi >= ki)
        return attention_ref.mha_reference(
            q, k, v, bias=bias, mask=mask, causal=causal, sm_scale=sm_scale,
            mask_value=DEFAULT_MASK_VALUE)
    raise ValueError(f"unknown attention impl {impl!r}")
