"""Plain reference attention (counterpart of `otter_tpu/ops/attention_ref.py`).

f32 logits, additive bias, boolean masks filled with a large negative,
f32 softmax: the math of the reference's
`scaled_multihead_dot_product_attention` (`mpt/attention.py:22-84`).
"""

from __future__ import annotations

from typing import Optional

import torch

from otter_tpu_torch.ops.masks import DEFAULT_MASK_VALUE, causal_mask


def mha_reference(
    q: torch.Tensor,                      # [B, H, S_q, D]
    k: torch.Tensor,                      # [B, H_kv, S_k, D]
    v: torch.Tensor,                      # [B, H_kv, S_k, D]
    bias: Optional[torch.Tensor] = None,  # broadcastable to [B, H, S_q, S_k]
    mask: Optional[torch.Tensor] = None,  # bool, True = attend
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> torch.Tensor:
    h, d = q.shape[1], q.shape[3]
    h_kv, s_q, s_k = k.shape[1], q.shape[2], k.shape[2]
    if h_kv != h:
        k = k.repeat_interleave(h // h_kv, dim=1)
        v = v.repeat_interleave(h // h_kv, dim=1)
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = logits.masked_fill(~mask, mask_value)
    if causal:
        cm = causal_mask(s_q, s_k, device=q.device)[None, None]
        logits = logits.masked_fill(~cm, mask_value)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)
