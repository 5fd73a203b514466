"""Mask and bias construction for the attention kernels
(counterpart of `otter_tpu/ops/masks.py`).

ALiBi slopes (reference `mpt/attention.py:449-456`), the causal mask, and
the Flamingo media-location mask as integer ids compared per (q, kv) pair
by the flash kernel (`modeling_otter.py:296-330`).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

# Large-but-finite negative for masked logits (-0.7 * f32 max): keeps the
# online softmax free of exp(-inf - -inf) NaNs.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def alibi_slopes(n_heads: int, alibi_bias_max: float = 8.0,
                 device=None) -> torch.Tensor:
    """Per-head ALiBi slopes [n_heads] f32. For non-power-of-two head
    counts the odd-indexed slopes come first, as the reference does."""
    ceil_pow2 = 2 ** math.ceil(math.log2(n_heads))
    m = torch.arange(1, ceil_pow2 + 1, dtype=torch.float32,
                     device=device) * (alibi_bias_max / ceil_pow2)
    slopes = 1.0 / torch.pow(2.0, m)
    if ceil_pow2 != n_heads:
        slopes = torch.cat([slopes[1::2], slopes[::2]])[:n_heads]
    return slopes


def causal_mask(s_q: int, s_k: int, device=None) -> torch.Tensor:
    """Bool [s_q, s_k], True where attention is allowed, aligned to the end
    of the key sequence."""
    q_pos = torch.arange(s_q, device=device)[:, None] + (s_k - s_q)
    k_pos = torch.arange(s_k, device=device)[None, :]
    return k_pos <= q_pos


def media_attention_ids(
    media_locations: torch.Tensor,   # [B, T_txt] bool
    num_media: int,
    num_latents: int,
    *,
    only_attend_immediate_media: bool = True,
    attend_previous: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Media mask as integer ids for the flash kernel's eq/ge comparison.

    Returns (q_ids [B, T_txt] int32, kv_ids [B, T_img*n] int32,
    out_keep [B, T_txt] bool): text_time is the running count of media
    tokens up to and including each position; latents of media t carry
    id t+1. "eq" attends only the immediately preceding media, "ge" all
    previous media; out_keep is False for text before the first media in
    only-immediate mode, whose attention output is zeroed.
    """
    media_locations = media_locations.bool()
    b = media_locations.shape[0]
    text_time = torch.cumsum(media_locations.int(), dim=-1).int()
    if not attend_previous:
        text_time = torch.where(media_locations, text_time, text_time + 1)
        n_media = media_locations.int().sum(-1, keepdim=True)
        text_time = torch.where(text_time > n_media,
                                torch.zeros_like(text_time), text_time)
    media_ids = torch.arange(1, num_media + 1, dtype=torch.int32,
                             device=media_locations.device
                             ).repeat_interleave(num_latents)
    kv_ids = media_ids[None].expand(b, num_media * num_latents)
    if only_attend_immediate_media:
        out_keep = text_time > 0
    else:
        out_keep = torch.ones_like(text_time, dtype=torch.bool)
    return text_time, kv_ids, out_keep
