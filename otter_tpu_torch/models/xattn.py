"""Tanh-gated masked cross-attention block (counterpart of
`otter_tpu/models/xattn.py`).

The media-location mask arrives as integer ids (text_time vs media_time)
compared inside the flash kernel ("eq" or "ge"); text with no preceding
media has its attention output zeroed by `out_keep`. With int8 (int4)
weights the feed-forward pair goes through the fused `int8_mlp`
(`int4_mlp`) kernel when the block sees at most 32 tokens (decode), else
through two `Int8Dense` (`Int4Dense`); the attention projections of an
int4 model are int8.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from otter_tpu_torch.ops import quant as quant_ops
from otter_tpu_torch.ops.attention import multi_head_attention
from otter_tpu_torch.ops.layers import LayerNorm, gelu


class MaskedCrossAttention(nn.Module):
    def __init__(self, dim: int, dim_visual: int, dim_head: int, heads: int,
                 only_attend_immediate_media: bool, quant: Optional[str],
                 dtype, device):
        super().__init__()
        self.dim_head, self.heads = dim_head, heads
        self.ids_mode = "eq" if only_attend_immediate_media else "ge"
        inner = dim_head * heads
        dense = lambda i, o: quant_ops.make_dense(
            quant, i, o, use_bias=False, dtype=dtype, device=device)
        self.norm = LayerNorm(dim, dtype=dtype, device=device)
        self.to_q = dense(dim, inner)
        self.to_kv = dense(dim_visual, 2 * inner)
        self.to_out = dense(inner, dim)

    def forward(self, x, media, q_ids=None, kv_ids=None, out_keep=None):
        """x [B, S, D]; media [B, T_img, n, D_vis]; q_ids [B, S];
        kv_ids [B, T_img*n]; out_keep [B, S] bool."""
        b, t_img, n, _ = media.shape
        q = self.to_q(self.norm(x))
        k, v = self.to_kv(media.reshape(b, t_img * n, -1)).chunk(2, dim=-1)

        def split(t):
            bb, s, _ = t.shape
            return t.reshape(bb, s, self.heads, self.dim_head).transpose(1, 2)

        out = multi_head_attention(
            split(q), split(k), split(v), q_ids=q_ids, kv_ids=kv_ids,
            ids_mode=self.ids_mode, sm_scale=self.dim_head ** -0.5)
        out = out.transpose(1, 2).reshape(b, -1, self.heads * self.dim_head)
        if out_keep is not None:
            out = out * out_keep[..., None].to(out.dtype)
        return self.to_out(out)


class GatedCrossAttentionBlock(nn.Module):
    def __init__(self, dim: int, dim_visual: int, dim_head: int = 64,
                 heads: int = 8, ff_mult: int = 4,
                 only_attend_immediate_media: bool = True,
                 quant: Optional[str] = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dim, self.quant, self.dtype = dim, quant, dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.attn_gate = nn.Parameter(torch.zeros(1, **f32))
        self.ff_gate = nn.Parameter(torch.zeros(1, **f32))
        self.attn = MaskedCrossAttention(
            dim, dim_visual, dim_head, heads, only_attend_immediate_media,
            quant, dtype, device)
        self.ff_norm = LayerNorm(dim, dtype=dtype, device=device)
        if quant == "int4":
            self.ff_up = quant_ops.Int4Dense(
                dim, dim * ff_mult, pack_axis=0, dtype=dtype, device=device)
            self.ff_down = quant_ops.Int4Dense(
                dim * ff_mult, dim, pack_axis=1, dtype=dtype, device=device)
        else:
            self.ff_up = quant_ops.make_dense(quant, dim, dim * ff_mult,
                                              use_bias=False, dtype=dtype,
                                              device=device)
            self.ff_down = quant_ops.make_dense(quant, dim * ff_mult, dim,
                                                use_bias=False, dtype=dtype,
                                                device=device)

    def forward(self, x, media, q_ids=None, kv_ids=None, out_keep=None):
        attn = self.attn(x, media, q_ids, kv_ids, out_keep)
        x = attn * torch.tanh(self.attn_gate).to(x.dtype) + x
        residual = x
        y = self.ff_norm(x)
        tokens = y.numel() // self.dim
        if self.quant in ("int8", "int4") and tokens <= 32:
            # decode: both weight streams in one fused kernel launch
            flat = y.reshape(tokens, self.dim).to(self.dtype)
            if self.quant == "int4":
                y = quant_ops.int4_mlp(
                    flat, self.ff_up.kernel_q4, self.ff_up.scale_q,
                    self.ff_down.kernel_q4, self.ff_down.scale_q, act="gelu")
            else:
                y = quant_ops.int8_mlp(
                    flat, self.ff_up.kernel_q, self.ff_up.scale_q,
                    self.ff_down.kernel_q, self.ff_down.scale_q, act="gelu")
            y = y.reshape(x.shape[:-1] + (self.dim,))
        else:
            y = self.ff_down(gelu(self.ff_up(y)))
        return y * torch.tanh(self.ff_gate).to(x.dtype) + residual
