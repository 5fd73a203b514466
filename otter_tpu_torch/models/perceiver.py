"""PerceiverResampler (counterpart of `otter_tpu/models/perceiver.py`).

Learned latents cross-attend to the vision tokens with the latents
concatenated into the key/value set, optional frame and media-time
embeddings, and a final LayerNorm.
"""

from __future__ import annotations

import torch
from torch import nn

from otter_tpu_torch.config import PerceiverConfig
from otter_tpu_torch.ops.attention import multi_head_attention
from otter_tpu_torch.ops.layers import Dense, LayerNorm, gelu


class PerceiverBlock(nn.Module):
    def __init__(self, cfg: PerceiverConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, inner = cfg.dim, cfg.dim_head * cfg.heads
        ln = lambda: LayerNorm(d, dtype=dtype, device=device)
        dense = lambda i, o: Dense(i, o, use_bias=False, dtype=dtype,
                                   device=device)
        self.norm_media, self.norm_latents, self.ff_norm = ln(), ln(), ln()
        self.to_q = dense(d, inner)
        self.to_kv = dense(d, 2 * inner)
        self.to_out = dense(inner, d)
        self.ff_up = dense(d, d * cfg.ff_mult)
        self.ff_down = dense(d * cfg.ff_mult, d)

    def forward(self, x, latents, kv_mask=None):
        """x: [B*T, n1, D] media tokens; latents: [B*T, n2, D]. kv_mask:
        optional [B*T, n1] bool; False tokens (padded frames of mixed
        still+video requests) are attended by no latent. Keys of the
        latents themselves are always attended, so no row is empty."""
        c = self.cfg
        x_n = self.norm_media(x)
        residual = latents
        lat_n = self.norm_latents(latents)
        q = self.to_q(lat_n)
        k, v = self.to_kv(torch.cat([x_n, lat_n], dim=-2)).chunk(2, dim=-1)
        q_ids = kv_ids = None
        if kv_mask is not None:
            bt, n2 = latents.shape[:2]
            q_ids = torch.ones((bt, n2), dtype=torch.int32, device=x.device)
            kv_ids = torch.cat([kv_mask.int(), q_ids], dim=-1)

        def split(t):
            b, s, _ = t.shape
            return t.reshape(b, s, c.heads, c.dim_head).transpose(1, 2)

        out = multi_head_attention(split(q), split(k), split(v),
                                   q_ids=q_ids, kv_ids=kv_ids, ids_mode="eq",
                                   sm_scale=c.dim_head ** -0.5)
        b, _, s, _ = out.shape
        out = self.to_out(out.transpose(1, 2).reshape(b, s, -1)) + residual
        y = self.ff_down(gelu(self.ff_up(self.ff_norm(out))))
        return y + out


class PerceiverResampler(nn.Module):
    def __init__(self, cfg: PerceiverConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        f32 = dict(dtype=torch.float32, device=device)
        if cfg.max_num_frames is not None:
            self.frame_embs = nn.Parameter(
                torch.empty(cfg.max_num_frames, d, **f32))
        if cfg.max_num_media is not None:
            self.media_time_embs = nn.Parameter(
                torch.empty(cfg.max_num_media, 1, d, **f32))
        self.latents = nn.Parameter(torch.empty(cfg.num_latents, d, **f32))
        for i in range(cfg.depth):
            self.add_module(f"layers_{i}",
                            PerceiverBlock(cfg, dtype, device))
        self.norm = LayerNorm(d, dtype=dtype, device=device)

    def forward(self, x, frame_mask=None):
        """x: [B, T, F, v, D] vision features -> [B, T, n_latents, D].
        frame_mask: optional [B, T, F] bool; the tokens of False frames
        (padding in mixed still+video requests) are left out of the latent
        attention."""
        c = self.cfg
        b, t, f, v, d = x.shape
        x = x.to(self.dtype)
        kv_mask = None
        if frame_mask is not None:
            kv_mask = frame_mask.reshape(b * t, f).repeat_interleave(v, dim=-1)
        if c.max_num_frames is not None:
            x = x + self.frame_embs[:f].to(self.dtype)[None, None, :, None]
        x = x.reshape(b, t, f * v, d)
        if c.max_num_media is not None:
            x = x + self.media_time_embs[:t].to(self.dtype)[None]
        lat = self.latents.to(self.dtype).expand(b * t, c.num_latents, d)
        x = x.reshape(b * t, f * v, d)
        for i in range(c.depth):
            lat = getattr(self, f"layers_{i}")(x, lat, kv_mask)
        return self.norm(lat).reshape(b, t, c.num_latents, d)
