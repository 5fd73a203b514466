"""CLIP ViT vision tower (counterpart of `otter_tpu/models/clip.py`).

Conv patch embedding, class token, learned position embeddings, pre-LN,
then N encoder layers (LN -> attention -> LN -> MLP with quick_gelu), the
attention going through the dispatcher (the flash kernel on the GPU). As
in HF, `last_hidden_state` comes back without the post-layernorm, which
applies to the pooled CLS only and is declared so checkpoints round-trip.
"""

from __future__ import annotations

import torch
from torch import nn

from otter_tpu_torch.config import VisionConfig
from otter_tpu_torch.ops.attention import multi_head_attention
from otter_tpu_torch.ops.layers import ACTIVATIONS, Dense, LayerNorm


class CLIPAttention(nn.Module):
    def __init__(self, cfg: VisionConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Dense(d, d, dtype=dtype, device=device))

    def forward(self, x):
        c = self.cfg
        b, s, _ = x.shape
        h, d = c.num_attention_heads, c.head_dim

        def split(t):  # [B, S, H*D] -> [B, H, S, D]
            return t.reshape(b, s, h, d).transpose(1, 2)

        out = multi_head_attention(split(self.q_proj(x)),
                                   split(self.k_proj(x)),
                                   split(self.v_proj(x)))
        return self.out_proj(out.transpose(1, 2).reshape(b, s, h * d))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: VisionConfig, dtype, device):
        super().__init__()
        self.act = ACTIVATIONS[cfg.hidden_act]
        kw = dict(eps=cfg.layer_norm_eps, dtype=dtype, device=device)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, **kw)
        self.self_attn = CLIPAttention(cfg, dtype, device)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, **kw)
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size, dtype=dtype,
                         device=device)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size, dtype=dtype,
                         device=device)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.fc2(self.act(self.fc1(self.layer_norm2(x))))


class CLIPVisionModel(nn.Module):
    """pixel_values [B, C, H, W] -> last_hidden_state [B, 1+P, D]."""

    def __init__(self, cfg: VisionConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d, p = cfg.hidden_size, cfg.patch_size
        # flax Conv layout [kh, kw, C, D]
        self.patch_embedding = nn.Module()
        self.patch_embedding.kernel = nn.Parameter(
            torch.empty(p, p, 3, d, dtype=dtype, device=device))
        self.class_embedding = nn.Parameter(
            torch.empty(d, dtype=torch.float32, device=device))
        self.position_embedding = nn.Parameter(
            torch.empty(1 + cfg.num_patches, d, dtype=torch.float32,
                        device=device))
        kw = dict(eps=cfg.layer_norm_eps, dtype=dtype, device=device)
        self.pre_layernorm = LayerNorm(d, **kw)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layers_{i}",
                            CLIPEncoderLayer(cfg, dtype, device))
        self.post_layernorm = LayerNorm(d, **kw)

    def forward(self, pixel_values):
        c = self.cfg
        b = pixel_values.shape[0]
        w = self.patch_embedding.kernel.permute(3, 2, 0, 1)   # [D, C, kh, kw]
        patches = torch.nn.functional.conv2d(
            pixel_values.to(self.dtype), w, stride=c.patch_size)
        patches = patches.flatten(2).transpose(1, 2)          # [B, P, D]
        cls = self.class_embedding.to(self.dtype).expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        x = x + self.position_embedding.to(self.dtype)[None]
        x = self.pre_layernorm(x)
        for i in range(c.num_hidden_layers):
            x = getattr(self, f"layers_{i}")(x)
        return x
