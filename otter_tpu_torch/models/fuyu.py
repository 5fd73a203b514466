"""Fuyu/OtterHD: encoder-free VLM (counterpart of `otter_tpu/models/fuyu.py`).

Variable-resolution image patches are linearly projected
(`vision_embed_tokens`) and placed into the Persimmon token stream at the
placeholder positions: a gather along the patch axis and a `where` inside
the decoder. The Persimmon-8B decoder is `models.decoder.Decoder` with
`arch="persimmon"` (per-head q/k LayerNorm, partial rotary, squared-ReLU
MLP, biases everywhere), under the flax name `language_model`.
"""

from __future__ import annotations

import torch
from torch import nn

from otter_tpu_torch.config import FuyuConfig
from otter_tpu_torch.device import resolve_device
from otter_tpu_torch.models.decoder import Cache, Decoder, init_cache
from otter_tpu_torch.ops.layers import Dense


class FuyuVLM(nn.Module):
    """forward: input_ids [B, S]; image_patches [B, P, patch_size^2 * C];
    image_patches_indices [B, S] int (-1 = text token, >= 0 = index into
    image_patches) -> (logits, cache). The patches are merged at prefill
    and training only (`cache_pos is None`): a cached step feeds one text
    token.

    Parameters are allocated uninitialized on `device` (the GPU unless the
    caller passes another); fill them with `models.convert.load_flax_params`.
    """

    def __init__(self, cfg: FuyuConfig, dtype=torch.bfloat16, device=None,
                 remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.dtype = cfg, dtype
        self.vision_embed_tokens = Dense(
            cfg.patch_size ** 2 * cfg.num_channels, cfg.text.hidden_size,
            dtype=dtype, device=device)
        self.language_model = Decoder(cfg.text, dtype=dtype, device=device,
                                      remat=remat)

    @property
    def device(self) -> torch.device:
        return self.vision_embed_tokens.kernel.device

    def forward(self, input_ids, *, image_patches=None,
                image_patches_indices=None, attention_mask=None,
                positions=None, cache=None, cache_pos=None, kv_valid=None,
                head_last_only: bool = False):
        merge = None
        if image_patches is not None and cache_pos is None:
            patch_emb = self.vision_embed_tokens(image_patches)   # [B, P, H]
            idx = image_patches_indices.clamp_min(0).long()       # [B, S]
            gathered = torch.gather(
                patch_emb, 1,
                idx[..., None].expand(-1, -1, patch_emb.shape[-1]))
            merge = (gathered, image_patches_indices >= 0)
        return self.language_model(
            input_ids, merge_embeds=merge, attention_mask=attention_mask,
            positions=positions, cache=cache, cache_pos=cache_pos,
            kv_valid=kv_valid, head_last_only=head_last_only)


def make_fuyu_cache(cfg: FuyuConfig, batch: int, max_len: int,
                    dtype=torch.bfloat16, device=None) -> Cache:
    return init_cache(cfg.text, batch, max_len, dtype, device)
