"""Otter/Flamingo composite VLM (counterpart of `otter_tpu/models/otter.py`).

Vision tower -> perceiver -> xattn-augmented decoder. The decoder forward
takes the vision latents and the media ids as explicit arguments.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from otter_tpu_torch.config import OtterConfig
from otter_tpu_torch.device import resolve_device
from otter_tpu_torch.models.clip import CLIPVisionModel
from otter_tpu_torch.models.decoder import Decoder
from otter_tpu_torch.models.perceiver import PerceiverResampler
from otter_tpu_torch.ops.masks import media_attention_ids


class OtterVLM(nn.Module):
    """forward: (vision_x [B,T,F,C,H,W], lang_x [B,S]) -> logits [B,S,V].

    Parameters are allocated uninitialized on `device` (the GPU unless the
    caller passes another); fill them with `models.convert.load_flax_params`.
    `remat=True` recomputes each decoder layer in the backward pass.
    """

    def __init__(self, cfg: OtterConfig, dtype=torch.bfloat16, device=None,
                 remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.dtype = cfg, dtype
        self.vision_encoder = CLIPVisionModel(cfg.vision, dtype, device)
        self.perceiver = PerceiverResampler(cfg.perceiver, dtype, device)
        self.lang_encoder = Decoder(cfg.text, otter_cfg=cfg, dtype=dtype,
                                    device=device, remat=remat)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def encode_vision(self, vision_x: torch.Tensor) -> torch.Tensor:
        """[B, T, F, C, H, W] float pixels -> latents [B, T, n, D]: CLIP,
        drop CLS, then the perceiver over each media's frames."""
        b, t, f = vision_x.shape[:3]
        flat = vision_x.reshape((b * t * f,) + vision_x.shape[3:])
        feats = self.vision_encoder(flat)[:, 1:, :]
        v, d = feats.shape[1], feats.shape[2]
        return self.perceiver(feats.reshape(b, t, f, v, d))

    def forward(self, vision_x, lang_x, attention_mask=None,
                attend_previous: bool = True, vis_latents=None, cache=None,
                cache_pos: Optional[int] = None, kv_valid=None,
                positions=None, media_counts=None, head_last_only: bool = False,
                skip_head: bool = False):
        """Full forward; with `vis_latents` given, `vision_x` is ignored.
        During cached decoding (cache_pos set) `media_counts` [B] is the
        number of media in each prompt: generated tokens sit after all of
        them, so their text_time is media_counts. `positions` [B, S] are
        the tokens' positions (rope models; default 0 .. S-1). Returns (logits, cache,
        vis_latents); with skip_head the final-norm hidden states take the
        logits' place (the fused cross-entropy's input)."""
        c = self.cfg
        if vis_latents is None:
            vis_latents = self.encode_vision(vision_x)
        t_img, n_lat = vis_latents.shape[1], vis_latents.shape[2]
        if cache_pos is None:
            q_ids, kv_ids, out_keep = media_attention_ids(
                lang_x == c.media_token_id, t_img, n_lat,
                only_attend_immediate_media=c.only_attend_immediate_media,
                attend_previous=attend_previous)
        else:
            b, s = lang_x.shape
            q_ids = media_counts[:, None].expand(b, s).int()
            kv_ids = torch.arange(
                1, t_img + 1, dtype=torch.int32, device=lang_x.device
            ).repeat_interleave(n_lat)[None].expand(b, t_img * n_lat)
            out_keep = (q_ids > 0 if c.only_attend_immediate_media
                        else torch.ones_like(q_ids, dtype=torch.bool))
        logits, cache = self.lang_encoder(
            lang_x, attention_mask=attention_mask, positions=positions,
            vis_latents=vis_latents,
            xattn_q_ids=q_ids, xattn_kv_ids=kv_ids, xattn_out_keep=out_keep,
            cache=cache, cache_pos=cache_pos, kv_valid=kv_valid,
            head_last_only=head_last_only, skip_head=skip_head)
        return logits, cache, vis_latents

