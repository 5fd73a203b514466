"""IDEFICS vision-language model (counterpart of `otter_tpu/models/idefics.py`).

HF `IdeficsForVisionText2Text`: a CLIP-style ViT tower (its full sequence,
CLS included) -> a perceiver resampler at the vision embed dim -> a LLaMA
trunk with gated cross-attention blocks BEFORE every
`cross_layer_interval`-th layer (`i % interval == 0`, unlike Flamingo's
`(i + 1) % n == 0`), a decoupled embedding and head for the trainable
additional vocab, per-head RMS q/k norms in the cross-attention.

Each text token attends only the MOST RECENT preceding image, a window that
an eos resets (HF `image_attention_mask_for_packed_input_ids` +
`incremental_to_binary_attention_mask`), computed here from the token ids
with a cumulative sum and a cumulative max. The mask reaches the
cross-attention as a dense additive bias [B, 1, S, N*m]; the rows of text
that attend no image are zeroed after the out-projection (`keep_gate`).
Generated tokens attend the last image of their prompt.

The decoder layers are `models.decoder.DecoderLayer`, fed by the same
per-call setup as `Decoder` (`models.decoder.layer_inputs`). With
`text.quant` set the decoder layers hold int8 weights (`quantize_decoder`:
the JAX package's `FROZEN_DECODER_PATTERNS`); the head, `additional_fc`,
the xattn blocks, the perceiver and the ViT stay in the activation dtype. Submodules and parameters carry the flax names, so
`models.convert.load_flax_params` is one to one.

forward: (vision_x [B, N, C, H, W] or [B, T, F, C, H, W], lang_x [B, S])
-> (logits [B, S, V + additional], cache, vis_latents [B, N, m, D_vis]).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from otter_tpu_torch.config import IdeficsModelConfig, IdeficsPerceiverConfig
from otter_tpu_torch.device import resolve_device
from otter_tpu_torch.models.clip import CLIPVisionModel
from otter_tpu_torch.models.decoder import DecoderLayer, Embed, layer_inputs
from otter_tpu_torch.ops import quant as quant_ops
from otter_tpu_torch.ops.attention import multi_head_attention
from otter_tpu_torch.ops.layers import Dense, LayerNorm, RMSNorm
from otter_tpu_torch.ops.masks import DEFAULT_MASK_VALUE

# flax nn.LayerNorm's default epsilon (the perceiver's norms)
_FLAX_LN_EPS = 1e-6


def image_attention_incremental(ids: torch.Tensor, image_token_id: int,
                                eos_token_id: int) -> torch.Tensor:
    """[B, S] token ids -> [B, S] int index of the most recent preceding
    image (-1 = none attendable): an eos blanks the window until the next
    image token."""
    b, s = ids.shape
    is_img = ids == image_token_id
    count = torch.cumsum(is_img.int(), dim=1) - 1
    pos = torch.arange(s, device=ids.device).expand(b, s)
    none = torch.full_like(pos, -1)
    img_last = torch.cummax(torch.where(is_img, pos, none), dim=1).values
    eod_last = torch.cummax(torch.where(ids == eos_token_id, pos, none),
                            dim=1).values
    # an eos affects only STRICTLY LATER tokens
    eod_prev = torch.cat([none[:, :1], eod_last[:, :-1]], dim=1)
    seen_eod = (eod_prev >= 0) & (eod_prev >= img_last)
    return torch.where(seen_eod, -1, count)


def incremental_to_binary(incr: torch.Tensor, num_images: int) -> torch.Tensor:
    """[B, S] incremental index -> [B, S, N] one-hot bool mask (indices
    outside [0, N) attend nothing)."""
    valid = (incr >= 0) & (incr < num_images)
    onehot = torch.nn.functional.one_hot(
        incr.clamp(0, num_images - 1).long(), num_images).bool()
    return onehot & valid[..., None]


class IdeficsPerceiverAttention(nn.Module):
    """Latents query concat(context, latents) (HF
    IdeficsPerceiverAttention); per-head LayerNorm with bias on q and k."""

    def __init__(self, cfg: IdeficsPerceiverConfig, embed_dim: int, dtype,
                 device):
        super().__init__()
        self.cfg = cfg
        inner = cfg.n_heads * cfg.head_dim
        ln = lambda: LayerNorm(embed_dim, eps=_FLAX_LN_EPS, dtype=dtype,
                               device=device)
        dense = lambda i, o: Dense(i, o, use_bias=False, dtype=dtype,
                                   device=device)
        self.context_layer_norm, self.latents_layer_norm = ln(), ln()
        self.q_proj = dense(embed_dim, inner)
        self.k_proj = dense(embed_dim, inner)
        self.v_proj = dense(embed_dim, inner)
        if cfg.qk_layer_norms:
            hln = lambda: LayerNorm(cfg.head_dim, eps=1e-5, dtype=dtype,
                                    device=device)
            self.q_layer_norm, self.k_layer_norm = hln(), hln()
        self.output_proj = dense(inner, embed_dim)

    def forward(self, context, latents):
        c = self.cfg
        context = self.context_layer_norm(context)
        latents = self.latents_layer_norm(latents)
        kv_in = torch.cat([context, latents], dim=1)

        def split(t):
            b, s, _ = t.shape
            return t.reshape(b, s, c.n_heads, c.head_dim).transpose(1, 2)

        q = split(self.q_proj(latents))
        k, v = split(self.k_proj(kv_in)), split(self.v_proj(kv_in))
        if c.qk_layer_norms:
            q, k = self.q_layer_norm(q), self.k_layer_norm(k)
        out = multi_head_attention(q, k, v, sm_scale=c.head_dim ** -0.5)
        b, _, s, _ = out.shape
        return self.output_proj(out.transpose(1, 2).reshape(b, s, -1))


class IdeficsPerceiverMLP(nn.Module):
    """LN -> fc -> ReLU -> c_proj, bias-free, at 4x the vision dim."""

    def __init__(self, embed_dim: int, dtype, device):
        super().__init__()
        self.ln = LayerNorm(embed_dim, eps=_FLAX_LN_EPS, dtype=dtype,
                            device=device)
        self.fc = Dense(embed_dim, 4 * embed_dim, use_bias=False, dtype=dtype,
                        device=device)
        self.c_proj = Dense(4 * embed_dim, embed_dim, use_bias=False,
                            dtype=dtype, device=device)

    def forward(self, x):
        return self.c_proj(torch.relu(self.fc(self.ln(x))))


class IdeficsPerceiver(nn.Module):
    """[B*N, S_img, D_vis] -> [B*N, n_latents, D_vis]."""

    def __init__(self, cfg: IdeficsPerceiverConfig, embed_dim: int, dtype,
                 device):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.latents = nn.Parameter(torch.empty(
            cfg.n_latents, embed_dim, dtype=torch.float32, device=device))
        for i in range(cfg.depth):
            self.add_module(f"blocks_{i}_attn", IdeficsPerceiverAttention(
                cfg, embed_dim, dtype, device))
            self.add_module(f"blocks_{i}_mlp", IdeficsPerceiverMLP(
                embed_dim, dtype, device))
        self.layer_norm = LayerNorm(embed_dim, eps=_FLAX_LN_EPS, dtype=dtype,
                                    device=device)

    def forward(self, x):
        lat = self.latents.to(self.dtype).expand(x.shape[0], -1, -1)
        for i in range(self.cfg.depth):
            lat = lat + getattr(self, f"blocks_{i}_attn")(x, lat)
            lat = lat + getattr(self, f"blocks_{i}_mlp")(lat)
        return self.layer_norm(lat)


class IdeficsGatedXAttn(nn.Module):
    """Gated cross-attention block (HF IdeficsGatedCrossAttentionLayer):
    pre-RMSNorm cross-attention (no rope; per-head RMS q/k norms) with a
    tanh(alpha) gate, the rows of text attending no image zeroed, then a
    SwiGLU MLP with its own gate."""

    def __init__(self, cfg: IdeficsModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        t = cfg.text
        h, d, hid = t.num_attention_heads, t.head_dim, t.hidden_size
        alpha = (1,) if cfg.alpha_type == "float" else (1, 1, hid)
        f32 = dict(dtype=torch.float32, device=device)
        self.alpha_cross_attn = nn.Parameter(torch.zeros(alpha, **f32))
        self.alpha_dense = nn.Parameter(torch.zeros(alpha, **f32))
        rms = lambda dim: RMSNorm(dim, eps=t.norm_eps, dtype=dtype,
                                  device=device)
        dense = lambda i, o: Dense(i, o, use_bias=False, dtype=dtype,
                                   device=device)
        self.input_layernorm = rms(hid)
        self.q_proj = dense(hid, h * d)
        self.k_proj = dense(cfg.vision.hidden_size, h * d)
        self.v_proj = dense(cfg.vision.hidden_size, h * d)
        if cfg.qk_layer_norms:
            self.q_layer_norm, self.k_layer_norm = rms(d), rms(d)
        self.o_proj = dense(h * d, hid)
        self.post_attention_layernorm = rms(hid)
        self.gate_proj = dense(hid, t.mlp_dim)
        self.up_proj = dense(hid, t.mlp_dim)
        self.down_proj = dense(t.mlp_dim, hid)

    def forward(self, x, image_hidden, img_bias, keep_gate):
        """x [B, S, D]; image_hidden [B, N*m, D_vis]; img_bias
        [B, 1, S, N*m] f32 (0 or the mask value); keep_gate [B, S] bool."""
        t = self.cfg.text
        h, d = t.num_attention_heads, t.head_dim

        def split(tens):
            b, s, _ = tens.shape
            return tens.reshape(b, s, h, d).transpose(1, 2)

        y = self.input_layernorm(x)
        q = split(self.q_proj(y))
        k, v = split(self.k_proj(image_hidden)), split(self.v_proj(
            image_hidden))
        if self.cfg.qk_layer_norms:
            q, k = self.q_layer_norm(q), self.k_layer_norm(k)
        out = multi_head_attention(q, k, v, bias=img_bias, sm_scale=d ** -0.5)
        b, _, s, _ = out.shape
        out = self.o_proj(out.transpose(1, 2).reshape(b, s, h * d))
        out = torch.where(keep_gate[..., None], out, torch.zeros_like(out))
        x = x + torch.tanh(self.alpha_cross_attn).to(out.dtype) * out
        y = self.post_attention_layernorm(x)
        mlp = self.down_proj(torch.nn.functional.silu(self.gate_proj(y))
                             * self.up_proj(y))
        return x + torch.tanh(self.alpha_dense).to(mlp.dtype) * mlp


class IdeficsVLM(nn.Module):
    """Parameters are allocated uninitialized on `device` (the GPU unless
    the caller passes another); fill them with
    `models.convert.load_flax_params`. `remat=True` recomputes each decoder
    layer in the backward pass."""

    def __init__(self, cfg: IdeficsModelConfig, dtype=torch.bfloat16,
                 device=None, remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        t = cfg.text
        if t.quant not in (None, "int8", "int4") or t.quant_embed \
                or t.megakernel or t.fused_tail or t.lora_rank:
            raise NotImplementedError(
                "IdeficsVLM: only int8 decoder layers (quant int8 or int4) "
                "are supported")
        self.cfg, self.dtype, self.remat = cfg, dtype, remat
        self.vision_encoder = CLIPVisionModel(cfg.vision, dtype, device)
        if cfg.use_resampler:
            self.perceiver = IdeficsPerceiver(cfg.perceiver,
                                              cfg.vision.hidden_size, dtype,
                                              device)
        self.wte = Embed(t.vocab_size, t.hidden_size, dtype, device)
        if cfg.additional_vocab_size:
            self.additional_embedding = Embed(cfg.additional_vocab_size,
                                              t.hidden_size, dtype, device)
        for i in range(t.num_hidden_layers):
            if i % cfg.cross_layer_interval == 0:
                self.add_module(f"xattn_{i}",
                                IdeficsGatedXAttn(cfg, dtype, device))
            self.add_module(f"layers_{i}", DecoderLayer(t, dtype, device))
        self.norm_f = RMSNorm(t.hidden_size, eps=t.norm_eps, dtype=dtype,
                              device=device)
        self.lm_head = Dense(t.hidden_size, t.vocab_size, use_bias=False,
                             dtype=dtype, device=device)
        if cfg.additional_vocab_size:
            self.additional_fc = Dense(t.hidden_size,
                                       cfg.additional_vocab_size,
                                       use_bias=False, dtype=dtype,
                                       device=device)

    @property
    def device(self) -> torch.device:
        return self.norm_f.scale.device

    def encode_vision(self, vision_x: torch.Tensor,
                      vision_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """[B, N, C, H, W] (or the Otter pipeline's [B, T, F, C, H, W], its
        T*F media as N) float pixels -> latents [B, N, m, D_vis]: the ViT's
        full sequence, CLS kept, then the perceiver. `vision_mask` is
        accepted for the engine's call and ignored, as in the JAX module."""
        if vision_x.dim() == 6:
            vision_x = vision_x.reshape((vision_x.shape[0], -1)
                                        + vision_x.shape[3:])
        b, n = vision_x.shape[:2]
        feats = self.vision_encoder(vision_x.reshape((b * n,)
                                                     + vision_x.shape[2:]))
        if self.cfg.use_resampler:
            feats = self.perceiver(feats)
        return feats.reshape((b, n) + feats.shape[1:])

    def _image_mask(self, lang_x, n: int, decoding: bool, media_counts):
        """[B, S, N] bool: which image each token attends."""
        b, s = lang_x.shape
        if decoding:
            # generated tokens attend the most recent prompt image
            idx = (media_counts - 1).long()[:, None].expand(b, s)
        else:
            idx = image_attention_incremental(
                lang_x, self.cfg.media_token_id, self.cfg.eos_token_id)
        return incremental_to_binary(idx, n)

    def embed(self, lang_x: torch.Tensor) -> torch.Tensor:
        """The decoupled embedding (IdeficsDecoupledEmbedding): ids at or
        above the base vocab read the additional table."""
        v = self.cfg.text.vocab_size
        x = self.wte(lang_x.clamp(0, v - 1))
        if self.cfg.additional_vocab_size:
            xa = self.additional_embedding(
                (lang_x - v).clamp(0, self.cfg.additional_vocab_size - 1))
            x = torch.where((lang_x >= v)[..., None], xa, x)
        return x

    def forward(self, vision_x, lang_x, attention_mask=None,
                attend_previous: bool = True, vis_latents=None, cache=None,
                cache_pos=None, kv_valid=None, positions=None,
                media_counts=None, head_last_only: bool = False):
        """With `vis_latents` given, `vision_x` is ignored. During cached
        decoding (cache_pos set) `media_counts` [B] is the number of images
        in each prompt. `attend_previous` is taken for the OtterVLM call
        signature and ignored, as in the JAX module. Returns (logits,
        cache, vis_latents)."""
        t = self.cfg.text
        if vis_latents is None:
            vis_latents = self.encode_vision(vision_x)
        b, n, m, dv = vis_latents.shape
        image_hidden = vis_latents.reshape(b, n * m, dv)
        decoding = cache is not None and cache_pos is not None
        iam = self._image_mask(lang_x, n, decoding, media_counts)
        # [B, S, N] -> [B, S, N*m], images-major as image_hidden
        iam_lat = iam.repeat_interleave(m, dim=-1)
        zero = torch.zeros((), dtype=torch.float32, device=iam.device)
        img_bias = torch.where(iam_lat, zero, DEFAULT_MASK_VALUE)[:, None]
        keep_gate = iam_lat.any(-1)

        x = self.embed(lang_x)
        positions, kw = layer_inputs(
            t, x, self.dtype, positions=positions,
            attention_mask=None if decoding else attention_mask,
            cache=cache, cache_pos=cache_pos, kv_valid=kv_valid)
        for i in range(t.num_hidden_layers):
            if i % self.cfg.cross_layer_interval == 0:
                x = getattr(self, f"xattn_{i}")(x, image_hidden, img_bias,
                                                keep_gate)
            layer = getattr(self, f"layers_{i}")
            if self.remat and cache is None and torch.is_grad_enabled():
                x = checkpoint(layer, x, layer=i, rope=kw["rope"],
                               attn_ids=kw["attn_ids"], bias=kw["bias"],
                               use_reentrant=False)
            else:
                x = layer(x, layer=i, cache=cache, cache_pos=cache_pos,
                          kv_valid=kv_valid, **kw)
        x = self.norm_f(x)
        if head_last_only:
            x = x[:, -1:]
        # the decoupled head (IdeficsDecoupledLinear)
        logits = self.lm_head(x)
        if self.cfg.additional_vocab_size:
            logits = torch.cat([logits, self.additional_fc(x)], dim=-1)
        return logits, cache, vis_latents


def quantize_decoder(cfg: IdeficsModelConfig, flat):
    """The load transform of an idefics model over a {flax path: array}
    mapping of its unquantized parameters: with `text.quant` "int8" or
    "int4", the decoder layers' kernels to int8 (`FROZEN_DECODER_PATTERNS`;
    the gated MLPs never pack to int4), everything else as it is. The JAX
    worker quantizes with the default patterns instead, which also take
    `lm_head`, and its `IdeficsVLM` then finds no `lm_head/kernel`."""
    return quant_ops.quantize_for(cfg.text, flat,
                                  patterns=quant_ops.FROZEN_DECODER_PATTERNS)
