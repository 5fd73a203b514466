"""MPT decoder with gated cross-attention (counterpart of
`otter_tpu/models/decoder.py`, `arch="mpt"`).

ALiBi, low-precision LayerNorm, fused Wqkv, no biases, tied embeddings,
GELU MLP, and a `GatedCrossAttentionBlock` before every
`cross_attn_every_n_layers`-th layer (`(i + 1) % n == 0`).

The KV cache is one stacked array per k/v, [B, n_layers, H, L, D] (int8
caches add f32 scales [B, n_layers, H, L]), as `init_cache` builds it.
JAX updates it functionally with `dynamic_update_slice`; here the layers
write their slots in place with slice assignment, so one buffer serves the
whole generation and no per-layer copy is ever made.

Training runs the forward with no cache under autograd: `remat=True`
recomputes each `DecoderLayer` in the backward pass
(`torch.utils.checkpoint`, as `nn.remat` per layer in the JAX module), and
`skip_head=True` returns the final-norm hidden states for the fused
cross-entropy.

Routing follows the JAX module: prefill and training attention go through
the dispatcher (flash kernels on the GPU); cached decode goes through the
decode-attention kernel when `decode_kernel` says so (`"auto"`: an int8
cache or L >= 1024), else through dense attention over the layer's slice;
the MLP with int8 weights goes through the fused `int8_mlp` kernel at
decode with at most 32 tokens, else through two `Int8Dense`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from otter_tpu_torch.config import OtterConfig, TextConfig
from otter_tpu_torch.models.xattn import GatedCrossAttentionBlock
from otter_tpu_torch.ops import decode_attention as da
from otter_tpu_torch.ops import quant as quant_ops
from otter_tpu_torch.ops.attention import multi_head_attention
from otter_tpu_torch.ops.layers import ACTIVATIONS, LayerNorm
from otter_tpu_torch.ops.masks import DEFAULT_MASK_VALUE, alibi_slopes

Cache = Dict[str, torch.Tensor]


def _lp_norm(c: TextConfig, dtype, device) -> LayerNorm:
    # MPT removes the LayerNorm biases (`modeling_mpt.py:83-87`)
    return LayerNorm(c.hidden_size, eps=c.norm_eps, use_bias=False,
                     dtype=dtype, device=device)


def write_cache(cache: Cache, layer: int, k: torch.Tensor, v: torch.Tensor,
                pos: int) -> None:
    """Write k/v [B, H, S, D] at offset `pos` into this layer's slot of the
    stacked cache, in place, quantizing when the cache is int8."""
    s = k.shape[2]
    if cache["k"].dtype == torch.int8:
        # k and v quantized in one pass (rows are independent)
        kvq, kvs = quant_ops.quantize_kv(torch.stack([k, v]))
        cache["k"][:, layer, :, pos:pos + s] = kvq[0]
        cache["v"][:, layer, :, pos:pos + s] = kvq[1]
        cache["k_scale"][:, layer, :, pos:pos + s] = kvs[0]
        cache["v_scale"][:, layer, :, pos:pos + s] = kvs[1]
    else:
        cache["k"][:, layer, :, pos:pos + s] = k.to(cache["k"].dtype)
        cache["v"][:, layer, :, pos:pos + s] = v.to(cache["v"].dtype)


def dense_decode_attention(q, k, v, kv_valid, bias, *, sm_scale):
    """Dense attention for cached decoding (small q_len against
    [B, H, L, D]); kv_valid bool [B, L] marks attendable entries."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        logits = logits + bias.float()
    logits = logits.masked_fill(~kv_valid[:, None, None, :],
                                DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


class SelfAttention(nn.Module):
    def __init__(self, cfg: TextConfig, dtype, device):
        super().__init__()
        if cfg.kv_heads != cfg.num_attention_heads or cfg.qk_ln \
                or cfg.clip_qkv:
            raise NotImplementedError("the port's MPT attention has no "
                                      "MQA, qk_ln or clip_qkv yet")
        self.cfg = cfg
        d = cfg.hidden_size
        self.Wqkv = quant_ops.make_dense(cfg.quant, d, 3 * d,
                                         use_bias=not cfg.no_bias,
                                         dtype=dtype, device=device)
        self.out_proj = quant_ops.make_dense(cfg.quant, d, d,
                                             use_bias=not cfg.no_bias,
                                             dtype=dtype, device=device)

    def _use_decode_kernel(self, cache_k: torch.Tensor) -> bool:
        mode = self.cfg.decode_kernel
        if mode == "auto":
            return cache_k.shape[3] >= 1024 or cache_k.dtype == torch.int8
        return bool(mode)

    def forward(self, x, *, layer: int, attn_ids=None, bias=None,
                cache: Optional[Cache] = None, cache_pos: Optional[int] = None,
                kv_valid=None, decode_span=None):
        c = self.cfg
        b, s, _ = x.shape
        h, d = c.num_attention_heads, c.head_dim
        sm_scale = d ** -0.5
        q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
                   for t in self.Wqkv(x).chunk(3, dim=-1))
        if cache is not None and cache_pos is not None:
            write_cache(cache, layer, k, v, cache_pos)
            quant = cache["k"].dtype == torch.int8
            if self._use_decode_kernel(cache["k"]) and s == 1:
                lengths, starts = decode_span
                scales = ({"k_scale": cache["k_scale"],
                           "v_scale": cache["v_scale"]} if quant else {})
                out = da.decode_attention(
                    q[:, :, 0], cache["k"], cache["v"], lengths,
                    bias[:, :, 0, :], starts=starts, layer=layer,
                    sm_scale=sm_scale, **scales)[:, :, None, :]
            else:
                ck, cv = cache["k"][:, layer], cache["v"][:, layer]
                if quant:
                    ck = quant_ops.dequantize_kv(
                        ck, cache["k_scale"][:, layer], q.dtype)
                    cv = quant_ops.dequantize_kv(
                        cv, cache["v_scale"][:, layer], q.dtype)
                out = dense_decode_attention(q, ck, cv, kv_valid, bias,
                                             sm_scale=sm_scale)
        else:
            out = multi_head_attention(
                q, k, v, bias=bias, q_ids=attn_ids, kv_ids=attn_ids,
                ids_mode="eq", causal=True, sm_scale=sm_scale)
            if cache is not None:   # prefill writes from offset 0
                write_cache(cache, layer, k, v, 0)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, h * d))


class MLP(nn.Module):
    def __init__(self, cfg: TextConfig, dtype, device):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        kw = dict(use_bias=not cfg.no_bias, dtype=dtype, device=device)
        self.up_proj = quant_ops.make_dense(cfg.quant, cfg.hidden_size,
                                            cfg.mlp_dim, **kw)
        self.down_proj = quant_ops.make_dense(cfg.quant, cfg.mlp_dim,
                                              cfg.hidden_size, **kw)

    def forward(self, x, decoding: bool):
        c = self.cfg
        tokens = x.numel() // x.shape[-1]
        if decoding and c.quant == "int8" and tokens <= 32:
            # decode: both int8 weight streams in one fused kernel launch
            up, down = self.up_proj, self.down_proj
            y = quant_ops.int8_mlp(
                x.reshape(tokens, -1).to(self.dtype), up.kernel_q,
                up.scale_q, down.kernel_q, down.scale_q, act=c.act,
                b1=getattr(up, "bias", None), b2=getattr(down, "bias", None))
            return y.reshape(x.shape[:-1] + (c.hidden_size,))
        return self.down_proj(ACTIVATIONS[c.act](self.up_proj(x)))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TextConfig, dtype, device):
        super().__init__()
        self.norm_1 = _lp_norm(cfg, dtype, device)
        self.attn = SelfAttention(cfg, dtype, device)
        self.norm_2 = _lp_norm(cfg, dtype, device)
        self.ffn = MLP(cfg, dtype, device)

    def forward(self, x, *, layer, attn_ids=None, bias=None, cache=None,
                cache_pos=None, kv_valid=None, decode_span=None):
        x = x + self.attn(self.norm_1(x), layer=layer, attn_ids=attn_ids,
                          bias=bias, cache=cache, cache_pos=cache_pos,
                          kv_valid=kv_valid, decode_span=decode_span)
        return x + self.ffn(self.norm_2(x),
                            decoding=cache is not None
                            and cache_pos is not None)


class Embed(nn.Module):
    """flax `nn.Embed` layout: `embedding` [V, H]."""

    def __init__(self, vocab: int, dim: int, dtype, device):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.empty(vocab, dim, dtype=dtype, device=device))

    def forward(self, ids):
        return self.embedding[ids]

    def attend(self, x):
        return x.to(self.embedding.dtype) @ self.embedding.t()


class Decoder(nn.Module):
    """MPT causal LM with an optional gated cross-attention interleave."""

    def __init__(self, cfg: TextConfig, otter_cfg: Optional[OtterConfig] = None,
                 dtype=torch.float32, device=None, remat: bool = False):
        super().__init__()
        self.remat = remat
        if cfg.arch != "mpt" or cfg.pos != "alibi" or not cfg.tie_embeddings \
                or cfg.norm_type != "low_precision_layernorm" \
                or cfg.quant not in (None, "int8") or cfg.lora_rank \
                or cfg.megakernel or cfg.fused_tail or cfg.quant_embed:
            raise NotImplementedError(
                "the port's decoder covers MPT (ALiBi, tied head, LP "
                "LayerNorm, bf16 or int8 weights) only")
        self.cfg, self.otter_cfg, self.dtype = cfg, otter_cfg, dtype
        self.wte = Embed(cfg.total_vocab, cfg.hidden_size, dtype, device)
        self.xattn_every = (otter_cfg.cross_attn_every_n_layers
                            if otter_cfg is not None else 0)
        for i in range(cfg.num_hidden_layers):
            if self.xattn_every and (i + 1) % self.xattn_every == 0:
                oc = otter_cfg
                self.add_module(f"xattn_{i}", GatedCrossAttentionBlock(
                    dim=cfg.hidden_size, dim_visual=oc.perceiver.dim,
                    dim_head=oc.xattn_dim_head, heads=oc.xattn_heads,
                    ff_mult=oc.xattn_ff_mult,
                    only_attend_immediate_media=oc.only_attend_immediate_media,
                    quant=(cfg.quant if cfg.quant_xattn == "follow"
                           else cfg.quant_xattn),
                    dtype=dtype, device=device))
            self.add_module(f"layers_{i}", DecoderLayer(cfg, dtype, device))
        self.norm_f = _lp_norm(cfg, dtype, device)

    def forward(self, input_ids, *, attention_mask=None, vis_latents=None,
                xattn_q_ids=None, xattn_kv_ids=None, xattn_out_keep=None,
                cache: Optional[Cache] = None, cache_pos: Optional[int] = None,
                kv_valid=None, head_last_only: bool = False,
                skip_head: bool = False
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """Prefill/forward: cache None (no cache: training) or a
        preallocated cache with cache_pos None (prefill writes from offset
        0). Decode: cache_pos (an int) set and kv_valid [B, L] marking
        attendable entries. Returns (logits [B, S|1, V], cache), or with
        skip_head the final-norm hidden states [B, S, D] in place of the
        logits."""
        c = self.cfg
        x = self.wte(input_ids)
        b, s, _ = x.shape
        decoding = cache is not None and cache_pos is not None
        slopes = alibi_slopes(c.num_attention_heads, c.alibi_bias_max,
                              device=x.device)
        attn_ids = decode_span = None
        if decoding:
            L = cache["k"].shape[3]
            # column j gets j * slope: softmax-shift-equivalent to the
            # reference's (j - query_pos) * slope for every query row
            if s != 1:
                raise NotImplementedError("cached steps of more than one "
                                          "token are not ported yet")
            rel = torch.arange(L, device=x.device)
            bias = rel[None, None, None, :] * slopes[None, :, None, None]
            idx = torch.arange(L, device=x.device)[None, :]
            valid = kv_valid.bool()
            # once per step, in the kernel's int32, for every layer
            lengths = torch.where(valid, idx + 1, 0).amax(-1).int()
            starts = torch.where(valid, idx, L).amin(-1).int()
            decode_span = (lengths, starts)
        else:
            rel = torch.arange(1 - s, 1, device=x.device)
            bias = rel[None, None, None, :] * slopes[None, :, None, None]
            if attention_mask is not None:
                attn_ids = attention_mask.int()

        for i in range(c.num_hidden_layers):
            if self.xattn_every and (i + 1) % self.xattn_every == 0 \
                    and vis_latents is not None:
                x = getattr(self, f"xattn_{i}")(
                    x, vis_latents, xattn_q_ids, xattn_kv_ids, xattn_out_keep)
            layer = getattr(self, f"layers_{i}")
            if self.remat and cache is None and torch.is_grad_enabled():
                # keep only the layer's input; recompute the rest backward
                x = checkpoint(layer, x, layer=i, attn_ids=attn_ids,
                               bias=bias, use_reentrant=False)
            else:
                x = layer(x, layer=i, attn_ids=attn_ids, bias=bias,
                          cache=cache, cache_pos=cache_pos,
                          kv_valid=kv_valid, decode_span=decode_span)
        x = self.norm_f(x)
        if skip_head:
            return x, cache
        if head_last_only:
            x = x[:, -1:]
        logits = self.wte.attend(x)
        if c.logit_scale is not None:
            logits = logits * c.logit_scale
        return logits, cache


def init_cache(cfg: TextConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Cache:
    """Preallocated stacked KV cache [batch, n_layers, kv_heads, max_len,
    head_dim]; dtype torch.int8 (or "int8") adds f32 per-(position, head)
    scales [batch, n_layers, kv_heads, max_len]."""
    if dtype == "int8":
        dtype = torch.int8
    if dtype == "int4":
        raise NotImplementedError("the int4 cache is not ported yet")
    shape = (batch, cfg.num_hidden_layers, cfg.kv_heads, max_len,
             cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
    return cache
