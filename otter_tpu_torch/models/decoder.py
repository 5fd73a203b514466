"""Decoder-only LM backbone with gated cross-attention (counterpart of
`otter_tpu/models/decoder.py`).

One parameterized implementation, selected by `TextConfig.arch`:

  - "mpt"        ALiBi, low-precision LayerNorm, fused Wqkv, no biases,
                 tied embeddings, GELU MLP
  - "mosaic_gpt" the older Mosaic variant, same structure
  - "llama"      RoPE, RMSNorm, SwiGLU, untied head
  - "falcon"     rotary, fused multiquery qkv, parallel attention + MLP
  - "persimmon"  partial rotary, per-head q/k LayerNorm, squared-ReLU MLP,
                 biases everywhere

and a `GatedCrossAttentionBlock` before every
`cross_attn_every_n_layers`-th layer (`(i + 1) % n == 0`). Submodules and
parameters carry the flax names, so `models.convert.load_flax_params` is
one to one.

The KV cache is one stacked array per k/v, [B, n_layers, kv_heads, L, D]
(int8 caches add f32 scales [B, n_layers, kv_heads, L]; an int4 cache is
one fused `kv` array of that shape, k in the low nibbles and v in the high,
with the same scales), as `init_cache` builds it.
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
or int4 cache, or L >= 1024) and the cache is as wide as the query
(`kv_heads == heads`), else through dense attention over the layer's
slice; the MLP with int8 (int4) weights goes through the fused `int8_mlp`
(`int4_mlp`) kernel at decode with at most 32 tokens (a gated `silu_glu`
MLP never does), else through its `Int8Dense` (`Int4Dense`) projections;
an untied quantized `lm_head` goes through `ops.quant.int8_matmul` at
decode with at most 32 tokens, else through its `Int8Dense`. Two opt-in
fused decode routes, int8 weights only: `TextConfig.megakernel` sends a
one-token step of at most 8
rows over a cache in the activation dtype through
`ops.megakernel.decode_attn_megakernel` (norm_1, qkv, cached attention,
out-proj and residual in one call over the fused `attn/wqo_q` operand),
then norm_2 and `int8_mlp`; `TextConfig.fused_tail` sends the layer's tail
(out-proj + residual, norm_2, MLP + residual) through
`ops.quant.int8_attn_tail`. The megakernel check comes first. Both ask for
MPT's shape of layer (no biases, GELU, low-precision LayerNorm).

Masks, as the JAX module builds them: a padding mask rides the flash
kernel's "eq" ids, causal; `sequence_id` the same ids with pad keys at -1;
`prefix_mask` (prefix-LM) the "ge" ids, not causal (prefix keys id 0, the
others their position), with the symmetric ALiBi bias; both together a
materialised [B, 1, S, S] bias. A cached step of S > 1 tokens (chunked
prefill, speculative windows) adds a block-causal bias over the cache:
the query at cache_pos + i attends the cache up to that position.

Not ported: LoRA adapters; the constructor refuses them.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from otter_tpu_torch.config import OtterConfig, TextConfig
from otter_tpu_torch.models.xattn import GatedCrossAttentionBlock
from otter_tpu_torch.ops import decode_attention as da
from otter_tpu_torch.ops import megakernel as mk
from otter_tpu_torch.ops import quant as quant_ops
from otter_tpu_torch.ops.attention import multi_head_attention
from otter_tpu_torch.ops.layers import (ACTIVATIONS, LayerNorm, RMSNorm,
                                        cached_rotary_tables, rotate,
                                        select_rotary)
from otter_tpu_torch.ops.masks import (DEFAULT_MASK_VALUE, alibi_bias,
                                       alibi_slopes, mask_to_bias)

Cache = Dict[str, torch.Tensor]


ARCHS = ("mpt", "mosaic_gpt", "llama", "falcon", "persimmon")


def _norm(c: TextConfig, dtype, device) -> nn.Module:
    """The block norm by `norm_type`. MPT removes the LayerNorm biases
    (`modeling_mpt.py:83-87`); falcon keeps them even with bias-free
    linears (`falcon/modelling_RW.py:368`)."""
    if c.norm_type == "rmsnorm":
        return RMSNorm(c.hidden_size, eps=c.norm_eps, dtype=dtype,
                       device=device)
    return LayerNorm(c.hidden_size, eps=c.norm_eps,
                     use_bias=(not c.no_bias) or c.arch == "falcon",
                     dtype=dtype, device=device)


def cache_len_of(cache: Cache) -> int:
    """Sequence capacity of a cache."""
    return cache["kv" if "kv" in cache else "k"].shape[3]


def write_cache(cache: Cache, layer: int, k: torch.Tensor, v: torch.Tensor,
                pos: Union[int, torch.Tensor]) -> None:
    """Write k/v [B, H, S, D] at offset `pos` (an int, or per-row offsets
    [B]: row r's S positions go to pos[r] .. pos[r] + S - 1) into this
    layer's slot of the stacked cache, in place, quantizing when the cache
    is int8 or int4."""
    b, _, s, _ = k.shape
    if "kv" in cache:
        kvq, ks, vs = quant_ops.quantize_kv_int4(k, v)
        vals = {"kv": kvq, "k_scale": ks, "v_scale": vs}
    elif cache["k"].dtype == torch.int8:
        # k and v quantized in one pass (rows are independent)
        kvq, kvs = quant_ops.quantize_kv(torch.stack([k, v]))
        vals = {"k": kvq[0], "v": kvq[1], "k_scale": kvs[0],
                "v_scale": kvs[1]}
    else:
        vals = {"k": k, "v": v}
    for key, val in vals.items():
        dst = cache[key]
        val = val.to(dst.dtype)
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            rows = torch.arange(b, device=pos.device)[:, None]
            cols = pos[:, None] + torch.arange(s, device=pos.device)[None, :]
            dst[rows, layer, :, cols] = val.transpose(1, 2)   # [B, S, H(, D)]
        else:
            dst[:, layer, :, pos:pos + s] = val


def dense_decode_attention(q, k, v, kv_valid, bias, *, sm_scale):
    """Dense attention for cached decoding (small q_len against
    [B, H_kv, L, D]); kv_valid bool [B, L] marks attendable entries."""
    h, hk = q.shape[1], k.shape[1]
    if hk != h:
        k = k.repeat_interleave(h // hk, dim=1)
        v = v.repeat_interleave(h // hk, dim=1)
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
        self.cfg = cfg
        c, d = cfg, cfg.hidden_size
        h, hk, hd = c.num_attention_heads, c.kv_heads, c.head_dim
        kw = dict(use_bias=not c.no_bias, dtype=dtype, device=device)
        dense = lambda n_in, n_out: quant_ops.make_dense(c.quant, n_in,
                                                         n_out, **kw)
        if c.arch == "llama":
            self.q_proj = dense(d, h * hd)
            self.k_proj = dense(d, hk * hd)
            self.v_proj = dense(d, hk * hd)
        elif c.arch == "falcon":
            # fused multiquery layout [q (h*d) | k (hk*d) | v (hk*d)]
            self.Wqkv = dense(d, (h + 2 * hk) * hd)
        elif c.arch == "persimmon" or hk == h:
            self.Wqkv = dense(d, 3 * d)
        else:
            # mpt / mosaic_gpt multiquery: [q (d_model) | k | v (hk*d each)]
            self.Wqkv = dense(d, d + 2 * hk * hd)
        if c.qk_ln and c.arch in ("mpt", "mosaic_gpt"):
            # full-width LayerNorm on q and k (`mpt/attention.py:246-251`)
            ln = dict(eps=c.norm_eps, use_bias=not c.no_bias, dtype=dtype,
                      device=device)
            self.q_ln = LayerNorm(d, **ln)
            self.k_ln = LayerNorm(hk * hd, **ln)
        elif c.qk_ln and c.arch == "persimmon":
            # per-head LayerNorm before rope
            # (`fuyu/modeling_persimmon.py:286-287`)
            ln = dict(eps=c.norm_eps, use_bias=True, dtype=dtype,
                      device=device)
            self.q_ln, self.k_ln = LayerNorm(hd, **ln), LayerNorm(hd, **ln)
        elif c.qk_ln and c.arch == "llama":
            # idefics: per-head RMSNorm after rope
            ln = dict(eps=c.norm_eps, dtype=dtype, device=device)
            self.q_ln, self.k_ln = RMSNorm(hd, **ln), RMSNorm(hd, **ln)
        self.out_proj = dense(h * hd, d)
        if c.megakernel and c.quant == "int8":
            # the decode megakernel's fused [Wqkv | Wo] operand
            # (`ops.quant.add_fused_wqo` makes it at load time)
            self.register_buffer("wqo_q", torch.empty(
                d, 4 * d, dtype=torch.int8, device=device))
            self.register_buffer("wqo_scale", torch.ones(
                4 * d, dtype=torch.float32, device=device))

    def _use_decode_kernel(self, cache_k: torch.Tensor) -> bool:
        mode = self.cfg.decode_kernel
        if mode == "auto":
            return cache_k.shape[3] >= 1024 or cache_k.dtype == torch.int8
        return bool(mode)

    def _qkv(self, x):
        """The three projections of x [B, S, D], still [B, S, heads * d]."""
        c = self.cfg
        h, hk, d = c.num_attention_heads, c.kv_heads, c.head_dim
        if c.arch == "llama":
            return self.q_proj(x), self.k_proj(x), self.v_proj(x)
        qkv = self.Wqkv(x)
        if c.arch == "persimmon" or (c.arch != "falcon" and hk == h):
            return qkv.chunk(3, dim=-1)
        nq = h * d if c.arch == "falcon" else c.hidden_size
        return qkv.split([nq, hk * d, hk * d], dim=-1)

    def forward(self, x, *, layer: int, rope=None, attn_ids=None, bias=None,
                cache: Optional[Cache] = None, cache_pos=None,
                kv_valid=None, decode_span=None, project_out: bool = True):
        """x [B, S, D] -> [B, S, D]; with `project_out=False` the raw
        attention output [B, S, h*d], for a caller that runs the
        out-projection itself (the fused layer tail). `rope` is the pair
        of rotary rows selected at this call's positions
        (`ops.layers.select_rotary`) when `pos == "rope"`."""
        c = self.cfg
        b, s, _ = x.shape
        h, hk, d = c.num_attention_heads, c.kv_heads, c.head_dim
        sm_scale = d ** -0.5
        q, k, v = self._qkv(x)
        if c.clip_qkv:
            q, k, v = (t.clamp(-c.clip_qkv, c.clip_qkv) for t in (q, k, v))
        if c.qk_ln and c.arch in ("mpt", "mosaic_gpt"):
            q, k = self.q_ln(q), self.k_ln(k)
        q = q.reshape(b, s, h, d).transpose(1, 2)
        k = k.reshape(b, s, hk, d).transpose(1, 2)
        v = v.reshape(b, s, hk, d).transpose(1, 2)
        if c.qk_ln and c.arch == "persimmon":
            q, k = self.q_ln(q), self.k_ln(k)
        if rope is not None:
            q, k = rotate(q, *rope), rotate(k, *rope)
        if c.qk_ln and c.arch == "llama":
            q, k = self.q_ln(q), self.k_ln(k)
        if cache is not None and cache_pos is not None:
            write_cache(cache, layer, k, v, cache_pos)
            int4 = "kv" in cache   # k|v fused by nibble in one array
            main = cache["kv" if int4 else "k"]
            quant = main.dtype == torch.int8
            if self._use_decode_kernel(main) and s == 1 \
                    and h == main.shape[2]:
                lengths, starts = decode_span
                scales = ({"k_scale": cache["k_scale"],
                           "v_scale": cache["v_scale"],
                           "kv_bits": 4 if int4 else 8} if quant else {})
                out = da.decode_attention(
                    q[:, :, 0], main, main if int4 else cache["v"], lengths,
                    None if bias is None else bias[:, :, 0, :],
                    starts=starts, layer=layer, sm_scale=sm_scale,
                    **scales)[:, :, None, :]
            else:
                if int4:
                    ck, cv = quant_ops.dequantize_kv_int4(
                        main[:, layer], cache["k_scale"][:, layer],
                        cache["v_scale"][:, layer], q.dtype)
                else:
                    ck, cv = main[:, layer], cache["v"][:, layer]
                    if quant:
                        ck = quant_ops.dequantize_kv(
                            ck, cache["k_scale"][:, layer], q.dtype)
                        cv = quant_ops.dequantize_kv(
                            cv, cache["v_scale"][:, layer], q.dtype)
                out = dense_decode_attention(q, ck, cv, kv_valid, bias,
                                             sm_scale=sm_scale)
        else:
            # attn_ids: one [B, S] id array (padding / sequence_id: "eq",
            # causal) or a (q_ids, kv_ids, mode, causal) tuple (prefix-LM)
            if isinstance(attn_ids, tuple):
                qi, ki, ids_mode, causal = attn_ids
            else:
                qi = ki = attn_ids
                ids_mode, causal = "eq", True
            out = multi_head_attention(
                q, k, v, bias=bias, q_ids=qi, kv_ids=ki, ids_mode=ids_mode,
                causal=causal, sm_scale=sm_scale)
            if cache is not None:   # prefill writes from offset 0
                write_cache(cache, layer, k, v, 0)
        out = out.transpose(1, 2).reshape(b, s, h * d)
        return self.out_proj(out) if project_out else out


class MLP(nn.Module):
    def __init__(self, cfg: TextConfig, dtype, device):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        # the pair packs to int4 only without biases and without a gate
        # (`quantize_params_int4` keeps such MLPs at int8)
        self.int4 = cfg.quant == "int4" and cfg.no_bias \
            and cfg.act != "silu_glu"
        if self.int4:
            kw = dict(dtype=dtype, device=device)
            self.up_proj = quant_ops.Int4Dense(
                cfg.hidden_size, cfg.mlp_dim, pack_axis=0, **kw)
            self.down_proj = quant_ops.Int4Dense(
                cfg.mlp_dim, cfg.hidden_size, pack_axis=1, **kw)
        else:
            kw = dict(use_bias=not cfg.no_bias, dtype=dtype, device=device)
            if cfg.act == "silu_glu":
                self.gate_proj = quant_ops.make_dense(
                    cfg.quant, cfg.hidden_size, cfg.mlp_dim, **kw)
            self.up_proj = quant_ops.make_dense(cfg.quant, cfg.hidden_size,
                                                cfg.mlp_dim, **kw)
            self.down_proj = quant_ops.make_dense(cfg.quant, cfg.mlp_dim,
                                                  cfg.hidden_size, **kw)

    def forward(self, x, decoding: bool):
        c = self.cfg
        tokens = x.numel() // x.shape[-1]
        if decoding and self.int4 and tokens <= 32 \
                and c.act in ("gelu", "silu", "relu"):
            # decode: both int4 weight streams in one fused kernel launch
            up, down = self.up_proj, self.down_proj
            y = quant_ops.int4_mlp(
                x.reshape(tokens, -1).to(self.dtype), up.kernel_q4,
                up.scale_q, down.kernel_q4, down.scale_q, act=c.act)
            return y.reshape(x.shape[:-1] + (c.hidden_size,))
        if decoding and c.quant == "int8" and tokens <= 32 \
                and c.act in ("gelu", "silu", "relu", "sq_relu"):
            # decode: both int8 weight streams in one fused kernel launch
            # (with persimmon's biases and squared ReLU too)
            up, down = self.up_proj, self.down_proj
            y = quant_ops.int8_mlp(
                x.reshape(tokens, -1).to(self.dtype), up.kernel_q,
                up.scale_q, down.kernel_q, down.scale_q, act=c.act,
                b1=getattr(up, "bias", None), b2=getattr(down, "bias", None))
            return y.reshape(x.shape[:-1] + (c.hidden_size,))
        if c.act == "silu_glu":
            gate = ACTIVATIONS["silu"](self.gate_proj(x))
            return self.down_proj(gate * self.up_proj(x))
        return self.down_proj(ACTIVATIONS[c.act](self.up_proj(x)))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TextConfig, dtype, device):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.norm_1 = _norm(cfg, dtype, device)
        self.attn = SelfAttention(cfg, dtype, device)
        if cfg.arch != "falcon":   # falcon: attention and MLP off norm_1
            self.norm_2 = _norm(cfg, dtype, device)
        self.ffn = MLP(cfg, dtype, device)

    def _fused_eligible(self) -> bool:
        """What both fused decode routes ask of the configuration."""
        c = self.cfg
        return c.quant == "int8" and c.no_bias and c.act == "gelu" \
            and c.norm_type == "low_precision_layernorm"

    def forward(self, x, *, layer, rope=None, attn_ids=None, bias=None,
                cache=None, cache_pos=None, kv_valid=None, decode_span=None):
        c = self.cfg
        decoding = cache is not None and cache_pos is not None
        kw = dict(layer=layer, rope=rope, attn_ids=attn_ids, bias=bias,
                  cache=cache, cache_pos=cache_pos, kv_valid=kv_valid,
                  decode_span=decode_span)
        if c.arch == "falcon":
            # parallel attention + MLP off one norm
            # (`falcon/modelling_RW.py`: parallel_attn)
            ln = self.norm_1(x)
            return x + self.attn(ln, **kw) + self.ffn(ln, decoding=decoding)

        if (c.megakernel and self._fused_eligible() and not c.qk_ln
                and not c.clip_qkv and c.num_attention_heads == c.kv_heads
                and decoding and getattr(cache_pos, "ndim", 0) == 0
                and x.shape[1] == 1 and x.shape[0] <= 8
                and "k" in cache and cache["k"].dtype != torch.int8
                and bias is not None):
            # norm_1 + qkv + cached attention + out-proj + residual in one
            # call; the new token's k/v come back and are appended in
            # place. With one cache_pos for the batch the ALiBi column
            # bias is the same for every row. The kernel attends every
            # cache row below cache_pos (no kv_valid).
            y, kn, vn = mk.decode_attn_megakernel(
                x[:, 0].to(self.dtype), cache["k"], cache["v"], cache_pos,
                bias[0, :, 0, :].float(), self.norm_1.scale,
                self.attn.wqo_q, self.attn.wqo_scale, layer=layer,
                eps=c.norm_eps, sm_scale=c.head_dim ** -0.5)
            cache["k"][:, layer, :, cache_pos] = kn.to(cache["k"].dtype)
            cache["v"][:, layer, :, cache_pos] = vn.to(cache["v"].dtype)
            x = y[:, None, :]
            return x + self.ffn(self.norm_2(x), decoding=True)

        a = self.norm_1(x)
        tokens = x.numel() // x.shape[-1]
        if c.fused_tail and self._fused_eligible() and tokens <= 32 \
                and decoding:
            # out-proj + residual + norm_2 + MLP + residual in one call
            raw = self.attn(a, project_out=False, **kw)
            out, ffn = self.attn.out_proj, self.ffn
            y = quant_ops.int8_attn_tail(
                raw.reshape(tokens, -1).to(self.dtype),
                x.reshape(tokens, -1).to(self.dtype), out.kernel_q,
                out.scale_q, self.norm_2.scale, ffn.up_proj.kernel_q,
                ffn.up_proj.scale_q, ffn.down_proj.kernel_q,
                ffn.down_proj.scale_q, eps=c.norm_eps, act=c.act)
            return y.reshape(x.shape)

        x = x + self.attn(a, **kw)
        return x + self.ffn(self.norm_2(x), decoding=decoding)


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


def layer_inputs(c: TextConfig, x: torch.Tensor, dtype, *, positions=None,
                 attention_mask=None, prefix_mask=None, sequence_id=None,
                 cache: Optional[Cache] = None, cache_pos=None,
                 kv_valid=None):
    """What every `DecoderLayer` of one call takes besides x [B, S, D],
    made once a call: (positions, {"rope", "attn_ids", "bias",
    "decode_span"}). `positions` default to 0 .. S-1 (None under ALiBi);
    `rope` is the rotary rows at them; `decode_span` the (lengths, starts)
    of `kv_valid` that `decode_attention` takes; `attn_ids` and `bias`
    carry the masks (see the module docstring)."""
    b, s, _ = x.shape
    decoding = cache is not None and cache_pos is not None
    if c.pos != "alibi" and positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    rope = None
    if c.pos == "rope":
        rope = select_rotary(*cached_rotary_tables(
            int(c.head_dim * c.rope_partial_factor), c.max_seq_len,
            c.rope_theta, x.device), positions, dtype)
    bias = attn_ids = decode_span = None
    if decoding:
        L = cache_len_of(cache)
        idx = torch.arange(L, device=x.device)[None, :]
        valid = kv_valid.bool()
        # in the kernel's int32
        lengths = torch.where(valid, idx + 1, 0).amax(-1).int()
        starts = torch.where(valid, idx, L).amin(-1).int()
        decode_span = (lengths, starts)
    if c.pos == "alibi":
        slopes = alibi_slopes(c.num_attention_heads, c.alibi_bias_max,
                              device=x.device)[None, :, None, None]
        if decoding:
            # column j gets j * slope, softmax-shift-equivalent to the
            # reference's (j - query_pos) * slope for every query row
            bias = torch.arange(L, device=x.device)[None, None, None] \
                * slopes
        elif prefix_mask is not None:
            # bidirectional over the prefix: the symmetric -|i - j|
            # form (`build_alibi_bias(full=True)`)
            bias = alibi_bias(c.num_attention_heads, s, full=True,
                              alibi_bias_max=c.alibi_bias_max,
                              device=x.device)
        else:
            bias = torch.arange(1 - s, 1, device=x.device)[
                None, None, None] * slopes
    # (made only where a mask needs it: a decode step is host-bound)
    pos = None if decoding and s == 1 else torch.arange(s, device=x.device)
    if decoding:
        if s > 1:
            # block causality inside the step: the query at
            # cache_pos + i attends the cache up to that position
            cols = torch.arange(L, device=x.device)
            if isinstance(cache_pos, torch.Tensor) and cache_pos.dim():
                qpos = cache_pos[:, None] + pos[None, :]
                mb = mask_to_bias(cols[None, None, :]
                                  <= qpos[:, :, None])[:, None]
            else:
                qpos = cache_pos + pos
                mb = mask_to_bias(cols[None, :] <= qpos[:, None])[None, None]
            bias = mb if bias is None else bias + mb
    elif prefix_mask is not None and sequence_id is not None:
        # both restrictions cannot ride one id comparison: a
        # materialised bias, as the reference builds
        # (`modeling_mpt.py:147-172`)
        allowed = (pos[None, :, None] >= pos[None, None, :]) \
            | prefix_mask.bool()[:, None, :]
        allowed = allowed & (sequence_id[:, :, None]
                             == sequence_id[:, None, :])
        if attention_mask is not None:
            allowed = allowed & (attention_mask > 0)[:, None, :]
        mb = mask_to_bias(allowed)[:, None]
        bias = mb if bias is None else bias + mb
        attn_ids = (None, None, "eq", False)
    elif prefix_mask is not None:
        # the kernel's "ge" ids: queries their position, prefix keys 0,
        # other keys their position (q_id >= kv_id <=> key in prefix or
        # key <= query), pad keys s + 1 (attended by nothing)
        ok = (attention_mask > 0 if attention_mask is not None
              else torch.ones((b, s), dtype=torch.bool, device=x.device))
        ki = torch.where(prefix_mask.bool() & ok, 0, pos[None, :])
        ki = torch.where(ok, ki, s + 1)
        attn_ids = (pos[None, :].expand(b, s).int(), ki.int(), "ge", False)
    elif sequence_id is not None:
        # block-diagonal same-document attention: pad keys id -1
        attn_ids = sequence_id.int()
        if attention_mask is not None:
            attn_ids = torch.where(attention_mask > 0, attn_ids, -1)
    elif attention_mask is not None:
        attn_ids = attention_mask.int()
    return positions, dict(rope=rope, attn_ids=attn_ids, bias=bias,
                           decode_span=decode_span)


class Decoder(nn.Module):
    """Causal LM with an optional gated cross-attention interleave."""

    def __init__(self, cfg: TextConfig, otter_cfg: Optional[OtterConfig] = None,
                 dtype=torch.float32, device=None, remat: bool = False):
        super().__init__()
        self.remat = remat
        if cfg.arch not in ARCHS or cfg.pos not in ("alibi", "rope",
                                                    "learned"):
            raise ValueError(f"decoder: arch {cfg.arch!r}, pos {cfg.pos!r}")
        missing = [name for name, on in (
            ("lora_rank", cfg.lora_rank),
            (f"quant={cfg.quant!r}",
             cfg.quant not in (None, "int8", "int4"))) if on]
        if missing:
            raise NotImplementedError(
                f"not ported yet: {', '.join(missing)}")
        if cfg.quant_embed and cfg.tie_embeddings:
            raise ValueError(
                "quant_embed requires untied embeddings (the tied head "
                "would re-read the quantized table at matmul precision)")
        self.cfg, self.otter_cfg, self.dtype = cfg, otter_cfg, dtype
        if cfg.quant_embed:
            # int8 table with per-row scales (`ops.quant.quantize_embed`)
            self.register_buffer("wte_q", torch.empty(
                cfg.total_vocab, cfg.hidden_size, dtype=torch.int8,
                device=device))
            self.register_buffer("wte_s", torch.ones(
                cfg.total_vocab, dtype=torch.float32, device=device))
        else:
            self.wte = Embed(cfg.total_vocab, cfg.hidden_size, dtype, device)
        if cfg.pos == "learned":
            self.wpe = nn.Parameter(torch.empty(
                cfg.max_seq_len, cfg.hidden_size, dtype=torch.float32,
                device=device))
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
        self.norm_f = _norm(cfg, dtype, device)
        if not cfg.tie_embeddings:
            # untied heads follow the weight-quant policy
            self.lm_head = quant_ops.make_dense(
                cfg.quant, cfg.hidden_size, cfg.total_vocab, use_bias=False,
                dtype=dtype, device=device)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        if self.cfg.quant_embed:
            return (self.wte_q[input_ids].to(self.dtype)
                    * self.wte_s[input_ids][..., None].to(self.dtype))
        return self.wte(input_ids)

    def forward(self, input_ids, *, merge_embeds=None, attention_mask=None,
                positions=None, prefix_mask=None, sequence_id=None,
                vis_latents=None,
                xattn_q_ids=None, xattn_kv_ids=None, xattn_out_keep=None,
                cache: Optional[Cache] = None, cache_pos=None,
                kv_valid=None, output_hidden: bool = False,
                head_last_only: bool = False, skip_head: bool = False):
        """Prefill/forward: cache None (no cache: training) or a
        preallocated cache with cache_pos None (prefill writes from offset
        0). Decode: cache_pos set (an int, or per-row offsets [B]) and
        kv_valid [B, L] marking attendable entries; a step may hold several
        tokens. `positions` [B, S] are
        the tokens' positions for rope and learned embeddings (default
        0 .. S-1). `merge_embeds` (values [B, S, H], mask [B, S]) puts
        `values` in place of the token embedding where the mask is set
        (Fuyu's image patches). `prefix_mask` bool [B, S] (prefix-LM: a
        query attends a key iff key <= query or the key is in the prefix)
        and `sequence_id` int [B, S] (attention only within one id) are
        prefill / training arguments. Returns (logits [B, S|1, V], cache),
        with output_hidden also the final hidden states, or with skip_head
        the final-norm hidden states [B, S, D] in place of the logits."""
        c = self.cfg
        x = self.embed(input_ids)
        if merge_embeds is not None:
            values, vmask = merge_embeds
            x = torch.where(vmask[..., None], values.to(x.dtype), x)
        decoding = cache is not None and cache_pos is not None
        if c.prefix_lm and prefix_mask is None and not decoding:
            # the reference's error (`modeling_mpt.py:206`)
            raise ValueError("prefix_mask is a required argument when the "
                             "decoder is configured with prefix_lm=True")
        positions, kw = layer_inputs(
            c, x, self.dtype, positions=positions,
            attention_mask=attention_mask, prefix_mask=prefix_mask,
            sequence_id=sequence_id, cache=cache, cache_pos=cache_pos,
            kv_valid=kv_valid)
        if c.pos == "learned":
            x = x + self.wpe.to(self.dtype)[positions]
        for i in range(c.num_hidden_layers):
            if self.xattn_every and (i + 1) % self.xattn_every == 0 \
                    and vis_latents is not None:
                x = getattr(self, f"xattn_{i}")(
                    x, vis_latents, xattn_q_ids, xattn_kv_ids, xattn_out_keep)
            layer = getattr(self, f"layers_{i}")
            if self.remat and cache is None and torch.is_grad_enabled():
                # keep only the layer's input; recompute the rest backward
                x = checkpoint(layer, x, layer=i, rope=kw["rope"],
                               attn_ids=kw["attn_ids"], bias=kw["bias"],
                               use_reentrant=False)
            else:
                x = layer(x, layer=i, cache=cache, cache_pos=cache_pos,
                          kv_valid=kv_valid, **kw)
        x = self.norm_f(x)
        if skip_head:
            return x, cache
        if head_last_only:
            x = x[:, -1:]
        if c.tie_embeddings:
            logits = self.wte.attend(x)
        else:
            tokens = x.shape[0] * x.shape[1]
            if c.quant in ("int8", "int4") and tokens <= 32 and decoding:
                # the head's read is the largest of a decode step and
                # nothing overlaps it: one streamed int8 product
                flat = x.reshape(tokens, c.hidden_size).to(self.dtype)
                logits = quant_ops.int8_matmul(
                    flat, self.lm_head.kernel_q, self.lm_head.scale_q
                ).reshape(x.shape[:2] + (c.total_vocab,))
            else:
                logits = self.lm_head(x)
        if c.logit_scale is not None:
            logits = logits * c.logit_scale
        if output_hidden:
            return logits, cache, x
        return logits, cache


def init_cache(cfg: TextConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Cache:
    """Preallocated stacked KV cache [batch, n_layers, kv_heads, max_len,
    head_dim]; dtype torch.int8 (or "int8") adds f32 per-(position, head)
    scales [batch, n_layers, kv_heads, max_len]; dtype "int4" holds k and
    v in one int8 array `kv` of that shape (byte = k4 | v4 << 4) with the
    same scales."""
    int4 = dtype == "int4"
    if dtype in ("int8", "int4"):
        dtype = torch.int8
    shape = (batch, cfg.num_hidden_layers, cfg.kv_heads, max_len,
             cfg.head_dim)
    if int4:
        cache = {"kv": torch.zeros(shape, dtype=dtype, device=device)}
    else:
        cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
    return cache
