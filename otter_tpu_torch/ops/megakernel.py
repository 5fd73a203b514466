"""The attention half of an MPT decode layer in one kernel call
(counterpart of `otter_tpu/ops/megakernel.py`):

    n      = LayerNorm(x) * ln1_scale                 (norm_1, f32 stats)
    qkv    = (n @ wqkv) * s_qkv                       (int8, column scales)
    attn_h = softmax(q_h . [K_h[:pos] | k_new_h] * sm + alibi) . [V_h | v_new_h]
    y      = x + (attn @ wo) * s_wo                   (out-proj + residual)

returning (y, k_new, v_new). `wqo` [d, 4d] int8 holds `wqkv | wo` side by
side (`ops.quant.add_fused_wqo`). The KV cache is read inside the call,
rows below `pos` only; the new token's k/v never come from the cache: they
enter the softmax from the kernel's own qkv, and the caller appends them
at `pos` (`mpt_decode_layer_megakernel` does, in place).

`pos` is a 0-d int tensor, read by the kernel from device memory as the
TPU kernel reads its scalar-prefetch operand: one launch, and a CUDA graph
that recorded it, serves every position, and the host never reads it. A
host int (tests, a single call) is checked against the cache on the host
and handed to the kernel as a device int32. On the card a position outside
the cache traps inside the kernel (`csrc/megakernel.cu`): the launch fails
and the next synchronisation raises; nothing outside the cache is read or
written.

`decode_attn_megakernel` launches the hand-written CUDA kernels of
`csrc/megakernel.cu` for CUDA tensors and runs
`decode_attn_megakernel_plain` for CPU tensors. Scope, as the JAX
function's: MPT (ALiBi column bias, weight-only LayerNorm, fused Wqkv, no
biases, heads == kv heads), one position `pos` for the whole batch, a
cache in the activation dtype, one new token a row, at most 8 rows. It
takes no `kv_valid`: every cache row below `pos` is attended, so
left-padded rows attend their pad slots.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from otter_tpu_torch import _build
from otter_tpu_torch.ops import decode_attention as da
from otter_tpu_torch.ops import quant
from otter_tpu_torch.ops.layers import layer_norm

_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
_SIGNATURES = {"decode_attn_megakernel_bf16": (
    [_P] * 4 + [_LL] + [_P] * 13 + [_I] * 7 + [_F, _F] + [_I] * 4 + [_P],
    _I)}
_POS_DTYPES = (torch.int32, torch.int64)

# head dims the kernel takes
KERNEL_HEAD_DIMS = (64, 128)


def attention_plan(b: int, h: int, cache_len: int, dh: int):
    """(splits, min_rows) of the kernel's attention phase: each (batch,
    head)'s span [0, pos) is cut into at most `splits` chunks of at least
    `min_rows` rows (`decode_attention.split_chunks(0, pos, ...)`), one CTA
    a chunk, as `decode_attention` splits a bf16 cache: B * H * splits CTAs
    within one wave of the card where B * H allows. A pure function of the
    shapes (the cache length, not pos), so a step's grid does not move
    with pos."""
    return da.split_plan(b, h, cache_len, dh, 0)


def _layer_of(cache: torch.Tensor, layer: Optional[int]) -> torch.Tensor:
    return cache if layer is None else cache[:, layer]


def decode_attn_megakernel_plain(x, k_cache, v_cache, pos, bias_col,
                                 ln1_scale, wqo, sqo, *,
                                 layer: Optional[int] = None,
                                 eps: float = 1e-5,
                                 sm_scale: Optional[float] = None):
    """The kernel's function in plain PyTorch, rounding where the kernel
    rounds: the norm, q, k_new and v_new (where they enter the new token's
    logit and value) and the attention output to x's dtype, p to the
    cache's dtype before p.V, the out-projection to x's dtype before the
    residual is added in f32; qkv stays f32 after its scale. `pos` an int
    or a 0-d tensor (read on the host)."""
    dt = x.dtype
    pos = int(pos)
    kc, vc = _layer_of(k_cache, layer), _layer_of(v_cache, layer)
    b, h, _, dh = kc.shape
    d = x.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (dh ** 0.5)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    normed = ((xf - mean) * torch.rsqrt(var + eps) * ln1_scale.float()).to(dt)
    qkv = (normed.float() @ wqo[:, :3 * d].to(dt).float()) \
        * sqo[:3 * d].float()
    q, kn, vn = (t.reshape(b, h, dh) for t in qkv.split(d, dim=-1))
    qa, kna, vna = q.to(dt).float(), kn.to(dt).float(), vn.to(dt).float()
    # cache rows below pos, then the new token as one more column
    s = torch.einsum("bhd,bhld->bhl", qa, kc[:, :, :pos].float()) * sm_scale
    s_new = (qa * kna).sum(-1, keepdim=True) * sm_scale
    if bias_col is not None:
        s = s + bias_col[:, :pos].float()
        s_new = s_new + bias_col[:, pos, None].float()
    logits = torch.cat([s, s_new], dim=-1)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhl,bhld->bhd", p[..., :pos].to(vc.dtype).float(),
                     vc[:, :, :pos].float()) + p[..., pos:] * vna
    attn = (o / l).to(dt).reshape(b, d)
    out = (attn.float() @ wqo[:, 3 * d:].to(dt).float()) * sqo[3 * d:].float()
    y = (xf + out.to(dt).float()).to(dt)
    return y, kn.to(k_cache.dtype), vn.to(v_cache.dtype)


def decode_attn_megakernel(
        x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
        pos: Union[int, torch.Tensor], bias_col: Optional[torch.Tensor],
        ln1_scale: torch.Tensor,
        wqo: torch.Tensor, sqo: torch.Tensor, *, layer: Optional[int] = None,
        eps: float = 1e-5, sm_scale: Optional[float] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, D]; k_cache/v_cache [B, H, L, Dh], or the stacked
    [B, n_layers, H, L, Dh] cache with `layer` given (read only); `pos` the
    new token's index (rows below it are attended), a 0-d int32 / int64
    tensor on x's device or a host int; bias_col [H, L] f32 or
    None; ln1_scale [D]; wqo [D, 4D] int8; sqo [4D] f32. Returns
    (y [B, D], k_new [B, H, Dh], v_new [B, H, Dh]). CUDA tensors: bf16 x
    and cache, B <= 8, Dh in {64, 128}, D % 128 == 0, contiguous and
    16-byte aligned."""
    stacked = layer is not None
    if k_cache.dim() != (5 if stacked else 4) or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attn_megakernel: cache "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}, "
                         f"layer {layer}")
    bsz, d = x.shape
    h, L, dh = k_cache.shape[-3:]
    if isinstance(pos, torch.Tensor):
        if pos.dim() != 0 or pos.dtype not in _POS_DTYPES \
                or pos.device != x.device:
            raise ValueError(f"decode_attn_megakernel: pos must be a 0-d "
                             f"int32 / int64 tensor on {x.device}, not "
                             f"{pos.dtype} {tuple(pos.shape)} on "
                             f"{pos.device}")
    else:
        pos = int(pos)
    if k_cache.shape[0] != bsz or h * dh != d or wqo.shape != (d, 4 * d) \
            or sqo.shape != (4 * d,) or ln1_scale.shape != (d,) \
            or (bias_col is not None and (bias_col.dim() != 2
                                          or bias_col.shape[0] != h
                                          or bias_col.shape[1] < L)):
        raise ValueError(
            f"decode_attn_megakernel: x {tuple(x.shape)}, cache "
            f"{tuple(k_cache.shape)}, wqo {tuple(wqo.shape)}, sqo "
            f"{tuple(sqo.shape)}, bias_col "
            f"{None if bias_col is None else tuple(bias_col.shape)}")
    # (a device position is checked by the kernel: the host never reads it)
    if (not isinstance(pos, torch.Tensor) or pos.device.type == "cpu") \
            and not 0 <= int(pos) < L:
        raise ValueError(f"decode_attn_megakernel: pos {int(pos)} outside "
                         f"the cache of {L}")
    if wqo.dtype != torch.int8:
        raise TypeError("decode_attn_megakernel: wqo must be int8")
    if x.device.type == "cpu":
        return decode_attn_megakernel_plain(
            x, k_cache, v_cache, pos, bias_col, ln1_scale, wqo, sqo,
            layer=layer, eps=eps, sm_scale=sm_scale)
    if x.device.type != "cuda":
        raise ValueError(f"decode_attn_megakernel: unsupported device "
                         f"{x.device}")
    if x.dtype != torch.bfloat16 or k_cache.dtype != torch.bfloat16 \
            or v_cache.dtype != torch.bfloat16:
        raise TypeError("decode_attn_megakernel kernel takes bf16 x and a "
                        "bf16 cache")
    if bsz > 8 or dh not in KERNEL_HEAD_DIMS or d % 128 or d > 12288:
        raise ValueError(f"decode_attn_megakernel kernel: B={bsz} (<= 8), "
                         f"head dim {dh} (64 or 128), D={d} (% 128, "
                         f"<= 12288)")
    if not stacked:   # one layer: a stacked cache of depth 1
        k_cache, v_cache, layer = k_cache[:, None], v_cache[:, None], 0
    nl = k_cache.shape[1]
    if not 0 <= layer < nl:
        raise ValueError(f"decode_attn_megakernel: layer {layer} of {nl}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (x, k_cache, v_cache, wqo)):
        raise ValueError("decode_attn_megakernel kernel: x, the cache (read "
                         "in place, never copied) and wqo must be contiguous "
                         "and 16-byte aligned")
    if sm_scale is None:
        sm_scale = 1.0 / (dh ** 0.5)
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.int32, device=x.device)
    ln1_scale, sqo = ln1_scale.float().contiguous(), sqo.float().contiguous()
    bias_ptr, bias_sh = None, 0
    if bias_col is not None:
        bias_col = bias_col.float()
        if bias_col.stride(1) != 1:
            bias_col = bias_col.contiguous()
        bias_ptr, bias_sh = bias_col.data_ptr(), bias_col.stride(0)
    dev = x.device
    splits_qkv = quant.split_k_rows(d, 3 * d, bsz)
    splits_o = quant.split_k_rows(d, d, bsz)
    # two allocations (a decode step is bound by the host): the outputs
    # y | k_new | v_new, and the scratch ws_qkv | ws_o (f32) | normed | attn
    out = torch.empty((3, bsz, d), dtype=torch.bfloat16, device=dev)
    n_qkv, n_o = splits_qkv * bsz * 3 * d, splits_o * bsz * d
    scratch = torch.empty(n_qkv + n_o + bsz * d, dtype=torch.float32,
                          device=dev)
    ws_qkv = scratch.data_ptr()
    ws_o = ws_qkv + 4 * n_qkv
    normed = ws_o + 4 * n_o
    attn = normed + 2 * bsz * d
    # the attention chunks' partials and counters: decode_attention's
    # workspace, of the same layout, kept per device (the counters are 0
    # between calls); calls on one stream use it in turn, and a captured
    # step uses the one its graph owns (`decode_attention.owned_workspace`)
    attn_splits, min_rows = attention_plan(bsz, h, L, dh)
    part = counters = None
    if attn_splits > 1:
        part, counters = (t.data_ptr() for t in da._workspace(
            dev, *da.workspace_size(bsz, h, attn_splits, dh)))
    y, k_new, v_new = out[0], out[1].view(bsz, h, dh), out[2].view(bsz, h, dh)
    lib = _build.library("megakernel", _SIGNATURES)
    err = lib.decode_attn_megakernel_bf16(
        x.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), bias_ptr,
        bias_sh, ln1_scale.data_ptr(), wqo.data_ptr(), sqo.data_ptr(),
        normed, ws_qkv, attn, ws_o, part, counters,
        y.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), pos.data_ptr(),
        int(pos.dtype == torch.int64), bsz, h, dh, nl, layer, L, float(eps),
        float(sm_scale), splits_qkv, splits_o,
        attn_splits, min_rows, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "decode_attn_megakernel")
    _build.count_launch(decode_attn_megakernel)
    return y, k_new, v_new


decode_attn_megakernel.launches = 0


def mpt_decode_layer_megakernel(x, k_cache, v_cache, pos, bias_col,
                                ln1_scale, wqo, sqo, ln2_scale, w1q, s1, w2q,
                                s2, *, layer: Optional[int] = None,
                                eps: float = 1e-5):
    """A whole MPT decode layer: the megakernel's attention half, the new
    token's k/v appended at `pos` (in place: the caches passed in are the
    ones returned; a 0-d tensor position by `index_copy_`, read on the
    device), norm_2 and the fused int8 MLP. Returns
    (x_out [B, D], k_cache, v_cache)."""
    y, kn, vn = decode_attn_megakernel(
        x, k_cache, v_cache, pos, bias_col, ln1_scale, wqo, sqo, layer=layer,
        eps=eps)
    for cache, new in ((k_cache, kn), (v_cache, vn)):
        dst = _layer_of(cache, layer)
        if isinstance(pos, torch.Tensor):
            dst.index_copy_(2, pos.view(1).long(), new[:, :, None].to(
                cache.dtype))
        else:
            dst[:, :, pos] = new.to(cache.dtype)
    n2 = layer_norm(y, ln2_scale, None, eps=eps)
    mlp = quant.int8_mlp(n2, w1q, s1, w2q, s2, act="gelu")
    return y + mlp.to(y.dtype), k_cache, v_cache
