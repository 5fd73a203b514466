"""Single-query cached attention (counterpart of
`otter_tpu/ops/decode_attention.py`).

`decode_attention` launches the hand-written CUDA kernel
`csrc/decode_attention.cu` for CUDA tensors and runs
`decode_attention_plain` for CPU tensors. It reads the stacked cache
[B, n_layers, H, L, D] with the layer chosen by index (no per-layer copy
of the cache), attends only positions in [starts[b], lengths[b]), adds an
optional ALiBi column bias [B|1, H|1, L], and takes bf16, int8 or int4
caches (quantized caches with f32 per-position scales: the k scale
multiplies the logits after q.k, the v scale the probabilities before
p.v). An int4 cache (`kv_bits=4`) is one fused array, k in the low nibble
of each byte and v in the high (`ops.quant.quantize_kv_int4`), passed as
both `k` and `v` and read through one pointer.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from otter_tpu_torch import _build
from otter_tpu_torch.ops.masks import DEFAULT_MASK_VALUE

_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
_SIGNATURES = {"decode_attention_bf16": (
    [_P, _P, _P, _P, _P, _I, _P, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _I,
     _I, _F, _P], _I)}


def decode_attention_plain(q, k, v, lengths, bias=None, starts=None, *,
                           k_scale=None, v_scale=None, kv_bits: int = 8,
                           layer: Optional[int] = None, sm_scale=None,
                           mask_value=DEFAULT_MASK_VALUE):
    """The kernel's function in plain PyTorch, one block covering the
    whole cache."""
    if layer is not None:
        k, v = k[:, layer], v[:, layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[:, layer], v_scale[:, layer]
    if kv_bits == 4 and k_scale is not None:
        k, v = ((k & 0xF) ^ 8) - 8, v >> 4   # sign-extended nibbles
    L, d = k.shape[2], q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    quant = k_scale is not None
    if starts is None:
        starts = torch.zeros_like(lengths)
    kk = k.to(q.dtype) if quant else k
    s = torch.einsum("bhd,bhld->bhl", q.float(), kk.float())
    if quant:
        s = s * k_scale.float()
    s = s * sm_scale
    if bias is not None:
        s = s + bias.float()
    pos = torch.arange(L, device=q.device)[None, None, :]
    ok = (pos < lengths.long()[:, None, None]) \
        & (pos >= starts.long()[:, None, None])
    s = torch.where(ok, s, torch.full_like(s, mask_value))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    if quant:
        p = p * v_scale.float()
    vv = v.to(q.dtype) if quant else v
    o = torch.einsum("bhl,bhld->bhd", p.to(vv.dtype).float(), vv.float())
    l_inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    return (o * l_inv[..., None]).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     starts: Optional[torch.Tensor] = None, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     kv_bits: int = 8, layer: Optional[int] = None,
                     sm_scale: Optional[float] = None,
                     mask_value: float = DEFAULT_MASK_VALUE) -> torch.Tensor:
    """q [B, H, D]; k/v [B, H, L, D], or the stacked [B, n_layers, H, L, D]
    cache with `layer` given (scales [B(, n_layers), H, L]); lengths and
    starts [B] int. -> [B, H, D]. With scales and `kv_bits=4`, k and v are
    the same fused int4 array. CUDA tensors: q bf16, cache bf16 or int8,
    D in {64, 128}."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k, v, lengths, bias, starts, k_scale=k_scale,
            v_scale=v_scale, kv_bits=kv_bits, layer=layer,
            sm_scale=sm_scale, mask_value=mask_value)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b, h, d = q.shape
    if layer is None:   # one layer: a stacked cache of depth 1
        k, v, layer = k[:, None], v[:, None], 0
        if k_scale is not None:
            k_scale, v_scale = k_scale[:, None], v_scale[:, None]
    nl, L = k.shape[1], k.shape[3]
    if k.shape != (b, nl, h, L, d) or v.shape != k.shape \
            or not 0 <= layer < nl:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, cache "
                         f"{tuple(k.shape)}, layer {layer}")
    quant = k_scale is not None
    int4 = quant and kv_bits == 4
    want = torch.int8 if quant else torch.bfloat16
    if q.dtype != torch.bfloat16 or k.dtype != want or v.dtype != want:
        raise TypeError("decode_attention kernel takes bf16 q with a bf16 "
                        "cache, or an int8 or fused int4 cache with scales")
    if int4 and (v.data_ptr() != k.data_ptr() or v.stride() != k.stride()):
        raise ValueError("decode_attention kernel: an int4 cache is one "
                         "fused array, passed as both k and v")
    if d not in (64, 128):
        raise ValueError(f"decode_attention kernel: head dim {d}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention kernel: the cache must be "
                         "contiguous (it is read in place, never copied)")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention kernel: misaligned cache")
    if quant and not (k_scale.is_contiguous() and v_scale.is_contiguous()
                      and k_scale.dtype == torch.float32
                      and v_scale.dtype == torch.float32
                      and k_scale.shape == k.shape[:4]
                      and v_scale.shape == k.shape[:4]):
        raise ValueError("decode_attention kernel: scales must be "
                         "contiguous f32 [B, n_layers, H, L]")
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    q = q.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    starts = (torch.zeros_like(lengths) if starts is None
              else starts.to(torch.int32).contiguous())
    bias_ptr, bstrides = None, (0, 0)
    if bias is not None:
        bias = bias.float()
        if bias.dim() != 3 or bias.shape[0] not in (1, b) \
                or bias.shape[1] not in (1, h) or bias.shape[2] != L:
            raise ValueError(f"decode_attention: bias {tuple(bias.shape)}")
        if bias.stride(2) != 1:
            bias = bias.contiguous()
        bstrides = tuple(0 if n == 1 else st for n, st in
                         zip(bias.shape[:2], bias.stride()[:2]))
        bias_ptr = bias.data_ptr()
    out = torch.empty_like(q)
    lib = _build.library("decode_attention", _SIGNATURES)
    err = lib.decode_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, 2 if int4 else int(quant),
        bias_ptr,
        *bstrides, lengths.data_ptr(), starts.data_ptr(), out.data_ptr(),
        b, h, nl, layer, L, d, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "decode_attention")
    decode_attention.launches += 1
    decode_attention.launches_int4 += int4
    return out


decode_attention.launches = 0        # every launch
decode_attention.launches_int4 = 0   # those over an int4 cache
