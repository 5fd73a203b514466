"""Int8 and int4 weight-only quantization (counterpart of
`otter_tpu/ops/quant.py`).

int8: weights are stored int8 [in, out] with per-output-channel f32 scales
(`kernel_q`, `scale_q`, the flax leaf names). `Int8Dense` applies the
scale on the output side; `int8_mlp` is the fused decode MLP, which
launches the hand-written kernel `csrc/int8_mlp.cu` for CUDA tensors and
runs `int8_mlp_plain` for CPU tensors. `int8_attn_tail` is the fused tail
of a decode layer (attention out-projection + residual, LayerNorm, int8
MLP + residual; `csrc/int8_attn_tail.cu`), and `add_fused_wqo` adds the
fused `[Wqkv | Wo]` operand of the decode megakernel (`ops/megakernel.py`).
`int8_matmul` is the single streamed product `(x @ kernel_q) * scale` of
the untied `lm_head` at decode (`csrc/int8_matmul.cu`; no other projection
goes through it: `Int8Dense` keeps its composed product, as in the JAX
package). `quantize_embed` gives the int8 embedding table of
`TextConfig(quant_embed=True)`. `quantize_kv` / `dequantize_kv` give the
int8 KV-cache layout, byte for byte the JAX package's.

int4: two weights a byte (`kernel_q4`), values in [-7, 7], paired half and
half along `pack_axis` (`quantize_kernel_int4`). `int4_mlp` is the fused
decode MLP over an up/down pair and `int4_matmul` a single packed product;
both launch `csrc/int4_mlp.cu` for CUDA tensors and run their plain
versions for CPU tensors. `Int4Dense` unpacks and multiplies (prefill
shapes). `quantize_kv_int4` fuses a k and a v cache entry into one byte
(k in the low nibble, v in the high).
"""

from __future__ import annotations

import ctypes
import re
from collections.abc import Mapping
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from otter_tpu_torch import _build
from otter_tpu_torch.ops.decode_attention import SM_COUNT
from otter_tpu_torch.ops.layers import ACTIVATIONS, Dense

_ACT_IDS = {"gelu": 0, "relu": 1, "silu": 2, "sq_relu": 3}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"int8_mlp_bf16": ([_P] * 9 + [_I] * 5 + [_P], _I)}
_SIGNATURES_MATMUL = {"int8_matmul_bf16": (
    [_P] * 4 + [_I] * 3 + [ctypes.c_longlong, _P], _I)}
_SIGNATURES_TAIL = {"int8_attn_tail_bf16": (
    [_P] * 14 + [_I] * 4 + [ctypes.c_float, _I, _I, _P], _I)}
_SIGNATURES_INT4 = {"int4_mlp_bf16": ([_P] * 7 + [_I] * 5 + [_P], _I),
                    "int4_matmul_bf16": ([_P] * 5 + [_I] * 4 + [_P], _I)}


class _Int8Product(torch.autograd.Function):
    """(x @ kernel_q) * scale for an `x` that needs its gradient: saves the
    int8 kernel and converts it again in the backward, where autograd
    would keep the forward's converted copy (2 bytes a weight, every frozen
    layer's until its backward). dx = (dy * scale) @ kernel^T, the JAX
    module's gradient."""

    @staticmethod
    def forward(ctx, x, kernel_q, scale_q):
        ctx.save_for_backward(kernel_q, scale_q)
        return (x @ kernel_q.to(x.dtype)) * scale_q.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        kernel_q, scale_q = ctx.saved_tensors
        dx = (dy * scale_q.to(dy.dtype)) @ kernel_q.to(dy.dtype).t()
        return dx, None, None


class Int8Dense(nn.Module):
    """Dense with an int8 `kernel_q` [in, out] and f32 `scale_q` [out]
    buffers: y = (x @ kernel_q) * scale, the scale cast to the compute
    dtype before the multiply (as the JAX module does). Where the input
    needs its gradient (a frozen int8 layer under a trainable one) the
    product runs as `_Int8Product`, which keeps no converted copy of the
    weight for the backward. Otherwise (decode, under inference mode) it
    runs as the two composed ops, which take less host time than
    `Function.apply` on a host-bound decode step (`chip_smoke.py`'s serve
    phase measures the difference)."""

    def __init__(self, in_features: int, features: int, *,
                 use_bias: bool = False, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("kernel_q", torch.empty(
            in_features, features, dtype=torch.int8, device=device))
        self.register_buffer("scale_q", torch.ones(
            features, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=torch.float32,
                                              device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if x.requires_grad and torch.is_grad_enabled():
            y = _Int8Product.apply(x, self.kernel_q, self.scale_q)
        else:
            y = x @ self.kernel_q.to(self.dtype)
            y = y * self.scale_q.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def make_dense(quant: Optional[str], in_features: int, features: int, *,
               use_bias: bool, dtype, device=None) -> nn.Module:
    # int4 models keep every projection that is not part of a fused MLP
    # pair at int8 (the JAX package's choice; `Int4AttnDense` is not routed)
    if quant in ("int8", "int4"):
        return Int8Dense(in_features, features, use_bias=use_bias,
                         dtype=dtype, device=device)
    if quant is not None:
        raise NotImplementedError(f"quant={quant!r} is not ported yet")
    return Dense(in_features, features, use_bias=use_bias, dtype=dtype,
                 device=device)


def int8_mlp_plain(x, w1q, s1, w2q, s2, *, act="gelu", b1=None, b2=None):
    """The kernel's function in plain PyTorch: f32 products of the int8
    weights converted to x's dtype, the hidden activation rounded to x's
    dtype before the second product."""
    dt = x.dtype
    h = x.float() @ w1q.to(dt).float()
    h = h * s1.float()
    if b1 is not None:
        h = h + b1.float()
    h = ACTIVATIONS[act](h).to(dt)
    y = h.float() @ w2q.to(dt).float()
    y = y * s2.float()
    if b2 is not None:
        y = y + b2.float()
    return y.to(dt)


def int8_mlp_refusal(m: int, k: int, h: int, n: int) -> Optional[str]:
    """Why the int8 MLP kernel refuses x [M, K] through an [K, H] / [H, N]
    pair, or None when it takes it."""
    if m > 32 or k % 64 or h % 128 or n % 16:
        return (f"int8_mlp kernel: M={m} (<= 32), K={k} (% 64), H={h} "
                f"(% 128), N={n} (% 16)")
    return None


def refuse_backward(what: str, *tensors) -> None:
    """Raise where a kernel without a backward would be launched on an
    input that needs its gradient: its output would leave the autograd
    graph and the gradient through it would be silently missing. (The
    plain versions, which CPU tensors take, are differentiable.) The
    fused xattn FF takes `int8_mlp` / `int4_mlp` at 32 tokens or fewer,
    so a model trained with quantized xattn needs more tokens than that,
    or `quant_xattn=None` as the 7B int8 recipe has it."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: the kernel has no backward, and its input needs a "
            "gradient (train with quant_xattn=None, or under no_grad)")


def int8_mlp(x: torch.Tensor, w1q: torch.Tensor, s1: torch.Tensor,
             w2q: torch.Tensor, s2: torch.Tensor, *, act: str = "gelu",
             b1: Optional[torch.Tensor] = None,
             b2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act((x @ w1q) * s1 + b1) @ w2q * s2 + b2 with x [M, K], w1q [K, H]
    int8, w2q [H, N] int8, f32 scales/biases. CUDA tensors: x bf16,
    M <= 32, K % 64 == 0, H % 128 == 0, N % 16 == 0."""
    m, k = x.shape
    h, n = w2q.shape
    if w1q.shape != (k, h) or s1.shape != (h,) or s2.shape != (n,):
        raise ValueError(f"int8_mlp: x {tuple(x.shape)}, w1q "
                         f"{tuple(w1q.shape)}, w2q {tuple(w2q.shape)}")
    if act not in _ACT_IDS:
        raise ValueError(f"int8_mlp: act {act!r}")
    if x.device.type == "cpu":
        return int8_mlp_plain(x, w1q, s1, w2q, s2, act=act, b1=b1, b2=b2)
    if x.device.type != "cuda":
        raise ValueError(f"int8_mlp: unsupported device {x.device}")
    refuse_backward("int8_mlp", x, b1, b2)
    if x.dtype != torch.bfloat16 or w1q.dtype != torch.int8 \
            or w2q.dtype != torch.int8:
        raise TypeError("int8_mlp kernel takes bf16 x and int8 weights")
    refusal = int8_mlp_refusal(m, k, h, n)
    if refusal is not None:
        raise ValueError(refusal)
    x = x.contiguous()
    w1q, w2q = w1q.contiguous(), w2q.contiguous()
    if x.data_ptr() % 16 or w1q.data_ptr() % 16 or w2q.data_ptr() % 16:
        raise ValueError("int8_mlp kernel: buffers must be 16-byte aligned")
    s1, s2 = s1.float().contiguous(), s2.float().contiguous()
    b1 = None if b1 is None else b1.float().contiguous()
    b2 = None if b2 is None else b2.float().contiguous()
    ws = torch.empty((h // 128, m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.library("int8_mlp", _SIGNATURES)
    err = lib.int8_mlp_bf16(
        x.data_ptr(), w1q.data_ptr(), s1.data_ptr(),
        None if b1 is None else b1.data_ptr(), w2q.data_ptr(), s2.data_ptr(),
        None if b2 is None else b2.data_ptr(), ws.data_ptr(),
        out.data_ptr(), m, k, h, n, _ACT_IDS[act],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "int8_mlp")
    _build.count_launch(int8_mlp)
    return out


int8_mlp.launches = 0


def int8_matmul_plain(x, wq, scale):
    """The kernel's function in plain PyTorch: an f32 product of x with the
    int8 weight converted to x's dtype, scaled in f32, rounded once."""
    dt = x.dtype
    y = x.float() @ wq.to(dt).float()
    return (y * scale.float()).to(dt)


def int8_matmul(x: torch.Tensor, wq: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """(x @ wq) * scale with x [M, K], wq [K, N] int8, f32 scale [N] ->
    [M, N] in x's dtype: the decode-shaped product of an untied int8
    `lm_head`. CUDA tensors: x bf16, M <= 32, K % 64 == 0; any N >= 1, and
    wq may be a view with any row stride (unit column stride): the weight
    is read in place, once."""
    if x.dim() != 2 or wq.dim() != 2 or wq.shape[0] != x.shape[1] \
            or scale.shape != (wq.shape[1],) or wq.shape[1] < 1:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)}, wq "
                         f"{tuple(wq.shape)}, scale {tuple(scale.shape)}")
    if wq.device != x.device or scale.device != x.device:
        raise ValueError(f"int8_matmul: x on {x.device}, wq on {wq.device}, "
                         f"scale on {scale.device}")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, wq, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or wq.dtype != torch.int8:
        raise TypeError("int8_matmul kernel takes bf16 x and an int8 weight")
    (m, k), n = x.shape, wq.shape[1]
    if m < 1 or m > 32 or k % 64:
        raise ValueError(f"int8_matmul kernel: M={m} (1..32), K={k} (% 64)")
    if n > 1 and wq.stride(1) != 1 or k > 1 and wq.stride(0) < n:
        raise ValueError(f"int8_matmul kernel: weight strides {wq.stride()} "
                         f"(rows must be runs of consecutive bytes)")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("int8_matmul kernel: x must be 16-byte aligned")
    scale = scale.float().contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.library("int8_matmul", _SIGNATURES_MATMUL)
    err = lib.int8_matmul_bf16(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k,
        n, wq.stride(0) if k > 1 else n,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "int8_matmul")
    _build.count_launch(int8_matmul)
    return out


int8_matmul.launches = 0


def split_k(k: int, n: int) -> int:
    """How many CTAs share the k weight rows of one 128-column block of a
    streamed product [M, k] @ [k, n] (each takes a run of rows, and the
    partial sums are added in a fixed order): enough to put about 256 CTAs
    on the card, in whole 64-row stages."""
    splits = 1
    while splits < 16 and (n // 128) * splits < 256 \
            and k % (128 * splits) == 0:
        splits *= 2
    return splits


def split_k_rows(k: int, n: int, m: int) -> int:
    """How many CTAs share the k weight rows of one 128-column block of the
    tensor-core split-K product (`csrc/int8_rows.cuh`: `int8_attn_tail`'s
    out-projection, the megakernel's two products) for m rows of x: the
    most, a power of two, that keeps the (n / 128) x splits CTAs within one
    wave of the CTAs an SM holds (three of 73 KB of shared memory at
    m <= 8, two of 80-96 KB above) and gives each a whole number of
    128-row stages. A pure function of the shapes, so the partial sums are
    added in the same order on every card."""
    ctas = (3 if m <= 8 else 2) * SM_COUNT
    splits = 1
    while (n // 128) * splits * 2 <= ctas and k % (128 * splits * 2) == 0:
        splits *= 2
    return splits


def int8_attn_tail_plain(attn_raw, resid, woq, so, norm_scale, w1q, s1, w2q,
                         s2, *, eps: float = 1e-5, act: str = "gelu",
                         return_mlp: bool = False):
    """The kernel's function in plain PyTorch, rounding to the activation
    dtype where the kernel rounds: the out-projection before the residual,
    y, the norm's result, the hidden activation, the MLP's result.
    `return_mlp`: also return that MLP result (before the residual), whose
    rounding a check of the kernel must allow for."""
    dt = attn_raw.dtype
    o = (attn_raw.float() @ woq.to(dt).float()) * so.float()
    y = (resid.float() + o.to(dt).float()).to(dt)
    yf = y.float()
    mean = yf.mean(-1, keepdim=True)
    var = (yf - mean).square().mean(-1, keepdim=True)
    n = ((yf - mean) * torch.rsqrt(var + eps) * norm_scale.float()).to(dt)
    h = ACTIVATIONS[act]((n.float() @ w1q.to(dt).float()) * s1.float()).to(dt)
    mlp = ((h.float() @ w2q.to(dt).float()) * s2.float()).to(dt)
    return (y + mlp, mlp) if return_mlp else y + mlp


def int8_attn_tail(attn_raw: torch.Tensor, resid: torch.Tensor,
                   woq: torch.Tensor, so: torch.Tensor,
                   norm_scale: torch.Tensor, w1q: torch.Tensor,
                   s1: torch.Tensor, w2q: torch.Tensor, s2: torch.Tensor, *,
                   eps: float = 1e-5, act: str = "gelu") -> torch.Tensor:
    """The tail of a decode layer in one kernel call:

        y   = resid + (attn_raw @ woq) * so          (attention out-proj)
        n   = LayerNorm(y) * norm_scale              (f32 statistics)
        out = y + act((n @ w1q) * s1) @ w2q * s2     (MLP)

    attn_raw [M, hd], resid [M, D]; woq [hd, D], w1q [D, H], w2q [H, D]
    int8 with f32 per-column scales; norm_scale [D]. CUDA tensors: bf16
    activations, M <= 32, hd % 64 == 0, D % 128 == 0, H % 128 == 0,
    everything contiguous and 16-byte aligned."""
    m, hd = attn_raw.shape
    d, h = w1q.shape
    if resid.shape != (m, d) or woq.shape != (hd, d) or w2q.shape != (h, d) \
            or so.shape != (d,) or s1.shape != (h,) or s2.shape != (d,) \
            or norm_scale.shape != (d,):
        raise ValueError(
            f"int8_attn_tail: attn_raw {tuple(attn_raw.shape)}, resid "
            f"{tuple(resid.shape)}, woq {tuple(woq.shape)}, w1q "
            f"{tuple(w1q.shape)}, w2q {tuple(w2q.shape)}")
    if act not in _INT4_ACTS:
        raise ValueError(f"int8_attn_tail: act {act!r}")
    if attn_raw.device.type == "cpu":
        return int8_attn_tail_plain(attn_raw, resid, woq, so, norm_scale,
                                    w1q, s1, w2q, s2, eps=eps, act=act)
    _check_kernel_inputs("int8_attn_tail", attn_raw, woq, w1q, w2q)
    if resid.dtype != torch.bfloat16 or not resid.is_contiguous():
        raise TypeError("int8_attn_tail kernel takes a contiguous bf16 resid")
    if m > 32 or hd % 64 or d % 128 or h % 128 or d > 12288:
        raise ValueError(f"int8_attn_tail kernel: M={m} (<= 32), hd={hd} "
                         f"(% 64), D={d} (% 128, <= 12288), H={h} (% 128)")
    so, s1, s2, norm_scale = (t.float().contiguous()
                              for t in (so, s1, s2, norm_scale))
    dev = attn_raw.device
    splits = split_k_rows(hd, d, m)
    # one scratch allocation (a decode step is bound by the host):
    # ws_o | ws_mlp (f32) | y | normed (bf16)
    n_o, n_mlp = splits * m * d, (h // 128) * m * d
    scratch = torch.empty(n_o + n_mlp + m * d, dtype=torch.float32,
                          device=dev)
    ws_o = scratch.data_ptr()
    ws_mlp = ws_o + 4 * n_o
    y = ws_mlp + 4 * n_mlp
    normed = y + 2 * m * d
    out = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    lib = _build.library("int8_attn_tail", _SIGNATURES_TAIL)
    err = lib.int8_attn_tail_bf16(
        attn_raw.data_ptr(), resid.data_ptr(), woq.data_ptr(), so.data_ptr(),
        norm_scale.data_ptr(), w1q.data_ptr(), s1.data_ptr(), w2q.data_ptr(),
        s2.data_ptr(), ws_o, y, normed, ws_mlp, out.data_ptr(), m, hd, d, h,
        float(eps), _ACT_IDS[act], splits,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "int8_attn_tail")
    _build.count_launch(int8_attn_tail)
    return out


int8_attn_tail.launches = 0


# ── load-time transforms ─────────────────────────────────────────────

ArrayLike = Union[np.ndarray, torch.Tensor]


def quantize_kernel(w: ArrayLike):
    """[in, out] float -> (int8 [in, out], f32 scale [out]): symmetric
    per-output-channel max-abs. Numpy in, numpy out (byte-identical to
    the JAX package's); a tensor stays on its device."""
    is_np = isinstance(w, np.ndarray)
    wt = torch.from_numpy(np.asarray(w, np.float32)) if is_np else w.float()
    absmax = wt.abs().amax(dim=0)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(wt / scale[None, :]), -127, 127
                    ).to(torch.int8)
    if is_np:
        return q.numpy(), scale.numpy()
    return q, scale


DEFAULT_QUANT_PATTERNS = re.compile(
    r"(.*/)?(layers_\d+/(attn|ffn)/[^/]+"
    r"|xattn_\d+/(ff_up|ff_down)"
    r"|xattn_\d+/attn/(to_q|to_kv|to_out)"
    r"|lm_head)/kernel$")

# the decoder layers only: the xattn blocks, the perceiver, the embeddings
# and the head stay in the activation dtype. The idefics family loads so
# (its head is a plain Dense in the JAX module too, which the default
# patterns would quantize away from under it).
FROZEN_DECODER_PATTERNS = re.compile(
    r"(.*/)?layers_\d+/(attn|ffn)/[^/]+/kernel$")


def quantize_params(flat: Dict[str, ArrayLike],
                    patterns=DEFAULT_QUANT_PATTERNS) -> Dict[str, ArrayLike]:
    """Replace matching `.../kernel` entries of a flat {flax path: array}
    dict with `kernel_q` + `scale_q` pairs (Int8Dense's names)."""
    out = {}
    for k, v in flat.items():
        if patterns.match(k):
            q, scale = quantize_kernel(v)
            base = k[: -len("kernel")]
            out[base + "kernel_q"] = q
            out[base + "scale_q"] = scale
        else:
            out[k] = v
    return out


def quantize_embed(flat: Dict[str, ArrayLike]) -> Dict[str, ArrayLike]:
    """Replace the `.../wte/embedding` entries of a flat {flax path: array}
    dict with the decoder's `quant_embed` layout: `wte_q` [V, H] int8 and
    `wte_s` [V] f32 per-row scales (symmetric max-abs per row). One-time
    load transform for `TextConfig(quant_embed=True)`: a decode step
    gathers one row either way, so this halves what the table takes on the
    device, not what a step reads. Numpy in, numpy out (byte-identical to
    the JAX package's); tensors stay on their device."""
    out = {}
    for k, v in flat.items():
        if not k.endswith("wte/embedding"):
            out[k] = v
            continue
        base = k[: -len("wte/embedding")]
        if isinstance(v, np.ndarray):
            w = np.asarray(v, np.float32)
            scale = np.maximum(np.abs(w).max(axis=1), 1e-12) / 127.0
            q = np.clip(np.rint(w / scale[:, None]), -127, 127)
            out[base + "wte_q"] = q.astype(np.int8)
            out[base + "wte_s"] = scale.astype(np.float32)
        else:
            w = v.float()
            scale = w.abs().amax(dim=1).clamp_min(1e-12) / 127.0
            q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
            out[base + "wte_q"] = q.to(torch.int8)
            out[base + "wte_s"] = scale
    return out


_WQKV_Q = re.compile(r"(.*layers_\d+/attn)/Wqkv/kernel_q$")


def add_fused_wqo(flat: Dict[str, ArrayLike]) -> Dict[str, ArrayLike]:
    """Add the decode megakernel's fused `[Wqkv | Wo]` leaves to a flat
    {flax path: array} dict of quantized parameters: next to each decoder
    layer's `attn/Wqkv/kernel_q` and `attn/out_proj/kernel_q`,
    `attn/wqo_q` [d, 4d] int8 and `attn/wqo_scale` [4d] f32. One-time load
    transform for `TextConfig(megakernel=True)`: the megakernel streams
    qkv and out-proj as one operand, while prefill keeps the original
    leaves (one more int8 copy of both on the device). Numpy in, numpy out
    (byte-identical to the JAX package's); tensors stay on their device."""
    out = dict(flat)
    for key in flat:
        m = _WQKV_Q.match(key)
        if not m or m.group(1) + "/out_proj/kernel_q" not in flat:
            continue
        base = m.group(1)
        wqkv, wo = flat[key], flat[base + "/out_proj/kernel_q"]
        scales = [flat[base + "/Wqkv/scale_q"],
                  flat[base + "/out_proj/scale_q"]]
        if isinstance(wqkv, np.ndarray):
            out[base + "/wqo_q"] = np.concatenate([wqkv, wo], axis=1)
            out[base + "/wqo_scale"] = np.concatenate(
                [np.asarray(t, np.float32) for t in scales])
        else:
            out[base + "/wqo_q"] = torch.cat([wqkv, wo], dim=1)
            out[base + "/wqo_scale"] = torch.cat([t.float() for t in scales])
    return out


def quantize_for(text_cfg, flat: Mapping,
                 patterns=DEFAULT_QUANT_PATTERNS) -> Dict[str, ArrayLike]:
    """The load transforms of a model whose decoder is `text_cfg`, over a
    {flax path: array} mapping of its unquantized parameters:
    `quantize_params_int4` for `quant="int4"`, `quantize_params` (and
    `add_fused_wqo` with `megakernel`) for "int8", `quantize_embed` with
    `quant_embed`. Other `patterns` (the idefics family's
    `FROZEN_DECODER_PATTERNS`) quantize the kernels they match to int8
    under "int8" and "int4" alike: that family's gated MLPs never pack. A
    lazy mapping is read one tensor at a time."""
    if text_cfg.quant == "int4" and patterns is DEFAULT_QUANT_PATTERNS:
        flat = quantize_params_int4(flat)
    elif text_cfg.quant in ("int8", "int4"):
        flat = quantize_params(flat, patterns)
        if text_cfg.megakernel:
            flat = add_fused_wqo(flat)
    if text_cfg.quant_embed:
        flat = quantize_embed(flat)
    return flat


def quantize_kv(x: torch.Tensor):
    """Symmetric per-row max-abs int8 for KV-cache entries: x [..., D] ->
    (int8 [..., D], f32 scale [...])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


# ── int4: two values a byte ──────────────────────────────────────────

def _nibbles(p: torch.Tensor):
    """int8 bytes -> (low nibble, high nibble), both sign-extended int8."""
    return ((p & 0xF) ^ 8) - 8, p >> 4


def quantize_kernel_int4(w: ArrayLike, pack_axis: int = 0):
    """[in, out] float -> (packed int8, f32 scale [out]): symmetric
    per-output-channel max-abs to [-7, 7], two values a byte, paired half
    and half so that a block of the packed array holds both nibbles of
    every element it stands for:

      pack_axis=0: byte[i, o] = w[i, o] | w[i + in/2, o] << 4  ([in/2, out])
      pack_axis=1: byte[i, o] = w[i, o] | w[i, o + out/2] << 4 ([in, out/2])

    Numpy in, numpy out (byte-identical to the JAX package's); a tensor
    stays on its device."""
    is_np = isinstance(w, np.ndarray)
    wt = torch.from_numpy(np.asarray(w, np.float32)) if is_np else w.float()
    if wt.shape[pack_axis] % 2:
        raise ValueError(f"quantize_kernel_int4: odd size along axis "
                         f"{pack_axis} of {tuple(wt.shape)}")
    absmax = wt.abs().amax(dim=0)
    scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wt / scale[None, :]), -7, 7).to(torch.int32)
    lo, hi = q.chunk(2, dim=pack_axis)
    packed = ((lo & 0xF) | ((hi & 0xF) * 16)).to(torch.uint8).view(torch.int8)
    if is_np:
        return packed.numpy(), scale.numpy()
    return packed, scale


def unpack_int4(packed: torch.Tensor, pack_axis: int = 0) -> torch.Tensor:
    """Inverse of the packing above: int8 values in the original order."""
    return torch.cat(_nibbles(packed), dim=pack_axis)


def quantize_kv_int4(k: torch.Tensor, v: torch.Tensor):
    """Symmetric per-row max-abs int4 for KV-cache entries, k and v fused:
    byte[..., d] = k4[..., d] | v4[..., d] << 4. k, v [..., D] ->
    (int8 [..., D], f32 k_scale [...], f32 v_scale [...])."""
    # k and v in one pass (rows are independent): a decode step is bound
    # by the host's launches, and this runs once a layer
    xf = torch.stack([k, v]).float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -7, 7).to(torch.int8)
    # v4 * 16 is v4 << 4 without a shift of a negative value; it fits int8
    return (q[0] & 0xF) | (q[1] * 16), scale[0], scale[1]


def dequantize_kv_int4(packed: torch.Tensor, k_scale: torch.Tensor,
                       v_scale: torch.Tensor, dtype=torch.bfloat16):
    """Inverse of `quantize_kv_int4`: fused [..., D] -> (k, v)."""
    k4, v4 = _nibbles(packed)
    return ((k4.float() * k_scale[..., None]).to(dtype),
            (v4.float() * v_scale[..., None]).to(dtype))


_INT4_UP = re.compile(
    r"(.*/)?(layers_\d+/ffn/up_proj|xattn_\d+/ff_up)/kernel$")
_INT4_DOWN = re.compile(
    r"(.*/)?(layers_\d+/ffn/down_proj|xattn_\d+/ff_down)/kernel$")


def quantize_params_int4(flat: Dict[str, ArrayLike]) -> Dict[str, ArrayLike]:
    """The parameters of a `quant="int4"` model from a flat {flax path:
    array} dict: the fused-MLP pairs (decoder ffn up/down, xattn
    ff_up/ff_down) pack to `kernel_q4` + `scale_q`, every other kernel of
    `DEFAULT_QUANT_PATTERNS` (all attention projections, `lm_head`) is
    int8. A pair with biases, or beside a `gate_proj`, is loaded by the
    int8 modules and stays int8 too."""
    def packs(key: str) -> bool:
        base = key[: -len("kernel")]
        ffn_dir = base.rsplit("/", 2)[0]
        return base + "bias" not in flat \
            and ffn_dir + "/gate_proj/kernel" not in flat

    out = {}
    for key, v in flat.items():
        base = key[: -len("kernel")]
        up = _INT4_UP.match(key)
        if (up or _INT4_DOWN.match(key)) and packs(key):
            q, scale = quantize_kernel_int4(v, pack_axis=0 if up else 1)
            out[base + "kernel_q4"] = q
            out[base + "scale_q"] = scale
        elif DEFAULT_QUANT_PATTERNS.match(key):
            q, scale = quantize_kernel(v)
            out[base + "kernel_q"] = q
            out[base + "scale_q"] = scale
        else:
            out[key] = v
    return out


def _unpacked_matmul(x, kernel_q4, scale_q, pack_axis, dtype):
    """(x @ unpack(kernel_q4)) * scale in `dtype`, the scale on the output
    side (a plain product over a converted weight, as `Int8Dense`)."""
    y = x.to(dtype) @ unpack_int4(kernel_q4, pack_axis).to(dtype)
    return y * scale_q.to(dtype)


class Int4Dense(nn.Module):
    """Dense over a packed int4 `kernel_q4` ([in/2, out] for pack_axis 0,
    [in, out/2] for 1) and f32 `scale_q` [out], for prefill shapes: unpack,
    convert, multiply."""

    def __init__(self, in_features: int, features: int, pack_axis: int = 0,
                 *, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.pack_axis, self.dtype = pack_axis, dtype
        shape = ((in_features // 2, features) if pack_axis == 0
                 else (in_features, features // 2))
        self.register_buffer("kernel_q4", torch.empty(
            shape, dtype=torch.int8, device=device))
        self.register_buffer("scale_q", torch.ones(
            features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _unpacked_matmul(x, self.kernel_q4, self.scale_q,
                                self.pack_axis, self.dtype)


class Int4AttnDense(nn.Module):
    """int4 projection (pack_axis 0): the `int4_matmul` kernel at up to 32
    tokens, unpack and multiply above. No model routes to it (`make_dense`
    keeps projections at int8, as the JAX package does)."""

    def __init__(self, in_features: int, features: int, *,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("kernel_q4", torch.empty(
            in_features // 2, features, dtype=torch.int8, device=device))
        self.register_buffer("scale_q", torch.ones(
            features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = x.numel() // x.shape[-1]
        if tokens <= 32:
            y = int4_matmul(x.reshape(tokens, -1).to(self.dtype),
                            self.kernel_q4, self.scale_q)
            return y.reshape(x.shape[:-1] + (y.shape[-1],))
        return _unpacked_matmul(x, self.kernel_q4, self.scale_q, 0,
                                self.dtype)


_INT4_ACTS = ("gelu", "relu", "silu")


def int4_mlp_plain(x, w1p, s1, w2p, s2, *, act="gelu"):
    """The kernel's function in plain PyTorch: `int8_mlp_plain` over the
    unpacked weights."""
    return int8_mlp_plain(x, unpack_int4(w1p, 0), s1, unpack_int4(w2p, 1),
                          s2, act=act)


def _check_kernel_inputs(what: str, x: torch.Tensor, *weights: torch.Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or any(w.dtype != torch.int8
                                        for w in weights):
        raise TypeError(f"{what} kernel takes bf16 x and packed int8 weights")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (x, *weights)):
        raise ValueError(f"{what} kernel: x and the weights must be "
                         f"contiguous and 16-byte aligned")


def int4_mlp_refusal(m: int, k: int, h: int, n: int) -> Optional[str]:
    """Why the int4 MLP kernel refuses x [M, K] through an [K, H] / [H, N]
    pair, or None when it takes it."""
    if m > 32 or k % 32 or h % 128 or n % 32:
        return (f"int4_mlp kernel: M={m} (<= 32), K={k} (% 32), H={h} "
                f"(% 128), N={n} (% 32)")
    return None


def int4_mlp(x: torch.Tensor, w1p: torch.Tensor, s1: torch.Tensor,
             w2p: torch.Tensor, s2: torch.Tensor, *,
             act: str = "gelu") -> torch.Tensor:
    """act((x @ unpack0(w1p)) * s1) @ unpack1(w2p) * s2 with x [M, K], w1p
    [K/2, H] (pack_axis 0), w2p [H, N/2] (pack_axis 1), f32 scales s1 [H],
    s2 [N]; the hidden activation is rounded to x's dtype before the second
    product. CUDA tensors: x bf16, M <= 32, K % 32 == 0, H % 128 == 0,
    N % 32 == 0, everything contiguous and 16-byte aligned."""
    m, k = x.shape
    h, n = w2p.shape[0], 2 * w2p.shape[1]
    if w1p.shape != (k // 2, h) or k % 2 or s1.shape != (h,) \
            or s2.shape != (n,):
        raise ValueError(f"int4_mlp: x {tuple(x.shape)}, w1p "
                         f"{tuple(w1p.shape)}, w2p {tuple(w2p.shape)}")
    if act not in _INT4_ACTS:
        raise ValueError(f"int4_mlp: act {act!r}")
    if x.device.type == "cpu":
        return int4_mlp_plain(x, w1p, s1, w2p, s2, act=act)
    _check_kernel_inputs("int4_mlp", x, w1p, w2p)
    refuse_backward("int4_mlp", x)
    refusal = int4_mlp_refusal(m, k, h, n)
    if refusal is not None:
        raise ValueError(refusal)
    s1, s2 = s1.float().contiguous(), s2.float().contiguous()
    ws = torch.empty((h // 128, m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.library("int4_mlp", _SIGNATURES_INT4)
    err = lib.int4_mlp_bf16(
        x.data_ptr(), w1p.data_ptr(), s1.data_ptr(), w2p.data_ptr(),
        s2.data_ptr(), ws.data_ptr(), out.data_ptr(), m, k, h, n,
        _ACT_IDS[act], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "int4_mlp")
    _build.count_launch(int4_mlp)
    return out


int4_mlp.launches = 0


def int4_matmul_plain(x, wp, scale):
    """The kernel's function in plain PyTorch: an f32 product of x with
    the unpacked weight converted to x's dtype, scaled on the output."""
    dt = x.dtype
    y = x.float() @ unpack_int4(wp, 0).to(dt).float()
    return (y * scale.float()).to(dt)


def int4_matmul(x: torch.Tensor, wp: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """(x @ unpack0(wp)) * scale with x [M, K], wp [K/2, N] (pack_axis 0),
    f32 scale [N]. CUDA tensors: x bf16, M <= 32, K % 128 == 0,
    N % 128 == 0, contiguous and 16-byte aligned."""
    m, k = x.shape
    n = wp.shape[1]
    if wp.shape[0] * 2 != k or scale.shape != (n,):
        raise ValueError(f"int4_matmul: x {tuple(x.shape)}, wp "
                         f"{tuple(wp.shape)}, scale {tuple(scale.shape)}")
    if x.device.type == "cpu":
        return int4_matmul_plain(x, wp, scale)
    _check_kernel_inputs("int4_matmul", x, wp)
    if m > 32 or k % 128 or n % 128:
        raise ValueError(f"int4_matmul kernel: M={m} (<= 32), K={k} "
                         f"(% 128), N={n} (% 128)")
    scale = scale.float().contiguous()
    splits = split_k(k // 2, n)   # over the packed rows
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.library("int4_mlp", _SIGNATURES_INT4)
    err = lib.int4_matmul_bf16(
        x.data_ptr(), wp.data_ptr(), scale.data_ptr(), ws.data_ptr(),
        out.data_ptr(), m, k, n, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "int4_matmul")
    _build.count_launch(int4_matmul)
    return out


int4_matmul.launches = 0
