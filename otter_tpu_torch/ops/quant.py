"""Int8 weight-only quantization (counterpart of `otter_tpu/ops/quant.py`).

Weights are stored int8 [in, out] with per-output-channel f32 scales
(`kernel_q`, `scale_q`, the flax leaf names). `Int8Dense` applies the
scale on the output side; `int8_mlp` is the fused decode MLP, which
launches the hand-written kernel `csrc/int8_mlp.cu` for CUDA tensors and
runs `int8_mlp_plain` for CPU tensors. `quantize_kv` / `dequantize_kv`
give the int8 KV-cache layout, byte for byte the JAX package's.
"""

from __future__ import annotations

import ctypes
import re
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from otter_tpu_torch import _build
from otter_tpu_torch.ops.layers import ACTIVATIONS, Dense

_ACT_IDS = {"gelu": 0, "relu": 1, "silu": 2, "sq_relu": 3}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"int8_mlp_bf16": ([_P] * 9 + [_I] * 5 + [_P], _I)}


class Int8Dense(nn.Module):
    """Dense with an int8 `kernel_q` [in, out] and f32 `scale_q` [out]
    buffers: y = (x @ kernel_q) * scale, the scale cast to the compute
    dtype before the multiply (as the JAX module does)."""

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
        y = x.to(self.dtype) @ self.kernel_q.to(self.dtype)
        y = y * self.scale_q.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def make_dense(quant: Optional[str], in_features: int, features: int, *,
               use_bias: bool, dtype, device=None) -> nn.Module:
    if quant == "int8":
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
    if x.dtype != torch.bfloat16 or w1q.dtype != torch.int8 \
            or w2q.dtype != torch.int8:
        raise TypeError("int8_mlp kernel takes bf16 x and int8 weights")
    if m > 32 or k % 64 or h % 128 or n % 16:
        raise ValueError(f"int8_mlp kernel: M={m} (<= 32), K={k} (% 64), "
                         f"H={h} (% 128), N={n} (% 16)")
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
    int8_mlp.launches += 1
    return out


int8_mlp.launches = 0


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
