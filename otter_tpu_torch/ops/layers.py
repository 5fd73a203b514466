"""Norms, activations and rotary embeddings (counterpart of
`otter_tpu/ops/layers.py`).

  - layer_norm: statistics in f32, output cast back to the input's dtype.
    Fed an input already cast to the compute dtype it is the reference's
    low-precision LayerNorm (`mpt/norm.py:16-46`).
  - rms_norm: variance in f32, normalize, cast, then the weight multiply
    (`xformers_model/llama.py:95-112`).
  - rotary: the HF rotate_half convention; `rotary_dim < D` rotates only
    the first `rotary_dim` channels (persimmon's partial rotary).
  - gelu: the exact erf form (torch `nn.GELU()` default).
  - quick_gelu: x * sigmoid(1.702 x) (CLIP).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import nn


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], *, eps: float = 1e-5
               ) -> torch.Tensor:
    # one fused f32 kernel (biased variance, as the JAX function computes
    # it) instead of a chain of elementwise ops: decode runs ~80 norms a
    # step, and each op costs host time
    y = torch.nn.functional.layer_norm(
        x.float(), x.shape[-1:],
        None if weight is None else weight.float(),
        None if bias is None else bias.float(), eps)
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return y * weight.to(x.dtype)


def rotary_tables(dim: int, max_len: int, *, theta: float = 10000.0,
                  dtype=torch.float32, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [max_len, dim] in the HF duplicated-halves layout."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=device) / dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    emb = torch.outer(t, inv_freq).repeat(1, 2)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


@functools.lru_cache(maxsize=None)
def cached_rotary_tables(dim: int, max_len: int, theta: float,
                         device: torch.device):
    """`rotary_tables` in f32, made once per (shape, theta, device): the
    tables are constants, kept out of the modules' buffers."""
    return rotary_tables(dim, max_len, theta=theta, device=device)


def select_rotary(cos: torch.Tensor, sin: torch.Tensor,
                  positions: torch.Tensor, dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tables' rows at `positions` [B, S], cast to `dtype` before any
    multiply: ([B, 1, S, rot], [B, 1, S, rot])."""
    return cos[positions][:, None].to(dtype), sin[positions][:, None].to(dtype)


def rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [B, H, S, D] with its first `rot = c.shape[-1]` channels turned by
    the selected rows (c, s) of `select_rotary`; the rest pass through."""
    rot = c.shape[-1]
    xr = x[..., :rot]
    xr = xr * c + _rotate_half(xr) * s
    return xr if rot == x.shape[-1] else torch.cat([xr, x[..., rot:]], dim=-1)


def apply_rotary(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, positions: torch.Tensor, *,
                 rotary_dim: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k [B, H, S, D]; positions [B, S] int; cos/sin [max_len, rot]."""
    rot = rotary_dim or q.shape[-1]
    c, s = select_rotary(cos[:, :rot], sin[:, :rot], positions, q.dtype)
    return rotate(q, c, s), rotate(k, c, s)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="none")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {
    "gelu": gelu,
    "quick_gelu": quick_gelu,
    "silu": torch.nn.functional.silu,
    "relu": torch.relu,
    "sq_relu": lambda x: torch.relu(x).square(),
}


class LayerNorm(nn.Module):
    """LayerNorm with f32 `scale` (and optionally `bias`) parameters, named
    as flax names them. The input is cast to `dtype` first, so the output
    is in `dtype`."""

    def __init__(self, dim: int, *, eps: float = 1e-5, use_bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(dim, dtype=torch.float32,
                                              device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x.to(self.dtype), self.scale, self.bias,
                          eps=self.eps)


class RMSNorm(nn.Module):
    """RMSNorm with an f32 `scale` parameter (the flax name). The input is
    cast to `dtype` first; statistics in f32, the normed value cast back
    before the multiply by the scale."""

    def __init__(self, dim: int, *, eps: float = 1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x.to(self.dtype), self.scale, eps=self.eps)


class Dense(nn.Module):
    """flax `nn.Dense` layout: `kernel` [in, out], optional `bias` [out];
    the product runs in `dtype`."""

    def __init__(self, in_features: int, features: int, *,
                 use_bias: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(
            in_features, features, dtype=dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=dtype,
                                              device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ self.kernel
        if self.bias is not None:
            y = y + self.bias
        return y
