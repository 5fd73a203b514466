"""Dtype policy helpers (counterpart of `otter_tpu/parallel/precision.py`).

bf16 storage for the large weights, f32 for norm, gate and bias
parameters, by the JAX module's `_KEEP_F32` regex over flax paths.
"""

from __future__ import annotations

import re
from typing import Mapping, Union

import torch
from torch import nn

# parameters kept in f32 regardless of the storage dtype
_KEEP_F32 = re.compile(
    r".*(scale|bias|gate$|attn_gate|ff_gate|norm[^/]*/|_ln/).*")


def cast_params(params: Mapping[str, torch.Tensor], dtype=torch.bfloat16,
                keep_f32=_KEEP_F32) -> dict:
    """{flax path: tensor} with floating tensors cast to `dtype`, except
    the paths `keep_f32` matches."""
    return {k: (v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
                and not keep_f32.match(k) else v)
            for k, v in params.items()}


def param_bytes(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Bytes of every tensor of a {path: tensor} mapping, or of a module's
    parameters and buffers."""
    if isinstance(params, nn.Module):
        tensors = list(params.state_dict().values())
    else:
        tensors = [v for v in params.values() if torch.is_tensor(v)]
    return sum(t.numel() * t.element_size() for t in tensors)
