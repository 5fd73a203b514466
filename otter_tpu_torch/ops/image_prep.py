"""Image preprocessing on the device: resize and normalise (counterpart of
`otter_tpu/ops/image_prep.py`).

The host decodes JPEG/PNG to uint8; the device does the float math:
`normalize_u8` (/255, CLIP-style mean/std, channels first) for pixels
already at the tower's size, `resize_normalize` for one decoded
resolution bucket that still needs resizing.

The resize is JAX's `jax.image.resize(method="cubic", antialias=True)`,
built the way its `scale_and_translate` builds it: per axis a weight
matrix [in, out] of the Keys cubic kernel (a = -0.5), whose support widens
by in/out when the image shrinks (antialias), each output column
normalised to sum 1 and zeroed where the sample falls outside the input;
an axis whose size does not change is left alone. The two matrices are
applied by two matmuls. `torch.nn.functional.interpolate(mode="bicubic")`
is another function (a = -0.75, no antialias, other edge rules) and is not
used.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from otter_tpu_torch.device import resolve_device

# CLIP-style normalisation of the Flamingo towers
# (`otter_tpu/data/templates.py:13-14`)
FLAMINGO_MEAN = (0.481, 0.458, 0.408)
FLAMINGO_STD = (0.269, 0.261, 0.276)

_F32_EPS = float(np.finfo(np.float32).eps)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel, a = -0.5, of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(in_size: int, out_size: int, *, antialias: bool = True,
                   device=None) -> torch.Tensor:
    """f32 [in_size, out_size]: column j holds the weights of output pixel
    j over the input pixels (JAX's `compute_weight_mat`, scale out/in, no
    translation)."""
    # the scale and its inverse rounded to f32, as JAX promotes them
    f32 = dict(dtype=torch.float32, device=device)
    inv_scale = 1.0 / torch.tensor(out_size / in_size, **f32)
    kernel_scale = (torch.clamp(inv_scale, min=1.0) if antialias
                    else torch.ones((), **f32))
    sample = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, **f32)[:, None]).abs()
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _mean_std(mean, std, device):
    return (torch.tensor(mean, dtype=torch.float32, device=device),
            torch.tensor(std, dtype=torch.float32, device=device))


def resize_normalize(images_u8: torch.Tensor, *, size: int = 224,
                     mean: Tuple[float, float, float] = FLAMINGO_MEAN,
                     std: Tuple[float, float, float] = FLAMINGO_STD,
                     out_dtype=torch.float32) -> torch.Tensor:
    """uint8 [N, H, W, 3] (one decoded resolution bucket) -> normalised
    [N, 3, size, size]: antialiased Keys-cubic resize in f32, clipped to
    [0, 1], then (x - mean) / std."""
    x = images_u8.float() / 255.0
    _, h, w, _ = x.shape
    if h != size:
        wh = resize_weights(h, size, device=x.device)
        x = torch.einsum("nhwc,ho->nowc", x, wh)
    if w != size:
        ww = resize_weights(w, size, device=x.device)
        x = torch.einsum("nhwc,wo->nhoc", x, ww)
    x = x.clamp(0.0, 1.0)
    m, s = _mean_std(mean, std, x.device)
    x = (x - m) / s
    return x.permute(0, 3, 1, 2).to(out_dtype)


def normalize_u8(x_u8: torch.Tensor,
                 mean: Tuple[float, float, float] = FLAMINGO_MEAN,
                 std: Tuple[float, float, float] = FLAMINGO_STD,
                 out_dtype=torch.float32) -> torch.Tensor:
    """uint8 [..., H, W, 3] at the target size -> normalised
    [..., 3, H, W]: /255, (x - mean) / std, channels first."""
    x = x_u8.float() / 255.0
    m, s = _mean_std(mean, std, x.device)
    x = (x - m) / s
    return torch.movedim(x, -1, -3).to(out_dtype)


def device_preprocess(decoded: Sequence, *, size: int = 224,
                      mean=FLAMINGO_MEAN, std=FLAMINGO_STD,
                      out_dtype=torch.float32, device=None) -> torch.Tensor:
    """Same-shaped uint8 HWC arrays -> one normalised batch
    [N, 3, size, size] on `device` (the GPU unless the caller passes
    another). The caller groups images by decoded resolution."""
    batch = torch.from_numpy(np.stack([np.asarray(a) for a in decoded], 0))
    return resize_normalize(batch.to(resolve_device(device)), size=size,
                            mean=tuple(mean), std=tuple(std),
                            out_dtype=out_dtype)
