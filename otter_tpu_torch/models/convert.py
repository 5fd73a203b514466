"""Weight bridge from the JAX package's parameter tree to the port.

`load_flax_params(model, flat)` takes `{"/"-joined flax path: array}` as
`flax.traverse_util.flatten_dict(params, sep="/")` gives it (int8
`kernel_q` / `scale_q` leaves included) and copies every leaf into the
port module of the same path: the port names its submodules and
parameters as the flax modules do, so `a/b/kernel` is the state-dict key
`a.b.kernel`. The mapping must be one to one: a leaf with no home, a
port tensor left unfilled, or a shape mismatch raises. Arrays may be
numpy (the port holds no jax) or torch tensors already on the device.
`export_flax_params(model)` is the inverse: the port's tensors as numpy
under their flax paths.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch
from torch import nn

ArrayLike = Union[np.ndarray, torch.Tensor]


def load_flax_params(model: nn.Module, flat: Dict[str, ArrayLike]) -> None:
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    filled = set()
    for path, value in flat.items():
        key = path[len("params/"):] if path.startswith("params/") else path
        key = key.replace("/", ".")
        dst = targets.get(key)
        if dst is None:
            raise KeyError(f"load_flax_params: no port tensor for {path!r}")
        if isinstance(value, np.ndarray):
            if value.dtype.kind not in "fiub":   # e.g. ml_dtypes bfloat16
                value = value.astype(np.float32)
            src = torch.from_numpy(np.array(value))
        else:
            src = value
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"load_flax_params: {path!r} has shape "
                             f"{tuple(src.shape)}, port expects "
                             f"{tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src.to(device=dst.device, dtype=dst.dtype))
        filled.add(key)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"load_flax_params: {len(missing)} port tensors not "
                       f"in the checkpoint, e.g. {missing[:5]}")


def export_flax_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """{flax path: numpy array} of every parameter and buffer, the paths as
    `flatten_dict(params, sep="/")` gives them (without the "params/"
    prefix). bf16 tensors come back as f32."""
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    out = {}
    for name, t in tensors.items():
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name.replace(".", "/")] = t.cpu().numpy()
    return out
