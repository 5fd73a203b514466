"""Random weights for benchmarks and smoke runs, made on the device.

`RandomParams(cfg, device)` is a {flax path: tensor} mapping of a model's
bf16 weights, each made when it is read, from its own seed; `build_model`
quantizes them tensor by tensor and loads them through
`models.convert.load_flax_params`, so the unquantized set never sits in
memory beside the model.
"""

from __future__ import annotations

import zlib
from collections.abc import Mapping

import torch

from otter_tpu_torch.config import OtterConfig
from otter_tpu_torch.models.convert import load_flax_params
from otter_tpu_torch.models.otter import OtterVLM
from otter_tpu_torch.ops import quant


class RandomParams(Mapping):
    """{flax path: tensor} of a model's random bf16 weights, made on
    `device` when read, each from its own seed: normal(0, std), LayerNorm
    scales 1 + that, tanh gates 1 (tanh(1) ~ 0.76, so the xattn blocks
    contribute). Any tensor can be made again to check a trained copy."""

    def __init__(self, cfg: OtterConfig, device, std: float = 0.02,
                 seed: int = 0):
        meta = OtterVLM(cfg, dtype=torch.bfloat16, device="meta")
        self.specs = {"params/" + n.replace(".", "/"): (tuple(t.shape),
                                                        t.dtype)
                      for n, t in meta.named_parameters()}
        self.device, self.std, self.seed = device, std, seed

    def __iter__(self):
        return iter(self.specs)

    def __len__(self):
        return len(self.specs)

    def __contains__(self, path):
        return path in self.specs   # without making the tensor

    def __getitem__(self, path):
        shape, dtype = self.specs[path]
        leaf = path.rsplit("/", 1)[-1]
        if leaf in ("attn_gate", "ff_gate"):
            return torch.ones(shape, device=self.device, dtype=dtype)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + zlib.crc32(path.encode()))
        val = self.std * torch.randn(shape, generator=gen, device=self.device,
                                     dtype=torch.bfloat16)
        if leaf == "scale":
            val = val + 1
        return val.to(dtype)


def build_model(cfg: OtterConfig, device, seed: int = 0) -> OtterVLM:
    """An `OtterVLM` in bf16 on `device` with `RandomParams` weights,
    quantized by the port's `quantize_params` (`quantize_params_int4` for
    `quant="int4"`), with the decode megakernel's fused leaves when
    `cfg.text.megakernel`."""
    model = OtterVLM(cfg, dtype=torch.bfloat16, device=device)
    plain = cfg.replace(text=cfg.text.replace(
        quant=None, megakernel=False, fused_tail=False))
    flat = RandomParams(plain, device, seed=seed)
    if cfg.text.quant == "int4":
        flat = quant.quantize_params_int4(flat)
    elif cfg.text.quant == "int8":
        flat = quant.quantize_params(flat)
        if cfg.text.megakernel:
            flat = quant.add_fused_wqo(flat)
    load_flax_params(model, flat)
    return model.eval()
