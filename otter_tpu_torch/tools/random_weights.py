"""Random weights for benchmarks and smoke runs, made on the device.

`RandomParams(cfg, device)` is a {flax path: tensor} mapping of a model's
bf16 weights, each made when it is read, from its own seed; `build_model`
quantizes them tensor by tensor and loads them through
`models.convert.load_flax_params`, so the unquantized set never sits in
memory beside the model. `cfg` is an `OtterConfig` (any decoder arch) or a
`FuyuConfig`. `fuyu_request` lays out a synthetic Fuyu request (image
placeholder rows, prompt ids, random patches) as the Fuyu processor does.
"""

from __future__ import annotations

import math
import zlib
from collections.abc import Mapping
from typing import Union

import numpy as np
import torch

from otter_tpu_torch.config import FuyuConfig, OtterConfig
from otter_tpu_torch.models.convert import load_flax_params
from otter_tpu_torch.models.fuyu import FuyuVLM
from otter_tpu_torch.models.otter import OtterVLM
from otter_tpu_torch.ops import quant

ModelConfig = Union[OtterConfig, FuyuConfig]


def _model_class(cfg: ModelConfig):
    return FuyuVLM if isinstance(cfg, FuyuConfig) else OtterVLM


class RandomParams(Mapping):
    """{flax path: tensor} of a model's random bf16 weights, made on
    `device` when read, each from its own seed: normal(0, std), LayerNorm
    scales 1 + that, tanh gates 1 (tanh(1) ~ 0.76, so the xattn blocks
    contribute). Any tensor can be made again to check a trained copy."""

    def __init__(self, cfg: ModelConfig, device, std: float = 0.02,
                 seed: int = 0):
        meta = _model_class(cfg)(cfg, dtype=torch.bfloat16, device="meta")
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


def build_model(cfg: ModelConfig, device, seed: int = 0):
    """An `OtterVLM` (a `FuyuVLM` for a `FuyuConfig`) in bf16 on `device`
    with `RandomParams` weights, quantized by the port's `quantize_params`
    (`quantize_params_int4` for `quant="int4"`), with the decode
    megakernel's fused leaves when `cfg.text.megakernel` and the int8
    embedding table when `cfg.text.quant_embed`."""
    model = _model_class(cfg)(cfg, dtype=torch.bfloat16, device=device)
    plain = cfg.replace(text=cfg.text.replace(
        quant=None, quant_embed=False, megakernel=False, fused_tail=False))
    flat = RandomParams(plain, device, seed=seed)
    if cfg.text.quant == "int4":
        flat = quant.quantize_params_int4(flat)
    elif cfg.text.quant == "int8":
        flat = quant.quantize_params(flat)
        if cfg.text.megakernel:
            flat = quant.add_fused_wqo(flat)
    if cfg.text.quant_embed:
        flat = quant.quantize_embed(flat)
    load_flax_params(model, flat)
    return model.eval()


def fuyu_request(cfg: FuyuConfig, height: int, width: int, prompt_len: int,
                 seed: int = 0, left_pad: int = 0):
    """A synthetic request for a `FuyuVLM` (numpy), laid out as the Fuyu
    processor lays out an image of `height` x `width` pixels and a prompt:
    a row of `image_placeholder_id` for every row of patches, each ended
    by `image_newline_id`, then `prompt_len` random text ids, after
    `left_pad` padding tokens. Returns (input_ids [1, S], image_patches
    [1, P, patch_size^2 * C] f32, image_patches_indices [1, S],
    attention_mask [1, S])."""
    rng = np.random.default_rng(seed)
    p = cfg.patch_size
    n_rows, n_cols = math.ceil(height / p), math.ceil(width / p)
    ids, idx = [0] * left_pad, [-1] * left_pad
    for r in range(n_rows):
        ids += [cfg.image_placeholder_id] * n_cols + [cfg.image_newline_id]
        idx += list(range(r * n_cols, (r + 1) * n_cols)) + [-1]
    # text ids below the special ids
    text = rng.integers(1, min(cfg.image_placeholder_id,
                               cfg.image_newline_id), prompt_len)
    ids += text.tolist()
    idx += [-1] * prompt_len
    patches = rng.standard_normal(
        (1, n_rows * n_cols, p * p * cfg.num_channels)).astype(np.float32)
    mask = np.ones((1, len(ids)), np.int32)
    mask[:, :left_pad] = 0
    return (np.asarray([ids], np.int64), patches,
            np.asarray([idx], np.int64), mask)
