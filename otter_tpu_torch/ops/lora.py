"""LoRA adapters for the decoder projections (counterpart of
`otter_tpu/ops/lora.py`).

A LoRA-wrapped projection computes  y = base(x) + (alpha/r) * (x A) B  with
`base` the projection `make_dense(quant)` gives (bf16 `Dense`, `Int8Dense`;
an int4 model keeps its attention projections at int8) frozen, and the f32
adapters `lora_a` [in, r] (normal(0, 0.02) from a `torch.Generator`) and
`lora_b` [r, out] (zeros) trainable: `train.step.path_is_trainable` takes
them by name, as the JAX trainer's mask does. Targets per arch are the
reference's table (`modeling_otter.py:813-820`).

`into_base` renames a LoRA-free model's {flax path: tensor} mapping into a
LoRA model's names (a target's leaves under `base/`), the lookup the JAX
HF loader makes (`otter_tpu/models/convert.py:545-551`); the adapters keep
their initial values. `merge_adapters` goes the other way for the HF
export: each adapter folded into its float base, under the LoRA-free
names (the JAX export leaves the wrapped projections out).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Container, Iterator, Optional

import torch
from torch import nn

from otter_tpu_torch.ops.quant import make_dense

# reference target-module table (modeling_otter.py:813-820)
LORA_TARGETS = {
    "mpt": ("Wqkv",),
    "mosaic_gpt": ("Wqkv",),
    "persimmon": ("Wqkv",),
    "falcon": ("Wqkv",),
    "llama": ("q_proj", "v_proj"),
}

INIT_STD = 0.02


class LoraDense(nn.Module):
    """`make_dense(quant)` as `base`, plus the low-rank residual adapter.
    `lora_a` is drawn from torch's default generator of `device`, as
    `nn.Linear` draws its init; `reset_adapters` draws it from another."""

    def __init__(self, in_features: int, features: int, *, rank: int,
                 alpha: float = 16.0, use_bias: bool = True,
                 quant: Optional[str] = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype, self.scale = dtype, alpha / rank
        self.base = make_dense(quant, in_features, features,
                               use_bias=use_bias, dtype=dtype, device=device)
        self.lora_a = nn.Parameter(torch.empty(
            in_features, rank, dtype=torch.float32, device=device))
        self.lora_b = nn.Parameter(torch.zeros(
            rank, features, dtype=torch.float32, device=device))
        if device is None or torch.device(device).type != "meta":
            self.reset_adapters()

    @torch.no_grad()
    def reset_adapters(self, generator: Optional[torch.Generator] = None
                       ) -> None:
        """A ~ normal(0, 0.02) from `generator`, B = 0 (the JAX module's
        initializers), so the layer starts as its base."""
        self.lora_a.copy_(INIT_STD * torch.randn(
            self.lora_a.shape, generator=generator,
            device=self.lora_a.device))
        self.lora_b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        delta = (x @ self.lora_a.to(self.dtype)) @ self.lora_b.to(self.dtype)
        return self.base(x) + delta * self.scale


def maybe_lora_dense(cfg, name: str, in_features: int, features: int, *,
                     use_bias: bool, dtype, device=None) -> nn.Module:
    """The projection `name` of a decoder layer: a `LoraDense` where
    `cfg.lora_rank` > 0 and `name` is one of the arch's targets, else
    `make_dense(cfg.quant)`."""
    if cfg.lora_rank > 0 and name in LORA_TARGETS.get(cfg.arch, ()):
        return LoraDense(in_features, features, rank=cfg.lora_rank,
                         alpha=cfg.lora_alpha, use_bias=use_bias,
                         quant=cfg.quant, dtype=dtype, device=device)
    return make_dense(cfg.quant, in_features, features, use_bias=use_bias,
                      dtype=dtype, device=device)


def reset_adapters(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every adapter of `model` again from `generator`, in module
    order."""
    for m in model.modules():
        if isinstance(m, LoraDense):
            m.reset_adapters(generator)


class _IntoBase(Mapping):
    def __init__(self, flat: Mapping, names: Container[str]):
        self.flat, self._keys = flat, {}
        for k in flat:
            key = k[len("params/"):] if k.startswith("params/") else k
            if key not in names and "/" in key:
                head, leaf = key.rsplit("/", 1)
                if f"{head}/base/{leaf}" in names:
                    key = f"{head}/base/{leaf}"
            self._keys[key] = k

    def __getitem__(self, key):
        return self.flat[self._keys[key]]

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)


def into_base(flat: Mapping, model: nn.Module) -> Mapping:
    """`flat` ({flax path: tensor} of a LoRA-free model, a leading
    "params/" dropped) under `model`'s names: a leaf the model does not
    hold whose `base/` twin it holds moves there (`.../Wqkv/kernel_q` ->
    `.../Wqkv/base/kernel_q`). Lazy: a tensor is read when indexed."""
    names = {n.replace(".", "/") for n, _ in model.named_parameters()}
    names.update(n.replace(".", "/") for n, _ in model.named_buffers())
    return _IntoBase(flat, names)


QUANTIZED_BASE_EXPORT = (
    "a LoRA adapter over a quantized base cannot be merged into an HF "
    "export: the export writes float projections and leaves int8/int4 "
    "leaves out")


def merge_adapters(flat: Mapping, scale: float) -> dict:
    """{flax path: tensor} of a LoRA model with each adapter folded into
    its base, under the LoRA-free model's names: `.../Wqkv/base/kernel`
    + scale * lora_a @ lora_b -> `.../Wqkv/kernel` (f32, [in, out] as
    flax's), `.../Wqkv/base/bias` -> `.../Wqkv/bias`; the adapters go.
    A quantized base (`kernel_q`) raises ValueError
    (`QUANTIZED_BASE_EXPORT`). `scale` is the config's alpha / rank."""
    heads = {k[:-len("/lora_a")] for k in flat if k.endswith("/lora_a")}
    out = {}
    for k, v in flat.items():
        head, _, leaf = k.rpartition("/")
        if head in heads:
            continue                       # lora_a, lora_b
        if head.endswith("/base") and head[:-len("/base")] in heads:
            head = head[:-len("/base")]
            if leaf == "kernel":
                a, b = (torch.as_tensor(flat[f"{head}/{n}"]).float()
                        for n in ("lora_a", "lora_b"))
                v = torch.as_tensor(v).float() + scale * (a @ b)
            elif leaf != "bias":
                raise ValueError(f"{head}: {QUANTIZED_BASE_EXPORT}")
            k = f"{head}/{leaf}"
        out[k] = v
    return out
