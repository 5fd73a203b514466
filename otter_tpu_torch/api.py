"""User-facing model API (counterpart of `otter_tpu/api.py`), the
reference's public surface (`from otter_ai import
OtterForConditionalGeneration, FlamingoForConditionalGeneration`).

The wrappers hold a config, an `OtterVLM` and its generation engine
behind the familiar forward / generate methods (reference
`modeling_otter.py:917-1041`). Flamingo differs only by
`use_media_placement_augmentation`. Without weights the model is filled
from a seed (`tools.random_weights`) where the JAX package runs flax's
init.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from otter_tpu_torch import config as cfgmod
from otter_tpu_torch.config import GenerationConfig, OtterConfig
from otter_tpu_torch.device import resolve_device
from otter_tpu_torch.generation.engine import OtterGenerator, _on
from otter_tpu_torch.models.convert import (load_flax_params,
                                             load_otter_checkpoint)
from otter_tpu_torch.models.otter import OtterVLM
from otter_tpu_torch.tools import random_weights
from otter_tpu_torch.train.step import causal_lm_loss

CONFIGS = {
    "mpt7b": cfgmod.otter_mpt7b,
    "mpt1b": cfgmod.otter_mpt1b,
    "llama7b-video": cfgmod.otter_llama7b_video,
    "tiny": lambda: OtterConfig.tiny("mpt"),
}


class OtterForConditionalGeneration:
    """Stateful convenience wrapper over `OtterVLM`. `params`: the weights
    as {flax path: array} (`models.convert.load_flax_params`); None fills
    them from `seed`. The model lives on `device` (the GPU unless the
    caller names another)."""

    use_media_placement_augmentation = False

    def __init__(self, cfg: OtterConfig,
                 params: Optional[Dict[str, object]] = None,
                 dtype=torch.bfloat16, seed: int = 0, device=None):
        if self.use_media_placement_augmentation:
            cfg = cfg.replace(use_media_placement_augmentation=True)
        self.cfg, self.dtype = cfg, dtype
        device = resolve_device(device)
        if params is None:
            self.model = random_weights.build_model(cfg, device, seed, dtype)
        else:
            self.model = OtterVLM(cfg, dtype=dtype, device=device)
            load_flax_params(self.model, params)
            self.model.eval()
        self._engine = None

    @classmethod
    def from_pretrained(cls, checkpoint_path: str,
                        config: Union[str, OtterConfig] = "mpt7b",
                        dtype=torch.bfloat16, device=None):
        """The model of `config` (a `CONFIGS` name or an `OtterConfig`)
        with its seeded weights, then the HF checkpoint at
        `checkpoint_path` (a file or a directory of shards) loaded over
        them as a partial update (`models.convert.load_otter_checkpoint`;
        a trainer's checkpoint holds only the trainable tensors)."""
        cfg = CONFIGS[config]() if isinstance(config, str) else config
        self = cls(cfg, dtype=dtype, device=device)
        load_otter_checkpoint(checkpoint_path, self.cfg, self.model)
        return self

    @property
    def engine(self) -> OtterGenerator:
        if self._engine is None:
            self._engine = OtterGenerator(self.model)
        return self._engine

    @torch.no_grad()
    def __call__(self, vision_x, lang_x, attention_mask=None, labels=None):
        """forward (`modeling_otter.py:917`): (loss or None, logits)."""
        dev = self.model.device
        lang_x = _on(lang_x, dev).long()
        if attention_mask is None:
            attention_mask = torch.ones_like(lang_x)
        logits, _, _ = self.model(_on(vision_x, dev), lang_x,
                                  attention_mask=_on(attention_mask, dev))
        loss = None
        if labels is not None:
            loss, _ = causal_lm_loss(logits, _on(labels, dev))
        return loss, logits

    def generate(self, vision_x, lang_x, attention_mask=None,
                 **generate_kwargs) -> np.ndarray:
        """generate (`modeling_otter.py:999`): the GenerationConfig fields
        among the keyword arguments, `max_length` as prompt + new tokens,
        eos defaulting to <|endofchunk|>."""
        known = set(GenerationConfig.__dataclass_fields__)
        kwargs = {k: v for k, v in generate_kwargs.items() if k in known}
        kwargs.setdefault("eos_token_id", self.cfg.eoc_token_id)
        if "max_length" in generate_kwargs and \
                "max_new_tokens" not in kwargs:
            kwargs["max_new_tokens"] = max(
                int(generate_kwargs["max_length"]) - np.shape(lang_x)[1], 1)
        return self.engine.generate(vision_x, lang_x,
                                    attention_mask=attention_mask,
                                    gen=GenerationConfig(**kwargs))

    @torch.no_grad()
    def encode_vision(self, vision_x) -> torch.Tensor:
        """Vision latents for reuse across turns (`use_cached_vision_x`)."""
        return self.model.encode_vision(_on(vision_x, self.model.device))


class FlamingoForConditionalGeneration(OtterForConditionalGeneration):
    use_media_placement_augmentation = True
