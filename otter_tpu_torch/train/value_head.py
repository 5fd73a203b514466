"""RLHF scaffolding: a value head over decoder hidden states (counterpart of
`otter_tpu/train/value_head.py`, the trl-style wrappers of the reference's
`pipeline/utils/modeling_value_head.py:21-415`): `ValueHead` (dropout,
then a scalar projection) and `DecoderWithValueHead`, whose forward gives
(lm_logits, values) for PPO-style training. The reference's training
loops never use it.

Dropout in training mode (`deterministic=False`) draws its mask from the
head's `torch.Generator`, so the dropped units are not `jax.random`'s;
the rule (keep with probability 1 - p, scale by 1 / (1 - p)) is flax's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from otter_tpu_torch.models.decoder import Decoder
from otter_tpu_torch.ops.layers import Dense


class ValueHead(nn.Module):
    """v_head: dropout -> `summary` Dense(hidden, 1)
    (modeling_value_head.py:21-54). `seed` seeds the dropout's
    generator."""

    def __init__(self, hidden_size: int, dropout: float = 0.1,
                 dtype=torch.float32, device=None, seed: int = 0):
        super().__init__()
        self.rate = dropout
        self.summary = Dense(hidden_size, 1, use_bias=True, dtype=dtype,
                             device=device)
        self.generator = torch.Generator(
            device=self.summary.kernel.device)
        self.generator.manual_seed(seed)

    def forward(self, hidden_states: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        x = hidden_states
        if not deterministic and self.rate > 0:
            keep = torch.rand(x.shape, generator=self.generator,
                              device=x.device) >= self.rate
            x = torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))
        return self.summary(x)[..., 0]    # [B, S]


class DecoderWithValueHead(nn.Module):
    """AutoModelForCausalLMWithValueHead equivalent
    (modeling_value_head.py:57-170): forward -> (logits, values)."""

    def __init__(self, cfg, dropout: float = 0.1, dtype=torch.float32,
                 device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.pretrained_model = Decoder(cfg, dtype=dtype, device=device)
        self.v_head = ValueHead(cfg.hidden_size, dropout, dtype, device,
                                seed)

    def forward(self, input_ids, attention_mask=None,
                positions: Optional[torch.Tensor] = None,
                deterministic: bool = True):
        logits, _, hidden = self.pretrained_model(
            input_ids, attention_mask=attention_mask, positions=positions,
            output_hidden=True)
        values = self.v_head(hidden, deterministic=deterministic)
        return logits, values
