"""OtterHD/Fuyu SFT: full fine-tuning on MIMIC-IT data (counterpart of
`otter_tpu/train/fuyu_sft.py`).

The reference trains Fuyu by keeping PIL images through collation and
running FuyuProcessor at batch time (`prepare_fuyu`,
mimicit_dataset.py:497-507: optional dynamic resolution drawn from
{448², 512², 768²}; labels from the \\x04 span, last \\x04 -> EOS), with the
whole model trainable (OtterHD full-finetunes; docs/OtterHD.md).

The step is `FuyuVLM` forward (its `remat` recomputes each decoder layer
in the backward), `causal_lm_loss` over the full logits, and either of the
port's optimizers over every parameter. At OtterHD-8B's size that is
`make_optimizer(state_bits=8)` over bf16 parameters: AdamW's f32 masters
and moments alone would take ~113 GB. The JAX package has no fuyu branch
in its SFT trainer and no fuyu CLI, and neither has the port.
"""

from __future__ import annotations

import random
from typing import Dict, Sequence, Tuple

import torch

from otter_tpu_torch.data.fuyu_processor import FuyuProcessor
from otter_tpu_torch.models.fuyu import FuyuVLM
from otter_tpu_torch.train.step import (AdamW, GlobalLoss, TrainState,
                                        _on_device, apply_grads,
                                        causal_lm_loss, flax_path,
                                        local_params)

DYNAMIC_RESOLUTIONS = ((448, 448), (512, 512), (768, 768))


class FuyuBatcher:
    """Collates MIMIC-IT samples (full_text + decoded images) into Fuyu
    batches with masked labels (numpy)."""

    def __init__(self, processor: FuyuProcessor, *,
                 dynamic_resolution: bool = False, seed: int = 0):
        self.processor = processor
        self.dynamic_resolution = dynamic_resolution
        self.rng = random.Random(seed)

    def __call__(self, texts: Sequence[str], images: Sequence) -> Dict:
        resolution = None
        if self.dynamic_resolution:
            resolution = self.rng.choice(DYNAMIC_RESOLUTIONS)
        batch = self.processor(list(texts), list(images),
                               target_resolution=resolution)
        labels = self.processor.get_labels(batch["input_ids"])
        input_ids, labels = self.processor.find_and_remove_tokens(
            batch["input_ids"], labels)
        batch["input_ids"] = input_ids
        batch["labels"] = labels
        return batch


def fuyu_train_state(model: FuyuVLM, tx: AdamW) -> TrainState:
    """The full fine-tune's state: every parameter trainable (the JAX
    step's {params, opt_state, step})."""
    params = {}
    for name, p in model.named_parameters():
        p.requires_grad_(True)
        params[flax_path(name)] = p
    if hasattr(model, "_shard_layouts"):
        tx.shard(model._shard_layouts, model._shard_groups)
    return TrainState(step=0, model=model, trainable=params, frozen={},
                      opt_state=tx.init(local_params(params)))


def make_fuyu_train_step(model: FuyuVLM, tx: AdamW, *, mesh=None):
    """step(state, batch) -> (state, metrics): one full-model update of
    the `fuyu_train_state`. batch: `FuyuBatcher`'s arrays (or tensors).
    metrics: loss, tokens, grad_norm (0-d tensors on the model's device).

    mesh: the model's mesh (`parallel.sharding.shard_params`): the
    self-attention runs as the ring over its "seq" axis, as JAX
    `fuyu_sft.py:55-70` routes it, and the loss is the global batch's."""
    device = model.device
    global_loss = GlobalLoss(mesh)

    def loss_fn(b) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, _ = model(
            b["input_ids"].long(), image_patches=b["image_patches"],
            image_patches_indices=b["image_patches_indices"].long(),
            attention_mask=b["attention_mask"])
        return causal_lm_loss(logits, b["labels"])

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        b = _on_device(batch, device)
        for p in state.trainable.values():
            p.grad = None
        with global_loss.context():
            loss, n = loss_fn(b)
        loss, report, n = global_loss(loss, b["labels"], n)
        loss.backward()
        global_loss.sync_grads(state.trainable)
        return state, {"loss": report, "tokens": n,
                       "grad_norm": apply_grads(state, tx)}

    return step
