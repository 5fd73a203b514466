"""Flamingo pretraining: joint LAION + MMC4 (counterpart of
`otter_tpu/train/pretrain.py`, the reference's
`pipeline/train/pretraining.py`), plus the CC3M variant
(`pretraining_cc3m.py`), on one device.

Loss = loss_multiplier_laion * L_laion + loss_multiplier_mmc4 * L_mmc4
(defaults 0.2 / 1.0, pretraining.py:115-116), both batches in one step:
each batch's weighted loss is backpropagated in turn and the gradients
add up before the one update, so only one batch's activations are held
at a time. Label policies (pretraining.py:232-295):

  - pairs (LAION / CC3M): labels = ids; pad, position 0 and <image> -> -100
  - interleaved (MMC4): additionally mask text before the first <image>
    and text between an <|endofchunk|> and the following <image> (only
    image-conditioned spans train)

Epoch resume restores the model, optimizer and step from the latest
checkpoint (pretraining.py:493-510) through `CheckpointStore`.

    python -m otter_tpu_torch.train.pretrain --laion_shards 'l-{0..9}.tar' \\
        --mmc4_shards 'm-{0..9}.tar' --tokenizer <HF tokenizer dir>

The model runs on the GPU unless the caller passes `device="cpu"`.
Weights start from `sft.init_params` (seeded), where the JAX trainer takes
flax's initializers from the same seed.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, Optional

import numpy as np
import torch

from otter_tpu_torch.config import PRESETS, OtterConfig
from otter_tpu_torch.data.webdataset import get_data
from otter_tpu_torch.config import ParallelConfig
from otter_tpu_torch.device import resolve_device
from otter_tpu_torch.models.otter import OtterVLM
from otter_tpu_torch.parallel.distributed import (init_distributed_device,
                                                  mesh_from_args,
                                                  process_rank,
                                                  world_info_from_env)
from otter_tpu_torch.parallel.mesh import batch_sharding, mesh_shape
from otter_tpu_torch.parallel.sharding import shard_params
from otter_tpu_torch.runtime.checkpoint import CheckpointStore
from otter_tpu_torch.runtime.metrics import MetricsLogger
from otter_tpu_torch.train.sft import (OTTER_TOKENS, init_params,
                                       load_tokenizer)
from otter_tpu_torch.train.step import (GlobalLoss, TrainState, _on_device,
                                        apply_grads, causal_lm_loss,
                                        make_optimizer, split_params)


def pair_labels(input_ids: np.ndarray, pad_id: int,
                media_id: int) -> np.ndarray:
    labels = input_ids.astype(np.int32).copy()
    labels[labels == pad_id] = -100
    labels[:, 0] = -100
    labels[labels == media_id] = -100
    return labels


def interleaved_labels(input_ids: np.ndarray, pad_id: int, media_id: int,
                       eoc_id: int) -> np.ndarray:
    labels = pair_labels(input_ids, pad_id, media_id)
    ids = input_ids
    b, s = ids.shape
    for i in range(b):
        # mask until the first <image>
        t = 0
        while t < s and ids[i, t] != media_id:
            labels[i, t] = -100
            t += 1
        # after each <|endofchunk|>, mask until the next <image>
        for start in np.nonzero(ids[i] == eoc_id)[0]:
            t = start + 1
            while t < s and ids[i, t] != media_id:
                labels[i, t] = -100
                t += 1
    return labels


def make_pretrain_step(model: OtterVLM, cfg: OtterConfig, tx, *,
                       loss_multiplier_laion: float = 0.2,
                       loss_multiplier_mmc4: float = 1.0,
                       mesh=None):
    """step(state, laion_batch, mmc4_batch, attend_prev=True) ->
    (state, metrics).

    Each batch: {vision_x, input_ids, attention_mask, labels} (numpy or
    tensors); either may be None (CC3M only, etc.). `attend_prev` is the
    media-placement augmentation's draw (`train` draws it each step).
    metrics: loss, loss_laion / loss_mmc4 (for the batches given) and
    grad_norm, 0-d tensors on the model's device.

    mesh: the model's mesh (`parallel.sharding.shard_params`); each batch
    is this rank's rows and each loss the mean over its global batch."""
    device = model.device
    global_loss = GlobalLoss(mesh)

    def step(state: TrainState, laion_batch, mmc4_batch,
             attend_prev: bool = True):
        for p in state.trainable.values():
            p.grad = None
        total = torch.zeros((), dtype=torch.float32, device=device)
        metrics = {}
        for name, batch, mult in (
                ("loss_laion", laion_batch, loss_multiplier_laion),
                ("loss_mmc4", mmc4_batch, loss_multiplier_mmc4)):
            if batch is None:
                continue
            b = _on_device(batch, device)
            with global_loss.context():
                logits, _, _ = model(b["vision_x"], b["input_ids"].long(),
                                     attention_mask=b["attention_mask"],
                                     attend_previous=attend_prev)
                loss, n = causal_lm_loss(logits, b["labels"])
            del logits
            loss, report, _ = global_loss(loss, b["labels"], n)
            (mult * loss).backward()
            metrics[name] = report
            total = total + mult * report
        global_loss.sync_grads(state.trainable)
        metrics["loss"] = total
        metrics["grad_norm"] = apply_grads(state, tx)
        return state, metrics

    return step


def train(args, tokenizer, *, dataset_types=("laion", "mmc4"),
          device=None) -> TrainState:
    """The pretraining loop; `args` is a `PretrainArgs` (its `model_cfg`
    set, else the tiny MPT model). With --multi_host (or WORLD_SIZE > 1)
    each process is a rank of the mesh: each data rank reads its part of
    the shards, and the placement augmentation's draws follow the data
    rank."""
    mesh, device = mesh_from_args(args, device)
    rank = process_rank()
    data_rank, data_world = batch_sharding(mesh)
    args.rank, args.world_size = data_rank, data_world

    cfg = getattr(args, "model_cfg", None) or OtterConfig.tiny("mpt")
    cfg = cfg.replace(use_media_placement_augmentation=True)  # Flamingo
    model = OtterVLM(cfg, dtype=torch.bfloat16 if args.precision == "bf16"
                     else torch.float32, device=device)
    datas = {t: get_data(args, tokenizer, t) for t in dataset_types}
    steps_per_epoch = min(d.num_batches for d in datas.values())

    init_params(model, args.seed)
    trainable, _ = split_params(model, cfg)
    shard_params(mesh, model)
    tx = make_optimizer(
        trainable, lr=args.learning_rate, schedule=args.lr_scheduler,
        warmup_steps=args.warmup_steps,
        total_steps=steps_per_epoch * args.num_epochs,
        weight_decay=args.weight_decay)
    state = TrainState.create(model, cfg, tx)
    # the "laion slot" carries whichever image-text-pair source is
    # configured; CC3M uses its own multiplier (reference
    # pretraining_cc3m.py:101 default 1.0, against LAION's 0.2)
    pair_mult = (args.loss_multiplier_laion if "laion" in datas
                 else args.loss_multiplier_cc3m)
    step_fn = make_pretrain_step(
        model, cfg, tx, loss_multiplier_laion=pair_mult,
        loss_multiplier_mmc4=args.loss_multiplier_mmc4, mesh=mesh)

    save_dir = os.path.join(args.external_save_dir, args.run_name)
    store = CheckpointStore(save_dir, keep=3, rank=rank)
    start_epoch = 0
    if store.latest_step() is not None:   # epoch resume
        state, meta = store.restore(state)
        start_epoch = meta.get("epoch", 0)

    logger = MetricsLogger(run_name=args.run_name, rank=rank,
                           jsonl_path=os.path.join(save_dir,
                                                   "metrics.jsonl"))
    pyrng = random.Random(args.seed + data_rank)
    media_id, eoc_id = cfg.media_token_id, cfg.eoc_token_id
    pad_id = tokenizer.pad_token_id or 0

    for epoch in range(start_epoch, args.num_epochs):
        for d in datas.values():
            d.dataloader.set_epoch(epoch)
        iters = {t: iter(d.dataloader) for t, d in datas.items()}
        for _ in range(steps_per_epoch):
            batches: Dict[str, dict] = {}
            try:
                for t, it in iters.items():
                    raw = next(it)
                    labels = (interleaved_labels(
                        raw["input_ids"], pad_id, media_id, eoc_id)
                        if t == "mmc4" else pair_labels(
                            raw["input_ids"], pad_id, media_id))
                    batches[t] = {"vision_x": raw["images"],
                                  "input_ids": raw["input_ids"],
                                  "attention_mask": raw["attention_mask"],
                                  "labels": labels}
            except StopIteration:
                break
            attend_prev = pyrng.random() < 0.5   # placement augmentation
            pair = batches.get("laion")
            state, metrics = step_fn(
                state, pair if pair is not None else batches.get("cc3m"),
                batches.get("mmc4"), attend_prev=attend_prev)
            if state.step % args.logging_steps == 0:
                logger.log(state.step, metrics)
        # (every rank calls it; rank 0 writes)
        store.save(state.step, state, metadata={"epoch": epoch + 1})
    logger.close()
    return state


@dataclasses.dataclass
class PretrainArgs:
    """CLI surface of the reference `pipeline/train/pretraining.py`
    argparse (shards, per-source batch sizes and sample counts, loss
    multipliers) on top of the shared TrainArgs-style optimization
    fields; the JAX package's fields."""
    laion_shards: str = ""             # brace syntax: /p/{00000..01234}.tar
    mmc4_shards: str = ""
    cc3m_shards: str = ""
    batch_size_laion: int = 128
    batch_size_mmc4: int = 32
    batch_size_cc3m: int = 128
    train_num_samples_laion: int = 10000
    train_num_samples_mmc4: int = 10000
    train_num_samples_cc3m: int = 10000
    mmc4_textsim_threshold: float = 0.24
    loss_multiplier_laion: float = 0.2
    loss_multiplier_mmc4: float = 1.0
    loss_multiplier_cc3m: float = 1.0  # pretraining_cc3m.py:101
    model_config: str = "mpt1b"
    tokenizer: str = ""
    workers: int = 4
    patch_image_size: int = 224
    batch_size: int = 128
    num_epochs: int = 1
    learning_rate: float = 1e-4
    lr_scheduler: str = "constant"
    warmup_steps: int = 1875           # pretraining.py default
    weight_decay: float = 0.1
    seed: int = 42
    dp: int = 1
    fsdp: int = -1
    tp: int = 1
    precision: str = "bf16"
    multi_host: bool = False
    external_save_dir: str = "runs"
    run_name: str = "flamingo-pretrain"
    logging_steps: int = 100
    # filled in by train()
    rank: int = 0
    world_size: int = 1
    media_token_id: int = -1


def parse_args(argv=None) -> PretrainArgs:
    import argparse

    p = argparse.ArgumentParser("otter_tpu_torch pretrainer")
    defaults = PretrainArgs()
    for name in defaults.__dataclass_fields__:
        if name in ("rank", "world_size", "media_token_id"):
            continue
        val = getattr(defaults, name)
        if isinstance(val, bool):
            p.add_argument("--" + name, action="store_true")
        else:
            p.add_argument("--" + name, type=type(val), default=val)
    return PretrainArgs(**vars(p.parse_args(argv)))


def main(argv=None, *, device=None) -> Optional[TrainState]:
    args = parse_args(argv)
    # the mesh's flags are checked (and the process group started) before
    # anything loads
    if args.multi_host or world_info_from_env()[2] > 1:
        init_distributed_device(device)
    else:
        mesh_shape(ParallelConfig(dp=args.dp, fsdp=args.fsdp, tp=args.tp),
                   1)
    device = resolve_device(device)
    cfg = PRESETS[args.model_config]()
    args.model_cfg = cfg.replace(use_media_placement_augmentation=True)
    args.media_token_id = cfg.media_token_id

    types = [t for t, shards in (("laion", args.laion_shards),
                                 ("mmc4", args.mmc4_shards),
                                 ("cc3m", args.cc3m_shards)) if shards]
    if not types:
        raise SystemExit("provide at least one of --laion_shards/"
                         "--mmc4_shards/--cc3m_shards")
    # Flamingo's two tokens and <PAD>, as the JAX `main` adds them
    tokenizer = load_tokenizer(args.tokenizer, OTTER_TOKENS[:2])
    return train(args, tokenizer, dataset_types=tuple(types), device=device)


if __name__ == "__main__":
    main()
