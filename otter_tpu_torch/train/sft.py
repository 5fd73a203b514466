"""SFT trainer entry point (counterpart of `otter_tpu/train/sft.py`, the
reference's `pipeline/train/instruction_following.py`) on one device.

    main(args, tokenizer, batches)

runs the JAX trainer's loop: build the model, split trainable/frozen,
AdamW with f32 masters, the train step, metrics (console + metrics.jsonl),
periodic and final checkpoints, and resume. `batches` is a re-iterable
(e.g. a list) of collated batches in `MimicitLoader`'s
`{"net_input": {"input_ids", "attention_masks", "patch_images"}}` format:
the YAML -> dataset -> loader chain is not ported yet (ROADMAP Queue 1,
item 8.1), so a call without `batches` raises. Weights come from `params`
({flax path: array}, as `models.convert.load_flax_params` takes them) or,
without them, from `init_params` (seeded normal(0, 0.02) matrices, unit
norm scales, zero biases and gates; not the flax initializers, which come
with `init_fns`); `pretrained_checkpoint` or `trained_ckpt` (an HF
checkpoint) is then loaded over them as a partial update.

The model runs on the GPU unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, Optional

import torch

from otter_tpu_torch import config as cfgmod
from otter_tpu_torch.config import OtterConfig
from otter_tpu_torch.data.mimicit import (find_and_remove_tokens,
                                          mask_answer_labels)
from otter_tpu_torch.device import resolve_device
from otter_tpu_torch.models.convert import (load_flax_params,
                                             load_otter_checkpoint)
from otter_tpu_torch.models.idefics import IdeficsVLM
from otter_tpu_torch.models.otter import OtterVLM
from otter_tpu_torch.runtime.checkpoint import CheckpointStore
from otter_tpu_torch.runtime.metrics import AverageMeter, MetricsLogger
from otter_tpu_torch.train.args import TrainArgs, parse_args
from otter_tpu_torch.train.step import (TrainState, make_optimizer,
                                        make_train_step, split_params)

CONFIG_FACTORIES = {
    "mpt7b": cfgmod.otter_mpt7b,
    "idefics9b": cfgmod.idefics9b,
    "tiny-idefics": cfgmod.idefics_tiny,
    "tiny": lambda: OtterConfig.tiny("mpt"),
}


def build_model_and_config(args: TrainArgs, device=None):
    """Model-zoo dispatch (reference instruction_following.py:331-427):
    otter, flamingo and idefics; parameters left uninitialized."""
    if args.model_name not in ("otter", "flamingo", "idefics"):
        raise ValueError(f"unknown model_name {args.model_name!r}")
    cfg = CONFIG_FACTORIES[args.model_config]()
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    if args.model_name == "idefics":
        if args.customized_config:
            with open(args.customized_config) as f:
                cfg = cfgmod.IdeficsModelConfig.from_dict(
                    {**cfg.to_dict(), **json.load(f)})
        return IdeficsVLM(cfg, dtype=dtype, device=device,
                          remat=args.gradient_checkpointing), cfg
    if args.customized_config:
        with open(args.customized_config) as f:
            cfg = OtterConfig.from_dict({**cfg.to_dict(), **json.load(f)})
    if args.model_name == "flamingo":
        cfg = cfg.replace(use_media_placement_augmentation=True)
    return OtterVLM(cfg, dtype=dtype, device=device,
                    remat=args.gradient_checkpointing), cfg


@torch.no_grad()
def init_params(model: torch.nn.Module, seed: int, std: float = 0.02
                ) -> None:
    """Seeded random weights: normal(0, std) for every weight, 1 for norm
    scales, 0 for biases and the xattn tanh gates (idefics'
    `alpha_cross_attn` / `alpha_dense` too, as the JAX modules initialize
    their gates)."""
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "attn_gate", "ff_gate", "alpha_cross_attn",
                      "alpha_dense"):
            p.zero_()
        else:
            p.copy_(std * torch.randn(p.shape, generator=gen,
                                      device=p.device, dtype=torch.float32))


def prepare_batch(batch: dict, tokenizer, args: TrainArgs) -> Dict:
    """Collated loader batch -> train-step batch with masked labels."""
    ni = batch["net_input"]
    input_ids = ni["input_ids"]
    attention_mask = ni["attention_masks"]
    answer_id = tokenizer.convert_tokens_to_ids("<answer>")
    eoc_id = tokenizer.convert_tokens_to_ids("<|endofchunk|>")
    labels = mask_answer_labels(
        input_ids, answer_token_id=answer_id, eoc_token_id=eoc_id,
        eos_token_id=tokenizer.eos_token_id)
    if args.remove_answer_token:
        input_ids, labels, attention_mask = find_and_remove_tokens(
            input_ids, labels, attention_mask, answer_id,
            tokenizer.pad_token_id or 0)
    if args.remove_eos_token:
        input_ids, labels, attention_mask = find_and_remove_tokens(
            input_ids, labels, attention_mask, eoc_id,
            tokenizer.pad_token_id or 0)
    return {
        "vision_x": ni["patch_images"],
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "labels": labels,
    }


def main(args: TrainArgs, tokenizer=None,
         batches: Optional[Iterable[dict]] = None, *,
         params: Optional[Dict] = None, device=None) -> TrainState:
    if batches is None:
        raise NotImplementedError(
            "the MIMIC-IT data chain (training_data_yaml -> MimicitDataset "
            "-> MimicitLoader) is not ported yet (ROADMAP Queue 1, item 8.1): "
            "pass `batches`, collated batches in MimicitLoader's format")
    if tokenizer is None:
        raise ValueError("pass a tokenizer (convert_tokens_to_ids, "
                         "eos_token_id, pad_token_id)")
    if args.multi_host or max(args.dp, args.fsdp, args.sp, args.tp) > 1:
        raise NotImplementedError("multi-device training is not ported yet "
                                  "(ROADMAP Queue 1, item 9)")
    if args.save_hf_model:
        raise NotImplementedError("the HF export is not ported yet")
    device = resolve_device(device)
    rank, world = 0, 1

    model, cfg = build_model_and_config(args, device)
    if params is not None:
        load_flax_params(model, params)
    else:
        init_params(model, args.seed)
    if args.pretrained_checkpoint or args.trained_ckpt:
        # an HF checkpoint over the initial weights, as a partial update
        load_otter_checkpoint(args.trained_ckpt or args.pretrained_checkpoint,
                              cfg, model)

    steps_per_epoch = len(batches) // args.gradient_accumulation_steps
    total_steps = max(steps_per_epoch * args.num_epochs, 1)
    warmup = args.warmup_steps
    if args.warmup_steps_ratio is not None:
        warmup = int(args.warmup_steps_ratio * total_steps)

    trainable, _ = split_params(model, cfg)
    tx = make_optimizer(
        trainable, lr=args.learning_rate, schedule=args.lr_scheduler,
        warmup_steps=warmup, total_steps=total_steps,
        weight_decay=args.weight_decay,
        grad_accum_steps=args.gradient_accumulation_steps,
        mu_dtype=torch.bfloat16 if args.adam_mu_bf16 else None)
    state = TrainState.create(model, cfg, tx)
    step_fn = make_train_step(
        model, cfg, tx, mask_embedding=args.mask_lm_head,
        # (the idefics config has no such field; its forward takes the
        # argument and ignores it)
        attend_previous=not getattr(cfg, "use_media_placement_augmentation",
                                    False),
        fused_ce_chunk=args.fused_ce_chunk)

    save_dir = os.path.join(args.external_save_dir, args.run_name)
    store = CheckpointStore(
        save_dir, keep=1 if args.delete_previous_checkpoint else 3)
    start_epoch = 0
    if args.resume_from_checkpoint:
        state, meta = store.restore(state)
        start_epoch = meta.get("epoch", 0)

    logger = MetricsLogger(
        run_name=args.run_name, report_to_wandb=args.report_to_wandb,
        wandb_project=args.wandb_project, wandb_entity=args.wandb_entity,
        jsonl_path=os.path.join(save_dir, "metrics.jsonl"), rank=rank)
    step_time = AverageMeter()
    data_time = AverageMeter()

    global_step = state.step
    for epoch in range(start_epoch, args.num_epochs):
        end = time.time()
        for batch in batches:
            data_time.update(time.time() - end)
            prepared = prepare_batch(batch, tokenizer, args)
            state, metrics = step_fn(state, prepared)
            global_step = state.step
            step_time.update(time.time() - end)
            end = time.time()
            if global_step % args.logging_steps == 0:
                bsz = prepared["input_ids"].shape[0]
                logger.log(global_step, {
                    "loss": metrics["loss"],
                    "grad_norm": metrics["grad_norm"],
                    "step_time": step_time.avg,
                    "data_time": data_time.avg,
                    "samples_per_sec": bsz * world / max(
                        step_time.avg, 1e-9),
                    "epoch": epoch,
                })
            if (args.save_steps_interval > 0
                    and global_step % args.save_steps_interval == 0
                    and rank == 0):
                store.save(global_step, state, metadata={"epoch": epoch},
                           trainable_only=True)
        if args.save_ckpt_each_epoch and rank == 0:
            store.save(global_step, state, metadata={"epoch": epoch + 1},
                       trainable_only=True)

    if rank == 0 and args.final_checkpoint:
        store.save(global_step, state, metadata={"epoch": args.num_epochs},
                   trainable_only=True)
    logger.close()
    return state


if __name__ == "__main__":
    main(parse_args())
