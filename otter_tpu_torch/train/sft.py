"""SFT trainer entry point (counterpart of `otter_tpu/train/sft.py`, the
reference's `pipeline/train/instruction_following.py`):

  subprocess pytest prerun gate      -> data.yaml_spec.verify_yaml
  model zoo dispatch (:331-427)      -> config factories
  weighted multi-dataloader sampling -> data.WeightedMultiLoader
  masking()/find_and_remove_tokens   -> data.mimicit helpers
  checkpointing                      -> runtime.checkpoint.CheckpointStore

    python -m otter_tpu_torch.train.sft --training_data_yaml=data.yaml \
        --tokenizer=<HF tokenizer dir> --model_config=mpt7b ...

`main(args, tokenizer, batches)` runs the JAX trainer's loop: the data
YAML gate, the model, the tokenizer (`AutoTokenizer` of `--tokenizer`
with Otter's three special tokens and `<PAD>`, unless one is passed), the
task-group loaders, AdamW with f32 masters, the train step, metrics
(console + metrics.jsonl), periodic and final checkpoints, resume, and
with `--save_hf_model` the whole state in the final checkpoint and
`final_weights.safetensors`. `batches`, a re-iterable of collated batches
in `MimicitLoader`'s format, stands in for the YAML's loaders where given.
Weights come from `params` ({flax path: array}, as
`models.convert.load_flax_params` takes them) or, without them, from
`init_params` (seeded normal(0, 0.02) matrices, unit norm scales, zero
biases and gates; not the flax initializers; the JAX trainer never reads
`init_config`, and neither does this one: `models.init_fns` is called by
hand on a bare decoder);
`pretrained_checkpoint` or `trained_ckpt` (an HF checkpoint) is then
loaded over them as a partial update.

The model runs on the GPU unless the caller passes `device="cpu"`. With
`--multi_host` (or WORLD_SIZE > 1) every process is a rank of the
`--dp/--fsdp/--sp/--tp` mesh (`parallel/`):

    torchrun --nproc_per_node 4 -m otter_tpu_torch.train.sft --multi_host \
        --fsdp -1 --training_data_yaml=data.yaml ...

the model is sharded (`shard_params`), each data rank loads its rows,
the loss is the global batch's, rank 0 logs, and every rank takes part in
a save that rank 0 writes. `batches`, where given, are this rank's.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List, Optional

import torch

from otter_tpu_torch import config as cfgmod
from otter_tpu_torch.config import OtterConfig
from otter_tpu_torch.data import (MimicitDataset, MimicitLoader,
                                  WeightedMultiLoader, find_and_remove_tokens,
                                  load_yaml, mask_answer_labels,
                                  tasks_from_spec, verify_yaml)
from otter_tpu_torch.models.convert import (load_flax_params,
                                             load_otter_checkpoint)
from otter_tpu_torch.models.idefics import IdeficsVLM
from otter_tpu_torch.models.otter import OtterVLM
from otter_tpu_torch.parallel.distributed import mesh_from_args, process_rank
from otter_tpu_torch.parallel.mesh import batch_sharding
from otter_tpu_torch.parallel.sharding import shard_params
from otter_tpu_torch.runtime.checkpoint import CheckpointStore, full_params
from otter_tpu_torch.runtime.metrics import AverageMeter, MetricsLogger
from otter_tpu_torch.train.args import TrainArgs, parse_args
from otter_tpu_torch.train.step import (TrainState, make_optimizer,
                                        make_train_step, split_params)

CONFIG_FACTORIES = {
    "mpt7b": cfgmod.otter_mpt7b,
    "mpt1b": cfgmod.otter_mpt1b,
    "llama7b-video": cfgmod.otter_llama7b_video,
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
    """Seeded random weights: normal(0, std) for every weight (LoRA's
    `lora_a` too, its own initializer at the default std), 1 for norm
    scales, 0 for biases, `lora_b` and the xattn tanh gates (idefics'
    `alpha_cross_attn` / `alpha_dense` too, as the JAX modules initialize
    their gates)."""
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "attn_gate", "ff_gate", "alpha_cross_attn",
                      "alpha_dense", "lora_b"):
            p.zero_()
        else:
            p.copy_(std * torch.randn(p.shape, generator=gen,
                                      device=p.device, dtype=torch.float32))


OTTER_TOKENS = ("<|endofchunk|>", "<image>", "<answer>")


def load_tokenizer(name_or_path: str, special_tokens=OTTER_TOKENS):
    """`AutoTokenizer.from_pretrained` plus `special_tokens` (Otter's; the
    pretrainer adds Flamingo's first two) and a `<PAD>` where the
    tokenizer has no pad token (`otter_tpu/train/sft.py:136-142`)."""
    from transformers import AutoTokenizer
    tokenizer = AutoTokenizer.from_pretrained(name_or_path)
    tokenizer.add_special_tokens({"additional_special_tokens": list(
        special_tokens)})
    if tokenizer.pad_token is None:
        tokenizer.add_special_tokens({"pad_token": "<PAD>"})
    return tokenizer


def build_loaders(args: TrainArgs, cfg, tokenizer, rank: int,
                  world: int) -> WeightedMultiLoader:
    """One `MimicitLoader` a task group of the data YAML, under a
    size-weighted random choice."""
    spec = load_yaml(args.training_data_yaml)
    per_process_batch = max(args.batch_size // max(world, 1), 1)
    loaders: List[MimicitLoader] = []
    for group, tasks in tasks_from_spec(spec).items():
        if not tasks:
            continue
        ds = MimicitDataset(
            tasks, tokenizer, task_group=group,
            instruction_format=args.instruction_format,
            max_seq_len=args.max_seq_len,
            patch_image_size=args.patch_image_size,
            resample_frames_to=args.resample_frames,
            keep_symbols=args.keep_symbols,
            populate_rel_ins=args.populate_rel_ins,
            with_task_description=args.with_task_description,
            device_preprocess=args.device_preprocess,
            seed=args.seed)
        loaders.append(MimicitLoader(
            ds, per_process_batch, seed=args.seed, num_workers=args.workers,
            rank=rank, world_size=world))
    if not loaders:
        raise ValueError("no task groups in the data YAML")
    return WeightedMultiLoader(loaders, seed=args.seed)


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
    # --multi_host (or WORLD_SIZE > 1): the process group and the mesh
    mesh, device = mesh_from_args(args, device)
    rank = process_rank()
    data_rank, data_world = batch_sharding(mesh)

    if batches is None:
        # pre-run data validation gate (train_utils.py:155-164 behavior)
        verify_yaml(args.training_data_yaml)
    model, cfg = build_model_and_config(args, device)
    text = getattr(cfg, "text", None)
    if args.save_hf_model and getattr(text, "lora_rank", 0) and text.quant:
        # refused before training, not after it
        from otter_tpu_torch.ops.lora import QUANTIZED_BASE_EXPORT
        raise ValueError(f"--save_hf_model: {QUANTIZED_BASE_EXPORT}")
    if tokenizer is None:
        tokenizer = load_tokenizer(args.tokenizer)
    if params is not None:
        load_flax_params(model, params)
    else:
        init_params(model, args.seed)
    if args.pretrained_checkpoint or args.trained_ckpt:
        # an HF checkpoint over the initial weights, as a partial update
        load_otter_checkpoint(args.trained_ckpt or args.pretrained_checkpoint,
                              cfg, model)

    trainable, _ = split_params(model, cfg)
    shard_params(mesh, model)
    multi = (build_loaders(args, cfg, tokenizer, data_rank, data_world)
             if batches is None else batches)
    steps_per_epoch = len(multi) // args.gradient_accumulation_steps
    total_steps = max(steps_per_epoch * args.num_epochs, 1)
    warmup = args.warmup_steps
    if args.warmup_steps_ratio is not None:
        warmup = int(args.warmup_steps_ratio * total_steps)

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
        fused_ce_chunk=args.fused_ce_chunk, mesh=mesh)

    save_dir = os.path.join(args.external_save_dir, args.run_name)
    store = CheckpointStore(
        save_dir, keep=1 if args.delete_previous_checkpoint else 3,
        rank=rank)
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
    n_devices = mesh.size() if mesh is not None else 1
    for epoch in range(start_epoch, args.num_epochs):
        if hasattr(multi, "set_epoch"):
            multi.set_epoch(epoch)
        end = time.time()
        for batch in multi:
            data_time.update(time.time() - end)
            prepared = prepare_batch(batch, tokenizer, args)
            state, metrics = step_fn(state, prepared)
            global_step = state.step
            step_time.update(time.time() - end)
            end = time.time()
            if global_step % args.logging_steps == 0:
                # every data rank's rows: samples/s of the world
                bsz = prepared["input_ids"].shape[0] * data_world
                logger.log(global_step, {
                    "loss": metrics["loss"],
                    "grad_norm": metrics["grad_norm"],
                    "step_time": step_time.avg,
                    "data_time": data_time.avg,
                    "samples_per_sec": bsz / max(step_time.avg, 1e-9),
                    "samples_per_sec_per_chip": bsz / max(
                        step_time.avg, 1e-9) / n_devices,
                    "epoch": epoch,
                })
            # (under a mesh every rank calls it; rank 0 writes)
            if (args.save_steps_interval > 0
                    and global_step % args.save_steps_interval == 0):
                store.save(global_step, state, metadata={"epoch": epoch},
                           trainable_only=True)
        if args.save_ckpt_each_epoch:
            store.save(global_step, state, metadata={"epoch": epoch + 1},
                       trainable_only=True)

    if args.final_checkpoint:
        store.save(global_step, state, metadata={"epoch": args.num_epochs},
                   trainable_only=not args.save_hf_model)
    if args.save_hf_model:
        store.export_hf(full_params(state), cfg,
                        os.path.join(save_dir, "final_weights.safetensors"))
    logger.close()
    return state


if __name__ == "__main__":
    main(parse_args())
