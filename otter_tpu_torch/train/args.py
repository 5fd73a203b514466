"""Training argument surface (counterpart of `otter_tpu/train/args.py`, the
reference's `pipeline/train/train_args.py:15-206`) as a dataclass + argparse
front-end. A copy of the JAX package's fields, so the two trainers take the
same flags. `final_checkpoint` is the port's one addition."""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class TrainArgs:
    # model
    model_name: str = "otter"          # otter | flamingo | fuyu | debug_model
    model_config: str = "mpt7b"        # mpt7b | mpt1b | llama7b-video | tiny
    instruction_format: str = "simple"  # simple | llama2 | idefics | fuyu
    pretrained_checkpoint: str = ""
    trained_ckpt: str = ""
    tokenizer: str = ""
    customized_config: str = ""
    # data
    training_data_yaml: str = ""
    max_seq_len: int = 2048
    patch_image_size: int = 224
    resample_frames: int = 32
    keep_symbols: bool = True
    remove_answer_token: bool = False
    remove_eos_token: bool = False
    populate_rel_ins: bool = False
    with_task_description: bool = False
    dynamic_resolution: bool = False
    # split preprocessing: host decodes+resizes uint8 only; normalize on TPU
    device_preprocess: bool = False
    workers: int = 4
    # optimization
    batch_size: int = 128
    gradient_accumulation_steps: int = 1
    num_epochs: int = 1
    learning_rate: float = 1e-4
    lr_scheduler: str = "constant"     # constant | linear | cosine
    warmup_steps: int = 1000
    warmup_steps_ratio: Optional[float] = None
    weight_decay: float = 0.1
    gradient_checkpointing: bool = False
    adam_mu_bf16: bool = False         # first moment in bf16 (saves HBM)
    # chunked fused CE (no [B,S,V] logits materialized; grads bit-match
    # the standard path — tests/test_train.py). 0 opts out.
    fused_ce_chunk: int = 256
    mask_lm_head: bool = False
    seed: int = 42
    # parallelism (replaces accelerate/deepspeed YAML)
    dp: int = 1
    fsdp: int = -1
    sp: int = 1      # sequence/context parallel (ring attention)
    tp: int = 1
    precision: str = "bf16"            # bf16 | fp32
    multi_host: bool = False           # start torch.distributed
    # checkpointing / logging
    external_save_dir: str = "runs"
    run_name: str = "otter-tpu"
    save_steps_interval: int = -1
    save_ckpt_each_epoch: bool = False
    save_hf_model: bool = False
    resume_from_checkpoint: str = ""
    delete_previous_checkpoint: bool = False
    # the port's addition: False skips the final save (a smoke run of the
    # full-width model, whose optimizer state is tens of GB)
    final_checkpoint: bool = True
    logging_steps: int = 100
    report_to_wandb: bool = False
    wandb_project: Optional[str] = None
    wandb_entity: Optional[str] = None
    profile_dir: str = ""


def parse_args(argv=None) -> TrainArgs:
    p = argparse.ArgumentParser("otter_tpu_torch trainer")
    defaults = TrainArgs()
    for name, f in defaults.__dataclass_fields__.items():
        val = getattr(defaults, name)
        flag = "--" + name
        if isinstance(val, bool):
            p.add_argument(flag, action="store_true" if not val
                           else "store_false")
        elif val is None:
            p.add_argument(flag, type=str, default=None)
        else:
            p.add_argument(flag, type=type(val), default=val)
    ns = p.parse_args(argv)
    return TrainArgs(**vars(ns))
