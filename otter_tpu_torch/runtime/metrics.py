"""Metrics and logging (counterpart of `otter_tpu/runtime/metrics.py`):
step timing meters, a console + JSONL (+ wandb when asked) sink, and a
`torch.profiler` trace context in place of the JAX profiler's.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Optional


class AverageMeter:
    """Running average (train_utils.py:83-99)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class MetricsLogger:
    """Console + optional wandb + JSONL metrics sink. Values may be 0-d
    tensors: logging one reads it (and so waits for the device)."""

    def __init__(self, *, run_name: str = "run", report_to_wandb: bool = False,
                 wandb_project: Optional[str] = None,
                 wandb_entity: Optional[str] = None,
                 jsonl_path: Optional[str] = None, rank: int = 0):
        self.rank = rank
        self.jsonl = None
        self.wandb = None
        if rank != 0:
            return
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)
            self.jsonl = open(jsonl_path, "a")
        if report_to_wandb:
            try:
                import wandb
                wandb.init(project=wandb_project, entity=wandb_entity,
                           name=run_name)
                self.wandb = wandb
            except Exception as e:
                print(f"wandb unavailable ({e}); console logging only",
                      file=sys.stderr)

    def log(self, step: int, metrics: dict):
        if self.rank != 0:
            return
        clean = {k: (float(v) if hasattr(v, "__float__") else v)
                 for k, v in metrics.items()}
        print(f"[step {step}] " + " ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in clean.items()), flush=True)
        if self.jsonl:
            self.jsonl.write(json.dumps({"step": step, **clean}) + "\n")
            self.jsonl.flush()
        if self.wandb:
            self.wandb.log(clean, step=step)

    def close(self):
        if self.jsonl:
            self.jsonl.close()
            self.jsonl = None


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """torch.profiler over a code region (CPU, and CUDA when there is a
    card); writes `trace.json` (Chrome trace) and `kernels.txt` (time by
    op) into `logdir`. A no-op when logdir is empty."""
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort = ("self_cuda_time_total" if torch.cuda.is_available()
            else "self_cpu_time_total")
    with open(os.path.join(logdir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=60))
