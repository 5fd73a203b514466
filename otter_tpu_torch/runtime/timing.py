"""Timing helpers (counterpart of `otter_tpu/runtime/timing.py`).

`force_sync` waits for the device work behind a result; `time_fn` is the
median of synced wall times. The JAX module's `enable_compile_cache` has
no counterpart: the port's kernels are built once by nvcc into
`otter_tpu_torch/_build/` (keyed by a hash of their sources) and loaded
from there, and nothing else is compiled at run time.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


def _first_tensor(tree):
    if torch.is_tensor(tree):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def force_sync(tree) -> None:
    """Wait until the device that holds the first tensor of `tree` has
    finished its queued work (nothing to wait for on the CPU)."""
    t = _first_tensor(tree)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Median wall-clock seconds a call, each call synced."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    force_sync(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        force_sync(out)
        times.append(time.perf_counter() - t0)
    return float(statistics.median(times))
