"""Checkpoint store (counterpart of `otter_tpu/runtime/checkpoint.py`):
save and restore the train state (trainable parameters, optimizer state
with its f32 masters and moments, step, optionally the frozen parameters),
keep the last N, one directory `checkpoint_<step>` per save holding
`state.pt` (`torch.save`) and `meta.json`.

The format is the port's own: reading or writing the JAX package's orbax
checkpoints is out of scope. `export_hf` writes the HF-named safetensors
file of the JAX store's export.

Under a mesh (`parallel.sharding.shard_params`) every rank calls `save`:
rank 0 writes the tensors it holds whole as they are, and the sharded
ones gathered to it alone in their dtype (`gather_full`), so the files
are those of a one-device run. `restore`
reads the full tensors on every rank and keeps each rank's shards: a
resume under a mesh equals a resume at one device.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, Optional

import torch

from otter_tpu_torch.parallel.sharding import (gather_full, global_flat_index,
                                               local_of, local_tensor)

_BLOCK_STATES = ("mu", "nu")     # the 8-bit Adam's int8 moments
_BLOCK_SCALES = ("mu_s", "nu_s")


def _layouts(state) -> Dict:
    return getattr(getattr(state, "model", None), "_shard_layouts",
                   None) or {}


def _blocked(lay, t) -> bool:
    """A sharded 8-bit moment: int8 over the local elements."""
    return (lay is not None and bool(lay.index) and t.dtype == torch.int8
            and t.dim() == 1)


def _full_blocks(lay, q, like):
    """A rank's int8 moments of its elements -> the global [nb, BLOCK] on
    rank 0 (None elsewhere)."""
    from otter_tpu_torch.train.opt8 import BLOCK
    full = gather_full(lay, q.view(like.shape))
    if full is None:
        return None
    nb = -(-full.numel() // BLOCK)
    flat = torch.zeros(nb * BLOCK, dtype=full.dtype)
    flat[:full.numel()] = full.reshape(-1)
    return flat.view(nb, BLOCK)


def full_params(state) -> Dict[str, torch.Tensor]:
    """`state.params` as full tensors (under a mesh a collective, whose
    sharded tensors only rank 0 gets: None elsewhere)."""
    lays = _layouts(state)
    return {k: gather_full(lays.get(k), v) for k, v in state.params.items()}


def _full_opt(state) -> dict:
    lays = _layouts(state)
    sd = state.opt_state.state_dict()
    if not lays:
        return sd
    like = {k: local_tensor(p) for k, p in state.trainable.items()}
    out = dict(sd)
    for key, tensors in sd.items():
        if not isinstance(tensors, dict):
            continue
        full = {}
        for k, t in tensors.items():
            lay = lays.get(k)
            if key in _BLOCK_SCALES:
                full[k] = t
            elif key in _BLOCK_STATES and _blocked(lay, t):
                full[k] = _full_blocks(lay, t, like[k])
            else:
                full[k] = gather_full(lay, t)
        out[key] = full
    return out


def _local_opt(state, sd: dict) -> dict:
    lays = _layouts(state)
    if not lays:
        return sd
    like = {k: local_tensor(p) for k, p in state.trainable.items()}
    mine = state.opt_state.state_dict()
    out = dict(sd)
    for key, tensors in sd.items():
        if not isinstance(tensors, dict):
            continue
        local = {}
        for k, t in tensors.items():
            lay = lays.get(k)
            if key in _BLOCK_SCALES:
                local[k] = t
            elif key in _BLOCK_STATES and _blocked(lay, mine[key][k]):
                local[k] = t.reshape(-1)[global_flat_index(
                    lay, like[k].shape, device=t.device)]
            else:
                local[k] = local_of(lay, t)
        out[key] = local
    return out


class CheckpointStore:
    def __init__(self, directory: str, *, keep: int = 3, rank: int = 0):
        """`rank`: the process's rank; only rank 0 writes."""
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.rank = rank

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{step}")

    def steps(self):
        out = []
        for d in os.listdir(self.directory):
            m = re.fullmatch(r"checkpoint_(\d+)", d)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, state, *, metadata: Optional[dict] = None,
             trainable_only: bool = False) -> str:
        """state: train.step.TrainState. Re-saving a step overwrites it.
        Under a mesh every rank calls it (`gather_full`); rank 0 writes."""
        lays = _layouts(state)
        full = lambda group: {
            k: gather_full(lays.get(k), local_tensor(p).detach())
            for k, p in getattr(state, group).items()}
        tree = {"step": step, "trainable": full("trainable"),
                "opt_state": _full_opt(state)}
        if not trainable_only:
            tree["frozen"] = full("frozen")
        path = self._path(step)
        if self.rank != 0:
            return path
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save(tree, os.path.join(path, "state.pt"))
        meta = dict(metadata or {}, step=step, trainable_only=trainable_only)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
        self._prune()
        return path

    def restore(self, state, step: Optional[int] = None):
        """Load a checkpoint into `state` in place (tensors go to the
        devices of the state's own). Returns (state, metadata)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._path(step)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        tree = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                          weights_only=True)
        lays = _layouts(state)
        with torch.no_grad():
            for group in ("trainable", "frozen"):
                for k, t in tree.get(group, {}).items():
                    local_tensor(getattr(state, group)[k]).copy_(
                        local_of(lays.get(k), t))
        state.opt_state.load_state_dict(_local_opt(state, tree["opt_state"]))
        state.step = int(tree["step"])
        return state, meta

    def _prune(self):
        steps = self.steps()
        while self.keep and len(steps) > self.keep:
            victim = steps.pop(0)
            shutil.rmtree(self._path(victim), ignore_errors=True)

    # ── HF-interop export (save_final_weights parity) ───────────────

    def export_hf(self, params: Dict[str, torch.Tensor], cfg,
                  out_path: str) -> str:
        """Write an HF-named .safetensors of the {flax path: tensor}
        params (`full_params(state)`, or `train.step.TrainState.params` at
        one device: the trainable leaves from
        their f32 masters where the optimizer keeps them). Every floating tensor is written in f32, the JAX export's
        dtype: a bf16 frozen weight is widened exactly, so it equals the
        f32 value it was rounded from within bf16's rounding. Leaves no
        rule produces (int8 kernels and scales) are left out, as in the
        JAX export. A LoRA model's adapters are merged into their float
        bases (`port_to_hf`), where the JAX export drops the projection."""
        from otter_tpu_torch.models.convert import port_to_hf, \
            save_state_dict
        if self.rank != 0:
            return out_path
        hf = port_to_hf(params, cfg)
        os.makedirs(os.path.dirname(os.path.abspath(out_path)) or ".",
                    exist_ok=True)
        # widened on the host, not beside the model on its device
        save_state_dict({k: v.detach().to("cpu", torch.float32)
                         if v.is_floating_point() else v
                         for k, v in hf.items()}, out_path)
        return out_path
