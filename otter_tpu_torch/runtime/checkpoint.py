"""Checkpoint store (counterpart of `otter_tpu/runtime/checkpoint.py`):
save and restore the train state (trainable parameters, optimizer state
with its f32 masters and moments, step, optionally the frozen parameters),
keep the last N, one directory `checkpoint_<step>` per save holding
`state.pt` (`torch.save`) and `meta.json`.

The format is the port's own: reading or writing the JAX package's orbax
checkpoints is out of scope. `export_hf` writes the HF-named safetensors
file of the JAX store's export.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, Optional

import torch


class CheckpointStore:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep

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
        """state: train.step.TrainState. Re-saving a step overwrites it."""
        path = self._path(step)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        tree = {"step": step,
                "trainable": {k: p.detach() for k, p in
                              state.trainable.items()},
                "opt_state": state.opt_state.state_dict()}
        if not trainable_only:
            tree["frozen"] = {k: p.detach() for k, p in state.frozen.items()}
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
        with torch.no_grad():
            for group in ("trainable", "frozen"):
                for k, t in tree.get(group, {}).items():
                    getattr(state, group)[k].copy_(t)
        state.opt_state.load_state_dict(tree["opt_state"])
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
        params (`train.step.TrainState.params`: the trainable leaves from
        their f32 masters where the optimizer keeps them). Every floating tensor is written in f32, the JAX export's
        dtype: a bf16 frozen weight is widened exactly, so it equals the
        f32 value it was rounded from within bf16's rounding. Leaves no
        rule produces (int8 kernels and scales) are left out, as in the
        JAX export. A LoRA model's adapters are merged into their float
        bases (`port_to_hf`), where the JAX export drops the projection."""
        from otter_tpu_torch.models.convert import port_to_hf, \
            save_state_dict
        hf = port_to_hf(params, cfg)
        os.makedirs(os.path.dirname(os.path.abspath(out_path)) or ".",
                    exist_ok=True)
        # widened on the host, not beside the model on its device
        save_state_dict({k: v.detach().to("cpu", torch.float32)
                         if v.is_floating_point() else v
                         for k, v in hf.items()}, out_path)
        return out_path
