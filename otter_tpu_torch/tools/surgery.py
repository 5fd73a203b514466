"""Checkpoint surgery on torch state dicts (counterpart of
`otter_tpu/tools/surgery.py`): build Otter/Flamingo weights from separate
sources, apply delta weights, merge LoRA.

Rebuild of the reference's conversion scripts:
  - injecting_{mpt,llama2,vicuna,falcon,mpt-1B}_into_flamingo.py:28-60 ->
    `inject_lm_into_flamingo` (base LM state dict + OpenFlamingo
    perceiver/xattn weights -> one Otter weight mapping)
  - pipeline/utils/apply_delta.py:12 -> `apply_delta`
  - LoRA merge -> `merge_lora`

Weights are flat mappings: HF names for state dicts, the port's
{flax path: tensor} (what `models.convert.load_flax_params` loads and
`export_flax_params` gives) for a model's weights. Values may be tensors
or numpy arrays; results are tensors.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x))


def inject_lm_into_flamingo(lm_state: Mapping, flamingo_state: Mapping,
                            cfg, *, lm_prefix: str = "lang_encoder.",
                            dtype=None) -> Dict[str, torch.Tensor]:
    """Merge a bare LM checkpoint (HF names WITHOUT the lang_encoder/
    OtterLayer wrapping) with OpenFlamingo perceiver/xattn/vision weights
    into {flax path: tensor} for the port's `OtterVLM` of `cfg`
    (`models.convert.hf_to_port`; `dtype` casts floating tensors).

    The LM's `transformer.blocks.N.x` names are rewritten to the wrapped
    `transformer.blocks.N.decoder_layer.x` form the Otter checkpoints use
    (injecting_mpt_into_flamingo.py:28-60 renames in the other direction).
    """
    from otter_tpu_torch.models.convert import hf_to_port

    merged = {}
    for k, v in lm_state.items():
        k = lm_prefix + k
        # wrap decoder layers: blocks.N.attn -> blocks.N.decoder_layer.attn
        k = re.sub(r"(\.(?:blocks|layers|h)\.\d+\.)(?!decoder_layer|"
                   r"gated_cross_attn_layer)", r"\1decoder_layer.", k)
        merged[k] = _tensor(v)
    merged.update((k, _tensor(v)) for k, v in flamingo_state.items())
    return dict(hf_to_port(merged, cfg, dtype=dtype).items())


def apply_delta(base: Mapping, delta: Mapping, *,
                subtract: bool = False) -> Dict[str, torch.Tensor]:
    """target = base + delta (or extract delta with subtract=True) —
    apply_delta.py:12 behavior. Keys only in one dict pass through."""
    out = dict(delta if not subtract else base)
    for k, b in base.items():
        if k in delta:
            d, b = _tensor(delta[k]), _tensor(b)
            if b.shape != d.shape:
                raise ValueError(f"shape mismatch for {k}")
            out[k] = (d - b) if subtract else (b + d)
    return out


def merge_lora(flat: Mapping, alpha: float = 16.0
               ) -> Dict[str, torch.Tensor]:
    """Fold each LoRA adapter (`.../lora_a` [in, r], `.../lora_b` [r, out])
    into its base kernel `.../base/kernel` and drop the adapters (the peft
    merge used before HF export): kernel + (alpha / r) * lora_a @ lora_b,
    computed in f32 and cast back to the kernel's dtype. `alpha` defaults
    to the config's 16. Other names pass through (`ops.lora.merge_adapters`
    also renames to the LoRA-free model's names for the HF export)."""
    out = {k: v for k, v in flat.items()
           if not k.endswith(("lora_a", "lora_b"))}
    for k in flat:
        if not k.endswith("lora_a"):
            continue
        prefix = k[: -len("lora_a")]
        base_key = prefix + "base/kernel"
        if base_key in out:
            a = _tensor(flat[k]).float()
            b = _tensor(flat[prefix + "lora_b"]).float()
            w = _tensor(out[base_key])
            out[base_key] = (w.float() + a @ b * (alpha / a.shape[1])).to(
                w.dtype)
    return out
