"""Generation engine: batched left-padded prefill + KV-cached decode
(counterpart of `otter_tpu/generation/engine.py`).

`OtterGenerator.generate` encodes the vision input once, runs one prefill
that writes the stacked KV cache and computes only the last position's
logits (`head_last_only`), then decodes with a Python loop of single-token
steps that update the cache in place. The JAX engine runs the same loop
inside one jitted `lax.while_loop`.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Union

import numpy as np
import torch

from otter_tpu_torch.config import GenerationConfig, OtterConfig, TextConfig
from otter_tpu_torch.generation import sampling
from otter_tpu_torch.models.decoder import init_cache
from otter_tpu_torch.models.otter import OtterVLM

CacheDtype = Union[torch.dtype, str]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _cache_name(dtype: CacheDtype) -> str:
    if isinstance(dtype, str):
        return dtype
    return "int8" if dtype == torch.int8 else "bf16"


def cache_bytes(text_cfg: TextConfig, batch: int, cache_len: int,
                dtype: CacheDtype) -> int:
    """Device bytes of one KV cache (entries + int8 scales)."""
    rows = batch * text_cfg.num_hidden_layers * text_cfg.kv_heads * cache_len
    if _cache_name(dtype) == "int8":
        return 2 * rows * text_cfg.head_dim + 2 * 4 * rows
    return 2 * rows * text_cfg.head_dim * 2


# the int4 rung of the JAX ladder is not ported yet
_LADDER = ["bf16", "int8"]
_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}


def select_cache_dtype(text_cfg: TextConfig, batch: int, cache_len: int,
                       requested: CacheDtype, *, device: torch.device,
                       param_bytes: int = 0,
                       hbm_bytes: Optional[float] = None,
                       headroom_bytes: Optional[float] = None
                       ) -> CacheDtype:
    """Degrade-not-die KV-cache precision: when the requested cache does
    not fit next to the resident parameters, step down the ladder
    (bf16 -> int8) with a warning instead of failing. On CUDA the budget
    is the free device memory from `torch.cuda.mem_get_info` less the
    headroom; `OTTER_HBM_BYTES` (total bytes, parameters then subtracted)
    and `OTTER_HBM_HEADROOM` override it. On the CPU the request is
    returned unchanged."""
    if device.type != "cuda":
        return requested
    env_hbm = os.environ.get("OTTER_HBM_BYTES")
    env_head = os.environ.get("OTTER_HBM_HEADROOM")
    if headroom_bytes is None:
        headroom_bytes = float(env_head) if env_head else 5.0e9
    if hbm_bytes is None and env_hbm:
        hbm_bytes = float(env_hbm)
    if hbm_bytes is not None:
        budget = hbm_bytes - headroom_bytes - param_bytes
    else:
        budget = torch.cuda.mem_get_info(device)[0] - headroom_bytes
    name = _cache_name(requested)
    for step in _LADDER[_LADDER.index(name):]:
        if cache_bytes(text_cfg, batch, cache_len, step) <= budget:
            if step != name:
                warnings.warn(
                    f"KV cache degraded {name} -> {step}: a b={batch} "
                    f"L={cache_len} {name} cache does not fit in "
                    f"{budget / 1e9:.1f} GB of device memory", stacklevel=2)
            return _DTYPES[step]
    warnings.warn(f"KV cache b={batch} L={cache_len} exceeds device memory "
                  f"even at int8; proceeding with int8", stacklevel=2)
    return torch.int8


def _on(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.asarray(x)).to(device)


def left_pad(lang_x: np.ndarray, attention_mask: Optional[np.ndarray],
             target_len: Optional[int] = None, pad_id: int = 0):
    """Right-padded (or ragged-masked) batch -> left-padded [B, P]."""
    lang_x = np.asarray(lang_x)
    b, s = lang_x.shape
    if attention_mask is None:
        attention_mask = np.ones_like(lang_x)
    attention_mask = np.asarray(attention_mask)
    p = target_len or s
    out = np.full((b, p), pad_id, lang_x.dtype)
    mask = np.zeros((b, p), np.int32)
    for i in range(b):
        real = lang_x[i][attention_mask[i].astype(bool)]
        out[i, p - len(real):] = real
        mask[i, p - len(real):] = 1
    return out, mask


class OtterGenerator:
    """Greedy / sampled generation over an `OtterVLM`, on the model's
    device."""

    def __init__(self, model: OtterVLM,
                 cache_dtype: CacheDtype = torch.bfloat16):
        self.model = model
        self.cfg: OtterConfig = model.cfg
        self.cache_dtype = cache_dtype
        self.param_bytes = sum(t.numel() * t.element_size() for t in
                               list(model.parameters()) + list(model.buffers()))

    @property
    def device(self) -> torch.device:
        return self.model.device

    @torch.inference_mode()
    def generate(self, vision_x, lang_x, attention_mask=None,
                 gen: Optional[GenerationConfig] = None,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """vision_x [B,T,F,C,H,W] float pixels; lang_x [B,P] LEFT-padded
        (see `left_pad`). Returns [B, P + max_new_tokens] (prompt +
        generation, eos-terminated, pad-filled)."""
        gen = gen or GenerationConfig()
        if gen.num_beams > 1:
            raise NotImplementedError("beam search is not ported yet")
        dev = self.device
        eos = gen.eos_token_id if gen.eos_token_id is not None \
            else self.cfg.eoc_token_id
        lang_x = _on(lang_x, dev).long()
        b, p = lang_x.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, p), dtype=torch.int32, device=dev)
        attention_mask = _on(attention_mask, dev).int()
        vision_x = _on(vision_x, dev)
        max_new = gen.max_new_tokens
        cache_len = _round_up(p + max_new, 128)
        cache_dtype = select_cache_dtype(
            self.cfg.text, b, cache_len, self.cache_dtype, device=dev,
            param_bytes=self.param_bytes)
        cache = init_cache(self.cfg.text, b, cache_len, cache_dtype, dev)

        logits, cache, vis_latents = self.model(
            vision_x, lang_x, attention_mask=attention_mask, cache=cache,
            head_last_only=True)
        last_logits = logits[:, -1]
        media_counts = (lang_x == self.cfg.media_token_id).int().sum(-1)
        valid_from = p - attention_mask.sum(-1)
        buffer = torch.cat([lang_x, torch.full(
            (b, cache_len - p), gen.pad_token_id, dtype=torch.long,
            device=dev)], dim=1)
        kv_valid = torch.cat([attention_mask.bool(), torch.zeros(
            (b, cache_len - p), dtype=torch.bool, device=dev)], dim=1)

        def sample_from(logits, t, done):
            logits = sampling.process_logits(logits, buffer, p + t, gen,
                                             valid_from)
            tok = sampling.sample_token(
                logits, do_sample=gen.do_sample,
                temperature=gen.temperature, top_k=gen.top_k,
                top_p=gen.top_p, generator=generator)
            return torch.where(done, gen.pad_token_id, tok)

        done = torch.zeros(b, dtype=torch.bool, device=dev)
        tok = sample_from(last_logits, 0, done)
        done = tok == eos
        buffer[:, p] = tok
        t = 1
        while t < max_new and not bool(done.all()):
            kv_valid[:, p + t - 1] = True
            logits, cache, _ = self.model(
                None, tok[:, None], vis_latents=vis_latents, cache=cache,
                cache_pos=p + t - 1, kv_valid=kv_valid,
                media_counts=media_counts)
            nxt = sample_from(logits[:, -1], t, done)
            done = done | (nxt == eos)
            buffer[:, p + t] = nxt
            tok = nxt
            t += 1
        return buffer[:, : p + max_new].cpu().numpy()
