"""Generation engine: batched left-padded prefill + KV-cached decode
(counterpart of `otter_tpu/generation/engine.py`).

`OtterGenerator.generate` encodes the vision input once, runs one prefill
that writes the stacked KV cache and computes only the last position's
logits (`head_last_only`), then decodes with a Python loop of single-token
steps that update the cache in place. The JAX engine runs the same loop
inside one jitted `lax.while_loop`. `stream_generate` runs the same
prefill and steps for one request and yields each token as it is sampled.
"""

from __future__ import annotations

import os
import warnings
from types import SimpleNamespace
from typing import Iterator, Optional, Union

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
    """Device bytes of one KV cache (entries + quantization scales)."""
    rows = batch * text_cfg.num_hidden_layers * text_cfg.kv_heads * cache_len
    name = _cache_name(dtype)
    if name == "int4":   # k and v share a byte
        return rows * text_cfg.head_dim + 2 * 4 * rows
    if name == "int8":
        return 2 * rows * text_cfg.head_dim + 2 * 4 * rows
    return 2 * rows * text_cfg.head_dim * 2


_LADDER = ["bf16", "int8", "int4"]
_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8, "int4": "int4"}


def select_cache_dtype(text_cfg: TextConfig, batch: int, cache_len: int,
                       requested: CacheDtype, *, device: torch.device,
                       param_bytes: int = 0,
                       hbm_bytes: Optional[float] = None,
                       headroom_bytes: Optional[float] = None
                       ) -> CacheDtype:
    """Degrade-not-die KV-cache precision: when the requested cache does
    not fit next to the resident parameters, step down the ladder
    (bf16 -> int8 -> int4) with a warning instead of failing. On CUDA the
    budget is the free device memory from `torch.cuda.mem_get_info` less
    the headroom; `OTTER_HBM_BYTES` (total bytes, parameters then
    subtracted) and `OTTER_HBM_HEADROOM` override it. On the CPU the
    request is returned unchanged."""
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
                  f"even at int4; proceeding with int4", stacklevel=2)
    return "int4"


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
    def _prefill(self, vision_x, lang_x, attention_mask,
                 gen: GenerationConfig, generator) -> SimpleNamespace:
        """Encode the vision input, prefill the cache and sample the first
        token: the state that `_step` advances."""
        dev = self.device
        lang_x = _on(lang_x, dev).long()
        b, p = lang_x.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, p), dtype=torch.int32, device=dev)
        attention_mask = _on(attention_mask, dev).int()
        cache_len = _round_up(p + gen.max_new_tokens, 128)
        cache_dtype = select_cache_dtype(
            self.cfg.text, b, cache_len, self.cache_dtype, device=dev,
            param_bytes=self.param_bytes)
        cache = init_cache(self.cfg.text, b, cache_len, cache_dtype, dev)
        # a token's position counts the real tokens before it: left padding
        # does not move a prompt (ALiBi takes no positions)
        real_len = positions = None
        if self.cfg.text.pos != "alibi":
            real_len = attention_mask.sum(-1)
            positions = (attention_mask.cumsum(-1) - 1).clamp_min(0)
        logits, cache, vis_latents = self.model(
            _on(vision_x, dev), lang_x, attention_mask=attention_mask,
            positions=positions, cache=cache, head_last_only=True)
        st = SimpleNamespace(
            gen=gen, generator=generator, p=p, cache=cache,
            real_len=real_len,
            vis_latents=vis_latents,
            eos=(gen.eos_token_id if gen.eos_token_id is not None
                 else self.cfg.eoc_token_id),
            media_counts=(lang_x == self.cfg.media_token_id).int().sum(-1),
            valid_from=p - attention_mask.sum(-1),
            buffer=torch.cat([lang_x, torch.full(
                (b, cache_len - p), gen.pad_token_id, dtype=torch.long,
                device=dev)], dim=1),
            kv_valid=torch.cat([attention_mask.bool(), torch.zeros(
                (b, cache_len - p), dtype=torch.bool, device=dev)], dim=1),
            done=torch.zeros(b, dtype=torch.bool, device=dev), t=0)
        self._sample(st, logits[:, -1])
        return st

    def _sample(self, st: SimpleNamespace, logits: torch.Tensor) -> None:
        """Token t of every row from its logits (pad once the row is
        done), written to the buffer."""
        gen = st.gen
        logits = sampling.process_logits(logits, st.buffer, st.p + st.t, gen,
                                         st.valid_from)
        tok = sampling.sample_token(
            logits, do_sample=gen.do_sample, temperature=gen.temperature,
            top_k=gen.top_k, top_p=gen.top_p, generator=st.generator)
        st.tok = torch.where(st.done, gen.pad_token_id, tok)
        st.done = st.done | (st.tok == st.eos)
        st.buffer[:, st.p + st.t] = st.tok
        st.t += 1

    @torch.inference_mode()
    def _step(self, st: SimpleNamespace) -> None:
        """One cached decode step: feed token t - 1, sample token t."""
        pos = st.p + st.t - 1
        st.kv_valid[:, pos] = True
        positions = (None if st.real_len is None
                     else (st.real_len + (st.t - 1))[:, None])
        logits, st.cache, _ = self.model(
            None, st.tok[:, None], vis_latents=st.vis_latents,
            cache=st.cache, cache_pos=pos, kv_valid=st.kv_valid,
            positions=positions, media_counts=st.media_counts)
        self._sample(st, logits[:, -1])

    def generate(self, vision_x, lang_x, attention_mask=None,
                 gen: Optional[GenerationConfig] = None,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """vision_x [B,T,F,C,H,W] float pixels; lang_x [B,P] LEFT-padded
        (see `left_pad`). Returns [B, P + max_new_tokens] (prompt +
        generation, eos-terminated, pad-filled)."""
        gen = gen or GenerationConfig()
        if gen.num_beams > 1:
            raise NotImplementedError("beam search is not ported yet")
        st = self._prefill(vision_x, lang_x, attention_mask, gen, generator)
        while st.t < gen.max_new_tokens and not bool(st.done.all()):
            self._step(st)
        return st.buffer[:, : st.p + gen.max_new_tokens].cpu().numpy()

    def stream_generate(self, vision_x, lang_x, attention_mask=None,
                        gen: Optional[GenerationConfig] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Iterator[int]:
        """One request (batch 1): yields each token id as it is sampled,
        with `generate`'s sampling and bans, and stops at eos (not
        yielded) or after max_new_tokens."""
        gen = gen or GenerationConfig()
        if gen.num_beams > 1:
            raise NotImplementedError("beam search is not ported yet")
        if np.shape(lang_x)[0] != 1:
            raise ValueError("stream_generate serves one request; batch "
                             "with generate")
        st = self._prefill(vision_x, lang_x, attention_mask, gen, generator)
        while True:
            tok = int(st.tok[0])
            if tok == st.eos:
                return
            yield tok
            if st.t >= gen.max_new_tokens:
                return
            self._step(st)
