"""Generation engine: batched left-padded prefill + KV-cached decode
(counterpart of `otter_tpu/generation/engine.py`).

`OtterGenerator.generate` encodes the vision input once, runs one prefill
that writes the stacked KV cache and computes only the last position's
logits (`head_last_only`), then decodes with a Python loop of single-token
steps that update the cache in place. The JAX engine runs the same loop
inside one jitted `lax.while_loop`. `stream_generate` runs the same
prefill and steps for one request and yields each token as it is sampled;
a `vision_mask` marks the real frames of mixed still+video media.

`num_beams > 1` runs beam search (`generation/beam.py`) over B*K rows:
the prompt, its mask and the vision latents repeated K times a row (the
reference's repeat for beams, `modeling_otter.py:1030-1032`; the JAX
engine repeats the pixels, here the vision input is encoded once and its
latents repeated, the same values for one CLIP pass in K).
`stream_beam_generate` yields the current best beam every few steps.

The model is an `OtterVLM` or an `IdeficsVLM`: the engine asks of it
`encode_vision(vision_x, vision_mask)` (latents [B, N, m, D]), the forward
signature of both, `device`, and a config with `.text`,
`.media_token_id` and `.eoc_token_id`.
"""

from __future__ import annotations

import os
import warnings
from types import SimpleNamespace
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from otter_tpu_torch.config import (GenerationConfig, IdeficsModelConfig,
                                    OtterConfig, TextConfig)
from otter_tpu_torch.generation import beam, sampling
from otter_tpu_torch.models.decoder import init_cache
from otter_tpu_torch.models.idefics import IdeficsVLM
from otter_tpu_torch.models.otter import OtterVLM

CacheDtype = Union[torch.dtype, str]
Model = Union[OtterVLM, IdeficsVLM]


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
                       headroom_bytes: Optional[float] = None,
                       also: Tuple[TextConfig, ...] = ()) -> CacheDtype:
    """Degrade-not-die KV-cache precision: when the requested cache does
    not fit next to the resident parameters, step down the ladder
    (bf16 -> int8 -> int4) with a warning instead of failing. The budget
    is `hbm_bytes` (or `OTTER_HBM_BYTES` on CUDA) less the headroom and
    `param_bytes`; on CUDA without either, the card's total memory less
    what live tensors hold (`torch.cuda.memory_allocated`, parameters
    included) and the headroom. Blocks that torch's caching allocator
    keeps from freed tensors count as free, so the answer does not depend
    on what ran before. `OTTER_HBM_HEADROOM` overrides the 5 GB headroom.
    `also` are the text configs of caches of the same shape and dtype that
    join the footprint (a speculative pool's draft cache). On the CPU
    without `hbm_bytes` the request is returned unchanged."""
    if device.type != "cuda" and hbm_bytes is None:
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
        budget = (torch.cuda.mem_get_info(device)[1]
                  - torch.cuda.memory_allocated(device) - headroom_bytes)
    name = _cache_name(requested)
    for step in _LADDER[_LADDER.index(name):]:
        if sum(cache_bytes(t, batch, cache_len, step)
               for t in (text_cfg,) + tuple(also)) <= budget:
            if step != name:
                warnings.warn(
                    f"KV cache degraded {name} -> {step}: a b={batch} "
                    f"L={cache_len} {name} cache"
                    f"{' (and the draft pool beside it)' if also else ''}"
                    f" does not fit in "
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
    """Greedy / sampled generation over an `OtterVLM` or an `IdeficsVLM`,
    on the model's device."""

    def __init__(self, model: Model,
                 cache_dtype: CacheDtype = torch.bfloat16,
                 hbm_bytes: Optional[float] = None):
        self.model = model
        self.cfg: Union[OtterConfig, IdeficsModelConfig] = model.cfg
        self.cache_dtype = cache_dtype
        self.hbm_bytes = hbm_bytes
        self.param_bytes = sum(t.numel() * t.element_size() for t in
                               list(model.parameters()) + list(model.buffers()))
        self._cache_dtypes: Dict[Tuple[int, int], CacheDtype] = {}

    def _cache_dtype_for(self, b: int, cache_len: int) -> CacheDtype:
        """The cache dtype for this (batch, cache_len): the requested one,
        degraded down the ladder when it would not fit
        (`select_cache_dtype`), chosen once per key so that equal requests
        get equal caches."""
        key = (b, cache_len)
        if key not in self._cache_dtypes:
            self._cache_dtypes[key] = select_cache_dtype(
                self.cfg.text, b, cache_len, self.cache_dtype,
                device=self.device, param_bytes=self.param_bytes,
                hbm_bytes=self.hbm_bytes)
        return self._cache_dtypes[key]

    @property
    def device(self) -> torch.device:
        return self.model.device

    @torch.inference_mode()
    def _prefill(self, vision_x, lang_x, attention_mask,
                 gen: GenerationConfig, generator=None, vision_mask=None,
                 beams: int = 1) -> SimpleNamespace:
        """Encode the vision input, prefill the cache and sample the first
        token: the state that `_step` advances. With `beams` K > 1 every
        request becomes K rows (row i*K + j is beam j of request i; the
        vision input encoded once, its latents repeated) and nothing is
        sampled: `st.logits` holds each request's first logits [B, V]."""
        dev = self.device
        lang_x = _on(lang_x, dev).long()
        b, p = lang_x.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, p), dtype=torch.int32, device=dev)
        attention_mask = _on(attention_mask, dev).int()
        vis_latents = self.model.encode_vision(
            _on(vision_x, dev),
            None if vision_mask is None else _on(vision_mask, dev).bool())
        if beams > 1:
            lang_x, attention_mask, vis_latents = (
                x.repeat_interleave(beams, 0)
                for x in (lang_x, attention_mask, vis_latents))
        rows = b * beams
        cache_len = _round_up(p + gen.max_new_tokens, 128)
        cache = init_cache(self.cfg.text, rows, cache_len,
                           self._cache_dtype_for(rows, cache_len), dev)
        # a token's position counts the real tokens before it: left padding
        # does not move a prompt (ALiBi takes no positions)
        real_len = positions = None
        if self.cfg.text.pos != "alibi":
            real_len = attention_mask.sum(-1)
            positions = (attention_mask.cumsum(-1) - 1).clamp_min(0)
        logits, cache, _ = self.model(
            None, lang_x, attention_mask=attention_mask, positions=positions,
            vis_latents=vis_latents, cache=cache, head_last_only=True)
        st = SimpleNamespace(
            gen=gen, generator=generator, p=p, cache=cache,
            real_len=real_len,
            vis_latents=vis_latents,
            eos=(gen.eos_token_id if gen.eos_token_id is not None
                 else self.cfg.eoc_token_id),
            media_counts=(lang_x == self.cfg.media_token_id).int().sum(-1),
            valid_from=p - attention_mask.sum(-1),
            buffer=torch.cat([lang_x, torch.full(
                (rows, cache_len - p), gen.pad_token_id, dtype=torch.long,
                device=dev)], dim=1),
            kv_valid=torch.cat([attention_mask.bool(), torch.zeros(
                (rows, cache_len - p), dtype=torch.bool, device=dev)], dim=1),
            done=torch.zeros(rows, dtype=torch.bool, device=dev), t=0)
        if beams > 1:
            st.logits = logits[::beams, -1]
        else:
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
        """vision_x [B,T,F,C,H,W] float pixels ([B,N,C,H,W] for
        idefics); lang_x [B,P] LEFT-padded
        (see `left_pad`). Returns [B, P + max_new_tokens] (prompt +
        generation, eos-terminated, pad-filled). num_beams > 1 runs beam
        search and returns the best beam of each row."""
        gen = gen or GenerationConfig()
        if gen.num_beams > 1:
            return self._beam_generate(vision_x, lang_x, attention_mask, gen)
        st = self._prefill(vision_x, lang_x, attention_mask, gen, generator)
        self._decode(st, gen.max_new_tokens)
        return st.buffer[:, : st.p + gen.max_new_tokens].cpu().numpy()

    def _decode(self, st: SimpleNamespace, until: int) -> None:
        """`generate`'s decode loop: steps until `until` tokens are sampled
        or every row is done (a host sync a step, for the done check)."""
        while st.t < until and not bool(st.done.all()):
            self._step(st)

    def stream_generate(self, vision_x, lang_x, attention_mask=None,
                        gen: Optional[GenerationConfig] = None,
                        generator: Optional[torch.Generator] = None,
                        vision_mask=None) -> Iterator[int]:
        """One request (batch 1): yields each token id as it is sampled,
        with `generate`'s sampling and bans, and stops at eos (not
        yielded) or after max_new_tokens. `vision_mask` [1, T, F] bool
        marks the real frames of mixed still+video media. Greedy or
        sampled only, as the JAX engine's: beams stream through
        `stream_beam_generate`."""
        gen = gen or GenerationConfig()
        if np.shape(lang_x)[0] != 1:
            raise ValueError("stream_generate serves one request; batch "
                             "with generate")
        st = self._prefill(vision_x, lang_x, attention_mask, gen, generator,
                           vision_mask)
        while True:
            tok = int(st.tok[0])
            if tok == st.eos:
                return
            yield tok
            if st.t >= gen.max_new_tokens:
                return
            self._step(st)

    # ── beam search ──────────────────────────────────────────────────

    def _beam_prefill(self, vision_x, lang_x, attention_mask,
                      gen: GenerationConfig) -> SimpleNamespace:
        """The prefill of B*K rows and what `beam.beam_search` asks for:
        each request's first logits with the bans applied, the cache, the
        step, and the bans of a step (`kw`)."""
        k = gen.num_beams
        st = self._prefill(vision_x, lang_x, attention_mask, gen, beams=k)
        p = st.p
        prompt = st.buffer[:, :p]
        cols = torch.arange(st.buffer.shape[1], device=prompt.device)[None]

        def step_fn(tok, cache, t):
            # as the JAX engine's beam step: every slot below p + t is
            # attended, the prompt's left padding too (ROADMAP Queue 3)
            pos = None if st.real_len is None else \
                (st.real_len + t - 1)[:, None]
            logits, cache, _ = self.model(
                None, tok, vis_latents=st.vis_latents, cache=cache,
                cache_pos=p + t - 1, kv_valid=st.kv_valid | (cols < p + t),
                positions=pos, media_counts=st.media_counts)
            return logits[:, -1], cache

        def logits_processor(logits, gen_tokens, t):
            # the left-padded prompt before the beam's tokens, so the bans
            # see the whole context, as HF's processors do
            return sampling.process_logits(
                logits, torch.cat([prompt, gen_tokens], dim=1), p + t, gen,
                st.valid_from)

        bans = gen.no_repeat_ngram_size or gen.bad_words_ids
        return SimpleNamespace(
            prompt=prompt[::k], cache=st.cache, step_fn=step_fn,
            init_logits=sampling.process_logits(
                st.logits, prompt[::k], p, gen, st.valid_from[::k]),
            kw=dict(num_beams=k, max_new_tokens=gen.max_new_tokens,
                    eos_token_id=st.eos, pad_token_id=gen.pad_token_id,
                    length_penalty=gen.length_penalty,
                    logits_processor=logits_processor if bans else None))

    @torch.inference_mode()
    def _beam_generate(self, vision_x, lang_x, attention_mask,
                       gen: GenerationConfig) -> np.ndarray:
        bs = self._beam_prefill(vision_x, lang_x, attention_mask, gen)
        out, _ = beam.beam_search(bs.step_fn, bs.init_logits, bs.cache,
                                  **bs.kw)
        return torch.cat([bs.prompt, out], dim=1).cpu().numpy()

    @torch.inference_mode()
    def stream_beam_generate(self, vision_x, lang_x, attention_mask=None,
                             gen: Optional[GenerationConfig] = None,
                             chunk: int = 4) -> Iterator[list]:
        """Beam search for one request, streamed: yields the current best
        beam's tokens (up to eos) every `chunk` steps; the last yield is
        `generate(num_beams=K)`'s continuation. A later yield may revise
        earlier tokens (the serving protocol re-renders the whole text)."""
        gen = gen or GenerationConfig()
        if np.shape(lang_x)[0] != 1:
            raise ValueError("stream_beam_generate serves one request; "
                             "batch with generate")
        bs = self._beam_prefill(vision_x, lang_x, attention_mask, gen)
        eos = bs.kw["eos_token_id"]
        for out, t in beam.beam_search_chunks(
                bs.step_fn, bs.init_logits, bs.cache, chunk=chunk, **bs.kw):
            toks = []
            for x in out[0, :t].tolist():
                if x == eos:
                    break
                toks.append(x)
            yield toks
