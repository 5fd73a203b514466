"""Cross-turn KV session cache (counterpart of
`otter_tpu/generation/session.py`): chat turn N prefills only the tokens
that the session's cache does not hold yet.

A stateless worker prefills the whole conversation every turn, so the
time to a turn's first token grows with the history. A `ChatSession`
keeps the KV cache, the vision latents and the record of ingested tokens
between turns; the next request's prompt is matched against that record
and only the unseen suffix runs, as a multi-token cached window right-
padded to a bucket (the decoder's block causality inside the window and
`kv_valid` over the cache: the padded rows write columns that stay
outside `kv_valid` until a later window or step overwrites them).
Divergence costs nothing: when the client edits its history, the longest
common prefix is kept and the window starts writing at the divergence.

The session restarts (a full prefill) when the vision input changes (a
hash of the host pixels), when the suffix holds a media token, or when
the common prefix is shorter than `min_reuse`: the heuristics decide the
time to the first token, never the output, which equals
`OtterGenerator.stream_generate` on the full prompt. A turn that cannot
fit the session's `cache_len` raises ValueError before any output.

`SpecChatSession` composes the session cache with speculative decoding
(`generation/speculative.py`); `SessionPool` keeps a few sessions by a
client's session id, under a lock, handing a session to one stream at a
time.
"""

from __future__ import annotations

import hashlib
import threading
from types import SimpleNamespace
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from otter_tpu_torch.config import GenerationConfig
from otter_tpu_torch.generation import sampling
from otter_tpu_torch.generation.engine import _on
from otter_tpu_torch.generation.speculative import (categorical,
                                                    processed_probs)
from otter_tpu_torch.models.decoder import init_cache


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _vision_hash(vision_x) -> str:
    """A hash of the host pixels (a numpy array or a CPU tensor): taken
    before they go to the card."""
    a = (vision_x.detach().cpu().numpy() if isinstance(vision_x, torch.Tensor)
         else np.asarray(vision_x))
    return hashlib.sha1(str(a.shape).encode()
                        + np.ascontiguousarray(a).tobytes()).hexdigest()


def _prompt_ids(lang_x, attention_mask) -> List[int]:
    """The real tokens of a one-request prompt [1, P] (padding dropped)."""
    ids = (lang_x.detach().cpu().numpy() if isinstance(lang_x, torch.Tensor)
           else np.asarray(lang_x))
    if ids.shape[0] != 1:
        raise ValueError("a session serves one stream")
    if attention_mask is not None:
        keep = (attention_mask.detach().cpu().numpy()
                if isinstance(attention_mask, torch.Tensor)
                else np.asarray(attention_mask))[0].astype(bool)
        ids = ids[:, keep]
    return [int(t) for t in ids[0]]


class _Session:
    """What `ChatSession` and `SpecChatSession` share: the bookkeeping of
    the ingested tokens, the prefix match and the restart's left-padded
    prompt."""

    def __init__(self, cfg, device, *, cache_len: int, prompt_bucket: int,
                 window_bucket: int, min_reuse: int):
        self.cfg, self.device = cfg, device
        self.cache_len = cache_len
        self.prompt_bucket = prompt_bucket
        self.window_bucket = window_bucket
        self.min_reuse = min_reuse
        self.last_stats: Dict[str, Any] = {}
        self.reset()

    def reset(self):
        self.vis_latents = self.media_count = self.vis_hash = None
        self.media_arr = None        # [1] int32: the prompt's media count
        self.base_valid = None       # [1, cache_len] bool (the pad mask)
        self.valid_from = 0          # the first real cache column
        self.n = 0                   # the next free cache column
        self.real_tokens: List[int] = []   # ids at valid_from .. n-1

    def _reuse(self, ids, vh, media_count, held: int, room: int) -> int:
        """The common prefix to keep (0: restart). `held` caps it at the
        tokens the caches are known to hold; `room` is the columns the
        turn needs past its prompt."""
        m = 0
        if self.vis_hash is not None and vh == self.vis_hash \
                and media_count == self.media_count:
            for a, b in zip(self.real_tokens, ids):
                if a != b:
                    break
                m += 1
        m = min(m, held, len(ids) - 1)   # the window covers >= 1 token
        if (m >= self.min_reuse
                and self.cfg.media_token_id not in ids[m:]
                and self.valid_from + len(ids) + room <= self.cache_len):
            return m
        return 0

    def _suffix(self, ids, m: int):
        """The window's tokens [1, sb] (the suffix right-padded to its
        bucket, the padding cut where it would pass the cache's end), its
        first column and its real length."""
        n0 = self.valid_from + m
        sb = min(_round_up(len(ids) - m, self.window_bucket),
                 self.cache_len - n0)
        toks = torch.zeros((1, sb), dtype=torch.long)
        toks[0, :len(ids) - m] = torch.tensor(ids[m:])
        return toks.to(self.device), n0, len(ids) - m

    def _window_valid(self, n0: int, s_real: int, sb: int):
        cols = torch.arange(self.cache_len, device=self.device)[None, :]
        positions = torch.arange(n0 - self.valid_from,
                                 n0 - self.valid_from + sb,
                                 device=self.device)[None, :]
        return self.base_valid & (cols < n0 + s_real), positions

    def _restart_prompt(self, ids, room: int):
        """The left-padded prompt [1, P'] and its mask for a restart;
        ValueError when the turn cannot fit the cache."""
        p = len(ids)
        p_pad = _round_up(p, self.prompt_bucket)
        if p_pad + room > self.cache_len:
            raise ValueError(f"prompt {p} + max_new {room} exceeds session "
                             f"cache_len {self.cache_len}")
        lx = torch.zeros((1, p_pad), dtype=torch.long)
        mask = torch.zeros((1, p_pad), dtype=torch.int32)
        lx[0, p_pad - p:] = torch.tensor(ids)
        mask[0, p_pad - p:] = 1
        self.valid_from, self.n = p_pad - p, p_pad
        self.base_valid = torch.cat([mask.bool(), torch.ones(
            (1, self.cache_len - p_pad), dtype=torch.bool)], 1).to(
                self.device)
        return lx.to(self.device), mask.to(self.device)

    def _record(self, ids, vh, media_count, m: int, window: int, pad: int,
                restart: bool):
        self.real_tokens = ids[:]
        if restart:
            self.vis_hash, self.media_count = vh, media_count
            self.media_arr = torch.tensor([media_count], dtype=torch.int32,
                                          device=self.device)
        self.last_stats = {"reused": m, "window": window, "window_pad": pad,
                           "restart": restart}


class ChatSession(_Session):
    """One conversation's decode state over an `OtterVLM`. `stream` takes
    the whole conversation every turn, as `OtterGenerator.stream_generate`
    does, and runs only what the cache does not hold."""

    def __init__(self, model, *, cache_len: int = 2048,
                 prompt_bucket: int = 128, window_bucket: int = 64,
                 min_reuse: int = 16, cache_dtype=torch.bfloat16):
        self.model, self.cache_dtype = model, cache_dtype
        super().__init__(model.cfg, model.device, cache_len=cache_len,
                         prompt_bucket=prompt_bucket,
                         window_bucket=window_bucket, min_reuse=min_reuse)

    def reset(self):
        super().reset()
        self.cache = None

    @torch.inference_mode()
    def _ingest(self, vision_x, ids, vh, media_count, max_new: int):
        """Prefill or window: the logits [1, V] after the prompt's last
        token, with the cache holding the whole prompt."""
        m = self._reuse(ids, vh, media_count, len(ids), max_new)
        if m:
            toks, n0, s_real = self._suffix(ids, m)
            kv_valid, positions = self._window_valid(n0, s_real,
                                                     toks.shape[1])
            logits, _, _ = self.model(
                None, toks, vis_latents=self.vis_latents, cache=self.cache,
                cache_pos=n0, kv_valid=kv_valid, positions=positions,
                media_counts=self.media_arr)
            self.n = n0 + s_real
            self._record(ids, vh, media_count, m, s_real, toks.shape[1],
                         False)
            return logits[:, s_real - 1]
        lx, mask = self._restart_prompt(ids, max_new)
        self.cache = init_cache(self.cfg.text, 1, self.cache_len,
                                self.cache_dtype, self.device)
        logits, _, self.vis_latents = self.model(
            _on(vision_x, self.device), lx, attention_mask=mask,
            positions=(mask.cumsum(-1) - 1).clamp_min(0), cache=self.cache,
            head_last_only=True)
        self._record(ids, vh, media_count, 0, len(ids), lx.shape[1], True)
        return logits[:, -1]

    @torch.inference_mode()
    def _sample(self, logits, buffer, gen: GenerationConfig, generator):
        if gen.no_repeat_ngram_size or gen.bad_words_ids:
            logits = sampling.process_logits(logits, buffer, self.n, gen,
                                             self.valid_from)
        return sampling.sample_token(
            logits, do_sample=gen.do_sample, temperature=gen.temperature,
            top_k=gen.top_k, top_p=gen.top_p, generator=generator)

    @torch.inference_mode()
    def _step(self, tok):
        """Token `tok` [1] into column n: the next logits [1, V]."""
        cols = torch.arange(self.cache_len, device=self.device)[None, :]
        logits, _, _ = self.model(
            None, tok[:, None], vis_latents=self.vis_latents,
            cache=self.cache, cache_pos=self.n,
            kv_valid=self.base_valid & (cols <= self.n),
            positions=torch.tensor([[self.n - self.valid_from]],
                                   device=self.device),
            media_counts=self.media_arr)
        return logits[:, -1]

    def stream(self, vision_x, lang_x, attention_mask=None,
               gen: Optional[GenerationConfig] = None,
               generator: Optional[torch.Generator] = None
               ) -> Iterator[int]:
        """Yields token ids as `OtterGenerator.stream_generate` does on the
        same full prompt (eos not yielded); ValueError when the prompt and
        max_new_tokens cannot fit the session's cache_len."""
        gen = gen or GenerationConfig()
        eos = (gen.eos_token_id if gen.eos_token_id is not None
               else self.cfg.eoc_token_id)
        ids = _prompt_ids(lang_x, attention_mask)
        media_count = ids.count(self.cfg.media_token_id)
        logits = self._ingest(vision_x, ids, _vision_hash(vision_x),
                              media_count, gen.max_new_tokens)
        buffer = torch.zeros((1, self.cache_len), dtype=torch.long,
                             device=self.device)
        buffer[0, self.valid_from:self.n] = torch.tensor(self.real_tokens)
        for _ in range(gen.max_new_tokens):
            tok = self._sample(logits, buffer, gen, generator)
            tok_i = int(tok[0])
            if tok_i == eos:
                return
            buffer[0, self.n] = tok_i
            yield tok_i
            # the token goes into the cache before the next turn can ask
            logits = self._step(tok)
            self.n += 1
            self.real_tokens.append(tok_i)


class SpecChatSession(_Session):
    """The session cache composed with speculative decoding: turn N
    prefills only its new tokens, into the target's and the draft's caches,
    then decodes in speculative rounds (`SpeculativeGenerator._round`).
    Greedy output equals the target's greedy decode of the full prompt;
    sampled output is distributed as the target's ancestral sampling.

    After a round the newest emitted token is in neither cache (the round
    invariant: the next round's opener ingests it). `held` therefore
    counts the leading tokens that both caches are known to hold, and the
    next turn's prefix match stops there; the window re-ingests the one
    token beyond it."""

    def __init__(self, spec, *, cache_len: int = 2048,
                 prompt_bucket: int = 128, window_bucket: int = 64,
                 min_reuse: int = 16):
        self.spec = spec
        super().__init__(spec.cfg_t, spec.device, cache_len=cache_len,
                         prompt_bucket=prompt_bucket,
                         window_bucket=window_bucket, min_reuse=min_reuse)

    def reset(self):
        super().reset()
        self.cache_t = self.cache_d = self.lat_d = None
        self.held = 0            # leading real_tokens cached in both models

    @torch.inference_mode()
    def _ingest(self, vision_x, ids, vh, media_count, room: int):
        """Prefill or window into both caches: the target's logits [1, V]
        after the prompt's last token."""
        sp = self.spec
        m = self._reuse(ids, vh, media_count, self.held, room)
        if m:
            toks, n0, s_real = self._suffix(ids, m)
            kv_valid, positions = self._window_valid(n0, s_real,
                                                     toks.shape[1])
            kw = dict(cache_pos=n0, kv_valid=kv_valid, positions=positions,
                      media_counts=self.media_arr)
            logits, _, _ = sp.model_t(None, toks, vis_latents=self.vis_latents,
                                      cache=self.cache_t, **kw)
            sp.model_d(None, toks, vis_latents=self.lat_d, cache=self.cache_d,
                       **kw)
            self.n = n0 + s_real
            self._record(ids, vh, media_count, m, s_real, toks.shape[1],
                         False)
            return logits[:, s_real - 1]
        lx, mask = self._restart_prompt(ids, room)
        vx = _on(vision_x, self.device)
        self.cache_t, self.cache_d = (
            init_cache(m_.cfg.text, 1, self.cache_len, sp.cache_dtype,
                       self.device) for m_ in (sp.model_t, sp.model_d))
        last, self.vis_latents = sp._prefill(sp.model_t, vx, lx, mask,
                                             self.cache_t)
        _, self.lat_d = sp._prefill(sp.model_d, vx, lx, mask, self.cache_d)
        self._record(ids, vh, media_count, 0, len(ids), lx.shape[1], True)
        return last

    def stream(self, vision_x, lang_x, attention_mask=None,
               gen: Optional[GenerationConfig] = None,
               generator: Optional[torch.Generator] = None
               ) -> Iterator[int]:
        """Full-prompt interface, as `ChatSession.stream`; ValueError when
        the prompt, max_new_tokens and a round's window cannot fit."""
        gen = gen or GenerationConfig()
        if gen.num_beams > 1:
            raise ValueError("speculative decoding has no beams")
        sp = self.spec
        eos = (gen.eos_token_id if gen.eos_token_id is not None
               else self.cfg.eoc_token_id)
        ids = _prompt_ids(lang_x, attention_mask)
        media_count = ids.count(self.cfg.media_token_id)
        # + gamma + 2: a round's verify window writes up to gamma + 1
        # columns past the last decided token
        last = self._ingest(vision_x, ids, _vision_hash(vision_x),
                            media_count, gen.max_new_tokens + sp.gamma + 2)
        self.held = len(ids)
        with torch.inference_mode():
            tok0 = (categorical(processed_probs(last[0], gen), generator)
                    if gen.do_sample else last[0].argmax(-1))
            tok0_i = int(tok0)
        if tok0_i == eos:
            return
        buffer = torch.full((1, self.cache_len), gen.pad_token_id,
                            dtype=torch.long)
        buffer[0, self.valid_from:self.n] = torch.tensor(self.real_tokens)
        buffer[0, self.n] = tok0_i
        # recorded before it is yielded: a stream the caller abandons
        # leaves a divergence for the next turn's match, which is free
        self.real_tokens.append(tok0_i)
        self.n += 1
        self.held = len(self.real_tokens) - 1   # tok0 is not ingested
        yield tok0_i
        st = SimpleNamespace(
            buffer=buffer.to(self.device), cache_t=self.cache_t,
            cache_d=self.cache_d, lat_t=self.vis_latents, lat_d=self.lat_d,
            media=self.media_arr, base_valid=self.base_valid,
            off=self.valid_from)
        emitted = 1
        while emitted < gen.max_new_tokens:
            n_out, out = sp._read(*sp._round(st, self.n, gen, eos,
                                             generator))
            toks = out[:min(n_out, gen.max_new_tokens - emitted)]
            hit_eos = eos in toks
            if hit_eos:
                toks = toks[:toks.index(eos)]
            self.real_tokens.extend(toks)
            self.n += len(toks)
            # the newest token may not be in the draft's cache yet: the
            # next turn re-ingests it
            self.held = len(self.real_tokens) - 1
            yield from toks
            emitted += len(toks)
            if hit_eos:
                return


class SessionPool:
    """Least-recently-used sessions by a client's session id. Each session
    pins a `cache_len`-column KV cache on the card, so the pool is small;
    an evicted session costs its next turn a full prefill. `factory` makes
    a session (`SpecChatSession` for the speculative composition).

    The pool is locked, and a session serves one stream at a time:
    `acquire` hands out a session and marks it held until `release`; it
    returns None for a session id whose session another stream holds, or
    when every pooled session is held (the caller then takes the stateless
    path). Eviction takes the least recently used session that no stream
    holds. `get` is `acquire` without the hold."""

    def __init__(self, model, *, max_sessions: int = 2,
                 factory: Optional[Callable[[], Any]] = None, **session_kw):
        self.model = model
        self.max_sessions = max_sessions
        self.session_kw = session_kw
        self._factory = factory or (lambda: ChatSession(self.model,
                                                        **self.session_kw))
        self._lock = threading.Lock()
        self._pool: Dict[str, Any] = {}
        self._last_used: Dict[str, int] = {}
        self._held: set = set()
        self._clock = 0

    def _take(self, session_id: str):
        self._clock += 1
        if session_id not in self._pool:
            if len(self._pool) >= self.max_sessions:
                idle = [s for s in self._pool
                        if id(self._pool[s]) not in self._held]
                if not idle:
                    return None
                victim = min(idle, key=self._last_used.get)
                del self._pool[victim], self._last_used[victim]
            self._pool[session_id] = self._factory()
        self._last_used[session_id] = self._clock
        return self._pool[session_id]

    def get(self, session_id: str):
        with self._lock:
            return self._take(session_id)

    def acquire(self, session_id: str):
        with self._lock:
            sess = self._pool.get(session_id)
            if sess is not None and id(sess) in self._held:
                return None
            sess = self._take(session_id)
            if sess is not None:
                self._held.add(id(sess))
            return sess

    def release(self, session) -> None:
        with self._lock:
            self._held.discard(id(session))

    def drop(self, session_id: str) -> None:
        with self._lock:
            self._pool.pop(session_id, None)
            self._last_used.pop(session_id, None)
