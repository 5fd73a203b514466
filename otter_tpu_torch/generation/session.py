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

The decode after the prompt is the counterpart of the JAX sessions' jitted
step (`ChatSession`'s, its cache donated) and round (`SpecChatSession`'s):
a session keeps its cache, token buffer, pad mask and media count in
tensors fixed in memory (a restart prefills them in place), the next cache
column is a device counter, and each step (sample a token, then feed it)
or round reads its position from it. On CUDA the step or round is captured
once per session and sampling key as a CUDA graph over the session's own
tensors and replayed (`engine.GraphedSteps`: each session holds its
graphs and their memory pools until the pool evicts it); `cuda_graph=False`
runs the same body eagerly, as the CPU always does. The prefill and the
suffix window stay eager, as the engine's prefill does.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from types import SimpleNamespace
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from otter_tpu_torch.config import GenerationConfig
from otter_tpu_torch.generation import sampling
from otter_tpu_torch.generation.engine import (GraphedSteps, _Entry, _on,
                                               _round_up)
from otter_tpu_torch.generation.speculative import SpeculativeGenerator
from otter_tpu_torch.models.decoder import init_cache


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
    the ingested tokens, the prefix match, the restart's left-padded
    prompt, and the tensors a step or round reads in place (made at the
    first turn, kept for the session's life: a captured graph recorded
    them) with the leases of its graphed decode (`steps`)."""

    def __init__(self, cfg, device, steps: GraphedSteps, *, cache_len: int,
                 prompt_bucket: int, window_bucket: int, min_reuse: int):
        self.cfg, self.device, self.steps = cfg, device, steps
        self.cache_len = cache_len
        self.prompt_bucket = prompt_bucket
        self.window_bucket = window_bucket
        self.min_reuse = min_reuse
        self.last_stats: Dict[str, Any] = {}
        self.tensors: Optional[Dict[str, torch.Tensor]] = None
        self.reset()

    def reset(self):
        self.vis_latents = self.media_count = self.vis_hash = None
        self.valid_from = 0          # the first real cache column
        self.n = 0                   # the next free cache column
        self.real_tokens: List[int] = []   # ids at valid_from .. n-1

    def close(self) -> None:
        """Free the session's graphs and their memory pools (a stream that
        still runs keeps its own until it ends)."""
        self.steps.close()

    def _caches(self) -> Dict[str, torch.Tensor]:
        """The session's KV caches by name (made by `_alloc`)."""
        raise NotImplementedError

    def _alloc(self) -> Dict[str, torch.Tensor]:
        """The session's fixed tensors, made once: its caches, the token
        buffer [1, L], the pad mask `base_valid` [1, L], the prompt's
        media count [1] int32, the next cache column `n` and the first
        real one `valid_from` (device scalars)."""
        if self.tensors is None:
            dev, L = self.device, self.cache_len
            zero = lambda: torch.zeros((), dtype=torch.long, device=dev)
            self.tensors = dict(
                self._caches(),
                buffer=torch.zeros((1, L), dtype=torch.long, device=dev),
                base_valid=torch.zeros((1, L), dtype=torch.bool, device=dev),
                media=torch.zeros(1, dtype=torch.int32, device=dev),
                n=zero(), valid_from=zero())
        return self.tensors

    def _load_turn(self, pad: int) -> Dict[str, torch.Tensor]:
        """The turn's state into the session's tensors: the buffer (the
        real tokens at valid_from .. n-1, `pad` elsewhere) and the
        counters."""
        t = self.tensors
        row = torch.full((1, self.cache_len), pad, dtype=torch.long)
        row[0, self.valid_from:self.n] = torch.tensor(self.real_tokens)
        t["buffer"].copy_(row)
        t["n"].fill_(self.n)
        t["valid_from"].fill_(self.valid_from)
        return t

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
        return self.tensors["base_valid"] & (cols < n0 + s_real), positions

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
        base = self._alloc()["base_valid"]
        base.fill_(True)
        base[:, :p_pad] = mask.bool().to(self.device)
        return lx.to(self.device), mask.to(self.device)

    def _record(self, ids, vh, media_count, m: int, window: int, pad: int,
                restart: bool):
        self.real_tokens = ids[:]
        if restart:
            self.vis_hash, self.media_count = vh, media_count
            self.tensors["media"].fill_(media_count)
        self.last_stats = {"reused": m, "window": window, "window_pad": pad,
                           "restart": restart}


class ChatSession(_Session):
    """One conversation's decode state over an `OtterVLM`. `stream` takes
    the whole conversation every turn, as `OtterGenerator.stream_generate`
    does, and runs only what the cache does not hold. Each token is one
    call of `_step_body` (sample from the last logits, then feed the token
    at the device counter `n`): on CUDA a graph captured once per sampling
    key (`gen` less `max_new_tokens`) and the latents' shape
    (`cuda_graph`, `engine.graph_setting`)."""

    def __init__(self, model, *, cache_len: int = 2048,
                 prompt_bucket: int = 128, window_bucket: int = 64,
                 min_reuse: int = 16, cache_dtype=torch.bfloat16,
                 cuda_graph: Optional[bool] = None):
        self.model, self.cache_dtype = model, cache_dtype
        super().__init__(model.cfg, model.device,
                         GraphedSteps(model, cuda_graph),
                         cache_len=cache_len, prompt_bucket=prompt_bucket,
                         window_bucket=window_bucket, min_reuse=min_reuse)

    def _caches(self):
        return dict(cache=init_cache(self.cfg.text, 1, self.cache_len,
                                     self.cache_dtype, self.device))

    @torch.inference_mode()
    def _ingest(self, vision_x, ids, vh, media_count, max_new: int):
        """Prefill or window: the logits [1, V] after the prompt's last
        token, with the cache holding the whole prompt."""
        m = self._reuse(ids, vh, media_count, len(ids), max_new)
        if m:
            toks, n0, s_real = self._suffix(ids, m)
            kv_valid, positions = self._window_valid(n0, s_real,
                                                     toks.shape[1])
            t = self.tensors
            logits, _, _ = self.model(
                None, toks, vis_latents=self.vis_latents, cache=t["cache"],
                cache_pos=n0, kv_valid=kv_valid, positions=positions,
                media_counts=t["media"])
            self.n = n0 + s_real
            self._record(ids, vh, media_count, m, s_real, toks.shape[1],
                         False)
            return logits[:, s_real - 1]
        lx, mask = self._restart_prompt(ids, max_new)
        logits, _, self.vis_latents = self.model(
            _on(vision_x, self.device), lx, attention_mask=mask,
            positions=(mask.cumsum(-1) - 1).clamp_min(0),
            cache=self.tensors["cache"], head_last_only=True)
        self._record(ids, vh, media_count, 0, len(ids), lx.shape[1], True)
        return logits[:, -1]

    def _lease(self, gen: GenerationConfig, eos: int,
               logits: torch.Tensor) -> SimpleNamespace:
        """The entry of this turn's key over the session's tensors, with
        the turn's latents and first logits copied in."""
        step_gen = dataclasses.replace(gen, max_new_tokens=0)
        key = ("step", step_gen, tuple(self.vis_latents.shape))
        t = self.tensors

        def make():
            st = SimpleNamespace(
                gen=step_gen, eos=eos, cache=t["cache"], buffer=t["buffer"],
                base_valid=t["base_valid"], media=t["media"], n=t["n"],
                valid_from=t["valid_from"],
                lat=torch.empty_like(self.vis_latents),
                logits=torch.empty_like(logits),
                tok=torch.zeros(1, dtype=torch.long, device=self.device),
                generator=(torch.Generator(device=self.device)
                           if gen.do_sample else None),
                source=None, p=0, t=0)
            return _Entry(key, st, self.cache_dtype,
                          lambda: self._step_body(st))
        st = self.steps._take(key, make).st
        st.lat.copy_(self.vis_latents)
        st.logits.copy_(logits)
        return st

    def _step_body(self, st: SimpleNamespace) -> None:
        """One token on the entry's tensors, in place: sampled from the
        last logits (with the bans over the buffer), written to the buffer
        at n, fed at cache column n (position n - valid_from), its logits
        kept for the next; n advances. Reads n from the device counter:
        the same call serves every token, what a graph captures."""
        gen, n = st.gen, st.n
        logits = st.logits
        if gen.no_repeat_ngram_size or gen.bad_words_ids:
            logits = sampling.process_logits(logits, st.buffer, n, gen,
                                             st.valid_from)
        tok = sampling.sample_token(
            logits, do_sample=gen.do_sample, temperature=gen.temperature,
            top_k=gen.top_k, top_p=gen.top_p, generator=st.generator)
        st.tok.copy_(tok)
        st.buffer.index_copy_(1, n.view(1), tok[:, None])
        cols = torch.arange(self.cache_len, device=n.device)[None, :]
        out, _, _ = self.model(
            None, tok[:, None], vis_latents=st.lat, cache=st.cache,
            cache_pos=n, kv_valid=st.base_valid & (cols <= n),
            positions=(n - st.valid_from).view(1, 1),
            media_counts=st.media)
        st.logits.copy_(out[:, -1])
        n.add_(1)

    def stream(self, vision_x, lang_x, attention_mask=None,
               gen: Optional[GenerationConfig] = None,
               generator: Optional[torch.Generator] = None
               ) -> Iterator[int]:
        """Yields token ids as `OtterGenerator.stream_generate` does on the
        same full prompt (eos not yielded); ValueError when the prompt and
        max_new_tokens cannot fit the session's cache_len. Each token is
        fed to the cache before it is yielded, as the JAX session's is
        before the next turn can ask."""
        gen = gen or GenerationConfig()
        eos = (gen.eos_token_id if gen.eos_token_id is not None
               else self.cfg.eoc_token_id)
        ids = _prompt_ids(lang_x, attention_mask)
        media_count = ids.count(self.cfg.media_token_id)
        logits = self._ingest(vision_x, ids, _vision_hash(vision_x),
                              media_count, gen.max_new_tokens)
        st = self._turn(gen, eos, logits, generator)
        try:
            for _ in range(gen.max_new_tokens):
                self.steps._advance(st)
                tok = int(st.tok[0])
                if tok == eos:
                    return
                self.n += 1
                self.real_tokens.append(tok)
                yield tok
        finally:
            self.steps._finish(st)

    @torch.inference_mode()
    def _turn(self, gen, eos, logits, generator) -> SimpleNamespace:
        """The turn's state loaded and its entry leased and seeded."""
        self._load_turn(0)
        st = self._lease(gen, eos, logits)
        try:
            self.steps._seed(st, generator)
        except BaseException:
            self.steps._finish(st)
            raise
        return st


class SpecChatSession(_Session):
    """The session cache composed with speculative decoding: turn N
    prefills only its new tokens, into the target's and the draft's caches,
    then decodes in speculative rounds (`SpeculativeGenerator`'s round
    body over the session's own caches and buffer: on CUDA a graph
    captured once per the generator's key, with `spec.cuda_graph`).
    Greedy output equals the target's greedy decode of the full prompt;
    sampled output is distributed as the target's ancestral sampling.

    After a round the newest emitted token is in neither cache (the round
    invariant: the next round's opener ingests it). `held` therefore
    counts the leading tokens that both caches are known to hold, and the
    next turn's prefix match stops there; the window re-ingests the one
    token beyond it."""

    def __init__(self, spec: SpeculativeGenerator, *, cache_len: int = 2048,
                 prompt_bucket: int = 128, window_bucket: int = 64,
                 min_reuse: int = 16):
        self.spec = spec
        super().__init__(spec.cfg_t, spec.device,
                         GraphedSteps(spec.model_t, spec.cuda_graph,
                                      draft=spec.model_d),
                         cache_len=cache_len, prompt_bucket=prompt_bucket,
                         window_bucket=window_bucket, min_reuse=min_reuse)

    def reset(self):
        super().reset()
        self.lat_d = None
        self.held = 0            # leading real_tokens cached in both models

    def _caches(self):
        sp = self.spec
        return {name: init_cache(m.cfg.text, 1, self.cache_len,
                                 sp.cache_dtype, self.device)
                for name, m in (("cache_t", sp.model_t),
                                ("cache_d", sp.model_d))}

    @torch.inference_mode()
    def _ingest(self, vision_x, ids, vh, media_count, room: int):
        """Prefill or window into both caches: the target's logits [1, V]
        after the prompt's last token."""
        sp = self.spec
        m = self._reuse(ids, vh, media_count, self.held, room)
        if m:
            t = self.tensors
            toks, n0, s_real = self._suffix(ids, m)
            kv_valid, positions = self._window_valid(n0, s_real,
                                                     toks.shape[1])
            kw = dict(cache_pos=n0, kv_valid=kv_valid, positions=positions,
                      media_counts=t["media"])
            logits, _, _ = sp.model_t(None, toks, vis_latents=self.vis_latents,
                                      cache=t["cache_t"], **kw)
            sp.model_d(None, toks, vis_latents=self.lat_d,
                       cache=t["cache_d"], **kw)
            self.n = n0 + s_real
            self._record(ids, vh, media_count, m, s_real, toks.shape[1],
                         False)
            return logits[:, s_real - 1]
        lx, mask = self._restart_prompt(ids, room)
        vx = _on(vision_x, self.device)
        t = self.tensors
        last, self.vis_latents = sp.prefill(sp.model_t, vx, lx, mask,
                                            t["cache_t"])
        _, self.lat_d = sp.prefill(sp.model_d, vx, lx, mask, t["cache_d"])
        self._record(ids, vh, media_count, 0, len(ids), lx.shape[1], True)
        return last

    @torch.inference_mode()
    def _turn(self, gen, eos, tok0, generator) -> SimpleNamespace:
        """The round entry of this turn's key over the session's tensors,
        its counters at the turn's first token `tok0` (column n - 1)."""
        sp, t = self.spec, self._load_turn(gen.pad_token_id)
        key = sp._key(self.cache_len, gen, eos, self.vis_latents, self.lat_d)

        def make():
            st = sp.round_state(
                self.cache_len, gen, eos, self.vis_latents, self.lat_d,
                cache_t=t["cache_t"], cache_d=t["cache_d"],
                buffer=t["buffer"], base_valid=t["base_valid"],
                media=t["media"], off=t["valid_from"])
            return _Entry(key, st, sp.cache_dtype,
                          lambda: sp._round_body(st))
        st = self.steps._take(key, make).st
        try:
            self.steps._seed(st, generator)
            sp._start(st, self.n - 1, tok0, gen.max_new_tokens,
                      self.vis_latents, self.lat_d)
        except BaseException:
            self.steps._finish(st)
            raise
        return st

    def stream(self, vision_x, lang_x, attention_mask=None,
               gen: Optional[GenerationConfig] = None,
               generator: Optional[torch.Generator] = None
               ) -> Iterator[int]:
        """Full-prompt interface, as `ChatSession.stream`; ValueError when
        the prompt, max_new_tokens and a round's window cannot fit. The
        rounds are read one at a time, as JAX's `stream` reads them."""
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
            tok0 = sp._first_token(last, gen, generator)
            tok0_i = int(tok0)
        if tok0_i == eos:
            return
        # recorded before it is yielded: a stream the caller abandons
        # leaves a divergence for the next turn's match, which is free
        self.real_tokens.append(tok0_i)
        self.n += 1
        self.held = len(self.real_tokens) - 1   # tok0 is not ingested
        yield tok0_i
        st = self._turn(gen, eos, tok0, generator)
        try:
            emitted = 1
            while emitted < gen.max_new_tokens:
                self.steps._advance(st)
                n_out, out = sp._read(st.n, st.out)
                toks = out[:n_out]
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
        finally:
            self.steps._finish(st)


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
                self._pool.pop(victim).close()
                del self._last_used[victim]
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
            sess = self._pool.pop(session_id, None)
            self._last_used.pop(session_id, None)
        if sess is not None:
            sess.close()
