"""Speculative decoding (counterpart of `otter_tpu/generation/speculative.py`):
a small draft model proposes gamma tokens, the target verifies them in one
multi-token cached step, and greedy output equals the target's own greedy
decode token for token.

A round is the draft's s=2 opener, gamma-1 single-token draft steps, then
one s=gamma+1 verify window of the target (the decoder's multi-token cached
step: block causality inside the window, `kv_valid` over the cache). The
round keeps its state on the device, as the JAX package's jitted round and
`lax.while_loop` do: the buffer, both caches and latents live in an entry
that a request leases (`engine.GraphedSteps`), and the next undecided
column, the tokens emitted, the rounds run and the done flag are device
counters that the round reads and advances. So one call serves every
round, with no host sync: on CUDA it is captured once per key as a CUDA
graph and replayed. `generate` queues rounds and reads the done flag once
in `engine.DONE_EVERY` rounds; `stream` reads each round's tokens, where
JAX's `stream` does. Nothing is rolled back: rejected columns stay outside
`kv_valid` and the next round's window overwrites them.

Two acceptance modes:
  - greedy: a proposal is accepted when it equals the target's argmax, so
    the output is the target's greedy decode (eos included);
  - sampled: the rejection rule of Leviathan et al. (arXiv 2211.17192),
    `accept_resample`, with temperature / top-k / top-p applied alike to
    the target's p and the draft's q (`processed_probs`): the output is
    distributed as ancestral sampling from the processed p. Uniforms come
    from a `torch.Generator`, so draws are not `jax.random`'s bits.

Batch is 1: rows would part on their accept counts (the continuous
batcher's rounds carry per-row offsets instead).

Invariant at the top of each round (pos = the next undecided buffer
column; buffer[:pos] decided): both caches hold the k/v of every position
below pos-1; the token at pos-1, the newest emitted one, is in neither.
The draft's round therefore opens with an s=2 window over
buffer[pos-2:pos]: re-ingesting pos-2 (the same k/v where it is cached)
closes the one-column gap that a fully accepted round leaves in the draft
cache.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Iterator, Optional

import numpy as np
import torch

from otter_tpu_torch.config import GenerationConfig
from otter_tpu_torch.generation import sampling
from otter_tpu_torch.generation.engine import (DONE_EVERY, GraphedSteps,
                                               _cache_name, _DoneFlag,
                                               _Entry, _inference, _on,
                                               _round_up)
from otter_tpu_torch.models.decoder import init_cache


def categorical(probs: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One draw a row from probs [..., V] (`jax.random.categorical` over
    log(max(probs, 1e-38))), by the Gumbel-max rule with uniforms from
    `generator` on the probs' device: no host wait."""
    u = torch.rand(probs.shape, generator=generator,
                   device=probs.device).clamp_(1e-20, 1.0)
    return (torch.log(probs.float().clamp_min(1e-38))
            - torch.log(-torch.log(u))).argmax(-1)


def processed_probs(logits: torch.Tensor,
                    gen: GenerationConfig) -> torch.Tensor:
    """logits [..., V] -> the processed sampling distribution (softmax of
    the temperature / top-k / top-p filtered logits, in f32). The draft's
    q and the target's p both go through it, so the rejection rule gives
    ancestral sampling from the processed p."""
    lg = sampling.apply_temperature(logits.float(), gen.temperature)
    lg = sampling.apply_top_k(lg, gen.top_k)
    lg = sampling.apply_top_p(lg, gen.top_p)
    return torch.softmax(lg, dim=-1)


def accept_resample_rows(p: torch.Tensor, q: torch.Tensor, d: torch.Tensor,
                         generator: Optional[torch.Generator] = None):
    """The speculative-sampling rule (Leviathan et al. 2211.17192, Thm 1)
    for every row at once, on the device: p [B, g+1, V] the target's
    processed probabilities at the g proposals and the bonus position, q
    [B, g, V] the draft's, d [B, g] the proposals. Proposal i is accepted
    while u_i < p_i(d_i) / q_i(d_i); at the first rejection m one token is
    drawn from norm(max(p_m - q_m, 0)) (from p_g when all g were
    accepted). Returns (out [B, g+1], n [B]): emit out[:n]."""
    b, g = d.shape
    u = torch.rand((b, g), generator=generator, device=p.device)
    p_at = torch.gather(p[:, :g], 2, d[..., None])[..., 0]
    q_at = torch.gather(q, 2, d[..., None])[..., 0].clamp_min(1e-20)
    m = torch.cumprod((u < p_at / q_at).long(), 1).sum(1)
    p_m = torch.gather(p, 1, m[:, None, None].expand(b, 1, p.shape[-1]))[:, 0]
    q_m = torch.gather(q, 1, m.clamp_max(g - 1)[:, None, None].expand(
        b, 1, q.shape[-1]))[:, 0]
    q_m = torch.where((m < g)[:, None], q_m, torch.zeros_like(q_m))
    resid = (p_m - q_m).clamp_min(0.0)
    rs = resid.sum(-1, keepdim=True)
    # float noise: where p == q a stray rejection would leave an empty
    # residual; p_m stands in for it
    resid = torch.where(rs > 1e-6, resid / rs.clamp_min(1e-20), p_m)
    x_m = categorical(resid, generator)
    out = torch.cat([d, torch.zeros_like(d[:, :1])], 1)
    out.scatter_(1, m[:, None], x_m[:, None].to(d.dtype))
    return out, m + 1


def accept_resample(p: torch.Tensor, q: torch.Tensor, d: torch.Tensor,
                    generator: Optional[torch.Generator] = None):
    """`accept_resample_rows` of one row: p [g+1, V], q [g, V], d [g] ->
    (out [g+1], n)."""
    out, n = accept_resample_rows(p[None], q[None], d[None], generator)
    return out[0], n[0]


class SpeculativeGenerator(GraphedSteps):
    """Speculative decoding over a (target, draft) pair of `OtterVLM`s on
    the target's device: greedy-exact, or distributionally exact when
    sampled (see the module docstring). Both models share the vocabulary
    and take the same vision input; `gamma` draft tokens a round.

    The round is the counterpart of the JAX package's jitted round
    (`_get_round_fn`, its buffer and both caches donated): on CUDA it is
    captured once per key as a CUDA graph (`cuda_graph`, on by default
    where both models are on the card and neither is sharded) and
    replayed; `cuda_graph=False` runs the same round body eagerly, as the
    CPU always does. The key is JAX's (the cache length, eos and the
    sampling settings) with the cache dtype and the latents' shapes, not
    the prompt's length: requests whose prompt and `max_new_tokens` round
    to one cache length share a key."""

    def __init__(self, model_t, model_d, *, gamma: int = 4,
                 cache_dtype=torch.bfloat16,
                 cuda_graph: Optional[bool] = None):
        if model_t.cfg.text.vocab_size != model_d.cfg.text.vocab_size:
            raise ValueError("speculative decoding needs one vocabulary: "
                             f"{model_t.cfg.text.vocab_size} against "
                             f"{model_d.cfg.text.vocab_size}")
        super().__init__(model_t, cuda_graph, draft=model_d)
        self.model_t, self.model_d = model_t, model_d
        self.cfg_t, self.cfg_d = model_t.cfg, model_d.cfg
        self.gamma = gamma
        self.cache_dtype = cache_dtype
        self.last_emitted = self.last_rounds = 0

    # ── the entries ──────────────────────────────────────────────────

    def _key(self, cache_len: int, gen: GenerationConfig, eos: int,
             lat_t: torch.Tensor, lat_d: torch.Tensor) -> tuple:
        """JAX's round key (`_get_round_fn`) with what the graph records
        besides: the cache dtype and both latents' shapes."""
        return ("round", cache_len, _cache_name(self.cache_dtype), eos,
                gen.do_sample, gen.temperature, gen.top_k, gen.top_p,
                tuple(lat_t.shape), tuple(lat_d.shape))

    def _lease(self, cache_len: int, gen: GenerationConfig, eos: int,
               lat_t: torch.Tensor, lat_d: torch.Tensor) -> _Entry:
        key = self._key(cache_len, gen, eos, lat_t, lat_d)

        def make():
            st = self.round_state(cache_len, gen, eos, lat_t, lat_d)
            return _Entry(key, st, self.cache_dtype,
                          lambda: self._round_body(st))
        return self._take(key, make)

    def round_state(self, cache_len: int, gen: GenerationConfig, eos: int,
                    lat_t: torch.Tensor, lat_d: torch.Tensor,
                    **held) -> SimpleNamespace:
        """The tensors a round reads and writes in place: the buffer, both
        caches (`cache_t`, `cache_d`), both latents, the prompt's media
        count, the pad mask `base_valid` [1, L] and left padding `off`, the
        counters `pos` (the next undecided column), `emitted` (tokens so
        far, the first included), `rounds` (rounds that emitted), `done`
        and `max_new`, and the round's outputs `n` and `out` (it emits
        out[:n]); a sampled state adds its generator. `held` gives tensors
        that another owner keeps (a session's caches and buffer) in place
        of new ones."""
        dev, long = self.device, dict(dtype=torch.long, device=self.device)

        def made(name, fn):
            return held[name] if name in held else fn()
        zero = lambda: torch.zeros((), **long)
        return SimpleNamespace(
            gen=gen, eos=eos,
            cache_t=made("cache_t", lambda: init_cache(
                self.cfg_t.text, 1, cache_len, self.cache_dtype, dev)),
            cache_d=made("cache_d", lambda: init_cache(
                self.cfg_d.text, 1, cache_len, self.cache_dtype, dev)),
            buffer=made("buffer", lambda: torch.zeros((1, cache_len),
                                                      **long)),
            base_valid=made("base_valid", lambda: torch.zeros(
                (1, cache_len), dtype=torch.bool, device=dev)),
            media=made("media", lambda: torch.zeros(1, dtype=torch.int32,
                                                    device=dev)),
            off=made("off", zero),
            lat_t=torch.empty_like(lat_t), lat_d=torch.empty_like(lat_d),
            pos=zero(), emitted=zero(), rounds=zero(), max_new=zero(),
            done=torch.zeros((), dtype=torch.bool, device=dev),
            n=zero(), out=torch.zeros(self.gamma + 1, **long),
            generator=(torch.Generator(device=dev) if gen.do_sample
                       else None),
            source=None, p=0, t=0)

    # ── device pieces ────────────────────────────────────────────────

    @staticmethod
    def _window(model, toks, cache, cache_pos, lat, media, base_valid, off,
                live):
        """One cached window: toks [1, S] at columns cache_pos ..
        cache_pos+S-1 (a 0-d device tensor), attending the valid columns
        up to each one. `off` is the prompt's left padding (a RoPE position
        is its column less `off`; ALiBi ignores it); a round that is not
        `live` takes positions 0 (its outputs go nowhere). Returns logits
        [1, S, V]."""
        s = toks.shape[1]
        L = base_valid.shape[1]
        cols = torch.arange(L, device=toks.device)[None, :]
        kv_valid = base_valid & (cols <= cache_pos + s - 1)
        positions = (cache_pos - off
                     + torch.arange(s, device=toks.device))[None, :] * live
        logits, _, _ = model(None, toks, vis_latents=lat, cache=cache,
                             cache_pos=cache_pos, kv_valid=kv_valid,
                             positions=positions, media_counts=media)
        return logits

    @staticmethod
    def _first_token(logits, gen: GenerationConfig, generator):
        """The first token [] from the target's prefill logits [1, V]."""
        if gen.do_sample:
            return categorical(processed_probs(logits[0], gen), generator)
        return logits[0].argmax(-1)

    @staticmethod
    def prefill(model, vision_x, lang_x, mask, cache, lat=None):
        """A prompt's prefill into `cache` (its vision input encoded, or
        its latents `lat`): (last logits [1, V], latents)."""
        positions = (mask.cumsum(-1) - 1).clamp_min(0)
        logits, _, lat = model(vision_x, lang_x, attention_mask=mask,
                               positions=positions, cache=cache,
                               vis_latents=lat, head_last_only=True)
        return logits[:, -1], lat

    @_inference
    def _prefill(self, vision_x, lang_x, attention_mask,
                 gen: GenerationConfig, eos: int, generator,
                 cache_len: int) -> SimpleNamespace:
        """Both prefills into a leased entry's caches and the first token:
        the state that the round advances (`st.entry`; `_finish` returns
        it)."""
        dev = self.device
        lang_x = _on(lang_x, dev).long()
        p = lang_x.shape[1]
        mask = (torch.ones_like(lang_x, dtype=torch.int32)
                if attention_mask is None
                else _on(attention_mask, dev).int())
        vx = _on(vision_x, dev)
        lat_t = self.model_t.encode_vision(vx)
        lat_d = self.model_d.encode_vision(vx)
        st = self._lease(cache_len, gen, eos, lat_t, lat_d).st
        try:
            last, _ = self.prefill(self.model_t, None, lang_x, mask,
                                   st.cache_t, lat_t)
            self.prefill(self.model_d, None, lang_x, mask, st.cache_d, lat_d)
            st.buffer.fill_(gen.pad_token_id)
            st.buffer[:, :p] = lang_x
            st.base_valid.fill_(True)
            st.base_valid[:, :p] = mask.bool()
            st.media.copy_((lang_x == self.cfg_t.media_token_id).sum(-1))
            st.off.copy_(p - mask.sum())
            self._seed(st, generator)
            self._start(st, p, self._first_token(last, gen, st.generator),
                        gen.max_new_tokens, lat_t, lat_d)
        except BaseException:
            self._finish(st)
            raise
        return st

    def _start(self, st: SimpleNamespace, p: int, tok0: torch.Tensor,
               max_new: int, lat_t, lat_d) -> None:
        """The counters of a request whose first token `tok0` (a device
        scalar) goes to buffer column p: the latents copied in, pos at
        p + 1, one token emitted, done if it is eos."""
        st.lat_t.copy_(lat_t)
        st.lat_d.copy_(lat_d)
        st.buffer[0, p] = tok0
        st.pos.fill_(p + 1)
        st.emitted.fill_(1)
        st.rounds.zero_()
        st.max_new.fill_(max_new)
        st.done.copy_(tok0 == st.eos)
        st.p, st.t = p, 0

    def _round_body(self, st: SimpleNamespace) -> None:
        """One round on the state's tensors, in place: the draft's opener
        over buffer[pos-2:pos] and gamma-1 steps, the target's s=gamma+1
        verify window at pos-1, then the accepted prefix and the target's
        correction, cut at eos, written to the buffer from pos; `n` (the
        tokens emitted, within `max_new`) and `out` [gamma+1] hold what
        the round emits, and the counters advance. Every value that
        changes between rounds is read from device memory, so the same
        call serves every round: what a graph captures.

        A round of a request that is done (or has emitted `max_new`) is a
        no-op: n = 0, the buffer and the counters unchanged; its windows
        move two columns right, so that it writes cache columns from pos
        on only, which no query attends before a live round rewrites
        them."""
        g, gen, eos, dev = self.gamma, st.gen, st.eos, self.device
        live = ~st.done & (st.emitted < st.max_new)
        at = st.pos + 2 * (~live).long()
        tw = st.buffer.index_select(1, at - 2 + torch.arange(2, device=dev))
        win = dict(media=st.media, base_valid=st.base_valid, off=st.off,
                   live=live)
        lg = self._window(self.model_d, tw, st.cache_d, at - 2, st.lat_d,
                          **win)
        sampled = gen.do_sample
        qs, ds = [], []
        for i in range(g):
            if i:
                lg = self._window(self.model_d, ds[-1].view(1, 1),
                                  st.cache_d, at + i - 1, st.lat_d, **win)
            if sampled:
                qs.append(processed_probs(lg[0, -1], gen))
                ds.append(categorical(qs[-1], st.generator))
            else:
                ds.append(lg[0, -1].argmax(-1))
        d = torch.stack(ds)                                   # [g]
        window = torch.cat([tw[0, 1:], d])[None]              # [1, g+1]
        lg_t = self._window(self.model_t, window, st.cache_t, at - 1,
                            st.lat_t, **win)[0]
        idx = torch.arange(g + 1, device=dev)
        if sampled:
            out, n = accept_resample(processed_probs(lg_t, gen),
                                     torch.stack(qs), d, st.generator)
            is_eos = (out == eos) & (idx < n)
        else:
            t = lg_t.argmax(-1)                               # [g+1]
            m = torch.cumprod((t[:g] == d).long(), 0).sum()
            out = torch.where(idx < m, torch.cat([d, d[-1:]]), t)
            n = m + 1
            is_eos = (out == eos) & (idx <= m)
        eos_at = torch.where(is_eos, idx, g + 1).min()
        n = torch.where(live, torch.minimum(n, eos_at + 1), 0)
        # (a no-op round's columns may pass the buffer's end: it writes
        # back what it read)
        cols = (at + idx).clamp_max(st.buffer.shape[1] - 1)
        cur = st.buffer.index_select(1, cols)[0]
        st.buffer.index_copy_(1, cols, torch.where(idx < n, out, cur)[None])
        # the candidates written past the budget are padded at the end
        n = torch.minimum(n, st.max_new - st.emitted)
        st.done.logical_or_(((out == eos) & (idx < n)).any())
        st.emitted.add_(n)
        st.pos.add_(n)
        st.rounds.add_(live.long())
        st.n.copy_(n)
        st.out.copy_(out)

    @staticmethod
    def _read(n, out):
        """A round's (n, out) on the host: one device -> host copy."""
        vals = torch.cat([n.view(1), out]).tolist()
        return vals[0], vals[1:]

    def _setup(self, lang_x, gen: Optional[GenerationConfig]):
        gen = gen or GenerationConfig()
        if gen.num_beams > 1:
            raise ValueError("speculative decoding has no beams")
        if np.shape(lang_x)[0] != 1:
            raise ValueError("speculative decoding is a b=1 latency tool")
        eos = (gen.eos_token_id if gen.eos_token_id is not None
               else self.cfg_t.eoc_token_id)
        p = np.shape(lang_x)[1]
        return gen, eos, _round_up(p + gen.max_new_tokens + self.gamma + 2,
                                   128)

    # ── public API ───────────────────────────────────────────────────

    def generate(self, vision_x, lang_x, attention_mask=None,
                 gen: Optional[GenerationConfig] = None,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """vision_x [1, T, F, C, H, W]; lang_x [1, P] left-padded. Returns
        [1, P + max_new_tokens] (eos-terminated, pad-filled): greedy, the
        target's greedy `OtterGenerator.generate`; sampled, distributed as
        the target's ancestral sampling. `last_emitted` / `last_rounds`
        are the tokens (the prefill's included) and the rounds it took.

        The rounds are queued without the host, as JAX's `lax.while_loop`
        runs them: the done flag is read once in `DONE_EVERY` rounds, from
        a copy made `DONE_EVERY` rounds before; the rounds queued past the
        end change nothing. A live round emits at least one token, so
        max_new_tokens - 1 rounds end any request."""
        gen, eos, cache_len = self._setup(lang_x, gen)
        st = self._prefill(vision_x, lang_x, attention_mask, gen, eos,
                           generator, cache_len)
        try:
            flag = None
            for r in range(gen.max_new_tokens - 1):
                if r % DONE_EVERY == 0:
                    if flag is not None and flag.value():
                        break
                    flag = _DoneFlag(st.done | (st.emitted >= st.max_new))
                self._advance(st)
            p, max_new = st.p, gen.max_new_tokens
            emitted, rounds = torch.stack([st.emitted, st.rounds]).tolist()
            cols = torch.arange(p + max_new, device=self.device)
            out = torch.where(cols < p + emitted, st.buffer[:, :p + max_new],
                              gen.pad_token_id).cpu().numpy()
        finally:
            self._finish(st)
        self.last_emitted, self.last_rounds = emitted, rounds
        return out

    def stream(self, vision_x, lang_x, attention_mask=None,
               gen: Optional[GenerationConfig] = None,
               generator: Optional[torch.Generator] = None
               ) -> Iterator[int]:
        """Yields token ids as `OtterGenerator.stream_generate` does (eos
        not yielded), reading the host once a round, as JAX's `stream`
        does: greedy requests yield the target engine's ids exactly. A
        stream closed early gives its entry back."""
        gen, eos, cache_len = self._setup(lang_x, gen)
        st = self._prefill(vision_x, lang_x, attention_mask, gen, eos,
                           generator, cache_len)
        try:
            tok0 = int(st.buffer[0, st.p])
            if tok0 == eos:
                return
            yield tok0
            emitted = 1
            while emitted < gen.max_new_tokens:
                self._advance(st)
                n, out = self._read(st.n, st.out)
                for tok in out[:n]:
                    if tok == eos:
                        return
                    yield tok
                    emitted += 1
        finally:
            self._finish(st)
