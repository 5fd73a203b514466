"""Speculative decoding (counterpart of `otter_tpu/generation/speculative.py`):
a small draft model proposes gamma tokens, the target verifies them in one
multi-token cached step, and greedy output equals the target's own greedy
decode token for token.

A round is a Python loop on the device's stream: the draft's s=2 opener,
gamma-1 single-token draft steps, then one s=gamma+1 verify window of the
target (the decoder's multi-token cached step: block causality inside the
window, `kv_valid` over the cache). The proposals, the accept count and
the emitted tokens stay on the device; the host reads them once a round,
where JAX's `stream` does (its `generate` runs the rounds inside one
`lax.while_loop`). Nothing is rolled back: rejected columns stay outside
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
from otter_tpu_torch.generation.engine import _on
from otter_tpu_torch.models.decoder import init_cache


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


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


class SpeculativeGenerator:
    """Speculative decoding over a (target, draft) pair of `OtterVLM`s on
    the target's device: greedy-exact, or distributionally exact when
    sampled (see the module docstring). Both models share the vocabulary
    and take the same vision input; `gamma` draft tokens a round."""

    def __init__(self, model_t, model_d, *, gamma: int = 4,
                 cache_dtype=torch.bfloat16):
        if model_t.cfg.text.vocab_size != model_d.cfg.text.vocab_size:
            raise ValueError("speculative decoding needs one vocabulary: "
                             f"{model_t.cfg.text.vocab_size} against "
                             f"{model_d.cfg.text.vocab_size}")
        self.model_t, self.model_d = model_t, model_d
        self.cfg_t, self.cfg_d = model_t.cfg, model_d.cfg
        self.gamma = gamma
        self.cache_dtype = cache_dtype
        self.last_emitted = self.last_rounds = 0

    @property
    def device(self) -> torch.device:
        return self.model_t.device

    # ── device pieces ────────────────────────────────────────────────

    @staticmethod
    def _prefill(model, vision_x, lang_x, mask, cache):
        """A prompt's prefill into `cache`: (last logits [1, V], latents)."""
        positions = (mask.cumsum(-1) - 1).clamp_min(0)
        logits, _, lat = model(vision_x, lang_x, attention_mask=mask,
                               positions=positions, cache=cache,
                               head_last_only=True)
        return logits[:, -1], lat

    @staticmethod
    def _window(model, toks, cache, cache_pos: int, lat, media, base_valid,
                off: int):
        """One cached window: toks [1, S] at columns cache_pos ..
        cache_pos+S-1, attending the valid columns up to each one. `off` is
        the prompt's left padding (a RoPE position is its column less
        `off`; ALiBi ignores it). Returns logits [1, S, V]."""
        s = toks.shape[1]
        L = base_valid.shape[1]
        cols = torch.arange(L, device=toks.device)[None, :]
        kv_valid = base_valid & (cols <= cache_pos + s - 1)
        positions = torch.arange(cache_pos - off, cache_pos - off + s,
                                 device=toks.device)[None, :]
        logits, _, _ = model(None, toks, vis_latents=lat, cache=cache,
                             cache_pos=cache_pos, kv_valid=kv_valid,
                             positions=positions, media_counts=media)
        return logits

    def _first_token(self, logits, gen: GenerationConfig, generator):
        """The first token [] from the target's prefill logits [1, V]."""
        if gen.do_sample:
            return categorical(processed_probs(logits[0], gen), generator)
        return logits[0].argmax(-1)

    @torch.inference_mode()
    def _start(self, vision_x, lang_x, attention_mask, gen, generator,
               cache_len: int) -> SimpleNamespace:
        """Both prefills into fresh caches of `cache_len` columns and the
        first token: the state that `_round` advances."""
        dev = self.device
        lang_x = _on(lang_x, dev).long()
        p = lang_x.shape[1]
        mask = (torch.ones_like(lang_x, dtype=torch.int32)
                if attention_mask is None
                else _on(attention_mask, dev).int())
        off = p - int(mask.sum())     # the left padding (before any launch)
        vision_x = _on(vision_x, dev)
        caches = [init_cache(m.cfg.text, 1, cache_len, self.cache_dtype, dev)
                  for m in (self.model_t, self.model_d)]
        last_t, lat_t = self._prefill(self.model_t, vision_x, lang_x, mask,
                                      caches[0])
        _, lat_d = self._prefill(self.model_d, vision_x, lang_x, mask,
                                 caches[1])
        buffer = torch.full((1, cache_len), gen.pad_token_id,
                            dtype=torch.long, device=dev)
        buffer[:, :p] = lang_x
        tok0 = self._first_token(last_t, gen, generator)
        buffer[0, p] = tok0
        return SimpleNamespace(
            p=p, tok0=tok0, buffer=buffer, cache_t=caches[0],
            cache_d=caches[1], lat_t=lat_t, lat_d=lat_d,
            media=(lang_x == self.cfg_t.media_token_id).int().sum(-1),
            base_valid=torch.cat([mask.bool(), torch.ones(
                (1, cache_len - p), dtype=torch.bool, device=dev)], 1),
            off=off)

    @torch.inference_mode()
    def _round(self, st: SimpleNamespace, pos: int, gen: GenerationConfig,
               eos: int, generator=None):
        """One round at buffer column `pos` (the next undecided one): the
        draft's opener over buffer[pos-2:pos] and gamma-1 steps, the
        target's s=gamma+1 verify window at pos-1, then the accepted
        prefix and the target's correction, cut at eos, written to the
        buffer from pos. Returns (n [], out [gamma+1]) on the device: the
        round emits out[:n]."""
        g = self.gamma
        win = dict(lat=st.lat_d, media=st.media, base_valid=st.base_valid,
                   off=st.off)
        tw = st.buffer[:, pos - 2:pos]
        lg = self._window(self.model_d, tw, st.cache_d, pos - 2, **win)
        sampled = gen.do_sample
        qs, ds = [], []
        for i in range(g):
            if i:
                lg = self._window(self.model_d, ds[-1].view(1, 1),
                                  st.cache_d, pos + i - 1, **win)
            if sampled:
                qs.append(processed_probs(lg[0, -1], gen))
                ds.append(categorical(qs[-1], generator))
            else:
                ds.append(lg[0, -1].argmax(-1))
        d = torch.stack(ds)                                   # [g]
        window = torch.cat([tw[0, 1:], d])[None]              # [1, g+1]
        lg_t = self._window(self.model_t, window, st.cache_t, pos - 1,
                            **dict(win, lat=st.lat_t))[0]
        idx = torch.arange(g + 1, device=d.device)
        if sampled:
            out, n = accept_resample(processed_probs(lg_t, gen),
                                     torch.stack(qs), d, generator)
            is_eos = (out == eos) & (idx < n)
        else:
            t = lg_t.argmax(-1)                               # [g+1]
            m = torch.cumprod((t[:g] == d).long(), 0).sum()
            out = torch.where(idx < m, torch.cat([d, d[-1:]]), t)
            n = m + 1
            is_eos = (out == eos) & (idx <= m)
        eos_at = torch.where(is_eos, idx, g + 1).min()
        n = torch.minimum(n, eos_at + 1)
        cur = st.buffer[0, pos:pos + g + 1]
        st.buffer[0, pos:pos + g + 1] = torch.where(idx < n, out, cur)
        return n, out

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
        are the tokens (the prefill's included) and the rounds it took."""
        gen, eos, cache_len = self._setup(lang_x, gen)
        st = self._start(vision_x, lang_x, attention_mask, gen, generator,
                         cache_len)
        p, max_new = st.p, gen.max_new_tokens
        emitted, rounds = 1, 0
        done = int(st.tok0) == eos
        while emitted < max_new and not done:
            n, out = self._read(*self._round(st, p + emitted, gen, eos,
                                             generator))
            # the round may have written candidates past the budget: the
            # pad below erases them
            n = min(n, max_new - emitted)
            done = eos in out[:n]
            emitted += n
            rounds += 1
        self.last_emitted, self.last_rounds = emitted, rounds
        out = st.buffer[:, :p + max_new]
        cols = torch.arange(p + max_new, device=out.device)
        return torch.where(cols < p + emitted, out,
                           gen.pad_token_id).cpu().numpy()

    def stream(self, vision_x, lang_x, attention_mask=None,
               gen: Optional[GenerationConfig] = None,
               generator: Optional[torch.Generator] = None
               ) -> Iterator[int]:
        """Yields token ids as `OtterGenerator.stream_generate` does (eos
        not yielded), reading the host once a round: greedy requests yield
        the target engine's ids exactly."""
        gen, eos, cache_len = self._setup(lang_x, gen)
        st = self._start(vision_x, lang_x, attention_mask, gen, generator,
                         cache_len)
        tok0 = int(st.tok0)
        if tok0 == eos:
            return
        yield tok0
        emitted = 1
        while emitted < gen.max_new_tokens:
            n, out = self._read(*self._round(st, st.p + emitted, gen, eos,
                                             generator))
            for tok in out[:min(n, gen.max_new_tokens - emitted)]:
                if tok == eos:
                    return
                yield tok
                emitted += 1
