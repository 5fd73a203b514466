"""Beam search (counterpart of `otter_tpu/generation/beam.py`).

The HF `generate_kwargs` beam surface the reference serving and demos
expose (`num_beams`, `length_penalty`, `gradio_web_server.py:361-370`).
Per step: the top 2K candidates of every row's K beams, a finished pool
of length-penalised scores (HF's score = logprob / len^length_penalty),
the live beams' cache rows gathered from their parents. The JAX package
runs the steps in a `lax.fori_loop`; here a Python loop runs the same
step, always `max_new_tokens - 1` times, as there.

The state is a set of fixed tensors that a step writes in place, and the
step index is a counter on the device (`t_dev`, the tokens so far), so one
step serves every index: `step_fn` and `logits_processor` get it as a 0-d
tensor, as the JAX loop's get a traced scalar, and the step makes no host
sync. That is what lets the engine capture a beam step once as a CUDA
graph and replay it (`generation/engine.py`). The host reads only the
best beam (`_beam_best`).

Selection keeps `jax.lax.top_k`'s order: descending, the lower index first
among equal values (a stable descending sort). Equal values are common:
the finished pool starts full of NEG_INF, and a candidate of a beam whose
score is NEG_INF rounds to a few values near it in f32. Log-softmax runs
in f32.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

NEG_INF = -1.0e7

Cache = Dict[str, torch.Tensor]


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, in
    `lax.top_k`'s order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, L] rows idx [B, M] -> [B, M, L]."""
    return x.gather(1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def beam_search(
    step_fn: Callable,  # (tok [B*K, 1], cache, t) -> (logits [B*K, V], cache)
    init_logits: torch.Tensor,  # [B, V] logits after the prefill
    cache: Cache,               # beam rows on dim 0 (B*K, pre-tiled)
    *,
    num_beams: int,
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int = 0,
    length_penalty: float = 1.0,
    logits_processor: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B, max_new_tokens] of the best beam, scores [B]).

    `logits_processor`, if given, is called as (logits [B*K, V],
    gen_tokens [B*K, max_new], t) -> logits before each expansion (the
    no-repeat-ngram / bad-words bans); the caller processes `init_logits`
    (t = 0) itself. `t` reaches both callables as a 0-d tensor on the
    logits' device. The cache's tensors are reordered in place."""
    st = _beam_state(init_logits.shape[0], init_logits.shape[1],
                     num_beams=num_beams, max_new_tokens=max_new_tokens,
                     eos_token_id=eos_token_id, pad_token_id=pad_token_id,
                     length_penalty=length_penalty, step_fn=step_fn,
                     logits_processor=logits_processor, cache=cache,
                     device=init_logits.device)
    _beam_setup(st, init_logits)
    for _ in range(1, max_new_tokens):
        _beam_step(st)
    return _beam_best(st)


def beam_search_chunks(
    step_fn: Callable,
    init_logits: torch.Tensor,
    cache: Cache,
    *,
    num_beams: int,
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int = 0,
    length_penalty: float = 1.0,
    logits_processor: Optional[Callable] = None,
    chunk: int = 8,
) -> Iterator[Tuple[torch.Tensor, int]]:
    """Streaming beam search: yields (tokens [B, max_new], steps so far) of
    the current best beam after every `chunk` steps; the last yield is
    `beam_search`'s result. Earlier yields are previews that a later chunk
    may revise."""
    st = _beam_state(init_logits.shape[0], init_logits.shape[1],
                     num_beams=num_beams, max_new_tokens=max_new_tokens,
                     eos_token_id=eos_token_id, pad_token_id=pad_token_id,
                     length_penalty=length_penalty, step_fn=step_fn,
                     logits_processor=logits_processor, cache=cache,
                     device=init_logits.device)
    _beam_setup(st, init_logits)
    for first, end in _chunks(max_new_tokens, chunk):
        for _ in range(first, end):
            _beam_step(st)
        yield _beam_best(st)[0], end


def _chunks(max_new_tokens: int, chunk: int) -> List[Tuple[int, int]]:
    """The streamed search's (first, end) step ranges: steps first .. end
    - 1 run before the yield at `end` tokens; one empty range where the
    prefill's token is all there is."""
    if max_new_tokens == 1:
        return [(1, 1)]
    return [(t, min(t + chunk, max_new_tokens))
            for t in range(1, max_new_tokens, chunk)]


def _penalize(scores: torch.Tensor, lengths: torch.Tensor,
              length_penalty: float) -> torch.Tensor:
    """scores / lengths ** length_penalty, the lengths a tensor on the
    scores' device (a host int would be a copy that a capture refuses)."""
    return scores / lengths.to(torch.float32) ** length_penalty


def _beam_state(b: int, vocab: int, *, num_beams, max_new_tokens,
                eos_token_id, pad_token_id, length_penalty, step_fn,
                logits_processor, cache, device,
                t_dev: Optional[torch.Tensor] = None) -> SimpleNamespace:
    """The search's tensors, allocated once and written in place by
    `_beam_setup` and `_beam_step`: the live beams' tokens and scores, the
    finished pool, and the step counter `t_dev` (the caller's, where it
    shares one with its step)."""
    k = num_beams
    tokens = torch.full((b, k, max_new_tokens), pad_token_id,
                        dtype=torch.long, device=device)
    scores = lambda: torch.zeros((b, k), dtype=torch.float32, device=device)
    return SimpleNamespace(
        b=b, k=k, vocab=vocab, eos=eos_token_id, pad=pad_token_id,
        lp=length_penalty, step_fn=step_fn,
        logits_processor=logits_processor, cache=cache,
        tokens=tokens, live_scores=scores(), fin_tokens=tokens.clone(),
        fin_scores=scores(),
        fin_lens=torch.ones((b, k), dtype=torch.int32, device=device),
        t_dev=(torch.zeros((), dtype=torch.long, device=device)
               if t_dev is None else t_dev))


def _beam_setup(st: SimpleNamespace, init_logits: torch.Tensor) -> None:
    """The state after the first token: K beams a row from the prefill's
    logits; a beam whose first token is eos is finished at length 1."""
    logp0 = torch.log_softmax(init_logits.float(), dim=-1)
    first_scores, first_toks = _top_k(logp0, st.k)              # [B, K]
    st.tokens.fill_(st.pad)
    st.tokens[:, :, 0] = first_toks
    is_eos = first_toks == st.eos
    neg = torch.full_like(first_scores, NEG_INF)
    st.live_scores.copy_(torch.where(is_eos, neg, first_scores))
    st.fin_tokens.copy_(st.tokens)
    st.fin_scores.copy_(torch.where(is_eos, first_scores, neg))
    st.fin_lens.fill_(1)
    st.t_dev.fill_(1)


def _beam_step(st: SimpleNamespace) -> None:
    """Token t = `st.t_dev` of every beam, in place: expand, update the
    finished pool, keep the K best live candidates and gather their
    parents' cache rows; t advances. Nothing here reads a device value on
    the host."""
    b, k, vocab = st.b, st.k, st.vocab
    t = st.t_dev
    cur = st.tokens.index_select(2, (t - 1).view(1)).reshape(b * k, 1)
    logits, cache = st.step_fn(cur, st.cache, t)
    for name, x in cache.items():
        if x is not st.cache[name]:
            st.cache[name].copy_(x)
    if st.logits_processor is not None:
        logits = st.logits_processor(logits, st.tokens.reshape(b * k, -1), t)
    logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, vocab)
    total = st.live_scores[:, :, None] + logp                    # [B, K, V]
    cand_scores, cand_idx = _top_k(total.reshape(b, k * vocab), 2 * k)
    cand_beam = cand_idx // vocab
    cand_tok = cand_idx % vocab
    cand_tokens = _take_rows(st.tokens, cand_beam)               # [B, 2K, L]
    cand_tokens.index_copy_(2, t.view(1), cand_tok[:, :, None])

    is_eos = cand_tok == st.eos
    neg = torch.full_like(cand_scores, NEG_INF)
    # finished pool: candidates ending in eos compete, penalised at t + 1;
    # the pool keeps penalised scores (penalised again at length 1)
    all_fin_scores = torch.cat(
        [_penalize(st.fin_scores, st.fin_lens, st.lp),
         torch.where(is_eos, _penalize(cand_scores, t + 1, st.lp), neg)], 1)
    top_fin, fin_idx = _top_k(all_fin_scores, k)
    st.fin_tokens.copy_(_take_rows(
        torch.cat([st.fin_tokens, cand_tokens], 1), fin_idx))
    st.fin_scores.copy_(top_fin)
    st.fin_lens.fill_(1)

    # live beams: the K best candidates that did not end in eos
    top_live, live_idx = _top_k(torch.where(is_eos, neg, cand_scores), k)
    live_beam = cand_beam.gather(1, live_idx)
    st.tokens.copy_(_take_rows(cand_tokens, live_idx))
    st.live_scores.copy_(top_live)
    # the cache rows of the parent beams, in place (index_select copies
    # before copy_ writes, so rows may move onto each other)
    rows = (torch.arange(b, device=live_beam.device)[:, None] * k
            + live_beam).reshape(-1)
    for x in st.cache.values():
        x.copy_(x.index_select(0, rows))
    st.t_dev.add_(1)


def _beam_best(st: SimpleNamespace) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best sequence so far: the best finished one against the best
    live one penalised at the current length (`t_dev` tokens)."""
    best_live = _penalize(st.live_scores, st.t_dev, st.lp)
    use_fin = st.fin_scores[:, 0] >= best_live[:, 0]
    out = torch.where(use_fin[:, None], st.fin_tokens[:, 0], st.tokens[:, 0])
    score = torch.where(use_fin, st.fin_scores[:, 0], best_live[:, 0])
    return out, score
