"""Beam search (counterpart of `otter_tpu/generation/beam.py`).

The HF `generate_kwargs` beam surface the reference serving and demos
expose (`num_beams`, `length_penalty`, `gradio_web_server.py:361-370`).
Per step: the top 2K candidates of every row's K beams, a finished pool
of length-penalised scores (HF's score = logprob / len^length_penalty),
the live beams' cache rows gathered from their parents. The JAX package
runs the steps in a `lax.fori_loop`; here a Python loop runs the same
steps, always `max_new_tokens - 1` of them, as there.

Selection keeps `jax.lax.top_k`'s order: descending, the lower index first
among equal values (a stable descending sort). Equal values are common:
the finished pool starts full of NEG_INF, and a candidate of a beam whose
score is NEG_INF rounds to a few values near it in f32. Log-softmax runs
in f32.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Dict, Iterator, Optional, Tuple

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
    (t = 0) itself. The cache's tensors are reordered in place."""
    st = _beam_setup(init_logits, cache, num_beams=num_beams,
                     max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                     pad_token_id=pad_token_id, length_penalty=length_penalty,
                     step_fn=step_fn, logits_processor=logits_processor)
    for t in range(1, max_new_tokens):
        _beam_step(st, t)
    return _beam_best(st, max_new_tokens)


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
    st = _beam_setup(init_logits, cache, num_beams=num_beams,
                     max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                     pad_token_id=pad_token_id, length_penalty=length_penalty,
                     step_fn=step_fn, logits_processor=logits_processor)
    t = 1
    while t < max_new_tokens:
        t1 = min(t + chunk, max_new_tokens)
        for s in range(t, t1):
            _beam_step(st, s)
        yield _beam_best(st, t1)[0], t1
        t = t1
    if max_new_tokens == 1:
        yield _beam_best(st, 1)[0], 1


def _penalize(scores: torch.Tensor, lengths, length_penalty: float
              ) -> torch.Tensor:
    lengths = torch.as_tensor(lengths, dtype=torch.float32,
                              device=scores.device)
    return scores / lengths ** length_penalty


def _beam_setup(init_logits, cache, *, num_beams, max_new_tokens,
                eos_token_id, pad_token_id, length_penalty, step_fn,
                logits_processor) -> SimpleNamespace:
    """The state after the first token: K beams a row from the prefill's
    logits; a beam whose first token is eos is finished at length 1."""
    b, vocab = init_logits.shape
    k = num_beams
    dev = init_logits.device
    logp0 = torch.log_softmax(init_logits.float(), dim=-1)
    first_scores, first_toks = _top_k(logp0, k)                 # [B, K]
    tokens = torch.full((b, k, max_new_tokens), pad_token_id,
                        dtype=torch.long, device=dev)
    tokens[:, :, 0] = first_toks
    is_eos = first_toks == eos_token_id
    neg = torch.full_like(first_scores, NEG_INF)
    return SimpleNamespace(
        b=b, k=k, vocab=vocab, eos=eos_token_id, lp=length_penalty,
        step_fn=step_fn, logits_processor=logits_processor, cache=cache,
        tokens=tokens, live_scores=torch.where(is_eos, neg, first_scores),
        fin_tokens=tokens.clone(),
        fin_scores=torch.where(is_eos, first_scores, neg),
        fin_lens=torch.ones((b, k), dtype=torch.int32, device=dev))


def _beam_step(st: SimpleNamespace, t: int) -> None:
    """Token t of every beam: expand, update the finished pool, keep the K
    best live candidates and gather their parents' cache rows."""
    b, k, vocab = st.b, st.k, st.vocab
    cur = st.tokens[:, :, t - 1].reshape(b * k, 1)
    logits, st.cache = st.step_fn(cur, st.cache, t)
    if st.logits_processor is not None:
        logits = st.logits_processor(logits, st.tokens.reshape(b * k, -1), t)
    logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, vocab)
    total = st.live_scores[:, :, None] + logp                    # [B, K, V]
    cand_scores, cand_idx = _top_k(total.reshape(b, k * vocab), 2 * k)
    cand_beam = cand_idx // vocab
    cand_tok = cand_idx % vocab
    cand_tokens = _take_rows(st.tokens, cand_beam)               # [B, 2K, L]
    cand_tokens[:, :, t] = cand_tok

    is_eos = cand_tok == st.eos
    neg = torch.full_like(cand_scores, NEG_INF)
    # finished pool: candidates ending in eos compete, penalised at t + 1;
    # the pool keeps penalised scores (penalised again at length 1)
    all_fin_scores = torch.cat(
        [_penalize(st.fin_scores, st.fin_lens, st.lp),
         torch.where(is_eos, _penalize(cand_scores, t + 1, st.lp), neg)], 1)
    top_fin, fin_idx = _top_k(all_fin_scores, k)
    st.fin_tokens = _take_rows(torch.cat([st.fin_tokens, cand_tokens], 1),
                               fin_idx)
    st.fin_scores = top_fin
    st.fin_lens = torch.ones_like(st.fin_lens)

    # live beams: the K best candidates that did not end in eos
    top_live, live_idx = _top_k(torch.where(is_eos, neg, cand_scores), k)
    live_beam = cand_beam.gather(1, live_idx)
    st.tokens = _take_rows(cand_tokens, live_idx)
    st.live_scores = top_live
    # the cache rows of the parent beams, in place (index_select copies
    # before copy_ writes, so rows may move onto each other)
    rows = (torch.arange(b, device=live_beam.device)[:, None] * k
            + live_beam).reshape(-1)
    for x in st.cache.values():
        x.copy_(x.index_select(0, rows))


def _beam_best(st: SimpleNamespace, cur_len: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best sequence so far: the best finished one against the best
    live one penalised at the current length."""
    best_live = _penalize(st.live_scores, cur_len, st.lp)
    use_fin = st.fin_scores[:, 0] >= best_live[:, 0]
    out = torch.where(use_fin[:, None], st.fin_tokens[:, 0], st.tokens[:, 0])
    score = torch.where(use_fin, st.fin_scores[:, 0], best_live[:, 0])
    return out, score
