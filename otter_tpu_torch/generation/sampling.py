"""Token sampling and logits processing (counterpart of
`otter_tpu/generation/sampling.py`): greedy, temperature, top-k, top-p and
the sequence-aware bans (no-repeat n-grams, bad words). Randomness comes
from an explicit `torch.Generator`.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

NEG_INF = -1e10


def apply_temperature(logits: torch.Tensor, temperature: float):
    if temperature not in (0.0, 1.0):
        logits = logits / temperature
    return logits


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    top = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < top, torch.full_like(logits, NEG_INF), logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set with cumulative probability
    >= p, always including the argmax."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < p
    threshold = torch.where(keep_sorted, sorted_logits,
                            torch.full_like(sorted_logits, float("inf"))
                            ).amin(-1, keepdim=True)
    return torch.where(logits < threshold, torch.full_like(logits, NEG_INF),
                       logits)


def ban_repeat_ngrams(logits, tokens, cur_end, ngram: int, valid_from=0):
    """Ban tokens that would complete an n-gram already present in
    tokens[:, valid_from:cur_end] (tokens [B, L]; cur_end and valid_from
    ints or [B])."""
    if ngram <= 0:
        return logits
    b, l = tokens.shape
    n1 = ngram - 1
    if l < ngram:
        return logits
    dev = tokens.device
    idx = torch.arange(l - n1, device=dev)[:, None] \
        + torch.arange(n1, device=dev)[None, :]
    windows = tokens[:, idx]                                  # [B, L-n1, n1]
    cur = torch.as_tensor(cur_end, device=dev).expand(b)
    vfrom = torch.as_tensor(valid_from, device=dev).expand(b)
    suf_idx = cur[:, None] - n1 + torch.arange(n1, device=dev)[None, :]
    suffix = torch.gather(tokens, 1, suf_idx.clamp(0, l - 1))
    match = (windows == suffix[:, None, :]).all(-1)           # [B, L-n1]
    win_start = torch.arange(l - n1, device=dev)[None, :]
    match = (match & (win_start >= vfrom[:, None])
             & (win_start + n1 < cur[:, None])
             & ((cur - vfrom)[:, None] >= ngram))
    cand = tokens[:, n1:].long()                              # [B, L-n1]
    hits = torch.zeros(logits.shape, dtype=torch.int32, device=dev)
    hits.scatter_add_(1, cand, match.int())
    return torch.where(hits > 0, torch.full_like(logits, NEG_INF), logits)


def ban_bad_words(logits, tokens, cur_end, bad_words_ids, valid_from=0):
    """HF `bad_words_ids`: each sequence's last token is banned whenever
    the tokens before it equal the tail of tokens[:, valid_from:cur_end];
    single-token sequences are banned outright."""
    if not bad_words_ids:
        return logits
    b, l = tokens.shape
    dev = tokens.device
    cur = torch.as_tensor(cur_end, device=dev).expand(b)
    vfrom = torch.as_tensor(valid_from, device=dev).expand(b)
    logits = logits.clone()
    for seq in bad_words_ids:
        if len(seq) == 0:
            continue
        last, n1 = int(seq[-1]), len(seq) - 1
        if n1 == 0:
            logits[:, last] = NEG_INF
            continue
        prefix = _word_prefix(tuple(seq[:-1]), tokens.dtype, dev)
        suf_idx = cur[:, None] - n1 + torch.arange(n1, device=dev)[None, :]
        suffix = torch.gather(tokens, 1, suf_idx.clamp(0, l - 1))
        match = (suffix == prefix[None, :]).all(-1) & ((cur - vfrom) >= n1)
        logits[:, last] = torch.where(
            match, torch.full_like(logits[:, last], NEG_INF), logits[:, last])
    return logits


@functools.lru_cache(maxsize=256)
def _word_prefix(seq: Tuple[int, ...], dtype, device) -> torch.Tensor:
    """A bad word's prefix as a tensor on `device`, made once: a host copy
    inside a captured CUDA graph would be baked into it (and a pageable
    one syncs the host)."""
    return torch.as_tensor(seq, dtype=dtype, device=device)


def process_logits(logits, tokens, cur_end, gen, valid_from=0):
    """The sequence-aware logit controls of a GenerationConfig."""
    logits = ban_repeat_ngrams(logits, tokens, cur_end,
                               gen.no_repeat_ngram_size, valid_from)
    return ban_bad_words(logits, tokens, cur_end, gen.bad_words_ids,
                         valid_from)


def sample_token(logits: torch.Tensor, *, do_sample: bool,
                 temperature: float, top_k: int, top_p: float,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """logits [B, V] -> token [B] int64."""
    if not do_sample or temperature == 0.0:
        return logits.argmax(-1)
    logits = apply_temperature(logits.float(), temperature)
    logits = apply_top_k(logits, top_k)
    logits = apply_top_p(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def filter_rows(scaled: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor) -> torch.Tensor:
    """Per-row top-k + top-p filtering of pre-scaled logits [B, V];
    `top_k` [B] int (0 = off), `top_p` [B] float (1.0 = off).

    One full-vocab sort: the top-k filter sets a value-ordered suffix of
    the sorted view to NEG_INF, so the sorted view of the filtered logits
    is the same `where` applied to the sorted array and the nucleus pass
    needs no second sort."""
    v = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    # per-row top-k: threshold at the k-th largest (k = 0: no filter)
    k_idx = (top_k.long() - 1).clamp(0, v - 1)
    kth = torch.gather(sorted_desc, 1, k_idx[:, None])
    kmask = top_k[:, None] > 0
    neg = torch.full_like(scaled, NEG_INF)
    scaled = torch.where(kmask & (scaled < kth), neg, scaled)
    sorted_f = torch.where(kmask & (sorted_desc < kth), neg, sorted_desc)
    # per-row top-p (nucleus), always keeping the argmax
    probs = torch.softmax(sorted_f, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p[:, None]
    thresh = torch.where(keep, sorted_f,
                         torch.full_like(sorted_f, float("inf"))
                         ).amin(-1, keepdim=True)
    return torch.where(scaled < thresh, neg, scaled)


def sample_rows(logits: torch.Tensor, *, do_sample: torch.Tensor,
                temperature: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
    """Per-row sampling, every control a [B] tensor: logits [B, V] ->
    token [B] int64. Logits are scaled in float32; a sampled row draws by
    the Gumbel-max rule (`jax.random.categorical`'s), with uniforms from
    `generator` on the logits' device, so that no step waits on the host."""
    greedy = logits.argmax(-1)
    scaled = logits.float() / temperature.float().clamp_min(1e-6)[:, None]
    scaled = filter_rows(scaled, top_k, top_p)
    u = torch.rand(scaled.shape, generator=generator,
                   device=scaled.device).clamp_(1e-20, 1.0)
    sampled = (scaled - torch.log(-torch.log(u))).argmax(-1)
    return torch.where(do_sample, sampled, greedy)
