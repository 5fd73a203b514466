"""Tokenizer adaptation helpers for arbitrary HF tokenizers (a copy of
`otter_tpu/data/tokenizer_adapt.py`).

Two policies, mirroring the two places the reference mutates a stock
tokenizer:

1. `adapt_for_otter` — the Otter/Flamingo special-token policy: add
   `<|endofchunk|>`, `<image>`, `<answer>` (and a `<PAD>` if the
   tokenizer lacks one) and report the ids + required embedding resize
   (reference scatters this across the trainers, e.g.
   `pipeline/train/instruction_following.py:340-346` add_special_tokens
   + resize_token_embeddings; here it is one reusable function whose
   result plugs straight into `TextConfig.extra_vocab` and the
   media/eoc/answer id fields).

2. `adapt_for_denoising` — the MPT mixture-of-denoisers adaptation
   (reference `src/otter_ai/models/mpt/adapt_tokenizer.py:8-44`):
   100 `<extra_id_k>` sentinels plus a pad token, with the sentinel id
   list attached to the tokenizer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

OTTER_SPECIAL_TOKENS = ("<|endofchunk|>", "<image>", "<answer>")
SENTINEL_COUNT = 100


@dataclass
class AdaptedTokens:
    """Result of adapt_for_otter: ids for the model config plus the
    embedding-resize bookkeeping."""
    eoc_token_id: int
    media_token_id: int
    answer_token_id: int
    pad_token_id: int
    added: int            # newly added tokens (drives extra_vocab)
    new_vocab: int        # len(tokenizer) after adaptation

    def apply_to(self, cfg):
        """Return `cfg` (an OtterConfig) with the ids and the embedding
        resize (`text.extra_vocab`) filled in."""
        grown = max(0, self.new_vocab - cfg.text.vocab_size
                    - cfg.text.extra_vocab)
        return cfg.replace(
            media_token_id=self.media_token_id,
            eoc_token_id=self.eoc_token_id,
            answer_token_id=self.answer_token_id,
            pad_token_id=self.pad_token_id,
            text=cfg.text.replace(
                extra_vocab=cfg.text.extra_vocab + grown))


def adapt_for_otter(tokenizer, *, add_answer_token: bool = True
                    ) -> AdaptedTokens:
    """Add the Otter special tokens to any HF tokenizer (idempotent).

    Matches the trainers' policy: `<|endofchunk|>` + `<image>` always
    (`instruction_following.py:340-343`), `<answer>` for SFT
    (`:344-346`), `<PAD>` only when the tokenizer has no pad token
    (`:348-350` sets pad to eos when available; we follow that instead
    of growing the vocab needlessly).
    """
    before = len(tokenizer)
    specials = list(OTTER_SPECIAL_TOKENS if add_answer_token
                    else OTTER_SPECIAL_TOKENS[:2])
    # replace_additional_special_tokens=False: HF's default REPLACE
    # semantics would strip special status from tokens the tokenizer
    # already carries (e.g. Qwen/ChatML's own additional_special_tokens),
    # breaking the idempotent-for-arbitrary-tokenizers contract
    # (advisor r4)
    tokenizer.add_special_tokens(
        {"additional_special_tokens": specials},
        replace_additional_special_tokens=False)
    if tokenizer.pad_token is None:
        if tokenizer.eos_token is not None:
            tokenizer.pad_token = tokenizer.eos_token
        else:
            tokenizer.add_special_tokens({"pad_token": "<PAD>"})
    ids = tokenizer.convert_tokens_to_ids(specials)
    answer_id = ids[2] if add_answer_token else -1
    return AdaptedTokens(
        eoc_token_id=ids[0], media_token_id=ids[1],
        answer_token_id=answer_id,
        pad_token_id=tokenizer.pad_token_id,
        added=len(tokenizer) - before, new_vocab=len(tokenizer))


def adapt_for_denoising(tokenizer) -> List[int]:
    """MOD sentinel adaptation (reference `adapt_tokenizer.py:8-28`):
    ensure `<extra_id_0>`..`<extra_id_99>` and a pad token exist, and
    return (and attach, as `.sentinel_token_ids`) the sentinel ids."""
    sentinels = [f"<extra_id_{i}>" for i in range(SENTINEL_COUNT)]
    tokenizer.add_tokens(sentinels, special_tokens=True)
    if tokenizer.pad_token is None:
        tokenizer.add_tokens("<pad>", special_tokens=True)
        tokenizer.pad_token = "<pad>"
        assert tokenizer.pad_token_id is not None
    joined = "".join(sentinels)
    ids = tokenizer(joined, add_special_tokens=False).input_ids
    tokenizer.sentinel_token_ids = ids
    return ids


def load_adapted(name_or_path: str, *, denoising: bool = False,
                 add_answer_token: bool = True, **kwargs):
    """AutoTokenizer.from_pretrained + adaptation in one call (the
    reference's AutoTokenizerForMOD.from_pretrained shape,
    `adapt_tokenizer.py:30-44`). Returns (tokenizer, AdaptedTokens or
    sentinel ids)."""
    from transformers import AutoTokenizer
    tok = AutoTokenizer.from_pretrained(name_or_path, **kwargs)
    if denoising:
        return tok, adapt_for_denoising(tok)
    return tok, adapt_for_otter(tok, add_answer_token=add_answer_token)
