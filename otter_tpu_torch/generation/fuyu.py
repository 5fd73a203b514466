"""Generation loop for Fuyu/OtterHD (counterpart of the loop inside
`make_fuyu_stream_fn`, `otter_tpu/serve/worker.py`, without HTTP,
tokenizer or image decoding).

One request at a time, as the worker serves them: a prefill over the
left-padded prompt with its image patches merged, then single-token cached
steps. The prefill computes the logits of every prompt position and keeps
the last (the JAX worker's prefill does the same).
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch

from otter_tpu_torch.config import GenerationConfig
from otter_tpu_torch.generation import sampling
from otter_tpu_torch.generation.engine import CacheDtype, _on
from otter_tpu_torch.models.fuyu import FuyuVLM, make_fuyu_cache


def fuyu_cache_len(prompt_len: int, max_new_tokens: int) -> int:
    """Cache length of a request: rounded up to 512 above 1024 tokens (so
    the decode kernel keeps its widest blocks; entries past the valid
    length are never read) and to 128 below."""
    total = prompt_len + max_new_tokens
    gran = 512 if total > 1024 else 128
    return -(-total // gran) * gran


@torch.inference_mode()
def fuyu_generate(model: FuyuVLM, input_ids, image_patches,
                  image_patches_indices, attention_mask,
                  gen: Optional[GenerationConfig] = None, *,
                  cache_dtype: Optional[CacheDtype] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Iterator[int]:
    """Yields each token id as it is sampled; stops at `gen.eos_token_id`
    (not yielded) or after `gen.max_new_tokens`. input_ids and
    attention_mask [B, S] left-padded, image_patches [B, P, patch dim] (or
    None), image_patches_indices [B, S]; numpy arrays or tensors. Sampling
    reads row 0: the loop serves one request."""
    gen = gen or GenerationConfig()
    dev = model.device
    ids = _on(input_ids, dev).long()
    mask = _on(attention_mask, dev).int()
    b, s = ids.shape
    cache_len = fuyu_cache_len(s, gen.max_new_tokens)
    cache = make_fuyu_cache(
        model.cfg, b, cache_len,
        model.dtype if cache_dtype is None else cache_dtype, dev)
    patches = pidx = None
    if image_patches is not None:
        patches = _on(image_patches, dev).to(model.dtype)
        pidx = _on(image_patches_indices, dev)
    logits, cache = model(
        ids, image_patches=patches, image_patches_indices=pidx,
        attention_mask=mask, positions=(mask.cumsum(-1) - 1).clamp_min(0),
        cache=cache)
    logits = logits[:, -1]
    real_len = int(mask.sum())
    kv_valid = torch.zeros((b, cache_len), dtype=torch.bool, device=dev)
    kv_valid[:, :s] = mask.bool()
    for t in range(gen.max_new_tokens):
        tok = sampling.sample_token(
            logits, do_sample=gen.do_sample, temperature=gen.temperature,
            top_k=gen.top_k, top_p=gen.top_p, generator=generator)
        tok_i = int(tok[0])
        if tok_i == gen.eos_token_id:
            return
        yield tok_i
        if t == gen.max_new_tokens - 1:
            return
        kv_valid[:, s + t] = True
        logits, cache = model(
            torch.full((b, 1), tok_i, dtype=torch.long, device=dev),
            cache=cache, cache_pos=s + t, kv_valid=kv_valid,
            positions=torch.full((b, 1), real_len + t, dtype=torch.long,
                                 device=dev))
        logits = logits[:, -1]
