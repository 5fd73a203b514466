"""Generation loop for Fuyu/OtterHD (counterpart of the loop inside
`make_fuyu_stream_fn`, `otter_tpu/serve/worker.py`, without HTTP,
tokenizer or image decoding).

One request at a time, as the worker serves them: a prefill over the
left-padded prompt with its image patches merged, which computes the last
position's logits only (`head_last_only`: OtterHD's head is 262144 wide),
then single-token cached steps. The JAX worker jits its step with the
cache donated, one dispatch a token; here the step keeps its state on the
device, as `OtterGenerator`'s does: the token, the stacked cache,
kv_valid and the counters (the prompt's width, the tokens so far) live
in an entry that a `FuyuGenerator` leases to the request, the step reads
its position from the counters and makes no host sync, and on CUDA it is
captured once per key as a CUDA graph and replayed
(`engine.GraphedSteps`). The host reads one token a step, as the JAX
loop's `int(sample_token(...)[0])` does.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Iterator, Optional, Union

import torch

from otter_tpu_torch.config import GenerationConfig
from otter_tpu_torch.generation import sampling
from otter_tpu_torch.generation.engine import (CacheDtype, GraphedSteps,
                                               _Entry, _inference, _on)
from otter_tpu_torch.models.fuyu import FuyuVLM, make_fuyu_cache


def fuyu_cache_len(prompt_len: int, max_new_tokens: int) -> int:
    """Cache length of a request: rounded up to 512 above 1024 tokens (so
    the decode kernel keeps its widest blocks; entries past the valid
    length are never read) and to 128 below."""
    total = prompt_len + max_new_tokens
    gran = 512 if total > 1024 else 128
    return -(-total // gran) * gran


class FuyuGenerator(GraphedSteps):
    """`fuyu_generate`'s engine over one `FuyuVLM`: the entries (one per
    key: the rows, the cache length, the cache dtype and `gen` less
    `max_new_tokens`) outlive a request, so a key's step is captured once
    (`cuda_graph`: `engine.graph_setting`, on by default on the card;
    `cuda_graph=False` runs the same step body eagerly, as the CPU always
    does). Build it once per model, as the worker and the eval adapters
    do. `cache_dtype` None is the model's dtype."""

    def __init__(self, model: FuyuVLM,
                 cache_dtype: Optional[CacheDtype] = None,
                 cuda_graph: Optional[bool] = None):
        super().__init__(model, cuda_graph)
        self.cache_dtype = model.dtype if cache_dtype is None \
            else cache_dtype

    def _lease(self, rows: int, cache_len: int,
               gen: GenerationConfig) -> _Entry:
        step_gen = dataclasses.replace(gen, max_new_tokens=0)
        key = (rows, cache_len, str(self.cache_dtype), step_gen)

        def make():
            st = self._new_state(rows, cache_len, step_gen)
            return _Entry(key, st, self.cache_dtype,
                          lambda: self._step_body(st))
        return self._take(key, make)

    def _new_state(self, rows: int, cache_len: int,
                   gen: GenerationConfig) -> SimpleNamespace:
        dev = self.device
        long = dict(dtype=torch.long, device=dev)
        return SimpleNamespace(
            gen=gen,
            cache=make_fuyu_cache(self.model.cfg, rows, cache_len,
                                  self.cache_dtype, dev),
            tok=torch.zeros(rows, **long),
            kv_valid=torch.zeros((rows, cache_len), dtype=torch.bool,
                                 device=dev),
            # the prompt's width, the tokens sampled so far, and the
            # prompt's real tokens (all rows', as the JAX loop counts them)
            p_dev=torch.zeros((), **long), t_dev=torch.zeros((), **long),
            real_len=torch.zeros((), **long),
            generator=(torch.Generator(device=dev) if gen.do_sample
                       else None),
            source=None, p=0, t=0, logits=None)

    @_inference
    def _prefill(self, input_ids, image_patches, image_patches_indices,
                 attention_mask, gen: GenerationConfig,
                 generator=None) -> SimpleNamespace:
        """The prefill into a leased entry and the first token sampled."""
        dev = self.device
        ids = _on(input_ids, dev).long()
        mask = _on(attention_mask, dev).int()
        b, s = ids.shape
        cache_len = fuyu_cache_len(s, gen.max_new_tokens)
        patches = pidx = None
        if image_patches is not None:
            patches = _on(image_patches, dev).to(self.model.dtype)
            pidx = _on(image_patches_indices, dev)
        st = self._lease(b, cache_len, gen).st
        try:
            logits, _ = self.model(
                ids, image_patches=patches, image_patches_indices=pidx,
                attention_mask=mask,
                positions=(mask.cumsum(-1) - 1).clamp_min(0),
                cache=st.cache, head_last_only=True)
            st.kv_valid.zero_()
            st.kv_valid[:, :s] = mask.bool()
            st.real_len.copy_(mask.sum())
            st.p_dev.fill_(s)
            st.t_dev.zero_()
            st.p, st.t = s, 0
            self._seed(st, generator)
            self._sample(st, logits[:, -1])
            st.t = 1
        except BaseException:
            self._finish(st)
            raise
        return st

    def _sample(self, st: SimpleNamespace, logits: torch.Tensor) -> None:
        gen = st.gen
        st.logits = logits
        st.tok.copy_(sampling.sample_token(
            logits, do_sample=gen.do_sample, temperature=gen.temperature,
            top_k=gen.top_k, top_p=gen.top_p, generator=st.generator))
        st.t_dev.add_(1)

    def _step_body(self, st: SimpleNamespace) -> None:
        """One cached step on the entry's tensors, in place: row 0's token
        t - 1 (every row is fed it, as the JAX loop feeds
        `full((b, 1), tok)`) at cache position p + t - 1 and position
        real_len + t - 1, then token t sampled. Reads the counters only."""
        t = st.t_dev
        rows = st.tok.shape[0]
        pos = st.p_dev + t - 1
        st.kv_valid.index_fill_(1, pos.view(1), True)
        logits, _ = self.model(
            st.tok[:1, None].expand(rows, 1), cache=st.cache, cache_pos=pos,
            kv_valid=st.kv_valid,
            positions=(st.real_len + (t - 1)).view(1, 1).expand(rows, 1))
        self._sample(st, logits[:, -1])

    def generate(self, input_ids, image_patches, image_patches_indices,
                 attention_mask, gen: Optional[GenerationConfig] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Iterator[int]:
        """`fuyu_generate`'s stream on this engine's entries."""
        gen = gen or GenerationConfig()
        st = self._prefill(input_ids, image_patches, image_patches_indices,
                           attention_mask, gen, generator)
        try:
            while True:
                tok = int(st.tok[0])
                if tok == gen.eos_token_id:
                    return
                yield tok
                if st.t >= gen.max_new_tokens:
                    return
                self._advance(st)
        finally:
            self._finish(st)


def fuyu_generate(model: Union[FuyuVLM, FuyuGenerator], input_ids,
                  image_patches, image_patches_indices, attention_mask,
                  gen: Optional[GenerationConfig] = None, *,
                  cache_dtype: Optional[CacheDtype] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Iterator[int]:
    """Yields each token id as it is sampled; stops at `gen.eos_token_id`
    (not yielded) or after `gen.max_new_tokens`. input_ids and
    attention_mask [B, S] left-padded, image_patches [B, P, patch dim] (or
    None), image_patches_indices [B, S]; numpy arrays or tensors. Sampling
    reads row 0: the loop serves one request. `model` is a `FuyuVLM` (an
    engine made for this call) or a `FuyuGenerator`, whose entries and
    graphs serve every call; `cache_dtype` is the engine's."""
    if isinstance(model, FuyuGenerator):
        if cache_dtype is not None and cache_dtype != model.cache_dtype:
            raise ValueError(f"cache_dtype {cache_dtype} for an engine of "
                             f"{model.cache_dtype} caches")
        engine = model
    else:
        engine = FuyuGenerator(model, cache_dtype)
    return engine.generate(input_ids, image_patches, image_patches_indices,
                           attention_mask, gen, generator)
