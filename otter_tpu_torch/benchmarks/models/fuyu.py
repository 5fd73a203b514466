"""Fuyu/OtterHD benchmark adapter (counterpart of
`otter_tpu/benchmarks/models/fuyu.py`, the reference's
`pipeline/benchmarks/models/fuyu.py` / `models/otterhd.py`): prompt
`User:{q} Assistant:\\x04`, variable-resolution patches, answer after the
beginning-of-answer token.

Greedy decoding runs `generation.fuyu.fuyu_generate`, the worker's loop,
on one `FuyuGenerator` of the adapter's model (its step captured once per
key as a CUDA graph on the card), where the JAX adapter steps its own: the
same tokens (the cache is rounded to another length, whose entries past
the valid ones are never read).
"""

from __future__ import annotations

import numpy as np
import torch


class Fuyu:
    def __init__(self, model_path: str = "", *, tokenizer: str = "",
                 max_new_tokens: int = 256, resolution=None,
                 model=None, tok=None, processor=None, cfg=None,
                 cache_dtype=None, device=None):
        """model/tok/processor/cfg may be injected directly; otherwise an
        adept/fuyu-8b-style checkpoint at model_path is loaded in bf16.
        `cache_dtype` (None: the model's dtype) is the KV cache's."""
        self.name = "fuyu"
        self.max_new_tokens = max_new_tokens
        self.resolution = resolution
        if model is not None:
            self.model, self.tokenizer = model, tok
            self.processor = processor
            self.cfg = cfg
        else:
            from transformers import AutoTokenizer
            from otter_tpu_torch.config import FuyuConfig
            from otter_tpu_torch.data.fuyu_processor import (
                FuyuImageProcessor, FuyuProcessor)
            from otter_tpu_torch.serve.worker import load_fuyu_model
            self.tokenizer = AutoTokenizer.from_pretrained(tokenizer)
            self.model, self.cfg = load_fuyu_model(model_path, FuyuConfig(),
                                                   device=device)
            self.processor = FuyuProcessor(
                self.tokenizer,
                FuyuImageProcessor(patch_size=self.cfg.patch_size),
                image_placeholder_id=self.cfg.image_placeholder_id,
                image_newline_id=self.cfg.image_newline_id)
        from otter_tpu_torch.generation.fuyu import FuyuGenerator
        self.engine = FuyuGenerator(self.model, cache_dtype)

    def generate(self, question: str, raw_image_data=None) -> str:
        from otter_tpu_torch.config import GenerationConfig
        from otter_tpu_torch.data.templates import inference_prompt
        from otter_tpu_torch.generation.fuyu import fuyu_generate
        prompt = inference_prompt(question, "fuyu")
        batch = self.processor([prompt], [raw_image_data],
                               target_resolution=self.resolution,
                               left_pad=True)
        out_ids = list(fuyu_generate(
            self.engine, batch["input_ids"], batch["image_patches"],
            batch["image_patches_indices"], batch["attention_mask"],
            GenerationConfig(max_new_tokens=self.max_new_tokens,
                             eos_token_id=self.tokenizer.eos_token_id)))
        return self.tokenizer.decode(out_ids,
                                     skip_special_tokens=True).strip()

    @torch.inference_mode()
    def eval_forward(self, question: str, answer: str, image=None) -> float:
        """Mean log-likelihood of `answer` after the boa token."""
        from otter_tpu_torch.data.templates import inference_prompt
        from otter_tpu_torch.generation.engine import _on
        from otter_tpu_torch.train.step import causal_lm_loss
        prompt = inference_prompt(question, "fuyu")
        batch = self.processor([prompt + " " + answer], [image],
                               target_resolution=self.resolution)
        # unmask everything after the (single) beginning-of-answer token
        ids = batch["input_ids"]
        labels = np.full_like(ids, -100)
        boa = self.processor.boa_id()
        for i in range(ids.shape[0]):
            pos = np.nonzero(ids[i] == boa)[0]
            if len(pos):
                labels[i, pos[0] + 1:] = ids[i, pos[0] + 1:]
        labels[ids == self.tokenizer.eos_token_id] = -100
        dev = self.model.device
        logits, _ = self.model(
            _on(ids, dev).long(),
            image_patches=_on(batch["image_patches"], dev).to(
                self.model.dtype),
            image_patches_indices=_on(batch["image_patches_indices"], dev),
            attention_mask=_on(batch["attention_mask"], dev))
        loss, _ = causal_lm_loss(logits, _on(labels, dev))
        return -float(loss)


class OtterHD(Fuyu):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.name = "otterhd"
