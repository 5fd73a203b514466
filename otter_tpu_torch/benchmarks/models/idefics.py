"""IDEFICS benchmark adapter (counterpart of
`otter_tpu/benchmarks/models/idefics.py`, the reference's
`pipeline/benchmarks/models/idefics.py`): prompt contract
`User:<fake_token_around_image><image><fake_token_around_image>{q}
<end_of_utterance>\\nAssistant:`, answer split on
<answer>/<end_of_utterance>. Generation runs the port's `OtterGenerator`
over an `IdeficsVLM`, stopping at the config's eoc token."""

from __future__ import annotations

import numpy as np
import torch

from otter_tpu_torch.data.templates import (IDEFICS_STANDARD_MEAN,
                                            IDEFICS_STANDARD_STD)


def _answer(text: str) -> str:
    text = text.split("<answer>")[-1]
    for stop in ("<end_of_utterance>", "</s>"):
        text = text.split(stop)[0]
    return text.strip().strip('"')


class Idefics:
    def __init__(self, model_path: str = "", *, tokenizer: str = "",
                 max_new_tokens: int = 512, model=None, tok=None,
                 cfg=None, patch_size: int = 224,
                 cache_dtype=torch.bfloat16, device=None):
        """model/tok/cfg may be injected directly; otherwise loaded in bf16
        from an HF IdeficsForVisionText2Text checkpoint dir. `cache_dtype`
        is the KV cache's."""
        self.name = "idefics"
        self.max_new_tokens = max_new_tokens
        self.patch_size = patch_size
        self.cache_dtype = cache_dtype
        if model is not None:
            self.model, self.tokenizer = model, tok
            self.cfg = cfg if cfg is not None else model.cfg
        else:
            from transformers import AutoTokenizer
            from otter_tpu_torch.config import idefics9b
            from otter_tpu_torch.serve.worker import load_idefics_model
            self.model, self.cfg = load_idefics_model(
                model_path, cfg or idefics9b(), device=device)
            self.tokenizer = AutoTokenizer.from_pretrained(tokenizer
                                                           or model_path)
        self._engine = None

    def _get_engine(self):
        if self._engine is None:
            from otter_tpu_torch.generation.engine import OtterGenerator
            self._engine = OtterGenerator(self.model,
                                          cache_dtype=self.cache_dtype)
        return self._engine

    def _vision(self, raw_image_data) -> np.ndarray:
        from otter_tpu_torch.data.mimicit import preprocess_image
        if raw_image_data is None:
            return np.zeros((1, 1, 3, self.patch_size, self.patch_size),
                            np.float32)
        img = raw_image_data
        if isinstance(img, (bytes, str)):
            from otter_tpu_torch.data.mimicit import decode_base64_image
            img = decode_base64_image(img if isinstance(img, str)
                                      else img.decode())
        arr = preprocess_image(img.convert("RGB"), self.patch_size,
                               IDEFICS_STANDARD_MEAN, IDEFICS_STANDARD_STD)
        return arr[None, None]                 # [1, N=1, C, H, W]

    def _prompt(self, question: str, with_image: bool) -> str:
        placeholder = ("<fake_token_around_image><image>"
                       "<fake_token_around_image>" if with_image else "")
        return (f"User:{placeholder}{question}<end_of_utterance>\n"
                f"Assistant:")

    def _ids(self, text: str) -> np.ndarray:
        return np.asarray(self.tokenizer(text, return_tensors="np")[
            "input_ids"]).astype(np.int32)

    def _gen(self):
        from otter_tpu_torch.config import GenerationConfig
        return GenerationConfig(max_new_tokens=self.max_new_tokens,
                                eos_token_id=self.cfg.eoc_token_id)

    def generate(self, question: str, raw_image_data=None) -> str:
        vision_x = self._vision(raw_image_data)
        ids = self._ids(self._prompt(question, raw_image_data is not None))
        out = self._get_engine().generate(vision_x, ids, gen=self._gen())
        return _answer(self.tokenizer.decode(out[0, ids.shape[1]:]))

    def generate_batch(self, prompts, raw_images) -> list:
        """Batched generate for the public eval suite: FULL prompt strings
        (few-shot context included), left-padded into one batch (the
        reference batches idefics eval via eval_model.py:21-60)."""
        vision = np.concatenate([self._vision(im) for im in raw_images], 0)
        encs = [self._ids(p)[0] for p in prompts]
        width = max(len(e) for e in encs)
        ids = np.zeros((len(encs), width), np.int32)
        mask = np.zeros((len(encs), width), np.int32)
        for i, e in enumerate(encs):
            ids[i, width - len(e):] = e
            mask[i, width - len(e):] = 1
        out = self._get_engine().generate(vision, ids, attention_mask=mask,
                                          gen=self._gen())
        return [_answer(self.tokenizer.decode(row)) for row in out[:, width:]]

    @torch.inference_mode()
    def eval_forward(self, question: str, answer: str, image=None) -> float:
        """The answer tokens' summed log-probabilities (a sum, where the
        other adapters take a mean, as in the reference)."""
        from otter_tpu_torch.generation.engine import _on
        vision_x = self._vision(image)
        prompt = self._prompt(question, image is not None)
        ids = self._ids(prompt + answer)
        p_len = self._ids(prompt).shape[1]
        dev = self.model.device
        logits, _, _ = self.model(_on(vision_x, dev), _on(ids, dev).long())
        lp = torch.log_softmax(logits[0, p_len - 1: -1].float(), dim=-1)
        toks = _on(ids[0, p_len:], dev).long()
        return float(lp.gather(-1, toks[:, None]).sum())
