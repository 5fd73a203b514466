"""LLaVA benchmark adapter (reference
`pipeline/benchmarks/models/llava_model.py:1-72`).

The reference wraps the external `llava` GitHub package around a
llava-v1.5 checkpoint; this adapter uses the HF-transformers-native
`LlavaForConditionalGeneration` (the same weights, upstreamed as
`llava-hf/llava-1.5-7b-hf`), which runs on the CPU without CUDA.
Prompt contract matches the reference's `llava_v1` conversation
template output: `USER: <image>\n{q} ASSISTANT:`; generation uses the
reference's kwargs (sampled, temperature 0.2, max_new_tokens 512).

Third-party torch model — scoring-harness interop only; the port's model
and kernels are not involved.
"""

from __future__ import annotations

from .base_model import BaseModel
from .image_utils import to_pil


class LLaVA(BaseModel):
    def __init__(self, model_path: str = "llava-hf/llava-1.5-7b-hf", *,
                 max_new_tokens: int = 512, temperature: float = 0.2,
                 do_sample: bool = True, model=None, processor=None):
        """model/processor may be injected directly (tests); otherwise
        loaded from an HF Llava checkpoint dir."""
        super().__init__("llava", model_path)
        if model is None:
            import torch
            from transformers import (AutoProcessor,
                                      LlavaForConditionalGeneration)
            model = LlavaForConditionalGeneration.from_pretrained(
                model_path, torch_dtype=torch.float32)
            processor = AutoProcessor.from_pretrained(model_path)
        self.model = model.eval()
        self.processor = processor
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.do_sample = do_sample

    def _prompt(self, question: str) -> str:
        return f"USER: <image>\n{question} ASSISTANT:"

    def generate(self, question: str, raw_image_data) -> str:
        import torch
        image = to_pil(raw_image_data).convert("RGB")
        inputs = self.processor(images=image, text=self._prompt(question),
                                return_tensors="pt")
        with torch.inference_mode():
            out = self.model.generate(
                **inputs, do_sample=self.do_sample,
                temperature=self.temperature,
                max_new_tokens=self.max_new_tokens, use_cache=True)
        new = out[:, inputs["input_ids"].shape[1]:]
        text = self.processor.batch_decode(
            new, skip_special_tokens=True)[0]
        return text.strip()

    def eval_forward(self, question: str, answer: str, image) -> float:
        """Sum log-prob of `answer` tokens given the rendered prompt
        (the ranking hook the reference's adapter leaves as `pass`)."""
        import torch
        pil = to_pil(image).convert("RGB")
        prompt = self._prompt(question)
        base = self.processor(images=pil, text=prompt, return_tensors="pt")
        full = self.processor(images=pil, text=prompt + " " + answer,
                              return_tensors="pt")
        n_ctx = base["input_ids"].shape[1]
        ids = full["input_ids"]
        with torch.inference_mode():
            logits = self.model(**full).logits
        lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        tgt = ids[:, 1:]
        tok_lp = lp.gather(-1, tgt[..., None]).squeeze(-1)
        return float(tok_lp[:, n_ctx - 1:].sum())
