"""InstructBLIP benchmark adapter (reference
`pipeline/benchmarks/models/instructblip.py:28-48`): HF-native
`InstructBlipForConditionalGeneration`, prompt `{q}\nAnswer:`, greedy
decode with the reference's max_new_tokens=32 default.

Third-party torch model — scoring-harness interop only."""

from __future__ import annotations

from .base_model import BaseModel
from .image_utils import to_pil


class InstructBLIP(BaseModel):
    def __init__(self,
                 model_path: str = "Salesforce/instructblip-vicuna-7b",
                 *, max_new_tokens: int = 32, model=None, processor=None):
        super().__init__("instructblip", model_path)
        if model is None:
            import torch
            from transformers import (InstructBlipForConditionalGeneration,
                                      InstructBlipProcessor)
            model = InstructBlipForConditionalGeneration.from_pretrained(
                model_path, torch_dtype=torch.float32)
            processor = InstructBlipProcessor.from_pretrained(model_path)
        self.model = model.eval()
        self.processor = processor
        self.max_new_tokens = max_new_tokens

    def generate(self, question: str, raw_image_data) -> str:
        import torch
        image = to_pil(raw_image_data).convert("RGB")
        inputs = self.processor(images=image,
                                text=f"{question}\nAnswer:",
                                return_tensors="pt")
        with torch.inference_mode():
            out = self.model.generate(
                **inputs, do_sample=False, min_length=1,
                max_new_tokens=self.max_new_tokens)
        return self.processor.batch_decode(
            out, skip_special_tokens=True)[0].strip()

    def eval_forward(self, question: str, answer: str, image) -> float:
        """Answer log-likelihood via the language head (the reference
        adapter raises NotImplementedError here)."""
        import torch
        pil = to_pil(image).convert("RGB")
        prompt = f"{question}\nAnswer:"
        base = self.processor(images=pil, text=prompt, return_tensors="pt")
        full = self.processor(images=pil, text=prompt + " " + answer,
                              return_tensors="pt")
        n_ctx = base["input_ids"].shape[1]
        ids = full["input_ids"]
        with torch.inference_mode():
            out = self.model(**full)
        logits = out.language_model_outputs.logits \
            if hasattr(out, "language_model_outputs") else out.logits
        # the LM consumes [query tokens | text]: answer logits sit at the
        # tail, offset by however many non-text tokens the model prepends
        off = logits.shape[1] - ids.shape[1]
        lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        tgt = ids[:, 1:]
        tok_lp = lp[:, off:].gather(-1, tgt[..., None]).squeeze(-1)
        return float(tok_lp[:, n_ctx - 1:].sum())
