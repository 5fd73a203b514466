"""Qwen-VL benchmark adapter (reference
`pipeline/benchmarks/models/qwen_vl.py:1-34`).

The reference drives `Qwen/Qwen-VL-Chat` through its remote-code
`.chat()` API (trust_remote_code downloads executable code from the
hub — unavailable and undesirable here). This adapter targets the
HF-native successor line (`Qwen2VLForConditionalGeneration`,
e.g. `Qwen/Qwen2-VL-7B-Instruct`), building the ChatML prompt the
model family expects:

    <|im_start|>user
    <|vision_start|><|image_pad|><|vision_end|>{q}<|im_end|>
    <|im_start|>assistant

The processor expands `<|image_pad|>` to the image's patch-grid length.
Third-party torch model — scoring-harness interop only."""

from __future__ import annotations

from .base_model import BaseModel
from .image_utils import to_pil

_CHAT = ("<|im_start|>user\n<|vision_start|><|image_pad|><|vision_end|>"
         "{q}<|im_end|>\n<|im_start|>assistant\n")


class QwenImageTextProcessor:
    """Image+text half of Qwen2VLProcessor: run the image processor,
    expand each `<|image_pad|>` to the image's patch-grid length
    (grid_thw.prod() / merge_size²), tokenize. Self-contained so the
    adapter works where the upstream processor class cannot be built
    (its video half hard-requires torchvision, absent here)."""

    def __init__(self, image_processor, tokenizer):
        self.image_processor = image_processor
        self.tokenizer = tokenizer

    def __call__(self, images, text, return_tensors="pt"):
        imgs = self.image_processor(images=images,
                                    return_tensors=return_tensors)
        merge2 = self.image_processor.merge_size ** 2
        out_text = []
        for t in (text if isinstance(text, list) else [text]):
            for grid in imgs["image_grid_thw"]:
                n = int(grid[0] * grid[1] * grid[2]) // merge2
                t = t.replace("<|image_pad|>",
                              "<|qwen_ph|>" * n, 1)
            out_text.append(t.replace("<|qwen_ph|>", "<|image_pad|>"))
        toks = self.tokenizer(out_text, return_tensors=return_tensors,
                              padding=True)
        toks.update(imgs)
        return toks

    def batch_decode(self, *a, **kw):
        return self.tokenizer.batch_decode(*a, **kw)


class QwenVL(BaseModel):
    def __init__(self, model_path: str = "Qwen/Qwen2-VL-7B-Instruct", *,
                 max_new_tokens: int = 512, model=None, processor=None):
        super().__init__("qwen_vl", model_path)
        if model is None:
            import torch
            from transformers import (AutoTokenizer,
                                      Qwen2VLForConditionalGeneration,
                                      Qwen2VLImageProcessor)
            model = Qwen2VLForConditionalGeneration.from_pretrained(
                model_path, torch_dtype=torch.float32)
            processor = QwenImageTextProcessor(
                Qwen2VLImageProcessor.from_pretrained(model_path),
                AutoTokenizer.from_pretrained(model_path))
        self.model = model.eval()
        self.processor = processor
        self.max_new_tokens = max_new_tokens

    def generate(self, question: str, raw_image_data) -> str:
        import torch
        image = to_pil(raw_image_data).convert("RGB")
        inputs = self.processor(images=[image],
                                text=[_CHAT.format(q=question)],
                                return_tensors="pt")
        with torch.inference_mode():
            out = self.model.generate(**inputs, do_sample=False,
                                      max_new_tokens=self.max_new_tokens)
        new = out[:, inputs["input_ids"].shape[1]:]
        return self.processor.batch_decode(
            new, skip_special_tokens=True)[0].strip()

    def eval_forward(self, question: str, answer: str, image) -> float:
        import torch
        pil = to_pil(image).convert("RGB")
        prompt = _CHAT.format(q=question)
        base = self.processor(images=[pil], text=[prompt],
                              return_tensors="pt")
        full = self.processor(images=[pil], text=[prompt + answer],
                              return_tensors="pt")
        n_ctx = base["input_ids"].shape[1]
        ids = full["input_ids"]
        with torch.inference_mode():
            logits = self.model(**full).logits
        lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        tgt = ids[:, 1:]
        tok_lp = lp.gather(-1, tgt[..., None]).squeeze(-1)
        return float(tok_lp[:, n_ctx - 1:].sum())
