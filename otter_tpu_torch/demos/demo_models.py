"""Programmatic inference demos (counterpart of
`otter_tpu/demos/demo_models.py`, the reference
`pipeline/demos/demo_models.py:35-143`): TestOtter / TestOtterHD wrappers
with the interactive prompt contracts
(`demos/interactive/otter_image.py:52-60`, `otter_video.py:29-44`)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class TestOtter:
    """Single-image / in-context chat demo over the public API."""

    def __init__(self, *, checkpoint: str = "", config: str = "mpt7b",
                 tokenizer: str = "", model=None, tok=None,
                 patch_size: Optional[int] = None, max_new_tokens: int = 512,
                 device=None):
        """model/tok may be injected directly; otherwise the port's
        `api.OtterForConditionalGeneration` loads `checkpoint` (on the card
        unless `device` names another). `patch_size` defaults to the
        model's image size (224 in every preset; the JAX demo always
        takes 224)."""
        self.max_new_tokens = max_new_tokens
        if model is not None:
            self.model, self.tokenizer = model, tok
        else:
            from transformers import AutoTokenizer
            from otter_tpu_torch.api import OtterForConditionalGeneration
            self.model = OtterForConditionalGeneration.from_pretrained(
                checkpoint, config=config, device=device)
            self.tokenizer = AutoTokenizer.from_pretrained(tokenizer)
        self.patch_size = patch_size or self.model.cfg.vision.image_size

    def _prompt(self, question: str, in_context: Optional[List] = None
                ) -> str:
        """`<image>User: {q} GPT:<answer>` with optional in-context pairs
        (otter_image.py:52-60)."""
        ctx = ""
        for q, a in in_context or []:
            ctx += f"<image>User: {q} GPT:<answer> {a}<|endofchunk|>"
        return ctx + f"<image>User: {question} GPT:<answer>"

    def _vision(self, images: List) -> np.ndarray:
        from otter_tpu_torch.data.mimicit import preprocess_image
        arr = np.stack([preprocess_image(img.convert("RGB"),
                                         self.patch_size)
                        for img in images], 0)
        return arr[None, :, None]         # [1, T, 1, C, H, W]

    def ask(self, question: str, image, in_context=None) -> str:
        images = ([img for img, _, _ in in_context or []]
                  if in_context else [])
        images.append(image)
        pairs = [(q, a) for _, q, a in in_context or []] or None
        vision_x = self._vision(images)
        prompt = self._prompt(question, pairs)
        ids = self.tokenizer(prompt, return_tensors="np")[
            "input_ids"].astype(np.int32)
        out = self.model.generate(vision_x, ids,
                                  max_new_tokens=self.max_new_tokens)
        text = self.tokenizer.decode(out[0])
        return text.split("<answer>")[-1].split(
            "<|endofchunk|>")[0].strip()


class TestOtterVideo(TestOtter):
    """16-frame video chat (otter_video.py:29-44 frame extraction)."""

    num_frames = 16

    def ask(self, question: str, frames: List, in_context=None) -> str:
        from otter_tpu_torch.data.mimicit import (preprocess_image,
                                                  resample_frames)
        frames = resample_frames(frames, min(self.num_frames, len(frames)))
        arr = np.stack([preprocess_image(f.convert("RGB"), self.patch_size)
                        for f in frames], 0)[None, None]  # [1,1,F,C,H,W]
        prompt = self._prompt(question)
        ids = self.tokenizer(prompt, return_tensors="np")[
            "input_ids"].astype(np.int32)
        out = self.model.generate(arr, ids,
                                  max_new_tokens=self.max_new_tokens)
        text = self.tokenizer.decode(out[0])
        return text.split("<answer>")[-1].split(
            "<|endofchunk|>")[0].strip()
