"""Otter-Image benchmark adapter (counterpart of
`otter_tpu/benchmarks/models/otter_image.py`, the reference's
`pipeline/benchmarks/models/otter_image.py:16-100`): prompt contract
`<image>User: {q} GPT:<answer>`, output split on <answer>/<|endofchunk|>.

The model is the port's `api.OtterForConditionalGeneration`: on the card
unless `device` names another, its engine the one `generate` and
`generate_batch` run (give the wrapper another `_engine` for another KV
cache)."""

from __future__ import annotations

import numpy as np


def _answer(text: str) -> str:
    text = text.split("<answer>")[-1]
    text = text.split("<|endofchunk|>")[0]
    return text.strip().strip('"')


class OtterImage:
    def __init__(self, model_path: str = "", *, config: str = "mpt7b",
                 tokenizer: str = "", max_new_tokens: int = 512,
                 model=None, tok=None, patch_size: int = 224,
                 batch: int = 8, device=None):
        """model/tok may be injected directly; otherwise loaded from
        model_path/tokenizer. `batch` caps generate_batch chunks
        (reference adapters' max_batch_size)."""
        self.name = "otter_image"
        self.max_new_tokens = max_new_tokens
        self.patch_size = patch_size
        self.max_batch_size = batch
        if model is not None:
            self.model, self.tokenizer = model, tok
        else:
            from transformers import AutoTokenizer
            from otter_tpu_torch.api import OtterForConditionalGeneration
            self.model = OtterForConditionalGeneration.from_pretrained(
                model_path, config=config, device=device)
            self.tokenizer = AutoTokenizer.from_pretrained(tokenizer)

    def _vision(self, raw_image_data) -> np.ndarray:
        from otter_tpu_torch.data.mimicit import preprocess_image
        if raw_image_data is None:
            return np.zeros((1, 1, 1, 3, self.patch_size, self.patch_size),
                            np.float32)
        img = raw_image_data
        if isinstance(img, (bytes, str)):
            from otter_tpu_torch.data.mimicit import decode_base64_image
            img = decode_base64_image(img if isinstance(img, str)
                                      else img.decode())
        return preprocess_image(img.convert("RGB"),
                                self.patch_size)[None, None, None]

    def _ids(self, text: str) -> np.ndarray:
        return np.asarray(self.tokenizer(text, return_tensors="np")[
            "input_ids"]).astype(np.int32)

    def generate(self, question: str, raw_image_data=None) -> str:
        from otter_tpu_torch.data.templates import inference_prompt
        vision_x = self._vision(raw_image_data)
        prompt = inference_prompt(question,
                                  insert_image=raw_image_data is not None)
        out = self.model.generate(vision_x, self._ids(prompt),
                                  max_new_tokens=self.max_new_tokens)
        return _answer(self.tokenizer.decode(out[0]))

    def generate_batch(self, prompts, raw_images) -> list:
        """Batched generate for the public eval suite: prompts are FULL
        prompt strings (few-shot context included), left-padded to one
        batch (reference eval batches via eval_model.py:21-60)."""
        vision = np.concatenate([self._vision(im) for im in raw_images], 0)
        encs = [self._ids(p)[0] for p in prompts]
        width = max(len(e) for e in encs)
        ids = np.zeros((len(encs), width), np.int32)
        mask = np.zeros((len(encs), width), np.int32)
        for i, e in enumerate(encs):
            ids[i, width - len(e):] = e
            mask[i, width - len(e):] = 1
        out = self.model.generate(vision, ids, attention_mask=mask,
                                  max_new_tokens=self.max_new_tokens)
        return [_answer(self.tokenizer.decode(row)) for row in out[:, width:]]

    def eval_forward(self, question: str, answer: str, image=None) -> float:
        """-(mean NLL) of the answer's tokens after the prompt."""
        from otter_tpu_torch.data.templates import inference_prompt
        vision_x = self._vision(image)
        prompt = inference_prompt(question, insert_image=image is not None)
        ids = self._ids(prompt + answer)
        p_len = self._ids(prompt).shape[1]
        labels = np.full_like(ids, -100)
        labels[:, p_len:] = ids[:, p_len:]
        loss, _ = self.model(vision_x, ids, labels=labels)
        return -float(loss)


class OtterVideo(OtterImage):
    """Video variant: frames stacked along F (reference
    `models/otter_video.py`)."""

    def __init__(self, *args, num_frames: int = 16, **kwargs):
        kwargs.setdefault("config", "llama7b-video")
        super().__init__(*args, **kwargs)
        self.name = "otter_video"
        self.num_frames = num_frames

    def _vision(self, raw_video_data) -> np.ndarray:
        from otter_tpu_torch.data.mimicit import (preprocess_image,
                                                  resample_frames)
        if raw_video_data is None:
            return np.zeros((1, 1, 1, 3, self.patch_size, self.patch_size),
                            np.float32)
        frames = raw_video_data if isinstance(raw_video_data, list) \
            else [raw_video_data]
        frames = resample_frames(frames, min(self.num_frames, len(frames)))
        arr = np.stack([preprocess_image(f.convert("RGB"), self.patch_size)
                        for f in frames], 0)
        return arr[None, None]          # [1, 1, F, C, H, W]
