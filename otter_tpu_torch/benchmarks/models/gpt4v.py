"""GPT-4V API adapter (reference `pipeline/benchmarks/models/gpt4v.py`):
image+question via the OpenAI vision chat API."""

from __future__ import annotations

import base64
import io
import json
import os
from typing import Optional


class OpenAIGPT4Vision:
    def __init__(self, api_key: Optional[str] = None,
                 model: str = "gpt-4-vision-preview",
                 max_new_tokens: int = 512):
        self.name = "gpt4v"
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        self.model = model
        self.max_new_tokens = max_new_tokens

    @staticmethod
    def _b64(image) -> str:
        if isinstance(image, str):
            return image
        buf = io.BytesIO()
        image.convert("RGB").save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    def generate(self, question: str, raw_image_data=None) -> str:
        import requests
        if not self.api_key:
            raise RuntimeError("OPENAI_API_KEY required for gpt4v")
        content = [{"type": "text", "text": question}]
        if raw_image_data is not None:
            content.append({"type": "image_url", "image_url": {
                "url": "data:image/png;base64," + self._b64(raw_image_data)
            }})
        r = requests.post(
            "https://api.openai.com/v1/chat/completions",
            headers={"Authorization": f"Bearer {self.api_key}"},
            json={"model": self.model, "max_tokens": self.max_new_tokens,
                  "messages": [{"role": "user", "content": content}]},
            timeout=120)
        r.raise_for_status()
        return r.json()["choices"][0]["message"]["content"]

    def eval_forward(self, question: str, answer: str, image=None) -> float:
        raise NotImplementedError("gpt4v does not expose likelihoods")
