"""Benchmark model registry + ABC (reference
`pipeline/benchmarks/models/base_model.py:7-48`). The registry covers
this framework's model families, the API-based gpt4v adapter, and
HF-transformers-native third-party baselines (llava, instructblip,
qwen_vl — torch on host, no CUDA needed). The remaining reference names
are registered as explicit de-scopes with reasons (DESCOPED_MODELS)."""

from __future__ import annotations

import importlib
from abc import ABC, abstractmethod
from typing import Dict, Optional

AVAILABLE_MODELS: Dict[str, str] = {
    "otter_image": "OtterImage",
    "otter_video": "OtterVideo",
    "fuyu": "Fuyu",
    "otterhd": "OtterHD",
    "idefics": "Idefics",
    "gpt4v": "OpenAIGPT4Vision",
    "llava": "LLaVA",
    "instructblip": "InstructBLIP",
    "qwen_vl": "QwenVL",
}

# reference registry names we intentionally do NOT implement, with the
# reason (COVERAGE.md "one-click benchmarks" has the longer rationale);
# load_model raises NotImplementedError naming the reason so a YAML
# suite that lists one fails loudly instead of silently skipping
DESCOPED_MODELS: Dict[str, str] = {
    "video_chat": "wraps the Ask-Anything GitHub repo (custom UniFormer "
                  "video encoder, no HF-native port); requires cloning "
                  "external code (reference video_chat.py:1-202)",
    "video_chatgpt": "wraps the mbzuai-oryx/Video-ChatGPT repo (custom "
                     "CLIP-L/14 spatio-temporal pooling fork), external "
                     "code only (reference video_chatgpt.py:1-48)",
    "mplug_owl": "wraps the X-PLUG/mPLUG-Owl repo's MplugOwlForConditional"
                 "Generation (remote code, no HF-native class) "
                 "(reference mplug_owl.py:1-63)",
    "llama_adapter": "wraps the OpenGVLab/LLaMA-Adapter repo and needs "
                     "the gated raw LLaMA weights directory (reference "
                     "llama_adapter.py:1-43)",
    "frozen_bilm": "empty stub in the reference itself "
                   "(frozen_bilm.py is 0 LoC)",
}


class BaseModel(ABC):
    def __init__(self, model_name: str, model_path: str, *,
                 max_batch_size: int = 1):
        self.name = model_name
        self.model_path = model_path
        self.max_batch_size = max_batch_size

    @abstractmethod
    def generate(self, question: str, raw_image_data) -> str:
        ...

    @abstractmethod
    def eval_forward(self, question: str, answer: str, image) -> float:
        """Log-likelihood style scoring hook."""
        ...


def load_model(model_name: str, model_args: Optional[Dict] = None
               ) -> BaseModel:
    if model_name in DESCOPED_MODELS:
        raise NotImplementedError(
            f"benchmark model {model_name!r} is de-scoped: "
            f"{DESCOPED_MODELS[model_name]}")
    assert model_name in AVAILABLE_MODELS, (
        f"{model_name} is not an available model")
    module = importlib.import_module(
        f"otter_tpu_torch.benchmarks.models.{model_name}")
    cls = getattr(module, AVAILABLE_MODELS[model_name])
    args = dict(model_args or {})
    args.pop("name", None)
    return cls(**args)
