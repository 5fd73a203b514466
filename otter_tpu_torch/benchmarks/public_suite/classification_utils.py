"""Rank-classification utilities (reference
`public_datasets_suite/classification_utils.py`): the model scores each
candidate class name appended to the prompt via `eval_forward`
(log-likelihood), prediction = argmax. HatefulMemes classes embedded;
ImageNet's 1000 class names ship as a vendored data asset
(`data/imagenet_classnames.json` — the reference embeds the same list at
classification_utils.py:2-1005; it is dataset metadata, vendored like the
syphus prompt JSONs) so `--dataset imagenet` runs with no side-channel
file; `load_classnames(path)` still overrides."""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

HM_CLASSNAMES = ["no", "yes"]  # hateful-memes: is the meme hateful?
HM_CLASS_ID_TO_LABEL = {0: "no", 1: "yes"}

_IMAGENET_JSON = os.path.join(os.path.dirname(__file__), "data",
                              "imagenet_classnames.json")


def imagenet_classnames() -> List[str]:
    """The 1000 ImageNet-1k class names (OpenAI CLIP prompt spelling)."""
    with open(_IMAGENET_JSON) as f:
        return json.load(f)


def load_classnames(path: Optional[str] = None) -> List[str]:
    if path is None:
        return imagenet_classnames()
    with open(path) as f:
        return [l.strip() for l in f if l.strip()]


def rank_classification(model, question: str, image,
                        classnames: Sequence[str]) -> int:
    """Returns the index of the highest-likelihood class."""
    scores = [model.eval_forward(question, c, image) for c in classnames]
    return max(range(len(classnames)), key=lambda i: scores[i])
