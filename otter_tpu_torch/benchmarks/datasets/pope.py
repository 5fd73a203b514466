"""POPE hallucination benchmark (reference
`pipeline/benchmarks/datasets/pope.py`): yes/no object-presence questions in
adversarial/popular/random splits; reports accuracy, precision, recall, f1,
yes-ratio per split and overall (pope.py:40-140)."""

from __future__ import annotations

from typing import List, Optional

from otter_tpu_torch.benchmarks.datasets.base_eval_dataset import (
    BaseEvalDataset)

CATEGORIES = ("adversarial", "popular", "random")


def parse_pred(text: str) -> str:
    t = text.lower()
    return "no" if "no" in t[:4] else "yes"


class PopeDataset(BaseEvalDataset):
    def __init__(self, data_path: str = "Otter-AI/POPE", *,
                 rows: Optional[List[dict]] = None, cache_dir=None,
                 split: str = "test",
                 default_output_path: str = "./logs/POPE"):
        super().__init__("PopeDataset", data_path)
        self.default_output_path = default_output_path
        self.data = rows if rows is not None else self._load_hf(
            data_path, split, cache_dir)

    def _evaluate(self, model) -> dict:
        m = {c: dict(TP=0, TN=0, FP=0, FN=0, yes_count=0, no_count=0)
             for c in CATEGORIES + ("overall",)}
        for item in self.data:
            category = item["category"]
            answer = item["answer"].lower().strip()
            pred = parse_pred(model.generate(item["question"],
                                             item.get("image")))
            for c in (category, "overall"):
                m[c]["yes_count" if answer == "yes" else "no_count"] += 1
                if pred == answer:
                    m[c]["TP" if pred == "yes" else "TN"] += 1
                else:
                    m[c]["FP" if pred == "yes" else "FN"] += 1
        for c, d in m.items():
            tp, tn, fp, fn = d["TP"], d["TN"], d["FP"], d["FN"]
            total = tp + tn + fp + fn
            d["accuracy"] = (tp + tn) / total if total else 0.0
            d["precision"] = tp / (tp + fp) if tp + fp else 0.0
            d["recall"] = tp / (tp + fn) if tp + fn else 0.0
            pr = d["precision"] + d["recall"]
            d["f1"] = 2 * d["precision"] * d["recall"] / pr if pr else 0.0
            yc, nc = d["yes_count"], d["no_count"]
            d["yes_ratio"] = yc / (yc + nc) if yc + nc else 0.0
        return m
