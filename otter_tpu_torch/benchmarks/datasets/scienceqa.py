"""ScienceQA (reference `datasets/scienceqa.py`): multiple-choice science
questions (with optional image + lecture/hint context); accuracy over
letter-matched predictions."""

from __future__ import annotations

from typing import List, Optional

from otter_tpu_torch.benchmarks.datasets.base_eval_dataset import (
    BaseEvalDataset)
from otter_tpu_torch.benchmarks.datasets.mmbench import (build_options_prompt,
                                                   match_choice)

LETTERS = "ABCDE"


class ScienceQADataset(BaseEvalDataset):
    def __init__(self, data_path: str = "Otter-AI/ScienceQA", *,
                 rows: Optional[List[dict]] = None, cache_dir=None,
                 split: str = "test",
                 default_output_path: str = "./logs/ScienceQA"):
        super().__init__("ScienceQADataset", data_path)
        self.default_output_path = default_output_path
        self.data = rows if rows is not None else self._load_hf(
            data_path, split, cache_dir)

    def _evaluate(self, model) -> dict:
        n_correct = n_total = 0
        for row in self.data:
            choices = row["choices"]
            options = {LETTERS[i]: c for i, c in enumerate(choices)}
            answer_letter = LETTERS[int(row["answer"])]
            parts = []
            if row.get("hint"):
                parts.append(row["hint"])
            parts.append(row["question"])
            parts.append(build_options_prompt(options))
            pred = model.generate(" ".join(parts), row.get("image"))
            n_correct += match_choice(pred, options, answer_letter)
            n_total += 1
        return {"accuracy": n_correct / max(n_total, 1), "total": n_total}
