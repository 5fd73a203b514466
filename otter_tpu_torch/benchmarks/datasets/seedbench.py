"""SEED-Bench (reference `datasets/seedbench.py`): multiple-choice over 12
evaluation dimensions; accuracy overall and per dimension."""

from __future__ import annotations

from collections import defaultdict
from typing import List, Optional

from otter_tpu_torch.benchmarks.datasets.base_eval_dataset import (
    BaseEvalDataset)
from otter_tpu_torch.benchmarks.datasets.mmbench import (build_options_prompt,
                                                   match_choice)


class SEEDBenchDataset(BaseEvalDataset):
    def __init__(self, data_path: str = "Otter-AI/SEEDBench", *,
                 rows: Optional[List[dict]] = None, cache_dir=None,
                 split: str = "test",
                 default_output_path: str = "./logs/SEEDBench"):
        super().__init__("SEEDBenchDataset", data_path)
        self.default_output_path = default_output_path
        self.data = rows if rows is not None else self._load_hf(
            data_path, split, cache_dir)

    def _evaluate(self, model) -> dict:
        per_dim = defaultdict(lambda: [0, 0])
        n_correct = n_total = 0
        for row in self.data:
            options = {k: row[k] for k in ("A", "B", "C", "D")
                       if row.get(k)}
            prompt = row["question"] + "\n" + build_options_prompt(options)
            pred = model.generate(prompt, row.get("image"))
            ok = match_choice(pred, options, row["answer"])
            dim = row.get("question_type_id", row.get("dimension", "all"))
            per_dim[dim][0] += ok
            per_dim[dim][1] += 1
            n_correct += ok
            n_total += 1
        return {
            "accuracy": n_correct / max(n_total, 1),
            "total": n_total,
            "per_dimension": {d: c / max(t, 1)
                              for d, (c, t) in per_dim.items()},
        }
