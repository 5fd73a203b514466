"""MagnifierBench (reference `datasets/magnifierbench.py`): small-object
questions with both multiple-choice and freeform variants; MC scored by
letter match, freeform by GPT-4 judge (magnifierbench.py:24-70; offline
fallback: heuristic matching)."""

from __future__ import annotations

from typing import List, Optional

from otter_tpu_torch.benchmarks.datasets.base_eval_dataset import (
    BaseEvalDataset)
from otter_tpu_torch.benchmarks.datasets.mmbench import (build_options_prompt,
                                                   match_choice)
from otter_tpu_torch.benchmarks.gpt_judge import judge_correct


class MagnifierBenchDataset(BaseEvalDataset):
    def __init__(self, data_path: str = "Otter-AI/MagnifierBench", *,
                 rows: Optional[List[dict]] = None, cache_dir=None,
                 split: str = "test", api_key: Optional[str] = None,
                 default_output_path: str = "./logs/MagnifierBench"):
        super().__init__("MagnifierBenchDataset", data_path)
        self.api_key = api_key
        self.default_output_path = default_output_path
        self.data = rows if rows is not None else self._load_hf(
            data_path, split, cache_dir)

    def _evaluate(self, model) -> dict:
        mc_correct = ff_correct = n_total = 0
        for row in self.data:
            options = {k: row[k] for k in ("A", "B", "C", "D")
                       if row.get(k)}
            mc_prompt = row["question"] + "\n" + build_options_prompt(
                options)
            mc_pred = model.generate(mc_prompt, row.get("image"))
            mc_correct += match_choice(mc_pred, options, row["answer"])

            ff_q = row.get("freeform_question", row["question"])
            ff_ans = row.get("freeform_answer",
                             options.get(row["answer"], ""))
            ff_pred = model.generate(ff_q, row.get("image"))
            ff_correct += judge_correct(ff_q, ff_pred, ff_ans,
                                        self.api_key)
            n_total += 1
        return {
            "mc_accuracy": mc_correct / max(n_total, 1),
            "freeform_accuracy": ff_correct / max(n_total, 1),
            "total": n_total,
        }
