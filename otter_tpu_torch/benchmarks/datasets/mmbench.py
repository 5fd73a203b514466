"""MMBench (reference `datasets/mmbench.py`): multiple-choice with lettered
options; the prompt is hint + question + "There are several options:" block
(mmbench.py:43-75); scored by matching the predicted letter/content against
the answer."""

from __future__ import annotations

import re
from typing import List, Optional

from otter_tpu_torch.benchmarks.datasets.base_eval_dataset import (
    BaseEvalDataset)

OPTION_KEYS = ("A", "B", "C", "D", "E")


def build_options_prompt(options: dict,
                         sys_prompt: str = "There are several options:"
                         ) -> str:
    lines = [sys_prompt]
    for k in sorted(options):
        lines.append(f"{k}. {options[k]}")
    return "\n".join(lines)


def match_choice(prediction: str, options: dict,
                 answer: str) -> bool:
    """Letter match first; otherwise option-content match."""
    pred = prediction.strip()
    m = re.match(r"^\(?([A-E])\)?[\.\s:,]", pred + " ")
    if m:
        return m.group(1) == answer
    norm = pred.lower()
    gt_content = options.get(answer, "").lower()
    if gt_content and gt_content in norm:
        # make sure no other option content also matches
        others = [v.lower() for k, v in options.items()
                  if k != answer and v]
        return not any(o in norm for o in others)
    return False


class MMBenchDataset(BaseEvalDataset):
    def __init__(self, data_path: str = "Otter-AI/MMBench", *,
                 rows: Optional[List[dict]] = None, cache_dir=None,
                 split: str = "test", sys_prompt: str =
                 "There are several options:",
                 default_output_path: str = "./logs/MMBench"):
        super().__init__("MMBenchDataset", data_path)
        self.sys_prompt = sys_prompt
        self.default_output_path = default_output_path
        self.data = rows if rows is not None else self._load_hf(
            data_path, split, cache_dir)

    def _row_options(self, row: dict) -> dict:
        return {k: row[k] for k in OPTION_KEYS
                if row.get(k) not in (None, "", "nan")}

    def _evaluate(self, model) -> dict:
        n_correct = n_total = 0
        records = []
        for row in self.data:
            options = self._row_options(row)
            prompt_parts = []
            hint = row.get("hint")
            if hint and str(hint) != "nan":
                prompt_parts.append(str(hint))
            prompt_parts.append(row["question"])
            prompt_parts.append(build_options_prompt(options,
                                                     self.sys_prompt))
            pred = model.generate(" ".join(prompt_parts), row.get("image"))
            ok = match_choice(pred, options, row["answer"])
            n_correct += ok
            n_total += 1
            records.append({"index": row.get("index"), "prediction": pred,
                            "correct": bool(ok)})
        return {"accuracy": n_correct / max(n_total, 1), "total": n_total,
                "records": records}
