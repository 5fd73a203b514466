"""MM-Vet (reference `datasets/mmvet.py`): open-ended integrated-capability
questions scored 0..1 by a GPT judge against the ground truth (offline
fallback: binary heuristic match)."""

from __future__ import annotations

import re
from typing import List, Optional

from otter_tpu_torch.benchmarks.datasets.base_eval_dataset import (
    BaseEvalDataset)
from otter_tpu_torch.benchmarks.gpt_judge import (get_chat_response,
                                            heuristic_judge)

JUDGE_SYS = ("Compare the ground truth and prediction from AI models, to "
             "give a correctness score for the prediction. Output a single "
             "number between 0.0 and 1.0.")


def judge_score(question: str, response: str, answer: str,
                api_key: Optional[str]) -> float:
    prompt = (f"Question: {question}\nGround truth: {answer}\n"
              f"Prediction: {response}\nCorrectness score:")
    out = get_chat_response(prompt, api_key, system=JUDGE_SYS)
    if out:
        m = re.search(r"([01](?:\.\d+)?)", out)
        if m:
            return min(max(float(m.group(1)), 0.0), 1.0)
    return 1.0 if heuristic_judge(question, response, answer) else 0.0


class MMVetDataset(BaseEvalDataset):
    def __init__(self, data_path: str = "Otter-AI/MMVet", *,
                 rows: Optional[List[dict]] = None, cache_dir=None,
                 split: str = "test", api_key: Optional[str] = None,
                 default_output_path: str = "./logs/MMVet"):
        super().__init__("MMVetDataset", data_path)
        self.api_key = api_key
        self.default_output_path = default_output_path
        self.data = rows if rows is not None else self._load_hf(
            data_path, split, cache_dir)

    def _evaluate(self, model) -> dict:
        total = 0.0
        n = 0
        per_cap = {}
        for row in self.data:
            pred = model.generate(row["question"], row.get("image"))
            score = judge_score(row["question"], pred, row["answer"],
                                self.api_key)
            total += score
            n += 1
            for cap in (row.get("capability") or "").split(","):
                cap = cap.strip()
                if cap:
                    per_cap.setdefault(cap, []).append(score)
        return {
            "score": 100 * total / max(n, 1),
            "total": n,
            "per_capability": {c: 100 * sum(v) / len(v)
                               for c, v in per_cap.items()},
        }
