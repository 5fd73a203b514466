"""MathVista (reference `datasets/mathvista.py`): math reasoning over
visual contexts; answers extracted from freeform responses (GPT-assisted
extraction when a key is present, regex fallback) and compared per
answer_type (integer/float/text/list)."""

from __future__ import annotations

import re
from typing import List, Optional

from otter_tpu_torch.benchmarks.datasets.base_eval_dataset import (
    BaseEvalDataset)
from otter_tpu_torch.benchmarks.gpt_judge import get_chat_response

EXTRACT_SYS = ("Extract the final answer from the model response as a "
               "short string. Output only the answer.")


def extract_answer(response: str, question: str,
                   api_key: Optional[str]) -> str:
    out = get_chat_response(
        f"Question: {question}\nModel response: {response}\n"
        "Extracted answer:", api_key, system=EXTRACT_SYS)
    if out:
        return out.strip()
    # regex fallback: last number or the final short line
    nums = re.findall(r"-?\d+(?:\.\d+)?", response)
    if nums:
        return nums[-1]
    lines = [l.strip() for l in response.strip().splitlines() if l.strip()]
    return lines[-1] if lines else ""


def answers_match(extracted: str, answer: str, answer_type: str,
                  precision: int = 2) -> bool:
    if answer_type in ("integer", "float"):
        try:
            return abs(float(extracted) - float(answer)) < 10 ** -precision
        except ValueError:
            return False
    return extracted.strip().lower() == str(answer).strip().lower()


class MathVistaDataset(BaseEvalDataset):
    def __init__(self, data_path: str = "Otter-AI/MathVista", *,
                 rows: Optional[List[dict]] = None, cache_dir=None,
                 split: str = "testmini", api_key: Optional[str] = None,
                 default_output_path: str = "./logs/MathVista"):
        super().__init__("MathVistaDataset", data_path)
        self.api_key = api_key
        self.default_output_path = default_output_path
        self.data = rows if rows is not None else self._load_hf(
            data_path, split, cache_dir)

    def _evaluate(self, model) -> dict:
        n_correct = n_total = 0
        for row in self.data:
            pred = model.generate(row["question"], row.get("image"))
            extracted = extract_answer(pred, row["question"], self.api_key)
            n_correct += answers_match(
                extracted, row["answer"], row.get("answer_type", "text"),
                int(row.get("precision", 2) or 2))
            n_total += 1
        return {"accuracy": n_correct / max(n_total, 1), "total": n_total}
