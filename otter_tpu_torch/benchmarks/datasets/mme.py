"""MME benchmark (reference `pipeline/benchmarks/datasets/mme.py`):
yes/no questions over 14 categories; per-category score = acc + acc+
(acc+ counts images with BOTH questions right), summed into
Perception/Cognition totals (mme.py:19-33, :88-200)."""

from __future__ import annotations

from typing import Dict, List, Optional

from otter_tpu_torch.benchmarks.datasets.base_eval_dataset import (
    BaseEvalDataset)

EVAL_TYPE_DICT = {
    "Perception": ["existence", "count", "position", "color", "posters",
                   "celebrity", "scene", "landmark", "artwork", "ocr"],
    "Cognition": ["commonsense", "numerical", "text", "code"],
}


def parse_pred_ans(pred: str) -> str:
    pred = pred.lower().strip().replace(".", "")
    if pred in ("yes", "no"):
        return pred
    prefix = pred[:4]
    if "yes" in prefix:
        return "yes"
    if "no" in prefix:
        return "no"
    return "other"


class MMEDataset(BaseEvalDataset):
    def __init__(self, data_path: str = "Otter-AI/MME", *,
                 rows: Optional[List[dict]] = None, cache_dir=None,
                 split: str = "test", default_output_path: str = "./logs/MME",
                 debug: bool = False):
        super().__init__("MMEDataset", data_path)
        self.default_output_path = default_output_path
        data = rows if rows is not None else self._load_hf(
            data_path, split, cache_dir)
        # group: eval_type -> category -> image_id -> [qa dicts]
        self.category_data: Dict = {}
        for item in data:
            category = item["id"].split("_")[0].lower()
            if category in EVAL_TYPE_DICT["Cognition"]:
                etype = "Cognition"
            elif category in EVAL_TYPE_DICT["Perception"]:
                etype = "Perception"
            else:
                raise ValueError(f"unknown MME category {category}")
            entry = {"question": item["instruction"],
                     "answer": item["answer"],
                     "image": item["images"][0] if item.get("images")
                     else None}
            img_id = item["image_ids"][0] if item.get("image_ids") \
                else item["id"]
            self.category_data.setdefault(etype, {}).setdefault(
                category, {}).setdefault(img_id, []).append(entry)

    def _evaluate(self, model) -> dict:
        results = {}
        for etype, cats in self.category_data.items():
            etype_total = 0.0
            per_cat = {}
            for cat, images in cats.items():
                n_correct = n_total = 0
                n_img_correct = n_img = 0
                for img_id, qas in images.items():
                    img_ok = True
                    for qa in qas:
                        pred = parse_pred_ans(model.generate(
                            qa["question"], qa["image"]))
                        gt = qa["answer"].lower().strip()
                        ok = pred == gt
                        n_correct += ok
                        n_total += 1
                        img_ok &= ok
                    n_img += 1
                    n_img_correct += img_ok
                acc = n_correct / max(n_total, 1)
                acc_plus = n_img_correct / max(n_img, 1)
                score = (acc + acc_plus) * 100
                per_cat[cat] = {"acc": acc, "acc_plus": acc_plus,
                                "score": score}
                etype_total += score
            results[etype] = {"total": etype_total,
                              "categories": per_cat}
        return results
