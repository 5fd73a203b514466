"""YAML-driven batch inference (counterpart of
`otter_tpu/demos/inference.py`, the reference
`pipeline/demos/inference.py:34-70`): a YAML of {cases: [{image,
question(s)}]} runs through the model with results logged to JSON — the
reference's manual regression-check pattern.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List

import yaml


def run_cases(demo, cases: List[dict]) -> List[dict]:
    from PIL import Image
    results = []
    for case in cases:
        image = Image.open(case["image"]) if case.get("image") else None
        questions = case.get("questions") or [case["question"]]
        for q in questions:
            answer = demo.ask(q, image)
            results.append({"image": case.get("image"), "question": q,
                            "answer": answer})
            print(json.dumps(results[-1]))
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True, help="cases YAML")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--model_config", default="mpt7b")
    p.add_argument("--output", default="inference_results.json")
    p.add_argument("--max_new_tokens", type=int, default=512)
    p.add_argument("--device", default=None,
                   help="the model's device (default: the GPU)")
    args = p.parse_args(argv)

    from otter_tpu_torch.demos.demo_models import TestOtter
    with open(args.config) as f:
        spec = yaml.safe_load(f)
    demo = TestOtter(checkpoint=args.checkpoint, config=args.model_config,
                     tokenizer=args.tokenizer, device=args.device,
                     max_new_tokens=args.max_new_tokens)
    results = run_cases(demo, spec["cases"])
    with open(args.output, "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
