"""One-click benchmark harness (reference
`pipeline/benchmarks/evaluate.py:48-137`): YAML lists models and datasets;
every model is evaluated on every dataset; reports are printed and teed to
per-run files (`DualOutput`, evaluate.py:34-45).

    models:
      - name: otter_image
        model_path: /path/to/ckpt.safetensors
        tokenizer: /path/to/tokenizer
    datasets:
      - name: mme
        data_path: Otter-AI/MME

Run: python -m otter_tpu_torch.benchmarks.evaluate --config benchmark.yaml
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
from typing import Any, Dict

import yaml

from otter_tpu_torch.benchmarks.datasets.base_eval_dataset import load_dataset
from otter_tpu_torch.benchmarks.models.base_model import load_model


class DualOutput:
    """stdout tee into a report file (evaluate.py:34-45)."""

    def __init__(self, file_path: str):
        self.terminal = sys.stdout
        self.log = open(file_path, "a")

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()


def run(config: Dict[str, Any], output_dir: str = "./logs") -> Dict:
    os.makedirs(output_dir, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    results: Dict[str, Dict] = {}
    for model_cfg in config["models"]:
        model_name = model_cfg["name"]
        model = load_model(model_name, model_cfg)
        results[model_name] = {}
        for ds_cfg in config["datasets"]:
            ds_name = ds_cfg["name"]
            dataset = load_dataset(ds_name, ds_cfg)
            report_path = os.path.join(
                output_dir, f"{model_name}_{ds_name}_{stamp}.log")
            old_stdout = sys.stdout
            sys.stdout = DualOutput(report_path)
            try:
                print(f"=== {model_name} on {ds_name} ===")
                res = dataset.evaluate(model)
                print(json.dumps(res, indent=2, default=str))
            finally:
                sys.stdout.log.close()
                sys.stdout = old_stdout
            results[model_name][ds_name] = res
    with open(os.path.join(output_dir, f"summary_{stamp}.json"), "w") as f:
        json.dump(results, f, indent=2, default=str)
    return results


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--output_dir", default="./logs")
    args = p.parse_args()
    with open(args.config) as f:
        config = yaml.safe_load(f)
    run(config, args.output_dir)


if __name__ == "__main__":
    main()
