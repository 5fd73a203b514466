"""Dataset-group YAML: parsing + pre-run validation gate (counterpart of
`otter_tpu/data/yaml_spec.py`, the same messages and refusals; PyYAML is
imported where a file is read).

The YAML schema is the reference's advertised public data interface
(docs/mimicit_format.md:9-35, README.md:56-67):

    IMAGE_TEXT:
      LADD:
        mimicit_path: .../LADD_instructions.json
        images_path:  .../LA.parquet
        num_samples:  -1
      ...
    TEXT_ONLY: { ... }
    VIDEO_TEXT: { ... }
    IMAGE_TEXT_IN_CONTEXT: { ... }

The validation mirrors the reference's trainer-invoked pytest gate
(`unit_tests/test_prerun.py:22-55` run via `verify_yaml`,
train_utils.py:155-164): structure, path existence, num_samples types, and
each mimicit JSON having a "data" key. Exposed both as a library function
(the trainer calls it directly) and as a pytest-markable check.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from otter_tpu_torch.data.mimicit import TASK_GROUPS, MimicitTask


class DataSpecError(ValueError):
    pass


def load_yaml(path: str) -> dict:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


def validate_spec(spec: dict, *, check_paths: bool = True,
                  check_data_key: bool = True) -> List[str]:
    """Returns a list of problems (empty = valid)."""
    problems = []
    if not isinstance(spec, dict) or not spec:
        return ["spec must be a non-empty mapping of task groups"]
    for group, tasks in spec.items():
        if group not in TASK_GROUPS:
            problems.append(f"unknown task group {group!r} "
                            f"(expected one of {TASK_GROUPS})")
            continue
        if not isinstance(tasks, dict):
            problems.append(f"{group}: must map task names to configs")
            continue
        for name, cfg in tasks.items():
            if not isinstance(cfg, dict):
                problems.append(f"{group}/{name}: config must be a mapping")
                continue
            mp = cfg.get("mimicit_path", "")
            if not mp:
                problems.append(f"{group}/{name}: missing mimicit_path")
            elif check_paths and not os.path.exists(mp):
                problems.append(f"{group}/{name}: mimicit_path {mp} missing")
            elif check_data_key and os.path.exists(mp):
                try:
                    with open(mp, "rb") as f:
                        head = json.loads(f.read())
                    if "data" not in head:
                        problems.append(
                            f"{group}/{name}: {mp} has no 'data' key")
                except Exception as e:
                    problems.append(f"{group}/{name}: {mp} unreadable: {e}")
            ns = cfg.get("num_samples", 0)
            if not isinstance(ns, int):
                problems.append(f"{group}/{name}: num_samples must be int, "
                                f"got {type(ns).__name__}")
            for key in ("images_path", "train_config_path"):
                p = cfg.get(key, "")
                if p and check_paths and not os.path.exists(p):
                    problems.append(f"{group}/{name}: {key} {p} missing")
    return problems


def verify_yaml(path: str) -> None:
    """Trainer-invoked gate: raises DataSpecError on any problem
    (replaces the subprocess-pytest gate, train_utils.py:155-164)."""
    problems = validate_spec(load_yaml(path))
    if problems:
        raise DataSpecError("data YAML validation failed:\n  " +
                            "\n  ".join(problems))


def tasks_from_spec(spec: dict) -> Dict[str, List[MimicitTask]]:
    """-> {task_group: [MimicitTask, ...]}."""
    out: Dict[str, List[MimicitTask]] = {}
    for group, tasks in spec.items():
        out[group] = [
            MimicitTask(
                name=name,
                mimicit_path=cfg.get("mimicit_path", ""),
                images_path=cfg.get("images_path", ""),
                train_config_path=cfg.get("train_config_path", ""),
                num_samples=max(int(cfg.get("num_samples", 0)), 0),
                task_description=cfg.get("task_description", ""),
            ) for name, cfg in tasks.items()]
    return out
