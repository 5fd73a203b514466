"""The port stands alone: importing it (or chip_smoke.py) loads no jax,
flax or otter_tpu module, its config round-trips through the JAX package's
JSON, and chip_smoke.py refuses to run without a GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from otter_tpu import config as jcfg
from otter_tpu_torch import config as tcfg

ROOT = Path(__file__).resolve().parents[1]

_CHECK_IMPORTS = r"""
import importlib, pkgutil, sys
import otter_tpu_torch
for m in pkgutil.walk_packages(otter_tpu_torch.__path__, "otter_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "otter_tpu"))
print(" ".join(sorted(m for m in sys.modules
                     if m.startswith("otter_tpu_torch"))))
sys.exit(1 if bad else 0)
"""
# the modules of the training slice, which the walk above must reach
_TRAINING_MODULES = {
    "otter_tpu_torch.train.step", "otter_tpu_torch.train.sft",
    "otter_tpu_torch.train.args", "otter_tpu_torch.runtime.metrics",
    "otter_tpu_torch.runtime.checkpoint", "otter_tpu_torch.data.mimicit"}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_no_jax_or_otter_tpu():
    res = subprocess.run([sys.executable, "-c", _CHECK_IMPORTS], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    loaded = set(res.stdout.split())
    assert len(loaded) >= 25                  # every module was imported
    assert _TRAINING_MODULES <= loaded, _TRAINING_MODULES - loaded


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


@pytest.mark.parametrize("preset", ["tiny", "mpt7b"])
def test_config_round_trips_with_jax_package(preset, tmp_path):
    jc = (jcfg.OtterConfig.tiny("mpt") if preset == "tiny"
          else jcfg.otter_mpt7b())
    tc = (tcfg.OtterConfig.tiny("mpt") if preset == "tiny"
          else tcfg.otter_mpt7b())
    assert tc.to_dict() == jc.to_dict()
    path = tmp_path / "cfg.json"
    path.write_text(jc.to_json())
    assert tcfg.load_config(str(path)) == tc
    tcfg.save_config(tc, str(path))
    assert jcfg.load_config(str(path)) == jc
    assert json.loads(path.read_text())["text"]["hidden_size"] == \
        jc.text.hidden_size
