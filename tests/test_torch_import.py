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
# the int4 serving path lives in these modules
from otter_tpu_torch.ops.quant import (Int4AttnDense, Int4Dense, int4_matmul,
                                       int4_mlp, quantize_params_int4)
from otter_tpu_torch.models.decoder import cache_len_of
from otter_tpu_torch.generation.engine import OtterGenerator
assert OtterGenerator.stream_generate
# the fused decode layer and the decode bench live in these
from otter_tpu_torch.ops.megakernel import (decode_attn_megakernel,
                                            mpt_decode_layer_megakernel)
from otter_tpu_torch.ops.quant import add_fused_wqo, int8_attn_tail
from otter_tpu_torch.tools import bench_decode, random_weights
assert bench_decode.run and random_weights.build_model
# the untied int8 head, the other decoder archs and Fuyu live in these
from otter_tpu_torch.ops.quant import int8_matmul, quantize_embed
from otter_tpu_torch.config import PRESETS, FuyuConfig
from otter_tpu_torch.models.fuyu import FuyuVLM, make_fuyu_cache
from otter_tpu_torch.generation.fuyu import fuyu_generate
assert random_weights.fuyu_request and len(PRESETS) == 9
# beams, mixed media, uint8 pixels and the user-facing API live in these
from otter_tpu_torch.generation.beam import beam_search, beam_search_chunks
from otter_tpu_torch.ops.image_prep import (device_preprocess, normalize_u8,
                                            resize_normalize)
from otter_tpu_torch.ops.masks import (alibi_bias, expand_media_mask_to_latents,
                                       mask_to_bias, media_cross_attention_mask,
                                       padding_mask_bias)
from otter_tpu_torch.api import (FlamingoForConditionalGeneration,
                                 OtterForConditionalGeneration)
assert OtterGenerator.stream_beam_generate
# the HF checkpoint converter and the serving stack live in these
from otter_tpu_torch.models.convert import (hf_to_port, load_otter_checkpoint,
                                            load_state_dict, port_to_hf)
from otter_tpu_torch.serve import cli, controller, web, worker
from otter_tpu_torch.data.fuyu_processor import FuyuProcessor
from otter_tpu_torch.data.mimicit import preprocess_image
assert worker.main and cli.main and controller.main and web.main
# the trainer's data chain, 8-bit Adam and the HF export live in these
from otter_tpu_torch.data import (MimicitDataset, MimicitLoader,
                                  WeightedMultiLoader, verify_yaml)
from otter_tpu_torch.data import tokenizer_adapt, transforms
from otter_tpu_torch.train.opt8 import Adam8
from otter_tpu_torch.train.sft import build_loaders, load_tokenizer
from otter_tpu_torch.runtime.checkpoint import CheckpointStore
assert CheckpointStore.export_hf
# the eval harness, the native decoder, the tools and the demos
from otter_tpu_torch.benchmarks import evaluate
from otter_tpu_torch.benchmarks.public_suite import evaluate as suite
from otter_tpu_torch.benchmarks.models.base_model import (AVAILABLE_MODELS,
                                                          load_model)
from otter_tpu_torch.benchmarks.datasets.base_eval_dataset import (
    AVAILABLE_EVAL_DATASETS, load_sample_rows)
from otter_tpu_torch import native
from otter_tpu_torch.tools import (convert_it, shards, surgery, syphus)
from otter_tpu_torch.demos import demo_models, inference, interactive
assert evaluate.main and suite.main and inference.main and interactive.main
assert convert_it.main and syphus.main and shards.main
assert native.preprocess_batch and surgery.merge_lora
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "otter_tpu"))
print(" ".join(sorted(m for m in sys.modules
                     if m.startswith("otter_tpu_torch"))))
sys.exit(1 if bad else 0)
"""
# the modules of the training slice, which the walk above must reach
_FUSED_DECODE_MODULES = {
    "otter_tpu_torch.ops.megakernel", "otter_tpu_torch.tools",
    "otter_tpu_torch.tools.bench_decode",
    "otter_tpu_torch.tools.random_weights"}
_FUYU_MODULES = {"otter_tpu_torch.models.fuyu",
                 "otter_tpu_torch.generation.fuyu"}
_BEAM_MEDIA_MODULES = {"otter_tpu_torch.generation.beam",
                       "otter_tpu_torch.ops.image_prep",
                       "otter_tpu_torch.api"}
_SERVING_MODULES = {
    "otter_tpu_torch.serve", "otter_tpu_torch.serve.worker",
    "otter_tpu_torch.serve.controller", "otter_tpu_torch.serve.web",
    "otter_tpu_torch.serve.cli", "otter_tpu_torch.serve.conversation",
    "otter_tpu_torch.serve.moderation", "otter_tpu_torch.serve.test_message",
    "otter_tpu_torch.serve.register_worker", "otter_tpu_torch.data.templates",
    "otter_tpu_torch.data.fuyu_processor", "otter_tpu_torch.models.convert"}
_TRAINING_MODULES = {
    "otter_tpu_torch.train.step", "otter_tpu_torch.train.sft",
    "otter_tpu_torch.train.args", "otter_tpu_torch.runtime.metrics",
    "otter_tpu_torch.runtime.checkpoint", "otter_tpu_torch.data.mimicit",
    "otter_tpu_torch.data.loader", "otter_tpu_torch.data.yaml_spec",
    "otter_tpu_torch.data.transforms", "otter_tpu_torch.data.tokenizer_adapt",
    "otter_tpu_torch.train.opt8"}
# the eval harness, the native decoder, the tools and the demos: every
# module of the JAX package's benchmarks, native, tools and demos
_LAST_SLICE_MODULES = {
    f"otter_tpu_torch.{m}" for m in (
        "native", "benchmarks", "benchmarks.evaluate", "benchmarks.gpt_judge",
        "benchmarks.models", "benchmarks.datasets",
        "benchmarks.public_suite", "demos", "demos.demo_models",
        "demos.inference", "demos.interactive")} | {
    f"otter_tpu_torch.benchmarks.models.{m}" for m in (
        "base_model", "image_utils", "otter_image", "otter_video", "otterhd",
        "fuyu", "idefics", "gpt4v", "llava", "instructblip", "qwen_vl")} | {
    f"otter_tpu_torch.benchmarks.datasets.{m}" for m in (
        "base_eval_dataset", "mme", "pope", "mmbench", "scienceqa",
        "seedbench", "mathvista", "mmvet", "magnifierbench")} | {
    f"otter_tpu_torch.benchmarks.public_suite.{m}" for m in (
        "evaluate", "coco_metric", "vqa_metric", "ok_vqa_utils",
        "classification_utils", "manifests")} | {
    f"otter_tpu_torch.tools.{m}" for m in (
        "surgery", "shards", "convert_it", "convert_it_datasets", "syphus",
        "syphus_datasets")}


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
    assert len(loaded) >= 46                  # every module was imported
    assert _SERVING_MODULES <= loaded, _SERVING_MODULES - loaded
    assert _FUYU_MODULES <= loaded, _FUYU_MODULES - loaded
    assert _BEAM_MEDIA_MODULES <= loaded, _BEAM_MEDIA_MODULES - loaded
    assert _TRAINING_MODULES <= loaded, _TRAINING_MODULES - loaded
    assert _FUSED_DECODE_MODULES <= loaded, _FUSED_DECODE_MODULES - loaded
    assert _LAST_SLICE_MODULES <= loaded, _LAST_SLICE_MODULES - loaded


def test_every_file_of_the_jax_package_has_its_counterpart():
    """Each .py, .cpp and data file of the JAX package has a file at the
    same relative path in the port (built libraries and caches aside)."""
    jax_root, port_root = ROOT / "otter_tpu", ROOT / "otter_tpu_torch"
    missing = [str(f.relative_to(jax_root)) for f in jax_root.rglob("*")
               if f.is_file() and f.suffix in (".py", ".cpp", ".json", ".md")
               and "__pycache__" not in f.parts
               and not (port_root / f.relative_to(jax_root)).is_file()]
    assert len(list(jax_root.rglob("*.py"))) > 100 and not missing, missing


def test_chip_smoke_imports_only_the_port_and_the_standard_library():
    """Every import statement of chip_smoke.py, wherever it stands, names
    torch, numpy, the port or the standard library."""
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    third_party = roots - set(sys.stdlib_module_names)
    assert third_party == {"torch", "numpy", "otter_tpu_torch"}, third_party


def test_bench_decode_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the bench would run for real")
    res = subprocess.run(
        [sys.executable, "-m", "otter_tpu_torch.tools.bench_decode"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "CUDA" in res.stderr and "metric" not in res.stdout


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


@pytest.mark.parametrize("preset", sorted(jcfg.PRESETS))
def test_presets_equal_the_jax_package(preset):
    assert tcfg.PRESETS[preset]().to_dict() == \
        jcfg.PRESETS[preset]().to_dict()


@pytest.mark.parametrize("tiny", [False, True])
def test_fuyu_config_equals_the_jax_package(tiny):
    jc = jcfg.FuyuConfig.tiny() if tiny else jcfg.FuyuConfig()
    tc = tcfg.FuyuConfig.tiny() if tiny else tcfg.FuyuConfig()
    assert tc.to_dict() == jc.to_dict()
    assert tcfg.FuyuConfig.from_dict(json.loads(jc.to_json())) == tc
    assert tcfg.OtterConfig.tiny("llama").to_dict() == \
        jcfg.OtterConfig.tiny("llama").to_dict()


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
