"""Port parity of the public-datasets suite
(`otter_tpu_torch.benchmarks.public_suite`) against the JAX package's: the
metrics (VQA accuracy, CIDEr, OK-VQA stemming), the few-shot drivers on a
scripted model, the manifest loaders, and the cross-process gather over a
two-process gloo group, whose global score equals one process's."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from otter_tpu.benchmarks.public_suite import coco_metric as jcoco
from otter_tpu.benchmarks.public_suite import evaluate as jsuite
from otter_tpu.benchmarks.public_suite import manifests as jman
from otter_tpu.benchmarks.public_suite import ok_vqa_utils as jokvqa
from otter_tpu.benchmarks.public_suite import vqa_metric as jvqa
from otter_tpu_torch.benchmarks.public_suite import coco_metric, manifests
from otter_tpu_torch.benchmarks.public_suite import evaluate as suite
from otter_tpu_torch.benchmarks.public_suite import ok_vqa_utils, vqa_metric

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["Two dogs.", "a red ball", "isnt", "riding horses", "leaves",
         "the Christmas tree", "3.5 apples", "yes, it is", "Running"]


@pytest.mark.parametrize("text", WORDS)
def test_answer_normalization_and_stemming_match_jax(text):
    assert vqa_metric.normalize_answer(text) == jvqa.normalize_answer(text)
    assert vqa_metric.postprocess_vqa_generation(text + " Question: x") == \
        jvqa.postprocess_vqa_generation(text + " Question: x")
    assert ok_vqa_utils.postprocess_ok_vqa_generation(text) == \
        jokvqa.postprocess_ok_vqa_generation(text)
    assert coco_metric.postprocess_captioning_generation(text + "\nOutput:") \
        == jcoco.postprocess_captioning_generation(text + "\nOutput:")


def test_vqa_accuracy_and_cider_match_jax():
    rng = np.random.default_rng(0)
    vocab = ["red", "blue", "two", "dog", "ride horse", "yes"]
    rows = [{"prediction": str(rng.choice(vocab)),
             "answers": [str(a) for a in rng.choice(vocab, 10)]}
            for _ in range(12)]
    assert vqa_metric.compute_vqa_accuracy(rows) == \
        jvqa.compute_vqa_accuracy(rows)
    for r in rows:
        assert vqa_metric.vqa_accuracy(r["prediction"], r["answers"]) == \
            jvqa.vqa_accuracy(r["prediction"], r["answers"])
    refs = {"1": ["a cat sits on the mat", "the cat is on a mat"],
            "2": ["a dog runs in the park", "the dog is running"],
            "3": ["two birds on a wire", "birds sitting on a line"]}
    results = [{"image_id": "1", "caption": "a cat on the mat"},
               {"image_id": "2", "caption": "a dog in a park"},
               {"image_id": "3", "caption": "purple elephant tango"}]
    ours = coco_metric.compute_cider(results, refs)
    assert ours == jcoco.compute_cider(results, refs) and ours > 0


class Scripted:
    max_batch_size = 3

    def __init__(self, caption="a cat on the mat", answer="red"):
        self.caption, self.answer = caption, answer
        self.batches = []

    def generate(self, prompt, image=None):
        return self.answer if "Short answer:" in prompt else self.caption

    def generate_batch(self, prompts, images):
        self.batches.append((list(prompts), list(images)))
        return [self.generate(p, im) for p, im in zip(prompts, images)]

    def eval_forward(self, question, answer, image=None):
        return 1.0 if answer == "yes" else 0.0


_VQA = [{"image": None, "question": f"q{i}?",
         "answers": ["red"] * 10 if i % 3 else ["ride horse"] * 10}
        for i in range(7)]
_CAPTIONS = [{"image": None, "caption": c, "image_id": str(i)}
             for i, c in enumerate(["a cat on the mat", "a dog under a tree",
                                    "a cat on a mat"])]


@pytest.mark.parametrize("dataset,shots", [("vqav2", 0), ("vqav2", 4),
                                           ("ok_vqa", 2)])
def test_vqa_driver_matches_jax(dataset, shots):
    """Same prompts (the few-shot context drawn from the seed), same
    batches through generate_batch, same score."""
    ours, ref = Scripted(answer="riding horses"), Scripted(
        answer="riding horses")
    kw = dict(test_items=_VQA, train_items=_VQA, num_shots=shots,
              dataset_name=dataset)
    assert suite.evaluate_vqa(ours, **kw) == jsuite.evaluate_vqa(ref, **kw)
    assert ours.batches == ref.batches and len(ours.batches) == 3


def test_captioning_and_classification_drivers_match_jax():
    ours, ref = Scripted(), Scripted()
    kw = dict(test_items=_CAPTIONS, train_items=_CAPTIONS, num_shots=2)
    score = suite.evaluate_captioning(ours, **kw)
    assert score == jsuite.evaluate_captioning(ref, **kw) and score > 0
    assert ours.batches == ref.batches
    items = [{"image": None, "class_id": 1}, {"image": None, "class_id": 0}]
    assert suite.evaluate_classification(
        Scripted(), test_items=items, classnames=["no", "yes"]) == \
        jsuite.evaluate_classification(
            Scripted(), test_items=items, classnames=["no", "yes"]) == 50.0


def test_manifest_image_paths_open_as_pil_images(tmp_path):
    """A manifest names image files; the suite hands the adapters PIL
    images (the JAX suite passes the path string on, which its adapters
    read as base64)."""
    path = tmp_path / "a.png"
    Image.fromarray(np.full((8, 8, 3), 200, np.uint8)).save(path)
    model = Scripted()
    items = [{"image": str(path), "question": "q?", "answers": ["red"] * 10},
             {"image": None, "question": "q?", "answers": ["red"] * 10}]
    assert suite.evaluate_vqa(model, test_items=items) == 100.0
    (_, images), = model.batches
    assert isinstance(images[0], Image.Image) and images[0].size == (8, 8)
    assert images[1] is None


def test_manifest_loaders_match_jax(tmp_path):
    coco = {"images": [{"id": 7, "file_name": "a.jpg"}],
            "annotations": [{"image_id": 7, "caption": "a cat"},
                            {"image_id": 7, "caption": "feline"}]}
    karpathy = {"images": [
        {"split": "test", "filepath": "val2014", "filename": "b.jpg",
         "cocoid": 9, "imgid": 1,
         "sentences": [{"raw": "a dog"}, {"raw": "canine"}]},
        {"split": "train", "filename": "c.jpg", "imgid": 2,
         "sentences": [{"raw": "x"}]}]}
    qs = {"questions": [{"question_id": 1, "image_id": 42,
                         "question": "what color?"}]}
    anns = {"annotations": [{"question_id": 1,
                             "answers": [{"answer": "red"}] * 10}]}
    files = {"coco.json": coco, "karpathy.json": karpathy, "q.json": qs,
             "a.json": anns}
    for name, obj in files.items():
        (tmp_path / name).write_text(json.dumps(obj))
    (tmp_path / "dev.jsonl").write_text(
        '{"img": "img/1.png", "label": 1, "text": "t"}\n')
    p = lambda n: str(tmp_path / n)  # noqa: E731
    for mod_a, mod_b in ((manifests, jman),):
        assert mod_a.load_coco_captions(p("coco.json"), "/imgs") == \
            mod_b.load_coco_captions(p("coco.json"), "/imgs")
        assert mod_a.load_karpathy_split(p("karpathy.json"), "/r",
                                         split="test") == \
            mod_b.load_karpathy_split(p("karpathy.json"), "/r", split="test")
        assert mod_a.load_vqav2(p("q.json"), p("a.json"), "/imgs") == \
            mod_b.load_vqav2(p("q.json"), p("a.json"), "/imgs")
        assert mod_a.load_hateful_memes(p("dev.jsonl"), "/r") == \
            mod_b.load_hateful_memes(p("dev.jsonl"), "/r")


def test_gather_is_the_identity_without_a_group():
    rows = [{"a": 1}, {"a": 2}]
    assert suite.gather_results(rows) == rows


_RANK_SCRIPT = """
import json, sys, types
sys.path.insert(0, {root!r})
from otter_tpu_torch.benchmarks.models import base_model
from otter_tpu_torch.benchmarks.public_suite import evaluate as suite


class Scripted:
    max_batch_size = 2

    def __init__(self, **kw):
        self.kw = kw

    def generate_batch(self, prompts, images):
        return ["red" if int(p.split("Question:q")[-1].split("?")[0]) % 3
                else "blue" for p in prompts]


mod = types.ModuleType("otter_tpu_torch.benchmarks.models.scripted")
mod.Scripted = Scripted
sys.modules[mod.__name__] = mod
base_model.AVAILABLE_MODELS["scripted"] = "Scripted"
scores = suite.main(["--model", "scripted", "--dataset", "vqav2",
                     "--test_manifest", {manifest!r}, "--shots", "0",
                     "--device", "cpu", "--multi_host"])
import torch.distributed as dist
print("SCORE", dist.get_rank(), dist.get_world_size(), json.dumps(scores))
dist.destroy_process_group()
"""


def test_two_process_eval_gives_the_single_process_score(tmp_path):
    """`main --multi_host` starts a gloo group through the port's
    bootstrap; each of two ranks answers its shard and scores the
    gathered set: one global score on both, equal to one process's."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_parallel_worker import free_port
    items = [{"image": None, "question": f"q{i}?",
              "answers": (["red"] * 10 if i % 2 else ["blue"] * 10)}
             for i in range(7)]
    manifest = tmp_path / "items.json"
    manifest.write_text(json.dumps(items))

    class One(Scripted):
        def generate(self, prompt, image=None):
            i = int(prompt.split("Question:q")[-1].split("?")[0])
            return "red" if i % 3 else "blue"

    expected = suite.evaluate_vqa(One(), test_items=items)
    assert 0 < expected < 100
    script = _RANK_SCRIPT.format(root=ROOT, manifest=str(manifest))
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              cwd=str(tmp_path), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    got = {}
    for out, _ in outs:
        line = next(ln for ln in out.splitlines() if ln.startswith("SCORE"))
        _, rank, world, scores = line.split(" ", 3)
        got[int(rank)] = (int(world), json.loads(scores))
    assert got == {0: (2, [expected]), 1: (2, [expected])}
    # rank 0 prints the score line of the JAX main's format
    assert json.loads(outs[0][0].splitlines()[0]) == {
        "dataset": "vqav2", "shots": 0, "score": expected}
