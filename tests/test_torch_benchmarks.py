"""Port parity of the one-click eval harness (`otter_tpu_torch.benchmarks`)
against the JAX package's (`otter_tpu.benchmarks`): the OtterImage,
OtterVideo, Fuyu and Idefics adapters on the same tiny weights (f32, the
flax init loaded into the port through `load_flax_params`), `run` over
the bundled MME and POPE samples at f32 and int8, and the dataset
scorers on scripted answers.

Both sides run in this process with one `TinyTokenizer` class, whose ids
come from `hash` (equal within a process). The recording tokenizer keeps
every id list an adapter decodes, so that generated tokens are compared,
not only the texts they decode to."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from helpers import TinyTokenizer
from otter_tpu import config as jcfg
from otter_tpu.api import OtterForConditionalGeneration as JaxOtter
from otter_tpu.benchmarks import evaluate as jeval
from otter_tpu.benchmarks.datasets import (mathvista as jmathvista,
                                           mme as jmme, pope as jpope,
                                           scienceqa as jscienceqa)
from otter_tpu.benchmarks.gpt_judge import heuristic_judge as jjudge
from otter_tpu.benchmarks.models import fuyu as jfuyu
from otter_tpu.benchmarks.models import idefics as jidefics
from otter_tpu.benchmarks.models import otter_image as jotter
from otter_tpu.models.otter import OtterVLM as JaxOtterVLM
from otter_tpu_torch.api import OtterForConditionalGeneration as TorchOtter
from otter_tpu_torch.benchmarks import evaluate as teval
from otter_tpu_torch.benchmarks.datasets import (mathvista, mme, pope,
                                                 scienceqa)
from otter_tpu_torch.benchmarks.datasets.base_eval_dataset import (
    AVAILABLE_EVAL_DATASETS, load_sample_rows)
from otter_tpu_torch.benchmarks.gpt_judge import heuristic_judge
from otter_tpu_torch.benchmarks.models import base_model
from otter_tpu_torch.benchmarks.models import fuyu as tfuyu
from otter_tpu_torch.benchmarks.models import idefics as tidefics
from otter_tpu_torch.benchmarks.models import otter_image as totter
from torch_parity_helpers import (_quantized, fuyu_pair, idefics_pair,
                                  jax_tiny, port_cfg)

NEW = 3          # max_new_tokens of every adapter


class RecordingTokenizer(TinyTokenizer):
    """`TinyTokenizer` that keeps each id list it decodes."""

    def __init__(self):
        self.decoded = []

    def decode(self, ids, skip_special_tokens=True):
        self.decoded.append([int(i) for i in ids])
        return super().decode(ids, skip_special_tokens)


@functools.lru_cache(maxsize=None)
def otter_pair(quant=None):
    """(JAX api wrapper, port api wrapper) of the tiny MPT OtterVLM on the
    same weights: f32 (the flax init, gates at 0.6) or int8
    (`jax_tiny`: `quantize_params` of the unquantized init)."""
    if quant == "int8":
        cfg, _, params, flat = jax_tiny(0)
    else:
        cfg = jcfg.OtterConfig.tiny("mpt")
        params, flat = _quantized(
            JaxOtterVLM, cfg, cfg,
            (jnp.zeros((1, 1, 1, 3, 28, 28), jnp.float32),
             jnp.zeros((1, 8), jnp.int32)), 0, None, False)
    return (JaxOtter(cfg, params=params, dtype=jnp.float32),
            TorchOtter(port_cfg(cfg), params=flat, dtype=torch.float32,
                       device="cpu"))


def _adapters(module_j, module_t, cls, models, **kw):
    jtok, ttok = RecordingTokenizer(), RecordingTokenizer()
    return (getattr(module_j, cls)(model=models[0], tok=jtok, **kw),
            getattr(module_t, cls)(model=models[1], tok=ttok, **kw),
            jtok, ttok)


def _rows():
    return [(r["question"], r["image"]) for r in load_sample_rows("pope")]


def test_otter_image_adapter_matches_jax():
    ja, ta, jtok, ttok = _adapters(jotter, totter, "OtterImage",
                                   otter_pair(), patch_size=28,
                                   max_new_tokens=NEW)
    rows = _rows()
    for q, img in rows[:2]:
        assert ta.generate(q, img) == ja.generate(q, img)
        np.testing.assert_allclose(ta.eval_forward(q, "yes it is", img),
                                   ja.eval_forward(q, "yes it is", img),
                                   rtol=0, atol=1e-4)
    prompts = [f"<image>User: {q} GPT:<answer>" for q, _ in rows[2:4]]
    images = [img for _, img in rows[2:4]]
    assert ta.generate_batch(prompts, images) == \
        ja.generate_batch(prompts, images)
    assert ttok.decoded == jtok.decoded and len(ttok.decoded) == 4
    assert any(ttok.decoded[0])


def test_otter_video_adapter_matches_jax():
    ja, ta, jtok, ttok = _adapters(jotter, totter, "OtterVideo",
                                   otter_pair(), patch_size=28,
                                   max_new_tokens=NEW, num_frames=4)
    rng = np.random.default_rng(1)
    frames = [Image.fromarray((rng.random((40, 36, 3)) * 255).astype(
        np.uint8)) for _ in range(6)]
    q = "what happens in the video?"
    np.testing.assert_array_equal(ta._vision(frames), ja._vision(frames))
    assert ta._vision(frames).shape == (1, 1, 4, 3, 28, 28)
    assert ta.generate(q, frames) == ja.generate(q, frames)
    assert ttok.decoded == jtok.decoded
    np.testing.assert_allclose(ta.eval_forward(q, "a dog runs", frames),
                               ja.eval_forward(q, "a dog runs", frames),
                               rtol=0, atol=1e-4)


class FuyuTok(RecordingTokenizer):
    specials = dict(TinyTokenizer.specials)
    specials["\x04"] = 250


def _fuyu_processor(mod, cfg, tok):
    return mod.FuyuProcessor(
        tok, mod.FuyuImageProcessor(patch_size=cfg.patch_size,
                                    buckets=((8, 8),)),
        image_placeholder_id=cfg.image_placeholder_id,
        image_newline_id=cfg.image_newline_id)


@pytest.mark.parametrize("cls", ["Fuyu", "OtterHD"])
def test_fuyu_adapter_matches_jax(cls):
    """The port's `fuyu_generate` gives the tokens of the JAX adapter's
    own greedy loop (its cache rounded to another length)."""
    from otter_tpu.data import fuyu_processor as jproc
    from otter_tpu_torch.data import fuyu_processor as tproc
    from otter_tpu_torch.config import FuyuConfig
    cfg, jmodel, params, tmodel = fuyu_pair()
    jtok, ttok = FuyuTok(), FuyuTok()
    ja = getattr(jfuyu, cls)(model=jmodel, tok=jtok, cfg=cfg,
                             processor=_fuyu_processor(jproc, cfg, jtok),
                             max_new_tokens=NEW)
    ja.params = params
    ta = getattr(tfuyu, cls)(model=tmodel, tok=ttok,
                             cfg=FuyuConfig.from_dict(cfg.to_dict()),
                             processor=_fuyu_processor(tproc, cfg, ttok),
                             max_new_tokens=NEW)
    rng = np.random.default_rng(2)
    img = Image.fromarray((rng.random((8, 8, 3)) * 255).astype(np.uint8))
    q = "is there a red square in it?"
    assert ta.generate(q, img) == ja.generate(q, img)
    np.testing.assert_allclose(ta.eval_forward(q, "a square", img),
                               ja.eval_forward(q, "a square", img),
                               rtol=0, atol=1e-4)
    assert ttok.decoded == jtok.decoded and len(ttok.decoded) == 1
    assert any(ttok.decoded[0]) and ta.name == cls.lower()


class IdeficsTok(RecordingTokenizer):
    specials = {"<image>": 126, "<fake_token_around_image>": 127,
                "<end_of_utterance>": 124, "<answer>": 125, "<PAD>": 0}

    def _tok(self, text):
        ids = super()._tok(text)
        return [i if i < 120 else (i % 100) + 10 for i in ids]


def test_idefics_adapter_matches_jax():
    cfg, jmodel, params, tmodel = idefics_pair()
    jtok, ttok = IdeficsTok(), IdeficsTok()
    ja = jidefics.Idefics(model=jmodel, tok=jtok, cfg=cfg, params=params,
                          patch_size=28, max_new_tokens=NEW)
    ta = tidefics.Idefics(model=tmodel, tok=ttok, patch_size=28,
                          max_new_tokens=NEW)
    assert ta.cfg.eoc_token_id == cfg.eoc_token_id
    rows = _rows()
    q, img = rows[0]
    assert ta.generate(q, img) == ja.generate(q, img)
    np.testing.assert_allclose(ta.eval_forward(q, "yes it is", img),
                               ja.eval_forward(q, "yes it is", img),
                               rtol=0, atol=1e-4)
    prompts = [ta._prompt(q, True) for q, _ in rows[1:3]]
    images = [img for _, img in rows[1:3]]
    assert ta.generate_batch(prompts, images) == \
        ja.generate_batch(prompts, images)
    assert ttok.decoded == jtok.decoded and len(ttok.decoded) == 3


@pytest.mark.parametrize("quant", [None, "int8"])
def test_harness_over_the_samples_matches_jax(tmp_path, quant):
    """`run` over the bundled MME and POPE samples with the otter_image
    adapter on the same tiny model: every row's generated ids, the
    scores, the report files and the summary equal JAX's `run`."""
    japi, tapi = otter_pair(quant)
    out = {}
    for side, mod, api in (("jax", jeval, japi), ("port", teval, tapi)):
        tok = RecordingTokenizer()
        config = {"models": [{"name": "otter_image", "model": api,
                              "tok": tok, "patch_size": 28,
                              "max_new_tokens": NEW}],
                  "datasets": [{"name": "mme", "data_path": "sample"},
                               {"name": "pope", "data_path": "sample"}]}
        res = mod.run(config, str(tmp_path / side))
        out[side] = res, tok.decoded, sorted(
            f.name.split("_20")[0] for f in (tmp_path / side).iterdir())
    (jres, jids, jfiles), (tres, tids, tfiles) = out["jax"], out["port"]
    assert tids == jids and len(tids) == 17
    assert tres == jres
    assert tfiles == jfiles == ["otter_image_mme", "otter_image_pope",
                                "summary"]
    overall = tres["otter_image"]["pope"]["overall"]
    assert 0.0 <= overall["accuracy"] <= 1.0
    assert set(tres["otter_image"]["mme"]) == {"Perception", "Cognition"}


def test_registries_and_the_descoped_models():
    from otter_tpu.benchmarks.datasets import base_eval_dataset as jds
    from otter_tpu.benchmarks.models import base_model as jbm
    assert AVAILABLE_EVAL_DATASETS == jds.AVAILABLE_EVAL_DATASETS
    assert base_model.AVAILABLE_MODELS == jbm.AVAILABLE_MODELS
    assert base_model.DESCOPED_MODELS == jbm.DESCOPED_MODELS
    with pytest.raises(NotImplementedError, match="de-scoped"):
        base_model.load_model("video_chat")
    model = base_model.load_model("otter_image", {
        "name": "otter_image", "model": otter_pair()[1],
        "tok": TinyTokenizer(), "patch_size": 28})
    assert isinstance(model, totter.OtterImage)


class Scripted:
    """Answers from a fixed question -> response mapping."""

    def __init__(self, answers):
        self.answers = answers

    def generate(self, question, image=None):
        return next((v for k, v in self.answers.items() if k in question),
                    "unknown")

    def eval_forward(self, *a, **k):
        return 0.0


_MME_ROWS = [
    {"id": "count_1", "instruction": "q1", "answer": "Yes",
     "image_ids": ["i1"], "images": [None]},
    {"id": "count_2", "instruction": "q2", "answer": "No",
     "image_ids": ["i1"], "images": [None]},
    {"id": "code_1", "instruction": "q3", "answer": "Yes",
     "image_ids": ["i2"], "images": [None]},
    {"id": "color_1", "instruction": "q4", "answer": "No",
     "image_ids": ["i3"], "images": [None]},
]
_POPE_ROWS = [
    {"category": c, "question": f"is there a {o}", "answer": a,
     "image": None}
    for c, o, a in (("random", "dog", "yes"), ("random", "cat", "no"),
                    ("adversarial", "car", "no"), ("popular", "cup", "yes"),
                    ("popular", "bus", "no"))]
_ANSWERS = {"q1": "Yes.", "q2": "yes", "q3": "No", "q4": "Nope",
            "dog": "yes", "cat": "yes", "car": "no", "cup": "No, none",
            "bus": "nothing"}


@pytest.mark.parametrize("name", ["mme", "pope", "scienceqa", "mathvista"])
def test_scorers_match_jax(name):
    model = Scripted(dict(_ANSWERS, color="B. blue", sum="the result is 7",
                          area="It is 3.14"))
    if name == "mme":
        pair = (mme.MMEDataset(rows=_MME_ROWS),
                jmme.MMEDataset(rows=_MME_ROWS))
    elif name == "pope":
        pair = (pope.PopeDataset(rows=_POPE_ROWS),
                jpope.PopeDataset(rows=_POPE_ROWS))
    elif name == "scienceqa":
        rows = [{"question": "what color", "choices": ["red", "blue"],
                 "answer": 1, "hint": "", "image": None},
                {"question": "which shape", "choices": ["cube", "ball"],
                 "answer": 0, "hint": "h", "image": None}]
        pair = (scienceqa.ScienceQADataset(rows=rows),
                jscienceqa.ScienceQADataset(rows=rows))
    else:
        rows = [{"question": "what is the sum", "answer": "7",
                 "answer_type": "integer", "image": None},
                {"question": "what is the area", "answer": "3.14",
                 "answer_type": "float", "precision": 2, "image": None}]
        pair = (mathvista.MathVistaDataset(rows=rows),
                jmathvista.MathVistaDataset(rows=rows))
    ours, ref = (ds.evaluate(model) for ds in pair)
    assert ours == ref


@pytest.mark.parametrize("pred,ref", [
    ("A red ball.", "red ball"), ("a blue cube", "red ball"),
    ("Yes, it is", "yes"), ("", "something")])
def test_heuristic_judge_matches_jax(pred, ref):
    assert heuristic_judge("q", pred, ref) == jjudge("q", pred, ref)
    assert mme.parse_pred_ans(pred) == jmme.parse_pred_ans(pred)
    assert pope.parse_pred(pred) == jpope.parse_pred(pred)


def test_gpt_judge_posts_through_an_injected_client(monkeypatch):
    """The judge's HTTP post goes through `requests.post`, imported inside
    the call: a fake stands in for it and nothing leaves the process."""
    import sys
    import types
    from otter_tpu_torch.benchmarks import gpt_judge
    calls = []

    def post(url, headers=None, data=None, timeout=None):
        calls.append((url, data))
        return types.SimpleNamespace(
            json=lambda: {"choices": [{"message": {"content": "7"}}]},
            raise_for_status=lambda: None, status_code=200)

    monkeypatch.setitem(sys.modules, "requests",
                        types.SimpleNamespace(post=post))
    out = gpt_judge.get_chat_response("what is 3 + 4?", api_key="k",
                                      sleep_time=0)
    assert out == "7" and len(calls) == 1
    assert "what is 3 + 4?" in calls[0][1]
    assert gpt_judge.judge_correct("q", "a red ball", "red ball",
                                   api_key="") is True


def test_gpt4v_posts_the_image_through_an_injected_client(monkeypatch):
    import sys
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    import types
    from otter_tpu_torch.benchmarks.models.gpt4v import OpenAIGPT4Vision
    calls = []

    def post(url, headers=None, json=None, timeout=None):
        calls.append(json)
        return types.SimpleNamespace(
            json=lambda: {"choices": [{"message": {"content": "a cat"}}]},
            raise_for_status=lambda: None)

    monkeypatch.setitem(sys.modules, "requests",
                        types.SimpleNamespace(post=post))
    img = Image.fromarray(np.full((8, 8, 3), 30, np.uint8))
    model = OpenAIGPT4Vision(api_key="k", max_new_tokens=7)
    assert model.generate("what is this?", img) == "a cat"
    (content,) = [m["content"] for m in calls[0]["messages"]]
    assert content[0] == {"type": "text", "text": "what is this?"}
    assert content[1]["image_url"]["url"].startswith(
        "data:image/png;base64,")
    assert calls[0]["max_tokens"] == 7
    with pytest.raises(RuntimeError, match="OPENAI_API_KEY"):
        OpenAIGPT4Vision(api_key="").generate("q")
