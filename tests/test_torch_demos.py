"""The port's demos (`otter_tpu_torch.demos`) against the JAX package's:
`TestOtter` (one image, and in-context pairs) and `TestOtterVideo` answer
as the JAX demos do on the same tiny weights, `run_cases` and the
interactive loops give the same transcripts, frames are extracted from a
directory and from a video file through cv2, and the two entry points
run a checkpoint on the CPU as a user starts them."""

import functools
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from helpers import TinyTokenizer
from otter_tpu import config as jcfg
from otter_tpu.api import OtterForConditionalGeneration as JaxOtter
from otter_tpu.demos import demo_models as jdemo
from otter_tpu.demos import inference as jinference
from otter_tpu.demos import interactive as jinteractive
from otter_tpu.models.otter import OtterVLM as JaxOtterVLM
from otter_tpu_torch.api import OtterForConditionalGeneration as TorchOtter
from otter_tpu_torch.demos import demo_models, inference, interactive
from torch_parity_helpers import _quantized, port_cfg


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX TestOtter args, port TestOtter args): the tiny f32 MPT model,
    the flax init with gates at 0.6, on both sides."""
    cfg = jcfg.OtterConfig.tiny("mpt")
    params, flat = _quantized(
        JaxOtterVLM, cfg, cfg,
        (jnp.zeros((1, 1, 1, 3, 28, 28), jnp.float32),
         jnp.zeros((1, 8), jnp.int32)), 3, None, False)
    return (JaxOtter(cfg, params=params, dtype=jnp.float32),
            TorchOtter(port_cfg(cfg), params=flat, dtype=torch.float32,
                       device="cpu"))


def _demos(cls="TestOtter"):
    japi, tapi = _pair()
    kw = dict(patch_size=28, max_new_tokens=3)
    return (getattr(jdemo, cls)(model=japi, tok=TinyTokenizer(), **kw),
            getattr(demo_models, cls)(model=tapi, tok=TinyTokenizer(), **kw))


def _img(rng, h=28, w=28):
    return Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8))


def test_answers_and_transcripts_match_jax(tmp_path):
    """One image, then in-context pairs (two context images and the
    query), through `ask`, `run_cases` over a cases YAML and the
    interactive loops."""
    rng = np.random.default_rng(0)
    jd, td = _demos()
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"i{i}.png"))
        _img(rng, 30 + i, 28).save(paths[-1])
    cases = yaml.safe_load(yaml.safe_dump({"cases": [
        {"image": paths[0], "questions": ["what is this?", "how many?"]},
        {"image": paths[1], "question": "what is this?"}]}))["cases"]
    ours = inference.run_cases(td, cases)
    assert ours == jinference.run_cases(jd, cases) and len(ours) == 3
    context = [(paths[0], "what is it?", "a red square"),
               (paths[1], "and this?", "a blue dot")]
    for run, args in ((interactive.run_image, (paths[2],)),
                      (interactive.run_incontext, (paths[2], context))):
        transcripts = []
        for mod, demo in ((interactive, td), (jinteractive, jd)):
            questions = iter(["how many?", ""])

            def ask_user(prompt):
                try:
                    return next(questions)
                except StopIteration:
                    raise EOFError
            out = io.StringIO()
            getattr(mod, run.__name__)(demo, *args, input_fn=ask_user,
                                       out=out)
            transcripts.append(out.getvalue())
        assert transcripts[0] == transcripts[1]
        assert transcripts[0].count("GPT: ") == 1


def test_video_answers_and_frames_match_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i in range(6):
        _img(rng, 24, 32).save(frames_dir / f"f{i:02d}.png")
    ours = interactive.extract_frames(str(frames_dir), 4)
    ref = jinteractive.extract_frames(str(frames_dir), 4)
    assert [np.asarray(f).tolist() for f in ours] == \
        [np.asarray(f).tolist() for f in ref] and len(ours) == 4
    video = str(tmp_path / "v.avi")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 8,
                             (32, 24))
    for _ in range(10):
        writer.write((rng.random((24, 32, 3)) * 255).astype(np.uint8))
    writer.release()
    ours = interactive.extract_frames(video, 4)
    ref = jinteractive.extract_frames(video, 4)
    assert len(ours) == len(ref) == 4
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(ours, ref))
    jd, td = _demos("TestOtterVideo")
    assert td.ask("what happens?", ours) == jd.ask("what happens?", ref)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The tiny model's weights as an HF checkpoint, and a tokenizer
    directory, as a user hands them to the entry points."""
    import chip_smoke
    from otter_tpu_torch.config import OtterConfig
    from otter_tpu_torch.models.convert import (export_flax_params,
                                                port_to_hf, save_state_dict)
    d = tmp_path_factory.mktemp("demo")
    cfg = OtterConfig.tiny("mpt")
    model = _pair()[1].model
    sd = port_to_hf(export_flax_params(model), cfg)
    save_state_dict({k: torch.as_tensor(v) for k, v in sd.items()},
                    str(d / "model.safetensors"))
    tok = chip_smoke.write_tokenizer(str(d / "tok"), cfg)
    Image.fromarray(np.full((28, 28, 3), 90, np.uint8)).save(d / "a.png")
    return d, tok


def test_entry_points_run_a_checkpoint_on_the_cpu(checkpoint, monkeypatch):
    d, tok = checkpoint
    argv = ["--checkpoint", str(d / "model.safetensors"), "--tokenizer",
            tok, "--device", "cpu"]
    (d / "cases.yaml").write_text(yaml.safe_dump({"cases": [
        {"image": str(d / "a.png"), "question": "User what GPT"}]}))
    results = inference.main(["--config", str(d / "cases.yaml"),
                              "--model_config", "tiny", "--output",
                              str(d / "out.json"), "--max_new_tokens", "3"]
                             + argv)
    assert json.loads((d / "out.json").read_text()) == results
    assert len(results) == 1 and isinstance(results[0]["answer"], str)
    monkeypatch.setattr("sys.stdin", io.StringIO("User what GPT\n"))
    out = io.StringIO()
    monkeypatch.setattr("sys.stdout", out)
    interactive.main(["image", "--config", "tiny", "--image",
                      str(d / "a.png"), "--max-new-tokens", "3"] + argv)
    assert "GPT: " in out.getvalue()


def test_entry_points_default_to_the_card(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the demo would run for real")
    d, tok = checkpoint
    with pytest.raises(RuntimeError, match="CUDA"):
        interactive.main(["image", "--checkpoint",
                          str(d / "model.safetensors"), "--tokenizer", tok,
                          "--config", "tiny", "--image", str(d / "a.png")])
