"""Port parity of Flamingo pretraining (`otter_tpu_torch.train.pretrain`)
against the JAX package's (`otter_tpu.train.pretrain`) on the tiny MPT
config in f32 on the CPU: the label policies, one step over a LAION and an
MMC4 batch (losses within 1e-5 relative, the trainable gradients within
1e-4 * max|JAX|, the parameters after AdamW within 1e-5, with the
near-eps allowance of `test_torch_train.py`), and `main` over tar shards
written in the test, with its epoch resume and its refusals."""

import functools
import io
import json
import os
import subprocess
import sys
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from PIL import Image

from otter_tpu.train import pretrain as jpre
from otter_tpu.train import step as jstep
from otter_tpu_torch.models.convert import export_flax_params
from otter_tpu_torch.train import pretrain
from otter_tpu_torch.train import step as tstep
from torch_parity_helpers import jax_tiny_train, port_cfg, torch_tiny_train

LR = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree):
    return {k: np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def test_label_policies_match_jax():
    rng = np.random.default_rng(0)
    M, E, P = 253, 252, 0
    ids = rng.choice([P, M, E, 11, 12, 13, 14, 15], (6, 20)).astype(np.int32)
    ids[:, 0] = rng.choice([M, 11], 6)
    np.testing.assert_array_equal(pretrain.pair_labels(ids, P, M),
                                  jpre.pair_labels(ids, P, M))
    np.testing.assert_array_equal(pretrain.interleaved_labels(ids, P, M, E),
                                  jpre.interleaved_labels(ids, P, M, E))


def _batches(cfg):
    """A LAION batch (one image, pair labels) and an MMC4 batch (three
    image slots, interleaved labels, right padding), numpy."""
    rng = np.random.default_rng(4)
    size = cfg.vision.image_size
    m, e = cfg.media_token_id, cfg.eoc_token_id
    ids = rng.integers(5, 200, (2, 12)).astype(np.int32)
    ids[:, 0], ids[:, 9] = m, e
    ids[1, 10:] = 0
    laion = {"vision_x": rng.standard_normal((2, 1, 1, 3, size, size)
                                             ).astype(np.float32),
             "input_ids": ids, "attention_mask": (ids != 0).astype(np.int32),
             "labels": jpre.pair_labels(ids, 0, m)}
    ids = rng.integers(5, 200, (2, 20)).astype(np.int32)
    ids[:, [2, 9]] = m
    ids[:, [7, 15]] = e
    ids[0, 16] = m
    ids[1, 17:] = 0
    mmc4 = {"vision_x": rng.standard_normal((2, 3, 1, 3, size, size)
                                            ).astype(np.float32),
            "input_ids": ids, "attention_mask": (ids != 0).astype(np.int32),
            "labels": jpre.interleaved_labels(ids, 0, m, e)}
    return laion, mmc4


@functools.lru_cache(maxsize=None)
def _jax_step(attend_prev):
    cfg, model, params, _ = jax_tiny_train()
    cfg = cfg.replace(use_media_placement_augmentation=True)
    laion, mmc4 = _batches(cfg)
    jl = {k: jnp.asarray(v) for k, v in laion.items()}
    jm = {k: jnp.asarray(v) for k, v in mmc4.items()}
    trainable, frozen = jstep.split_params(params, cfg)
    tx = jstep.make_optimizer(trainable, lr=LR, total_steps=10)
    state = jstep.TrainState.create(params, cfg, tx)

    def total(tr):
        out = 0.0
        for mult, b in ((0.2, jl), (1.0, jm)):
            logits, _, _ = model.apply(
                {"params": jstep.merge_params(tr, frozen)}, b["vision_x"],
                b["input_ids"], attention_mask=b["attention_mask"],
                attend_previous=attend_prev)
            out = out + mult * jstep.causal_lm_loss(logits, b["labels"])[0]
        return out

    grads = _flat(jax.jit(jax.grad(total))(trainable))
    step = jax.jit(jpre.make_pretrain_step(model, cfg, tx),
                   static_argnames=("attend_prev",))
    state, metrics = step(state, jl, jm, attend_prev=attend_prev)
    return ({k: float(v) for k, v in metrics.items()}, grads,
            _flat(trainable), _flat(state.trainable))


@pytest.mark.parametrize("attend_prev", [True, False])
def test_one_step_matches_jax(attend_prev):
    ref_metrics, ref_grads, start, ref_params = _jax_step(attend_prev)
    cfg, _, _, _ = jax_tiny_train()
    pcfg = port_cfg(cfg).replace(use_media_placement_augmentation=True)
    model = torch_tiny_train()
    trainable, frozen = tstep.split_params(model, pcfg)
    frozen_before = {k: p.detach().clone() for k, p in frozen.items()}
    tx = tstep.make_optimizer(trainable, lr=LR, total_steps=10)
    seen = {}
    update = tx.update

    def capture(grads, opt_state, params):
        seen.update({k: g.detach().clone() for k, g in grads.items()})
        return update(grads, opt_state, params)

    tx.update = capture
    state = tstep.TrainState.create(model, pcfg, tx)
    step = pretrain.make_pretrain_step(model, pcfg, tx)
    laion, mmc4 = _batches(cfg)
    state, metrics = step(state, laion, mmc4, attend_prev=attend_prev)
    assert state.step == 1
    for k in ("loss", "loss_laion", "loss_mmc4"):
        np.testing.assert_allclose(float(metrics[k]), ref_metrics[k],
                                   rtol=1e-5, err_msg=k)
    assert set(seen) == set(ref_grads)
    for k, g in ref_grads.items():
        np.testing.assert_allclose(seen[k].numpy(), g, rtol=0,
                                   atol=1e-4 * float(np.abs(g).max()),
                                   err_msg=k)
    got = export_flax_params(model)
    for k, ref in ref_params.items():
        tol = 1e-5 + LR / 2 * (np.abs(ref - start[k]) < LR / 2)
        assert (np.abs(got[k] - ref) <= tol).all(), k
    for k, p in frozen.items():
        torch.testing.assert_close(p, frozen_before[k], atol=0, rtol=0)


# ── main over shards ────────────────────────────────────────────────

def _add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _png(rng, n):
    buf = io.BytesIO()
    Image.fromarray((rng.random((n, n, 3)) * 255).astype(np.uint8)).save(
        buf, "PNG")
    return buf.getvalue()


def _write_shards(d, seed=0):
    """Two LAION shards of 6 pairs and two MMC4 shards of 4 documents
    (two images each, over 10 KB) in `d`; returns the brace patterns."""
    import base64
    rng = np.random.default_rng(seed)
    for s in range(2):
        with tarfile.open(os.path.join(d, f"laion-{s}.tar"), "w") as tf:
            for i in range(6):
                _add(tf, f"{s}{i:03d}.jpg", _png(rng, 24))
                _add(tf, f"{s}{i:03d}.txt", f"w{i} w{i + 3} w7".encode())
        with tarfile.open(os.path.join(d, f"mmc4-{s}.tar"), "w") as tf:
            for i in range(4):
                doc = {"text_list": [f"w{i}", "w3 w4", "w5", "w6 w7 w8"],
                       "image_info": [
                           {"image_base64": base64.b64encode(
                               _png(rng, 64)).decode(), "matched_sim": 0.5,
                            "matched_text_index": j} for j in (1, 3)]}
                _add(tf, f"{s}{i:03d}.json", json.dumps(doc).encode())
    return (os.path.join(d, "laion-{0..1}.tar"),
            os.path.join(d, "mmc4-{0..1}.tar"))


def _argv(tmp_path, laion, mmc4, tok_dir, *extra):
    return ["--laion_shards", laion, "--mmc4_shards", mmc4, "--tokenizer",
            tok_dir, "--precision", "fp32",
            "--patch_image_size", "28", "--batch_size_laion", "4",
            "--batch_size_mmc4", "2", "--train_num_samples_laion", "12",
            "--train_num_samples_mmc4", "6", "--workers", "1",
            "--warmup_steps", "0", "--learning_rate", "1e-3",
            "--logging_steps", "1", "--external_save_dir", str(tmp_path),
            "--run_name", "pre", *extra]


def _logged(run):
    with open(run / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_main_trains_over_shards_and_resumes(tmp_path, monkeypatch):
    """`main` as a user runs it (its default `--model_config mpt1b`, here
    the tiny MPT config): a tokenizer directory (Flamingo's two tokens land
    on the config's ids), LAION and MMC4 shards; both losses logged each
    step, the frozen tower untouched, a checkpoint an epoch; a second call
    with --num_epochs 2 resumes at epoch 1 from the saved step."""
    import chip_smoke
    from otter_tpu_torch.config import OtterConfig
    monkeypatch.setitem(pretrain.PRESETS, "mpt1b",
                        lambda: OtterConfig.tiny("mpt"))
    tok_dir = chip_smoke.write_tokenizer(str(tmp_path / "tok"),
                                         OtterConfig.tiny("mpt"))
    laion, mmc4 = _write_shards(str(tmp_path))
    state = pretrain.main(_argv(tmp_path, laion, mmc4, tok_dir),
                          device="cpu")
    run = tmp_path / "pre"
    logged = _logged(run)
    assert [r["step"] for r in logged] == [1, 2, 3] and state.step == 3
    for r in logged:
        assert np.isfinite([r["loss"], r["loss_laion"], r["loss_mmc4"]]).all()
        np.testing.assert_allclose(
            r["loss"], 0.2 * r["loss_laion"] + r["loss_mmc4"], rtol=1e-5)
    meta = json.loads((run / "checkpoint_3" / "meta.json").read_text())
    assert meta["epoch"] == 1 and meta["trainable_only"] is False
    frozen = {k: p.detach().clone() for k, p in state.frozen.items()}
    trained = {k: p.detach().clone() for k, p in state.trainable.items()}

    calls = []
    make = pretrain.make_pretrain_step

    def counting(*a, **kw):
        step = make(*a, **kw)

        def wrapped(state, *b, **k2):
            calls.append(state.step)
            return step(state, *b, **k2)
        return wrapped

    pretrain.make_pretrain_step = counting
    try:
        resumed = pretrain.main(_argv(tmp_path, laion, mmc4, tok_dir,
                                      "--num_epochs", "2"), device="cpu")
    finally:
        pretrain.make_pretrain_step = make
    assert calls == [3, 4, 5] and resumed.step == 6
    assert [r["step"] for r in _logged(run)] == [1, 2, 3, 4, 5, 6]
    meta = json.loads((run / "checkpoint_6" / "meta.json").read_text())
    assert meta["epoch"] == 2
    for k, p in resumed.frozen.items():
        torch.testing.assert_close(p, frozen[k], atol=0, rtol=0)
    assert all(not torch.equal(p, trained[k])
               for k, p in resumed.trainable.items()
               if not k.endswith(("attn_gate", "ff_gate")))


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--fsdp", "2"],
                                  ["--tp", "2"], ["--multi_host"]])
def test_main_refuses_multi_device(flag, monkeypatch):
    """One process cannot fill a mesh of two ranks (create_mesh's
    ValueError), and --multi_host without a rendezvous address raises
    before anything loads. tests/test_torch_parallel.py runs main across
    two processes."""
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    err = RuntimeError if flag == ["--multi_host"] else ValueError
    with pytest.raises(err, match="MASTER_ADDR|device"):
        pretrain.main(["--laion_shards", "x.tar", "--tokenizer", "t"] + flag,
                      device="cpu")


def test_main_requires_shards_as_jax_does():
    with pytest.raises(SystemExit):
        jpre.main(["--tokenizer", "x"])
    with pytest.raises(SystemExit):
        pretrain.main(["--tokenizer", "x"], device="cpu")
    ours = pretrain.PretrainArgs()
    ref = jpre.PretrainArgs()
    assert dataclass_fields(ours) == dataclass_fields(ref)


def dataclass_fields(args):
    return {k: getattr(args, k) for k in args.__dataclass_fields__}


def test_entry_point_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the trainer would run for real")
    res = subprocess.run(
        [sys.executable, "-m", "otter_tpu_torch.train.pretrain",
         "--laion_shards", "x.tar", "--tokenizer", str(tmp_path)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    assert res.returncode != 0 and "CUDA" in res.stderr
