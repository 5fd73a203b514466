"""The port's trainer entry point (`otter_tpu_torch.train.sft.main`) on the
tiny MPT config on the CPU: synthetic collated batches in MimicitLoader's
format, metrics, checkpoints, resume; and the CheckpointStore itself."""

import json

import numpy as np
import pytest
import torch

from helpers import TinyTokenizer
from otter_tpu_torch.config import OtterConfig
from otter_tpu_torch.data.mimicit import mask_answer_labels
from otter_tpu_torch.runtime.checkpoint import CheckpointStore
from otter_tpu_torch.train import sft
from otter_tpu_torch.train.args import TrainArgs, parse_args


def _batches(n: int, seed: int = 0, b: int = 2, s: int = 24):
    """n copies of one collated batch: media token, an <answer> span closed
    by <|endofchunk|>, eos, right padding on the last row."""
    cfg = OtterConfig.tiny("mpt")
    tok = TinyTokenizer()
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 200, (b, s)).astype(np.int64)
    ids[:, 0] = cfg.media_token_id
    ids[:, 6] = tok.specials["<answer>"]
    ids[:, 17] = tok.specials["<|endofchunk|>"]
    ids[:, 18] = tok.eos_token_id
    mask = np.ones((b, s), np.int64)
    ids[-1, 20:], mask[-1, 20:] = tok.pad_token_id, 0
    images = rng.standard_normal((b, 1, 1, 3, 28, 28)).astype(np.float32)
    batch = {"net_input": {"input_ids": ids, "attention_masks": mask,
                           "patch_images": images}}
    return [batch] * n


def _args(tmp_path, **kw):
    base = dict(model_config="tiny", precision="fp32", learning_rate=1e-2,
                warmup_steps=0, logging_steps=1, fused_ce_chunk=8,
                gradient_checkpointing=True, external_save_dir=str(tmp_path),
                run_name="tiny", save_steps_interval=2, seed=0)
    base.update(kw)
    return TrainArgs(**base)


def _losses(path):
    with open(path) as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f)]


def test_main_trains_logs_checkpoints_and_resumes(tmp_path):
    tok = TinyTokenizer()
    state = sft.main(_args(tmp_path), tok, _batches(3), device="cpu")
    run = tmp_path / "tiny"
    logged = _losses(run / "metrics.jsonl")
    assert [s for s, _ in logged] == [1, 2, 3]
    losses = [x for _, x in logged]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert state.step == 3
    store = CheckpointStore(str(run))
    assert store.steps() == [2, 3]          # periodic at 2, final at 3
    saved = {k: p.detach().clone() for k, p in state.trainable.items()}

    # resume: restores step 3 and epoch 1, then runs the second epoch
    state2 = sft.main(_args(tmp_path, num_epochs=2,
                            resume_from_checkpoint="latest"),
                      tok, _batches(3), device="cpu")
    assert state2.step == 6
    assert [s for s, _ in _losses(run / "metrics.jsonl")] == [1, 2, 3, 4, 5,
                                                                6]
    assert store.steps() == [3, 4, 6]       # keep the last 3

    # restoring step 3 into the resumed state brings the first run back
    restored, meta = store.restore(state2, step=3)
    assert restored.step == 3 and meta["epoch"] == 1
    for k, p in restored.trainable.items():
        torch.testing.assert_close(p.detach(), saved[k], atol=0, rtol=0)
    for k, m in restored.opt_state.master.items():
        torch.testing.assert_close(m, state.opt_state.master[k], atol=0,
                                   rtol=0)


def test_checkpoint_store_keeps_the_last_n(tmp_path):
    tok = TinyTokenizer()
    state = sft.main(_args(tmp_path, save_steps_interval=1,
                           delete_previous_checkpoint=True,
                           final_checkpoint=False), tok, _batches(2),
                     device="cpu")
    assert CheckpointStore(str(tmp_path / "tiny")).steps() == [2]
    assert state.step == 2


def test_main_needs_batches_until_the_loader_is_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sft.main(_args(tmp_path), TinyTokenizer(), None, device="cpu")


def test_prepare_batch_masks_labels_as_the_loader_format_says():
    tok = TinyTokenizer()
    batch = _batches(1)[0]
    out = sft.prepare_batch(batch, tok, TrainArgs())
    ids = batch["net_input"]["input_ids"]
    np.testing.assert_array_equal(out["labels"], mask_answer_labels(
        ids, answer_token_id=251, eoc_token_id=252, eos_token_id=2))
    # labelled: the answer span after <answer> up to <|endofchunk|>, and eos
    assert (out["labels"][0, 7:18] == ids[0, 7:18]).all()
    assert out["labels"][0, 18] == 2 and out["labels"][0, 6] == -100
    removed = sft.prepare_batch(batch, tok,
                                TrainArgs(remove_answer_token=True))
    assert (removed["input_ids"] != 251).all()


def test_parse_args_round_trips_the_dataclass():
    args = parse_args(["--model_config", "tiny", "--learning_rate", "3e-4",
                       "--gradient_checkpointing", "--final_checkpoint"])
    assert args.model_config == "tiny" and args.learning_rate == 3e-4
    assert args.gradient_checkpointing and not args.final_checkpoint


def test_profiler_trace_writes_the_trace_and_the_table(tmp_path):
    from otter_tpu_torch.runtime.metrics import profiler_trace
    with profiler_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert "aten::mm" in (tmp_path / "kernels.txt").read_text()
    with profiler_trace("") as prof:
        assert prof is None


def test_main_loads_an_hf_checkpoint_over_the_initial_weights(tmp_path):
    """`trained_ckpt`: an HF checkpoint of some frozen tensors (CLIP's
    first layer) loads over the seeded initial weights, as the JAX
    trainer's `load_otter_checkpoint` does; frozen, they leave training
    as they came in."""
    from otter_tpu_torch.models.convert import port_to_hf, save_state_dict
    from otter_tpu_torch.tools.random_weights import RandomParams
    cfg = OtterConfig.tiny("mpt")
    hf = {k: v for k, v in port_to_hf(RandomParams(
        cfg, "cpu", seed=9), cfg).items()
        if k.startswith("vision_encoder.vision_model.encoder.layers.0.")}
    ckpt = str(tmp_path / "trained.bin")
    save_state_dict(hf, ckpt)
    state = sft.main(_args(tmp_path, trained_ckpt=ckpt), TinyTokenizer(),
                     _batches(1), device="cpu")
    fc1 = state.model.vision_encoder.layers_0.fc1.kernel
    want = hf["vision_encoder.vision_model.encoder.layers.0.mlp.fc1.weight"]
    assert torch.equal(fc1, want.t().float())
