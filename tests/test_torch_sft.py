"""The port's trainer entry point (`otter_tpu_torch.train.sft.main`) on the
tiny MPT config on the CPU: synthetic collated batches in MimicitLoader's
format, metrics, checkpoints, resume; the data YAML chain and its losses
against the JAX package's; the HF export against the JAX store's; and the
CheckpointStore itself."""

import json

import numpy as np
import pytest
import torch

from helpers import TinyTokenizer, write_mimicit_fixture
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


# ── the YAML -> dataset -> loader chain and the HF export ────────────

def _two_group_yaml(tmp_path):
    """`write_mimicit_fixture`'s IMAGE_TEXT task (8 samples, 28x28 images)
    and an IMAGE_TEXT_IN_CONTEXT task over its images: 4 samples of three
    images, two in-context pairs each."""
    import yaml
    ypath = write_mimicit_fixture(tmp_path, np.random.default_rng(1))
    spec = yaml.safe_load(open(ypath))
    data = {f"IC_{i}": {"instruction": f"which one is {i}",
                        "answer": f"the {i} one",
                        "image_ids": [f"IMG_{(i + j) % 8}" for j in range(3)]}
            for i in range(4)}
    ins = tmp_path / "IC_instructions.json"
    ins.write_text(json.dumps({"data": data}))
    tc = tmp_path / "IC_train.json"
    tc.write_text(json.dumps({k: [f"IC_{(i + 1) % 4}", f"IC_{(i + 2) % 4}"]
                              for i, k in enumerate(data)}))
    spec["IMAGE_TEXT_IN_CONTEXT"] = {"IC": {
        "mimicit_path": str(ins), "train_config_path": str(tc),
        "images_path": spec["IMAGE_TEXT"]["DC"]["images_path"]}}
    ypath = tmp_path / "two.yaml"
    ypath.write_text(yaml.safe_dump(spec))
    return str(ypath)


def _yaml_args(tmp_path, yaml_path, **kw):
    base = dict(training_data_yaml=yaml_path, batch_size=2,
                patch_image_size=28, max_seq_len=64, workers=2,
                learning_rate=1e-4, num_epochs=2, fused_ce_chunk=8,
                gradient_checkpointing=False, mask_lm_head=True)
    base.update(kw)
    return _args(tmp_path, **base)


def _jax_args(args):
    from otter_tpu.train.args import TrainArgs as JaxTrainArgs
    fields = JaxTrainArgs.__dataclass_fields__
    return JaxTrainArgs(**{k: v for k, v in vars(args).items()
                           if k in fields})


def _jax_batches(args, tok, monkeypatch, epochs=1):
    """The JAX chain's train-step batches over the YAML: its
    `build_loaders` and `prepare_batch`, native decoder off."""
    from otter_tpu import native as jnative
    from otter_tpu.train import sft as jsft
    monkeypatch.setattr(jnative, "available", lambda: False)
    jargs = _jax_args(args)
    multi = jsft.build_loaders(jargs, None, tok, 0, 1)
    out = []
    for epoch in range(epochs):
        multi.set_epoch(epoch)
        out += [jsft.prepare_batch(b, tok, jargs) for b in multi]
    return out


def test_build_loaders_and_prepare_batch_give_the_jax_batches(
        tmp_path, monkeypatch):
    tok = TinyTokenizer()
    args = _yaml_args(tmp_path, _two_group_yaml(tmp_path))
    want = _jax_batches(args, tok, monkeypatch, epochs=2)
    multi = sft.build_loaders(args, OtterConfig.tiny("mpt"), tok, 0, 1)
    got = []
    for epoch in range(2):
        multi.set_epoch(epoch)
        got += [sft.prepare_batch(b, tok, args) for b in multi]
    assert len(got) == len(want) == 12
    assert {b["vision_x"].shape[1] for b in got} == {1, 3}
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0,
                                       err_msg=k)


def test_main_over_the_yaml_matches_jax_losses(tmp_path, monkeypatch):
    """`main` over the data YAML from the JAX parameters gives the losses
    of the JAX package's jitted `make_train_step` over the JAX chain's
    batches, in f32, within 1e-4 relative (two epochs, both task groups,
    the embedding-row mask, fused CE)."""
    import jax
    import jax.numpy as jnp
    from otter_tpu.train import step as jstep
    from torch_parity_helpers import jax_tiny_train
    cfg, model, params, flat = jax_tiny_train()
    tok = TinyTokenizer()
    args = _yaml_args(tmp_path, _two_group_yaml(tmp_path), run_name="yaml")
    batches = _jax_batches(args, tok, monkeypatch, epochs=2)
    trainable, _ = jstep.split_params(params, cfg)
    tx = jstep.make_optimizer(
        trainable, lr=args.learning_rate, schedule=args.lr_scheduler,
        warmup_steps=args.warmup_steps, total_steps=len(batches),
        weight_decay=args.weight_decay)
    state = jstep.TrainState.create(params, cfg, tx)
    step = jax.jit(jstep.make_train_step(
        model, cfg, tx, mask_embedding=True, fused_ce_chunk=8))
    want = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(m["loss"]))

    sft.main(args, tok, params=flat, device="cpu")
    got = [x for _, x in _losses(tmp_path / "yaml" / "metrics.jsonl")]
    assert len(got) == len(want) == 12
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _export_pair(tmp_path, dtype):
    """(port export, JAX export, port TrainState) of the tiny model's
    parameters after one port step (fp32: the JAX parameters themselves on
    both sides, the step skipped)."""
    from safetensors.torch import load_file
    from otter_tpu.runtime.checkpoint import CheckpointStore as JaxStore
    from otter_tpu.train import step as jstep
    from torch_parity_helpers import jax_tiny_train, port_cfg
    from otter_tpu_torch.models.convert import load_flax_params
    from otter_tpu_torch.models.otter import OtterVLM
    from otter_tpu_torch.train import step as tstep
    cfg, _, params, flat = jax_tiny_train()
    pcfg = port_cfg(cfg)
    model = OtterVLM(pcfg, dtype=dtype, device="cpu")
    load_flax_params(model, flat)
    trainable, _ = tstep.split_params(model, pcfg)
    tx = tstep.make_optimizer(trainable, lr=1e-2)
    state = tstep.TrainState.create(model, pcfg, tx)
    if dtype == torch.bfloat16:
        step = tstep.make_train_step(model, pcfg, tx, fused_ce_chunk=8)
        prepared = sft.prepare_batch(_batches(1)[0], TinyTokenizer(),
                                     TrainArgs())
        state, _ = step(state, prepared)
    port = CheckpointStore(str(tmp_path / "port")).export_hf(
        state.params, pcfg, str(tmp_path / "port.safetensors"))
    ref = JaxStore(str(tmp_path / "jax")).export_hf(
        jstep.TrainState.create(params, cfg, jstep.make_optimizer(
            jstep.split_params(params, cfg)[0])).params, cfg,
        str(tmp_path / "jax.safetensors"))
    return load_file(port), load_file(ref), state


def test_export_hf_matches_jax_in_f32(tmp_path):
    """The same parameters exported by both stores: the same HF names,
    shapes and dtypes (f32), the same values."""
    got, want, _ = _export_pair(tmp_path, torch.float32)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32, k
        assert torch.equal(got[k], v), k


def test_export_hf_of_a_bf16_model_writes_masters_and_widened_frozen(
        tmp_path):
    """A bf16 model after one step: the export's names, shapes and dtypes
    are JAX's (f32); every trainable tensor is the optimizer's f32 master
    bit for bit; every frozen one is its bf16 weight widened, so it equals
    JAX's f32 value within bf16's rounding (2^-8 relative), which is how
    the port's frozen leaves compare with the JAX export."""
    from otter_tpu_torch.models.convert import port_to_hf
    got, want, state = _export_pair(tmp_path, torch.bfloat16)
    assert sorted(got) == sorted(want)
    masters = port_to_hf(state.opt_state.master, state.model.cfg)
    frozen = port_to_hf({k: p.detach() for k, p in state.frozen.items()},
                        state.model.cfg)
    assert masters and sorted(got) == sorted({**masters, **frozen})
    assert any(t.dtype == torch.bfloat16 for t in frozen.values())
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32, k
        assert got[k].shape == v.shape, k
        if k in masters:
            assert torch.equal(got[k], masters[k].contiguous()), k
        else:
            # (norm scales and the like stay f32 in the bf16 model)
            assert torch.equal(got[k], frozen[k].float().contiguous()), k
            assert ((got[k] - v).abs() <= 2.0 ** -8 * v.abs()).all(), k
    moved = [k for k in masters if not torch.equal(
        masters[k].contiguous(), want[k])]
    assert moved                             # the step moved the masters

    # loaded back into a fresh bf16 model: every tensor the trained one's
    # (the f32 ones, norm scales and latents, keep the masters' values)
    from otter_tpu_torch.models.convert import load_otter_checkpoint
    from otter_tpu_torch.models.otter import OtterVLM
    fresh = OtterVLM(state.model.cfg, dtype=torch.bfloat16, device="cpu")
    load_otter_checkpoint(str(tmp_path / "port.safetensors"),
                          state.model.cfg, fresh)
    mine = dict(fresh.named_parameters())
    kinds = set()
    for k, p in state.model.named_parameters():
        assert mine[k].dtype == p.dtype and torch.equal(mine[k], p), k
        kinds.add(p.dtype)
    assert kinds == {torch.bfloat16, torch.float32}


def _tokenizer_dir(tmp_path):
    """A WordLevel tokenizer saved to a directory with ids below the tiny
    config's specials (chip_smoke.write_tokenizer, whose added tokens take
    the config's eoc and media ids), and a customized config giving the
    <answer> id the trainer's tokenizer gives it."""
    import chip_smoke
    cfg = OtterConfig.tiny("mpt").replace(eoc_token_id=250,
                                           media_token_id=251,
                                           answer_token_id=252)
    directory = chip_smoke.write_tokenizer(str(tmp_path / "tok"), cfg)
    custom = tmp_path / "custom.json"
    custom.write_text(json.dumps({"eoc_token_id": 250, "media_token_id": 251,
                                  "answer_token_id": 252}))
    return directory, str(custom)


def test_main_from_the_command_line_with_a_tokenizer_dir(tmp_path):
    """The entry point's flags: the data YAML, `--tokenizer` (a directory:
    `AutoTokenizer` plus Otter's tokens and <PAD>), `--save_hf_model`.
    It writes metrics.jsonl, a whole-state final checkpoint that
    `--resume_from_checkpoint` restores, and final_weights.safetensors,
    which `load_otter_checkpoint` loads into a fresh model equal to the
    trained one."""
    import chip_smoke
    from otter_tpu_torch.models.convert import (export_flax_params,
                                                load_otter_checkpoint)
    from otter_tpu_torch.models.otter import OtterVLM
    tok_dir, custom = _tokenizer_dir(tmp_path)
    yaml_path = chip_smoke.write_train_data(str(tmp_path / "data"), 0,
                                            n_single=4, n_context=2,
                                            image_size=32, long=False)
    argv = ["--training_data_yaml", yaml_path, "--tokenizer", tok_dir,
            "--model_config", "tiny", "--customized_config", custom,
            "--precision", "fp32", "--batch_size", "2",
            "--patch_image_size", "28", "--max_seq_len", "128",
            "--learning_rate", "1e-3", "--warmup_steps", "0",
            "--logging_steps", "1", "--fused_ce_chunk", "16",
            "--workers", "2", "--save_hf_model",
            "--external_save_dir", str(tmp_path), "--run_name", "cli"]
    state = sft.main(parse_args(argv), device="cpu")
    run = tmp_path / "cli"
    logged = _losses(run / "metrics.jsonl")
    assert [s for s, _ in logged] == [1, 2, 3] and state.step == 3
    assert all(np.isfinite([x for _, x in logged]))
    meta = json.loads((run / "checkpoint_3" / "meta.json").read_text())
    assert meta["trainable_only"] is False
    assert state.model.cfg.answer_token_id == 252

    fresh = OtterVLM(state.model.cfg, dtype=torch.float32, device="cpu")
    load_otter_checkpoint(str(run / "final_weights.safetensors"),
                          state.model.cfg, fresh)
    trained, loaded = export_flax_params(state.model), \
        export_flax_params(fresh)
    assert sorted(trained) == sorted(loaded)
    for k, v in trained.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)

    resumed = sft.main(parse_args(argv + ["--num_epochs", "2",
                                          "--resume_from_checkpoint",
                                          "latest"]), device="cpu")
    assert resumed.step == 6
    assert [s for s, _ in _losses(run / "metrics.jsonl")] == list(
        range(1, 7))


def test_main_refuses_a_bad_yaml_before_the_model(tmp_path, monkeypatch):
    from otter_tpu_torch.data import DataSpecError
    bad = tmp_path / "bad.yaml"
    bad.write_text("IMAGE_TEXT:\n  t: {mimicit_path: /nonexistent.json}\n")
    monkeypatch.setattr(sft, "build_model_and_config", None)
    with pytest.raises(DataSpecError, match="mimicit_path"):
        sft.main(_args(tmp_path, training_data_yaml=str(bad)),
                 TinyTokenizer(), device="cpu")


def test_trainer_entry_point_defaults_to_the_card(tmp_path):
    import os
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the trainer would run for real")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "otter_tpu_torch.train.sft",
         "--model_config", "tiny"], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=300)
    assert res.returncode != 0 and "CUDA" in res.stderr


@pytest.mark.parametrize("name", ["mpt7b", "mpt1b", "llama7b-video",
                                  "idefics9b", "tiny-idefics", "tiny"])
def test_config_factories_equal_the_jax_trainers(name):
    from otter_tpu.train import sft as jsft
    assert sft.CONFIG_FACTORIES[name]().to_dict() == \
        jsft.CONFIG_FACTORIES[name]().to_dict()


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
