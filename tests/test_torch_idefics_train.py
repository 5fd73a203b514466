"""The port's trainer on the IDEFICS family: `sft.main(model_name="idefics",
model_config="tiny-idefics")` on the CPU, and one train step against the
JAX package's `otter_tpu.train.step` on the same tiny f32 weights (non-zero
tanh gates, moved norms). Only the perceiver, the gated xattn blocks and
the decoupled additional vocab (`additional_embedding`, `additional_fc`)
train; every frozen tensor stays bit-identical. Tolerances as in
`test_torch_train.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from helpers import TinyTokenizer
from otter_tpu import config as jcfg
from otter_tpu.models.idefics import IdeficsVLM as JaxIdeficsVLM
from otter_tpu.train import step as jstep
from otter_tpu_torch.models.convert import export_flax_params, load_flax_params
from otter_tpu_torch.models.idefics import IdeficsVLM
from otter_tpu_torch.train import sft
from otter_tpu_torch.train import step as tstep
from otter_tpu_torch.train.args import TrainArgs
from test_torch_train import LR, _assert_params_close
from torch_parity_helpers import idefics_flat, idefics_port_cfg

TRAINABLE_ROOTS = ("perceiver", "additional_embedding", "additional_fc")


class IdeficsTrainTok(TinyTokenizer):
    """The special ids `sft.prepare_batch` asks for, inside the tiny
    idefics vocabulary (120 + 8 additional)."""
    specials = {"<image>": 126, "<answer>": 125, "<|endofchunk|>": 124,
                "<PAD>": 0}


def _batch(seed: int = 0, b: int = 2, s: int = 20):
    """A collated batch in MimicitLoader's format: one image a sample
    (the media token at 1), an <answer> span closed by <|endofchunk|> and
    eos, right padding on the last row."""
    tok = IdeficsTrainTok()
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 120, (b, s)).astype(np.int64)
    ids[:, 1] = tok.specials["<image>"]
    ids[:, 6] = tok.specials["<answer>"]
    ids[:, 15] = tok.specials["<|endofchunk|>"]
    ids[:, 16] = tok.eos_token_id
    mask = np.ones((b, s), np.int64)
    ids[-1, 18:], mask[-1, 18:] = tok.pad_token_id, 0
    images = rng.standard_normal((b, 1, 1, 3, 28, 28)).astype(np.float32)
    return {"net_input": {"input_ids": ids, "attention_masks": mask,
                          "patch_images": images}}


def _trainable(path: str) -> bool:
    root = path.split("/")[0]
    return root in TRAINABLE_ROOTS or root.startswith("xattn_")


def _args(tmp_path, **kw):
    base = dict(model_name="idefics", model_config="tiny-idefics",
                precision="fp32", learning_rate=1e-2, warmup_steps=0,
                logging_steps=1, fused_ce_chunk=0,
                gradient_checkpointing=True, external_save_dir=str(tmp_path),
                run_name="tiny-idefics", final_checkpoint=False, seed=0)
    base.update(kw)
    return TrainArgs(**base)


def test_sft_main_trains_idefics(tmp_path):
    """Three steps of `sft.main`: finite, falling loss; the trainable set
    is the idefics one; the frozen towers (ViT, wte, lm_head, decoder
    layers) leave training bit for bit as they came in."""
    params = {k: v.copy() for k, v in idefics_flat().items()}
    state = sft.main(_args(tmp_path), IdeficsTrainTok(), [_batch()] * 3,
                     params=params, device="cpu")
    assert isinstance(state.model, IdeficsVLM) and state.step == 3
    assert state.trainable and all(_trainable(k) for k in state.trainable)
    assert {k.split("/")[0] for k in state.trainable} >= {
        "perceiver", "xattn_0", "xattn_2", "additional_embedding",
        "additional_fc"}
    assert not any(_trainable(k) for k in state.frozen)
    for k, p in state.frozen.items():
        np.testing.assert_array_equal(
            p.detach().numpy(), params["params/" + k], err_msg=k)
    moved = [k for k, p in state.trainable.items() if not np.array_equal(
        p.detach().numpy(), params["params/" + k])]
    assert set(moved) == set(state.trainable)
    with open(tmp_path / "tiny-idefics" / "metrics.jsonl") as f:
        import json
        losses = [json.loads(l)["loss"] for l in f]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_fused_cross_entropy_is_refused_for_idefics(tmp_path):
    """The idefics forward has no skip_head (the JAX one refuses it too):
    the trainer asks for fused_ce_chunk=0 instead of failing in the
    forward."""
    with pytest.raises(ValueError, match="fused_ce_chunk=0"):
        sft.main(_args(tmp_path, fused_ce_chunk=8), IdeficsTrainTok(),
                 [_batch()], params=dict(idefics_flat()), device="cpu")


def test_train_step_matches_jax():
    """One step (lr 1e-4, no fused CE) from the same weights and batch:
    loss and grad norm within 1e-5, every trainable parameter after the
    step within `test_torch_train`'s bound, the frozen ones untouched."""
    cfg = jcfg.idefics_tiny()
    flat = {k[len("params/"):]: v for k, v in idefics_flat().items()}
    tok = IdeficsTrainTok()
    args = TrainArgs(fused_ce_chunk=0)
    batch = sft.prepare_batch(_batch(1), tok, args)

    jparams = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    jtrain, _ = jstep.split_params(jparams, cfg)
    jtx = jstep.make_optimizer(jtrain, lr=LR, total_steps=10)
    jstate = jstep.TrainState.create(jparams, cfg, jtx)
    jstate, jm = jax.jit(jstep.make_train_step(JaxIdeficsVLM(cfg), cfg,
                                               jtx))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = {k: np.asarray(v) for k, v in
           traverse_util.flatten_dict(jstate.trainable, sep="/").items()}

    pcfg = idefics_port_cfg(cfg)
    model = IdeficsVLM(pcfg, dtype=torch.float32, device="cpu")
    load_flax_params(model, flat)
    trainable, frozen = tstep.split_params(model, pcfg)
    assert set(trainable) == set(ref)
    tx = tstep.make_optimizer(trainable, lr=LR, total_steps=10)
    state = tstep.TrainState.create(model, pcfg, tx)
    state, m = tstep.make_train_step(model, pcfg, tx)(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5, atol=1e-5)
    after = export_flax_params(model)
    _assert_params_close(after, ref, sorted(ref), start=flat)
    for k in frozen:
        np.testing.assert_array_equal(after[k], flat[k], err_msg=k)
