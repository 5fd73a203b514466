"""Port parity of the OtterHD / Fuyu full fine-tune
(`otter_tpu_torch.train.fuyu_sft`) against the JAX package's
(`otter_tpu.train.fuyu_sft`): the batcher's arrays exact (dynamic
resolution drawn from the same `random.Random`), and one full-model step
on the tiny FuyuVLM in f32 on the CPU (loss within 1e-5 relative, every
parameter within 1e-5 with the near-eps allowance of
`test_torch_train.py`); remat and the 8-bit optimizer on the port's
side."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from PIL import Image

from helpers import TinyTokenizer
from otter_tpu.data.fuyu_processor import FuyuImageProcessor as JaxFIP
from otter_tpu.data.fuyu_processor import FuyuProcessor as JaxFP
from otter_tpu.train import fuyu_sft as jfs
from otter_tpu.train import step as jstep
from otter_tpu_torch.data.fuyu_processor import (FuyuImageProcessor,
                                                 FuyuProcessor)
from otter_tpu_torch.data.templates import format_pair
from otter_tpu_torch.models.convert import export_flax_params
from otter_tpu_torch.train import fuyu_sft
from otter_tpu_torch.train import step as tstep
from torch_parity_helpers import fuyu_pair

LR = 1e-4


class FuyuTok(TinyTokenizer):
    specials = dict(TinyTokenizer.specials)
    specials["\x04"] = 250


def _processors(cfg, patch_size, buckets=None):
    kw = dict(image_placeholder_id=cfg.image_placeholder_id,
              image_newline_id=cfg.image_newline_id)
    ikw = dict(patch_size=patch_size)
    if buckets is not None:
        ikw["buckets"] = buckets
    return (FuyuProcessor(FuyuTok(), FuyuImageProcessor(**ikw), **kw),
            JaxFP(FuyuTok(), JaxFIP(**ikw), **kw))


def _samples(seed, sizes):
    rng = np.random.default_rng(seed)
    texts = [format_pair("what is shown", "a red square", "fuyu") + "\x04",
             format_pair("count the dots", "three dots", "fuyu") + "\x04"]
    images = [Image.fromarray((rng.random((h, w, 3)) * 255).astype(
        np.uint8)) for h, w in sizes]
    return texts, images


def _assert_batch_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_dynamic_resolution_batches_match_jax():
    """OtterHD's patch size, the three dynamic resolutions drawn from
    `random.Random(seed)` call by call, labels from the \\x04 span."""
    cfg, _, _, _ = fuyu_pair()
    ours, ref = _processors(cfg, 30)
    b1 = fuyu_sft.FuyuBatcher(ours, dynamic_resolution=True, seed=3)
    b2 = jfs.FuyuBatcher(ref, dynamic_resolution=True, seed=3)
    shapes = set()
    for i in range(4):
        texts, images = _samples(i, [(40, 50), (64, 32)])
        got, want = b1(texts, images), b2(texts, images)
        _assert_batch_equal(got, want)
        assert (got["labels"] != -100).sum() > 0
        shapes.add(got["image_patches"].shape[1])
    assert len(shapes) > 1
    assert fuyu_sft.DYNAMIC_RESOLUTIONS == jfs.DYNAMIC_RESOLUTIONS


def _batch(cfg):
    ours, ref = _processors(cfg, cfg.patch_size, ((8, 8),))
    texts, images = _samples(7, [(8, 8), (8, 8)])
    got = fuyu_sft.FuyuBatcher(ours)(texts, images)
    _assert_batch_equal(got, jfs.FuyuBatcher(ref)(texts, images))
    return got


@functools.lru_cache(maxsize=None)
def _jax_step():
    cfg, model, params, _ = fuyu_pair()
    params = params["params"]
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    tx = jstep.make_optimizer(params, lr=LR, total_steps=10)
    state = {"params": params, "opt_state": tx.init(params),
             "step": jnp.zeros((), jnp.int32)}
    state, metrics = jax.jit(jfs.make_fuyu_train_step(model, tx))(state,
                                                                   batch)
    flat = lambda t: {k: np.asarray(v) for k, v in
                      traverse_util.flatten_dict(t, sep="/").items()}
    return float(metrics["loss"]), flat(params), flat(state["params"])


def _port_model(remat=False, dtype=torch.float32):
    from otter_tpu_torch.models.fuyu import FuyuVLM
    cfg, _, _, tmodel = fuyu_pair()
    model = FuyuVLM(tmodel.cfg, dtype=dtype, device="cpu", remat=remat)
    model.load_state_dict(tmodel.state_dict())
    return cfg, model


@pytest.mark.parametrize("remat", [False, True])
def test_one_full_step_matches_jax(remat):
    ref_loss, start, ref_params = _jax_step()
    cfg, model = _port_model(remat)
    tx = tstep.make_optimizer([tstep.flax_path(n) for n, _ in
                               model.named_parameters()], lr=LR,
                              total_steps=10)
    state = fuyu_sft.fuyu_train_state(model, tx)
    assert set(state.trainable) == set(start)
    state, metrics = fuyu_sft.make_fuyu_train_step(model, tx)(state,
                                                              _batch(cfg))
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), ref_loss, rtol=1e-5)
    got = export_flax_params(model)
    for k, ref in ref_params.items():
        tol = 1e-5 + LR / 2 * (np.abs(ref - start[k]) < LR / 2)
        assert (np.abs(got[k] - ref) <= tol).all(), k
        assert not np.array_equal(got[k], start[k]), k


def test_8bit_steps_on_bf16_parameters_lower_the_loss():
    """OtterHD-8B's recipe at the tiny size: bf16 parameters, 8-bit Adam
    (no masters), remat; the loss on a repeated batch falls and every
    parameter moves."""
    cfg, model = _port_model(remat=True, dtype=torch.bfloat16)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tx = tstep.make_optimizer([tstep.flax_path(n) for n, _ in
                               model.named_parameters()], lr=3e-3,
                              total_steps=10, state_bits=8)
    state = fuyu_sft.fuyu_train_state(model, tx)
    assert state.opt_state.master == {}
    step = fuyu_sft.make_fuyu_train_step(model, tx)
    batch = _batch(cfg)
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(4)]
    assert losses[-1] < losses[0], losses
    for k, v in model.state_dict().items():
        assert not torch.equal(v, before[k]), k


def test_mesh_is_refused():
    """A mesh that is not a DeviceMesh is refused (the step takes
    `parallel.mesh.create_mesh`'s; tests/test_torch_seq_parallel.py runs
    one)."""
    _, model = _port_model()
    with pytest.raises(TypeError, match="DeviceMesh"):
        fuyu_sft.make_fuyu_train_step(model, None, mesh=object())
