"""Sequence parallelism in the port: `ops.attention.sequence_parallel`
routes eligible self-attention through the ring (JAX `ops/attention.py:
37-79`), in gloo processes on the CPU (`torch_parallel_worker.py`):
forward logits of the tiny mpt (ALiBi column bias, padding ids), llama
(RoPE) and fuyu (persimmon) models at sp 4 against the JAX package's
plain forward (JAX `tests/test_seq_parallel.py:48, 124`), and one OtterHD
full fine-tune step at sp 2 and fsdp 2 against JAX's step.

Tolerances: logits within 2e-4 (the JAX test's); the fuyu step as
`tests/test_torch_fuyu_sft.py` holds its one-device step (loss 1e-5
relative, parameters 1e-5 plus the near-eps allowance of lr / 2).
"""

import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu_torch.ops import attention as tattn
from test_torch_parallel import jax_vlm, write_model
from torch_parallel_worker import launch
from torch_parity_helpers import fuyu_pair


class _Mesh:
    """A stand-in with a DeviceMesh's `size(dim)` (no process group)."""

    def __init__(self, sp):
        self.shape = (1, 1, sp, 1)

    def size(self, dim=None):
        return self.shape[dim]


def test_sequence_parallel_is_nothing_at_extent_one():
    with tattn.sequence_parallel(_Mesh(1)):
        assert tattn._SEQ_PARALLEL.stack == []
    with tattn.sequence_parallel(None):
        assert tattn._SEQ_PARALLEL.stack == []


def test_sequence_parallel_is_thread_local():
    seen = []
    with tattn.sequence_parallel(_Mesh(4)):
        assert len(tattn._SEQ_PARALLEL.stack) == 1
        t = threading.Thread(
            target=lambda: seen.append(list(tattn._SEQ_PARALLEL.stack)))
        t.start()
        t.join()
    assert seen == [[]] and tattn._SEQ_PARALLEL.stack == []


def test_ineligible_calls_take_the_normal_path_and_bad_lengths_raise():
    """Not causal, S_q != S_kv, one query, or a bias that is not in column
    form: the normal path (None from `_maybe_ring`). A causal sequence the
    axis does not divide raises JAX's ValueError: no full attention on
    sharded activations."""
    q = torch.zeros(1, 2, 6, 16)
    args = dict(bias=None, q_ids=None, kv_ids=None, ids_mode="eq",
                sm_scale=None)
    with tattn.sequence_parallel(_Mesh(4)):
        assert tattn._maybe_ring(q, q, q, causal=False, **args) is None
        assert tattn._maybe_ring(q, q[:, :, :4], q[:, :, :4], causal=True,
                                 **args) is None
        one = q[:, :, :1]
        assert tattn._maybe_ring(one, one, one, causal=True, **args) is None
        full = dict(args, bias=torch.zeros(1, 2, 8, 8))
        q8 = torch.zeros(1, 2, 8, 16)
        assert tattn._maybe_ring(q8, q8, q8, causal=True, **full) is None
        with pytest.raises(ValueError, match="not divisible"):
            tattn._maybe_ring(q, q, q, causal=True, **args)


def _fwd_inputs(cfg, rng, b=2, s=32):
    vx = rng.standard_normal((b, 1, 1, 3, 28, 28)).astype(np.float32)
    ids = rng.integers(5, 200, (b, s)).astype(np.int32)
    ids[:, 1] = cfg.media_token_id
    mask = np.ones((b, s), np.int32)
    mask[0, -5:] = 0
    mask[1, -9:] = 0
    return dict(vision_x=vx, input_ids=ids, attention_mask=mask)


def _fuyu_inputs(cfg, rng, b=2, s=32, p=8):
    pd = cfg.patch_size ** 2 * 3
    ids = rng.integers(5, 200, (b, s)).astype(np.int32)
    ids[:, :4] = cfg.image_placeholder_id
    idx = np.full((b, s), -1, np.int32)
    idx[:, :4] = np.arange(4)
    return dict(input_ids=ids, image_patches_indices=idx,
                image_patches=rng.standard_normal((b, p, pd)).astype(
                    np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from flax import traverse_util
    from test_torch_fuyu_sft import LR, _batch
    d = str(tmp_path_factory.mktemp("seq"))
    rng = np.random.default_rng(3)
    refs = {}
    for arch in ("mpt", "llama"):
        cfg, model, params, flat = jax_vlm(arch)
        write_model(d, arch, flat, cfg)
        x = _fwd_inputs(cfg, rng)
        np.savez(os.path.join(d, f"{arch}_fwd.npz"), **x)
        refs[arch] = np.asarray(model.apply(
            {"params": params}, jnp.asarray(x["vision_x"]),
            jnp.asarray(x["input_ids"]),
            attention_mask=jnp.asarray(x["attention_mask"]))[0])
    cfg, model, params, _ = fuyu_pair()
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        params["params"], sep="/").items()}
    write_model(d, "fuyu", flat, cfg)
    x = _fuyu_inputs(cfg, rng)
    np.savez(os.path.join(d, "fuyu_fwd.npz"), **x)
    refs["fuyu"] = np.asarray(model.apply(
        params, jnp.asarray(x["input_ids"]),
        image_patches=jnp.asarray(x["image_patches"]),
        image_patches_indices=jnp.asarray(x["image_patches_indices"]))[0])
    np.savez(os.path.join(d, "fuyu_batch.npz"), **_batch(cfg))
    with open(os.path.join(d, "fuyu.json"), "w") as f:
        json.dump({"lr": LR}, f)
    launch(4, ["seq_forward"], d)
    launch(2, ["fuyu_step"], d)
    return d, refs


@pytest.mark.parametrize("arch", ["mpt", "llama", "fuyu"])
def test_sp4_forward_matches_jax(runs, arch):
    d, refs = runs
    with np.load(os.path.join(d, "seq_forward_4.npz")) as z:
        got = z[arch]
    np.testing.assert_allclose(got, refs[arch], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("mesh", ["sp2", "fsdp2"])
def test_fuyu_step_on_a_mesh_matches_jax(runs, mesh):
    from test_torch_fuyu_sft import LR, _jax_step
    d, _ = runs
    ref_loss, start, ref_params = _jax_step()
    with np.load(os.path.join(d, f"fuyu_step_{mesh}.npz")) as z:
        got = {k: z[k] for k in z.files}
    np.testing.assert_allclose(float(got["loss"]), ref_loss, rtol=1e-5)
    for k, ref in ref_params.items():
        tol = 1e-5 + LR / 2 * (np.abs(ref - start[k]) < LR / 2)
        assert (np.abs(got[f"param/{k}"] - ref) <= tol).all(), k
