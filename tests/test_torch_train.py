"""Port parity: the SFT train step (`otter_tpu_torch.train.step`) against
the JAX package's (`otter_tpu.train.step`) on the tiny MPT config in f32
on the CPU, from the same weights (carried across by `load_flax_params`)
and the same batch.

Tolerances: losses and their gradients within 1e-5 (f32 on both sides,
only the order of sums differs); after a whole step each parameter within
1e-4 * max|JAX param| + 1e-5. AdamW's first step moves every weight by
about lr whatever its gradient's size: m / sqrt(v) is g / (|g| + eps).
Where a gradient is within a few eps of 0 the two sides' rounding noise
in g is a sizable part of eps, and the updates may differ by a large part
of lr (2.96e-5 at lr 1e-4 seen on one element of 16384, torch 2.13 on 8
threads). After one step, an element whose JAX update is under lr / 2
(so its gradient is near eps) is held within that tolerance plus lr / 2,
which still fails a spurious ~lr move of an element the reference holds
still; an element with a real gradient moves by ~lr and keeps the tight
bound, so a missing or wrong-signed update there still fails.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from otter_tpu.train import step as jstep
from otter_tpu_torch.models.convert import export_flax_params
from otter_tpu_torch.ops import attention as tattn
from otter_tpu_torch.train import step as tstep
from torch_parity_helpers import (jax_tiny_train, port_cfg, torch_tiny_train,
                                  train_batch)

LR = 1e-4


def _flat(tree):
    return {k: np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


@functools.lru_cache(maxsize=None)
def _jax_steps(n_steps: int, mask_embedding: bool, fused_ce_chunk: int,
               accum: int):
    """Metrics of each step and the trainable params after the last."""
    cfg, model, params, _ = jax_tiny_train()
    batch = {k: jnp.asarray(v) for k, v in train_batch(cfg, 1).items()}
    trainable, _ = jstep.split_params(params, cfg)
    tx = jstep.make_optimizer(trainable, lr=LR, total_steps=10,
                              grad_accum_steps=accum)
    state = jstep.TrainState.create(params, cfg, tx)
    step = jax.jit(jstep.make_train_step(
        model, cfg, tx, mask_embedding=mask_embedding,
        fused_ce_chunk=fused_ce_chunk))
    metrics = []
    for _ in range(n_steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _flat(state.trainable)


def _port_steps(n_steps, mask_embedding, fused_ce_chunk, accum,
                remat=False):
    cfg, _, _, _ = jax_tiny_train()
    model = torch_tiny_train(remat=remat)
    pcfg = port_cfg(cfg)
    trainable, frozen = tstep.split_params(model, pcfg)
    frozen_before = {k: p.detach().clone() for k, p in frozen.items()}
    tx = tstep.make_optimizer(trainable, lr=LR, total_steps=10,
                              grad_accum_steps=accum)
    state = tstep.TrainState.create(model, pcfg, tx)
    step = tstep.make_train_step(model, pcfg, tx,
                                 mask_embedding=mask_embedding,
                                 fused_ce_chunk=fused_ce_chunk)
    batch = train_batch(cfg, 1)
    metrics = []
    for _ in range(n_steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    for k, p in frozen.items():
        torch.testing.assert_close(p, frozen_before[k], atol=0, rtol=0)
    return metrics, export_flax_params(model), state


@functools.lru_cache(maxsize=None)
def _jax_start():
    """The trainable params before any step."""
    cfg, _, params, _ = jax_tiny_train()
    return _flat(jstep.split_params(params, cfg)[0])


def _assert_params_close(port, ref, keys, start=None):
    """Each parameter within 1e-4 * max|ref| + 1e-5; with `start` (the
    params before one step), plus lr / 2 on the elements whose reference
    update is under lr / 2 (gradients near Adam's eps)."""
    for k in keys:
        tol = np.full(ref[k].shape, 1e-4 * float(np.abs(ref[k]).max()) + 1e-5)
        if start is not None:
            tol += LR / 2 * (np.abs(ref[k] - start[k]) < LR / 2)
        err = np.abs(port[k] - ref[k])
        bad = err > tol
        assert not bad.any(), (
            f"{k}: {int(bad.sum())} of {err.size} elements beyond the "
            f"tolerance; worst {float((err - tol).max()):.3e} over it")


def test_trainable_frozen_and_decay_sets_match_jax():
    cfg, _, params, _ = jax_tiny_train()
    jtrain, jfrozen = jstep.split_params(params, cfg)
    model = torch_tiny_train()
    trainable, frozen = tstep.split_params(model, port_cfg(cfg))
    assert set(trainable) == set(_flat(jtrain))
    assert set(frozen) == set(_flat(jfrozen))
    assert all(p.requires_grad for p in trainable.values())
    assert not any(p.requires_grad for p in frozen.values())
    assert tstep.weight_decay_mask(trainable) == {
        k: bool(v) for k, v in
        traverse_util.flatten_dict(jstep.weight_decay_mask(jtrain),
                                   sep="/").items()}


@pytest.mark.parametrize("name", ["constant", "linear", "cosine"])
@pytest.mark.parametrize("warmup", [0, 10])
def test_schedule_matches_optax(name, warmup):
    total, lr = 100, 3e-4
    ref = jstep.make_schedule(name, lr, warmup, total)
    ours = tstep.make_schedule(name, lr, warmup, total)
    # optax evaluates in f32, the port in f64: 1e-6 of lr apart at most
    for s in (0, 1, warmup, warmup + 1, (warmup + total) // 2, total - 1,
              total, total + 20):
        np.testing.assert_allclose(ours(s), float(ref(s)), rtol=1e-6,
                                   atol=1e-6 * lr, err_msg=f"step {s}")


def test_losses_and_their_grads_match_jax():
    rng = np.random.default_rng(3)
    b, s, d, v = 2, 19, 16, 40
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    head = rng.standard_normal((v, d)).astype(np.float32)
    labels = np.where(rng.random((b, s)) < 0.6,
                      rng.integers(0, v, (b, s)), -100).astype(np.int32)

    def jax_loss(chunked):
        def f(h, w):
            if chunked:
                return jstep.chunked_causal_lm_loss(h, w, jnp.asarray(labels),
                                                    chunk=8)[0]
            return jstep.causal_lm_loss(jnp.einsum("bsd,vd->bsv", h, w),
                                        jnp.asarray(labels))[0]
        loss, grads = jax.value_and_grad(f, argnums=(0, 1))(
            jnp.asarray(hidden), jnp.asarray(head))
        return float(loss), [np.asarray(g) for g in grads]

    def port_loss(chunked):
        h = torch.from_numpy(hidden).requires_grad_()
        w = torch.from_numpy(head).requires_grad_()
        lab = torch.from_numpy(labels)
        if chunked:
            loss, n = tstep.chunked_causal_lm_loss(h, w, lab, chunk=8)
        else:
            loss, n = tstep.causal_lm_loss(h @ w.t(), lab)
        assert int(n) == int((labels[:, 1:] != -100).sum())
        loss.backward()
        return float(loss.detach()), [h.grad.numpy(), w.grad.numpy()]

    results = {c: (port_loss(c), jax_loss(c)) for c in (False, True)}
    for (loss, grads), (jloss, jgrads) in results.values():
        np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-5)
        for g, r in zip(grads, jgrads):
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)
    (l0, g0), _ = results[False]
    (l1, g1), _ = results[True]
    np.testing.assert_allclose(l0, l1, rtol=1e-5, atol=1e-5)
    for a, c in zip(g0, g1):
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["standard", "fused_ce_masked_emb",
                                     "flash_route"])
def test_one_step_matches_jax(variant, monkeypatch):
    """One full step from the same weights and batch: loss, grad norm and
    every trainable parameter afterwards. "flash_route" sends the decoder
    and xattn attention through the flash autograd.Function (plain forward
    and plain backward on the CPU), as the GPU route takes the kernels."""
    mask, chunk = (True, 8) if variant == "fused_ce_masked_emb" else (False,
                                                                       0)
    if variant == "flash_route":
        monkeypatch.setattr(tattn, "default_impl", lambda q: "kernel")
    ref_metrics, ref_params = _jax_steps(1, mask, chunk, 1)
    metrics, params, state = _port_steps(1, mask, chunk, 1)
    assert metrics[0]["tokens"] == ref_metrics[0]["tokens"]
    np.testing.assert_allclose(metrics[0]["loss"], ref_metrics[0]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(metrics[0]["grad_norm"],
                               ref_metrics[0]["grad_norm"], rtol=1e-4)
    _assert_params_close(params, ref_params, ref_params, _jax_start())
    assert state.step == 1


def test_flash_route_reaches_the_flash_function(monkeypatch):
    """The flash_route variant above really takes the autograd.Function:
    its backward runs once per attention the route sends there."""
    from otter_tpu_torch.ops import flash_attention as fa
    calls = []
    real = fa.flash_attention_bwd
    monkeypatch.setattr(fa, "flash_attention_bwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tattn, "default_impl", lambda q: "kernel")
    _port_steps(1, False, 0, 1)
    # 4 causal decoder layers + 2 xattn blocks (the perceiver's and CLIP's
    # shapes are sub-tile at this size and take the reference)
    assert len(calls) == 6


def test_grad_accumulation_matches_multisteps():
    ref_metrics, ref_params = _jax_steps(2, False, 0, 2)
    metrics, params, state = _port_steps(2, False, 0, 2)
    for m, r in zip(metrics, ref_metrics):
        np.testing.assert_allclose(m["loss"], r["loss"], rtol=1e-5)
    _assert_params_close(params, ref_params, ref_params)
    assert state.opt_state.count == 1 and state.opt_state.mini_step == 0


def test_accumulation_holds_params_until_the_last_mini_step():
    _, before, _ = _port_steps(0, False, 0, 2)
    _, mid, state = _port_steps(1, False, 0, 2)
    for k, p in state.trainable.items():
        np.testing.assert_array_equal(mid[k], before[k])


def test_remat_matches_no_remat():
    m0, p0, _ = _port_steps(1, False, 8, 1, remat=False)
    m1, p1, _ = _port_steps(1, False, 8, 1, remat=True)
    np.testing.assert_allclose(m1[0]["loss"], m0[0]["loss"], rtol=1e-6)
    np.testing.assert_allclose(m1[0]["grad_norm"], m0[0]["grad_norm"],
                               rtol=1e-5)
    for k in p0:
        np.testing.assert_allclose(p1[k], p0[k], atol=1e-6, rtol=0,
                                   err_msg=k)


def test_embedding_mask_moves_only_the_answer_row():
    cfg, _, _, _ = jax_tiny_train()
    _, before, _ = _port_steps(0, True, 0, 1)
    _, after, _ = _port_steps(1, True, 0, 1)
    key = "lang_encoder/wte/embedding"
    moved = np.nonzero(np.abs(after[key] - before[key]).sum(1) > 0)[0]
    assert moved.tolist() == [cfg.answer_token_id]


def test_int8_adam_states_are_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tstep.make_optimizer(["perceiver/latents"], state_bits=8)


def test_label_masking_matches_jax_package():
    from otter_tpu.data import mimicit as jmimicit
    from otter_tpu_torch.data import mimicit as tmimicit
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 12, (4, 30)).astype(np.int64)   # 9-11 special
    kw = dict(answer_token_id=9, eoc_token_id=10, eos_token_id=11)
    labels = tmimicit.mask_answer_labels(ids, **kw)
    np.testing.assert_array_equal(labels,
                                  jmimicit.mask_answer_labels(ids, **kw))
    mask = (rng.random((4, 30)) < 0.9).astype(np.int64)
    for a, r in zip(tmimicit.find_and_remove_tokens(ids, labels, mask, 9, 0),
                    jmimicit.find_and_remove_tokens(ids, labels, mask, 9, 0)):
        np.testing.assert_array_equal(a, r)
