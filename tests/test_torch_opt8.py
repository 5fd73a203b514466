"""Port parity: the 8-bit Adam of `otter_tpu_torch.train.opt8` behind
`make_optimizer(state_bits=8)` against the JAX package's chain
(`otter_tpu.train.step.make_optimizer(state_bits=8)`: clip, `scale_by_adam8`,
decoupled decay, learning rate), fed the same gradients.

Tolerances, over 5 steps in f32: each int8 state within 1 LSB of JAX's (a
value that lands near a rounding half may round the other way in one
framework); each block scale within 1e-5 relative (an absmax divided by
127, so it follows one element's f32 arithmetic); each parameter within
1e-6 + 1e-5 |param| of JAX's, but for at most 0.5% of a tensor's elements,
which are held within lr / 20. Five updates of lr 1e-2 move an element by
lr m / sqrt(v) a step, and where its nu sits a few LSB above 0 in its
block (a gradient far below the block's largest) one LSB of nu moves that
step by tens of percent; 2.1e-4 = lr / 48 was seen on one element of
2560. In bf16 (no master: the 7B recipe's trainables) the JAX chain
rounds the step to bf16 before the decay and again after the rate, the
port once: the parameters are held within lr / 4 of JAX's (up to 2e-3 =
lr / 5 seen), and the state's exact parity is the f32 test's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.train import opt8 as jopt8
from otter_tpu.train import step as jstep
from otter_tpu_torch.train import opt8 as topt8
from otter_tpu_torch.train import step as tstep

SHAPES = {"perceiver/latents": (7, 96),          # 672: one full block + tail
          "lang/xattn_0/attn/to_q/kernel": (64, 40),      # decayed
          "lang/xattn_0/attn_gate": (1,),
          "lang/xattn_0/ff_up/kernel": (128, 48)}         # 12 blocks


def _jax_tree(flat):
    from flax import traverse_util
    return traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def _flat(tree):
    from flax import traverse_util
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


def _adam8_state(opt_state):
    for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda t: isinstance(
                t, jopt8.ScaleByAdam8State)):
        if isinstance(s, jopt8.ScaleByAdam8State):
            return s
    raise AssertionError("no ScaleByAdam8State in the chain's state")


def _grads(step, scale):
    rng = np.random.default_rng(100 + step)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _runs(steps, *, grad_scale, chunk_blocks=None, dtype=np.float32,
          accum=1):
    """(port params, port state, JAX params, JAX adam8 state) after
    `steps` updates from the same start and gradients."""
    rng = np.random.default_rng(0)
    start = {k: rng.standard_normal(s).astype(np.float32) * 0.1
             for k, s in SHAPES.items()}
    kw = dict(lr=1e-2, schedule="cosine", warmup_steps=2, total_steps=8,
              weight_decay=0.1, grad_clip=1.0, grad_accum_steps=accum,
              state_bits=8)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jparams = jax.tree_util.tree_map(lambda x: x.astype(jdt),
                                     _jax_tree(start))
    tx = jstep.make_optimizer(jparams, **kw)
    jstate = tx.init(jparams)

    @jax.jit
    def jupdate(g, s, p):
        u, s = tx.update(g, s, p)
        return jax.tree_util.tree_map(
            lambda a, b: (a + b).astype(a.dtype), p, u), s

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(tdt))
              for k, v in start.items()}
    opt = tstep.make_optimizer(list(params), **kw)
    assert isinstance(opt, topt8.Adam8)
    if chunk_blocks is not None:
        opt.chunk_blocks = chunk_blocks
    state = opt.init(params)
    for i in range(steps):
        g = _grads(i, grad_scale)
        jparams, jstate = jupdate(jax.tree_util.tree_map(
            lambda x: x.astype(jdt), _jax_tree(g)), jstate, jparams)
        opt.update({k: torch.from_numpy(v).to(tdt) for k, v in g.items()},
                   state, params)
    return params, state, _flat(jparams), _adam8_state(jstate)


@pytest.mark.parametrize("grad_scale", [0.01, 1.0],
                         ids=["unclipped", "clipped"])
@pytest.mark.parametrize("chunk_blocks", [None, 2], ids=["whole", "chunks"])
def test_adam8_matches_the_jax_chain_over_5_steps(grad_scale, chunk_blocks):
    params, state, jparams, js = _runs(5, grad_scale=grad_scale,
                                       chunk_blocks=chunk_blocks)
    jmu_q, jmu_s = _flat(js.mu_q), _flat(js.mu_s)
    jnu_q, jnu_s = _flat(js.nu_q), _flat(js.nu_s)
    assert int(js.count) == state.count == 5
    for k in SHAPES:
        for mine, ref in ((state.mu[k], jmu_q[k]), (state.nu[k], jnu_q[k])):
            assert mine.dtype == torch.int8 and mine.shape == ref.shape
            lsb = np.abs(mine.numpy().astype(np.int32) - ref.astype(np.int32))
            assert lsb.max() <= 1, (k, int(lsb.max()))
        for mine, ref in ((state.mu_s[k], jmu_s[k]),
                          (state.nu_s[k], jnu_s[k])):
            assert mine.shape == ref.shape
            np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-5,
                                       atol=0, err_msg=k)
        _assert_params_close(params[k].detach().numpy(), jparams[k], k)
    assert state.master == {}


def _assert_params_close(p, ref, what, lr=1e-2):
    err = np.abs(p - ref)
    loose = err > 1e-6 + 1e-5 * np.abs(ref)
    assert loose.mean() <= 5e-3, (what, int(loose.sum()), err.size)
    assert err.max() <= lr / 20, (what, float(err.max()))


def test_adam8_bf16_parameters_keep_no_master():
    """bf16 parameters, as the 7B recipe's trainables: no f32 master, the
    parameters stay bf16, move, and follow JAX's bf16 chain within lr / 4
    (the module docstring says why not closer)."""
    params, state, jparams, _ = _runs(5, grad_scale=0.01, dtype="bf16")
    assert state.master == {}
    rng = np.random.default_rng(0)
    for k, shape in SHAPES.items():
        start = rng.standard_normal(shape).astype(np.float32) * 0.1
        p = params[k].detach()
        assert p.dtype == torch.bfloat16
        ref = np.asarray(jparams[k], np.float32)
        assert np.abs(p.float().numpy() - ref).max() <= 1e-2 / 4, k
        assert not np.array_equal(p.float().numpy(), start), k


def test_state_takes_about_2_02_bytes_a_parameter():
    params = {"xattn_0/ff_up/kernel": torch.zeros(4096, 512),
              "perceiver/latents": torch.zeros(64, 1024)}
    opt = tstep.make_optimizer(list(params), state_bits=8)
    state = opt.init(params)
    n = sum(p.numel() for p in params.values())
    assert state.nbytes() / n == pytest.approx(2 + 2 * 4 / 512, rel=1e-9)
    f32 = tstep.make_optimizer(list(params)).init(params)
    assert f32.nbytes() / n == 12          # master + mu + nu, f32 each


def test_grad_accumulation_matches_multisteps():
    params, state, jparams, js = _runs(4, grad_scale=0.01, accum=2)
    assert state.count == int(js.count) == 2 and state.mini_step == 0
    for k in SHAPES:
        _assert_params_close(params[k].detach().numpy(), jparams[k], k)


def test_state_dict_round_trips_the_int8_states(tmp_path):
    """Checkpoint and resume: a restored state continues as the one saved
    (the CheckpointStore carries the int8 states and their scales)."""
    from otter_tpu_torch.runtime.checkpoint import CheckpointStore
    params, state, _, _ = _runs(3, grad_scale=0.01)
    sd = state.state_dict()
    assert {"mu_s", "nu_s"} <= set(sd) and sd["mu"]["perceiver/latents"] \
        .dtype == torch.int8
    opt = tstep.make_optimizer(list(params), lr=1e-2, schedule="cosine",
                               warmup_steps=2, total_steps=8,
                               state_bits=8)
    fresh = opt.init(params)
    fresh.load_state_dict(torch.load(_save(tmp_path, sd),
                                     weights_only=True))
    assert fresh.count == 3
    for key in ("mu", "nu", "mu_s", "nu_s"):
        for k, t in getattr(state, key).items():
            assert torch.equal(getattr(fresh, key)[k], t)

    class _State:
        step, trainable, frozen, opt_state = 3, params, {}, state
    store = CheckpointStore(str(tmp_path / "ckpt"))
    store.save(3, _State)
    restored = _State()
    restored.opt_state = opt.init(params)
    store.restore(restored)
    assert torch.equal(restored.opt_state.nu["perceiver/latents"],
                       state.nu["perceiver/latents"])


def _save(tmp_path, sd):
    path = tmp_path / "opt.pt"
    torch.save(sd, path)
    return path


def test_quantize_blocks_equals_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((9, 512)).astype(np.float32) * 1e-3
    x[4] = 0.0                                   # an all-zero block
    q, s = topt8.quantize_blocks(torch.from_numpy(x))
    jq, js = jopt8._quantize(jnp.asarray(x), 512)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[4]) == 1.0
