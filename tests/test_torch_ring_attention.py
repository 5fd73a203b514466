"""The port's ring attention (`otter_tpu_torch/ops/ring_attention.py`)
against the JAX package's `ring_attention` on the 8-device CPU mesh and
against the port's single-call flash attention over the whole sequence:
forward and every gradient, at sp 2 and 4, causal or not, GQA (4 query
heads over 2 kv heads) and MQA, the ALiBi column bias (taking a gradient)
with "eq" and "ge" ids, in both grad modes. `ring_attention_local` runs the
per-rank code of n ranks in this process; the same cases run over gloo
process rings (`torch_parallel_worker.py`).

Tolerances, the JAX ring test's: the output within 2e-5, gradients within
3e-4 (f32 on both sides; the ring merges blocks in another order than
one softmax).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from otter_tpu.config import ParallelConfig as JCfg
from otter_tpu.ops.ring_attention import ring_attention as jring
from otter_tpu.parallel.mesh import create_mesh as jcreate_mesh
from otter_tpu_torch.ops import flash_attention as fa
from otter_tpu_torch.ops.ring_attention import (ring_attention_local,
                                                ring_attention_local_bwd,
                                                ring_attention_local_fwd)
from torch_parallel_worker import launch

OUT_TOL, GRAD_TOL = 2e-5, 3e-4
B, S, D = 2, 32, 16

# name: (causal, h, h_kv, bias, ids_mode)
CASES = {
    "causal_gqa_alibi_eq": (True, 4, 2, True, "eq"),
    "full_gqa_alibi_eq": (False, 4, 2, True, "eq"),
    "causal_mha_ge": (True, 4, 4, False, "ge"),
    "full_mqa_plain": (False, 4, 1, False, None),
}
GRID = [(c, sp, g) for c in CASES for sp in (2, 4) for g in ("ring", "ad")]


@functools.lru_cache(maxsize=None)
def _arrays(case: str):
    causal, h, hkv, bias, ids_mode = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    a = {x: rng.standard_normal((B, n, S, D)).astype(np.float32)
         for x, n in (("q", h), ("k", hkv), ("v", hkv))}
    a["do"] = rng.standard_normal((B, h, S, D)).astype(np.float32)
    if bias:
        slopes = np.asarray([0.5 ** (i + 1) for i in range(h)], np.float32)
        a["bias"] = (np.arange(1 - S, 1, dtype=np.float32)[None, None, None]
                     * slopes[None, :, None, None])
    if ids_mode == "eq":            # right padding, id 0
        ids = np.ones((B, S), np.int32)
        ids[0, -7:] = 0
        ids[1, -13:] = 0
        a["q_ids"] = a["kv_ids"] = ids
    elif ids_mode == "ge":          # media ids that only grow
        ids = np.cumsum(rng.random((B, S)) < 0.2, axis=1).astype(np.int32)
        a["q_ids"], a["kv_ids"] = ids, ids
    return a


def _kw(case):
    causal, _, _, _, ids_mode = CASES[case]
    return dict(causal=causal, ids_mode=ids_mode or "eq")


@functools.lru_cache(maxsize=None)
def _jax(case: str, sp: int):
    """JAX's ring (its two-pass VJP) on an sp-device "seq" mesh: out and
    (dq, dk, dv[, dbias])."""
    a = _arrays(case)
    mesh = jcreate_mesh(JCfg(dp=1, fsdp=1, sp=sp, tp=1), jax.devices()[:sp])
    kw = _kw(case)
    ids = ({"q_ids": jnp.asarray(a["q_ids"]),
            "kv_ids": jnp.asarray(a["kv_ids"])} if "q_ids" in a else {})
    wrt = [jnp.asarray(a[x]) for x in "qkv"]
    if "bias" in a:
        wrt.append(jnp.asarray(a["bias"]))

    def f(*xs):
        return jring(*xs[:3], mesh=mesh, bias=xs[3] if len(xs) > 3 else None,
                     **ids, **kw)

    sh = NamedSharding(mesh, P(None, None, "seq", None))
    wrt[:3] = [jax.device_put(x, sh) for x in wrt[:3]]
    out, vjp = jax.vjp(jax.jit(f), *wrt)
    grads = vjp(jnp.asarray(a["do"]))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(case: str, n: int, grad_mode: str):
    """The port's n-rank ring in this process: out and grads."""
    a = _arrays(case)
    t = {k: torch.tensor(v) for k, v in a.items()}
    wrt = [t[x].requires_grad_() for x in "qkv"]
    bias = t["bias"].requires_grad_() if "bias" in t else None
    out = ring_attention_local(*wrt, n=n, bias=bias, q_ids=t.get("q_ids"),
                               kv_ids=t.get("kv_ids"), grad_mode=grad_mode,
                               **_kw(case))
    grads = torch.autograd.grad(out, wrt + ([bias] if bias is not None
                                            else []), t["do"])
    return out.detach().numpy(), [g.numpy() for g in grads]


def _flash(case: str):
    """One flash_attention call over the whole sequence (kv heads repeated
    to the query heads), its output and (dq, dk, dv)."""
    a = _arrays(case)
    t = {k: torch.tensor(v) for k, v in a.items()}
    h = t["q"].shape[1]
    q, k, v = (t[x].requires_grad_() for x in "qkv")
    g = h // k.shape[1]
    out = fa.flash_attention(q, k.repeat_interleave(g, 1),
                             v.repeat_interleave(g, 1), t.get("bias"),
                             t.get("q_ids"), t.get("kv_ids"), **_kw(case))
    grads = torch.autograd.grad(out, [q, k, v], t["do"])
    return out.detach().numpy(), [x.numpy() for x in grads]


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("case,sp,grad_mode", GRID)
def test_local_ring_matches_jax_ring_and_flash(case, sp, grad_mode):
    out, grads = _port(case, sp, grad_mode)
    j_out, j_grads = _jax(case, sp)
    _close(out, j_out, OUT_TOL, "out vs JAX")
    for g, jg, name in zip(grads, j_grads, ("dq", "dk", "dv", "dbias")):
        _close(g, jg, GRAD_TOL, f"{name} vs JAX")
    f_out, f_grads = _flash(case)
    _close(out, f_out, OUT_TOL, "out vs flash")
    for g, fg, name in zip(grads, f_grads, ("dq", "dk", "dv")):
        _close(g, fg, GRAD_TOL, f"{name} vs flash")


def test_the_two_passes_alone_match_autograd():
    """`ring_attention_local_fwd` / `_bwd` (what the card's parallel phase
    times) give the autograd Function's out and gradients."""
    case = "causal_gqa_alibi_eq"
    a = {k: torch.tensor(v) for k, v in _arrays(case).items()}
    kw = dict(n=4, bias=a["bias"], q_ids=a["q_ids"], kv_ids=a["kv_ids"],
              **_kw(case))
    out, lse = ring_attention_local_fwd(a["q"], a["k"], a["v"], **kw)
    grads = ring_attention_local_bwd(a["q"], a["k"], a["v"], out, lse,
                                     a["do"], **kw)
    ref_out, ref_grads = _port(case, 4, "ring")
    np.testing.assert_array_equal(out.numpy(), ref_out)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_array_equal(g.numpy(), r)
    assert lse.shape == (B, 4, S) and lse.dtype == torch.float32


def _masked_case():
    """Non-causal, "eq" ids where two query rows match no key id."""
    rng = np.random.default_rng(9)
    a = {x: rng.standard_normal((B, 4, S, D)).astype(np.float32)
         for x in ("q", "k", "v", "do")}
    ids = np.ones((B, S), np.int32)
    ids[0, -5:] = 0
    q_ids = ids.copy()
    q_ids[0, 3] = q_ids[1, 20] = 7      # no key has id 7
    a["q_ids"], a["kv_ids"] = q_ids, ids
    return a


@pytest.mark.parametrize("sp", [2, 4])
def test_rows_that_attend_no_key_get_what_flash_gives(sp):
    """A row masked in every block gets the mean of v over every key, and
    1/S of its gradient on every key's dv, as the port's flash over the
    whole sequence; the other rows match JAX's ring, which sums the
    blocks' means on such rows (ROADMAP Queue 3)."""
    a = _masked_case()
    t = {k: torch.tensor(v) for k, v in a.items()}
    q, k, v = (t[x].requires_grad_() for x in "qkv")
    out = ring_attention_local(q, k, v, n=sp, causal=False,
                               q_ids=t["q_ids"], kv_ids=t["kv_ids"])
    grads = torch.autograd.grad(out, [q, k, v], t["do"])
    q2, k2, v2 = (t[x].detach().clone().requires_grad_() for x in "qkv")
    ref = fa.flash_attention(q2, k2, v2, None, t["q_ids"], t["kv_ids"])
    ref_grads = torch.autograd.grad(ref, [q2, k2, v2], t["do"])
    _close(out.detach().numpy(), ref.detach().numpy(), OUT_TOL, "out")
    for g, r, name in zip(grads, ref_grads, ("dq", "dk", "dv")):
        _close(g.numpy(), r.numpy(), GRAD_TOL, name)
    mesh = jcreate_mesh(JCfg(dp=1, fsdp=1, sp=sp, tp=1), jax.devices()[:sp])
    j_out = np.asarray(jax.jit(lambda *x: jring(
        *x[:3], mesh=mesh, causal=False, q_ids=x[3], kv_ids=x[4]))(
        *(jnp.asarray(a[x]) for x in ("q", "k", "v", "q_ids", "kv_ids"))))
    attends = (a["q_ids"][:, :, None] == a["kv_ids"][:, None, :]).any(-1)
    sel = attends[:, None, :, None]
    _close(np.where(sel, out.detach().numpy(), 0), np.where(sel, j_out, 0),
           OUT_TOL, "attending rows vs JAX")


def test_indivisible_sequences_and_unknown_grad_modes_raise():
    a = {k: torch.tensor(v) for k, v in _arrays("full_mqa_plain").items()}
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention_local(a["q"][:, :, :30], a["k"][:, :, :30],
                             a["v"][:, :, :30], n=4)
    with pytest.raises(ValueError, match="grad_mode"):
        ring_attention_local(a["q"], a["k"], a["v"], n=2, grad_mode="x")
    with pytest.raises(ValueError, match="column bias"):
        ring_attention_local(a["q"], a["k"], a["v"], n=2,
                             bias=torch.zeros(1, 4, S, S))


# ── over gloo process rings ─────────────────────────────────────────


@pytest.fixture(scope="module")
def process_rings(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ring"))
    spec, arrays = [], {}
    for case, sp, grad_mode in GRID:
        name = f"{case}-{sp}-{grad_mode}"
        causal, _, _, _, ids_mode = CASES[case]
        spec.append(dict(name=name, sp=sp, causal=causal,
                         ids_mode=ids_mode or "eq", grad_mode=grad_mode))
        arrays.update({f"{name}/{k}": v for k, v in _arrays(case).items()})
    np.savez(os.path.join(d, "ring.npz"), **arrays)
    with open(os.path.join(d, "ring.json"), "w") as f:
        json.dump(spec, f)
    launch(2, ["ring"], d)
    launch(4, ["ring"], d)
    return d


@pytest.mark.parametrize("case,sp,grad_mode", GRID)
def test_process_ring_matches_jax_ring(process_rings, case, sp, grad_mode):
    """`ring_attention` over an sp-rank "seq" mesh of gloo processes (the
    rotation by batch_isend_irecv) against JAX's ring."""
    name = f"{case}-{sp}-{grad_mode}"
    with np.load(os.path.join(process_rings, f"ring_{sp}.npz")) as z:
        got = {k: z[k] for k in z.files if k.startswith(name + "/")}
    j_out, j_grads = _jax(case, sp)
    _close(got[f"{name}/out"], j_out, OUT_TOL, "out")
    for x, jg in zip("qkvb", j_grads):
        _close(got[f"{name}/d{x}"], jg, GRAD_TOL, f"d{x}")
