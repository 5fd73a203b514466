"""Port parity: the flash-attention forward's plain version, the attention
dispatcher and the mask helpers against the JAX package (Pallas in
interpret mode), in f32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.ops import attention as jattn
from otter_tpu.ops import masks as jmasks
from otter_tpu.ops.flash_attention import flash_attention as jflash
from otter_tpu_torch.ops import attention as tattn
from otter_tpu_torch.ops import masks as tmasks
from otter_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_plain)

TOL = 1e-5   # f32 on both sides; only summation order differs


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _case(name):
    """(arrays, kwargs, rows to compare) for one kernel configuration."""
    if name == "causal_alibi_eq":
        # decoder prefill: causal + ALiBi column bias + left-padding ids
        b, h, s, d = 2, 4, 40, 32
        q, k, v = _qkv(1, b, h, s, s, d)
        slopes = np.asarray(jmasks.alibi_slopes(h))
        bias = (np.arange(1 - s, 1)[None, None, None, :]
                * slopes[None, :, None, None]).astype(np.float32)
        ids = np.ones((b, s), np.int32)
        ids[1, :13] = 0
        return (q, k, v, bias, ids, ids), dict(causal=True), None
    if name == "ragged_kv":
        # CLIP / perceiver: non-causal, S_k not a multiple of anything
        q, k, v = _qkv(2, 2, 3, 9, 37, 16)
        return (q, k, v, None, None, None), dict(causal=False), None
    if name in ("media_eq", "media_ge"):
        # cross-attention: text_time vs media ids, two media of 8 latents
        b, h, s, d = 2, 2, 12, 16
        q, k, v = _qkv(3, b, h, s, 16, d)
        loc = np.zeros((b, s), bool)
        loc[0, [0, 6]] = True
        loc[1, [3, 4]] = True
        q_ids, kv_ids, keep = jmasks.media_attention_ids(
            jnp.asarray(loc), 2, 8,
            only_attend_immediate_media=name == "media_eq")
        mode = "eq" if name == "media_eq" else "ge"
        # text before the first media attends no key: those rows are
        # compared separately (test_fully_masked_rows_average_real_keys)
        return ((q, k, v, None, np.asarray(q_ids), np.asarray(kv_ids)),
                dict(causal=False, ids_mode=mode), np.asarray(q_ids) > 0)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["causal_alibi_eq", "ragged_kv",
                                  "media_eq", "media_ge"])
def test_plain_flash_matches_jax_kernel(name):
    arrays, kw, keep = _case(name)
    ref = np.asarray(jflash(*(_j(a) for a in arrays), interpret=True, **kw))
    out, lse = flash_attention_plain(*(_t(a) for a in arrays),
                                     return_lse=True, **kw)
    _, jlse = jflash(*(_j(a) for a in arrays), interpret=True,
                     return_lse=True, **kw)
    out, lse, jlse = out.numpy(), lse.numpy(), np.asarray(jlse)
    if keep is not None:
        sel = keep[:, None, :, None]
        out, ref = np.where(sel, out, 0), np.where(sel, ref, 0)
        lse, jlse = np.where(sel[..., 0], lse, 0), np.where(sel[..., 0],
                                                           jlse, 0)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse, jlse, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["media_eq", "media_ge"])
def test_fully_masked_rows_average_real_keys(name):
    """A query row that may attend no key gets the mean of v over the real
    keys, as the JAX reference path (and the reference's masked_fill +
    softmax) gives. The JAX Pallas kernel averages over its 128-padded key
    axis there instead; in "eq" mode out_keep zeroes those rows anyway."""
    arrays, kw, attends = _case(name)
    q, k, v, _, q_ids, kv_ids = arrays
    ref = jattn.multi_head_attention(
        _j(q), _j(k), _j(v), q_ids=_j(q_ids), kv_ids=_j(kv_ids),
        ids_mode=kw["ids_mode"], impl="ref")
    out = flash_attention_plain(*(_t(a) for a in arrays), **kw).numpy()
    sel = ~attends[:, None, :, None]
    assert sel.any()
    np.testing.assert_allclose(np.where(sel, out, 0),
                               np.where(sel, np.asarray(ref), 0),
                               atol=TOL, rtol=TOL)


def test_wrapper_takes_plain_version_on_cpu():
    arrays, kw, _ = _case("causal_alibi_eq")
    args = [_t(a) for a in arrays]
    before = flash_attention.launches
    np.testing.assert_array_equal(flash_attention(*args, **kw).numpy(),
                                  flash_attention_plain(*args, **kw).numpy())
    assert flash_attention.launches == before   # no kernel launched


def test_flash_rejects_causal_with_unequal_lengths():
    q, k, v = (torch.zeros(1, 1, n, 16) for n in (4, 8, 8))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, causal=True)


@pytest.mark.parametrize("ids", [False, True])
def test_dispatcher_ref_matches_jax(ids):
    q, k, v = _qkv(4, 2, 4, 10, 10, 16)
    kw = {}
    if ids:
        mask = np.ones((2, 10), np.int32)
        mask[0, :4] = 0
        kw = dict(q_ids=mask, kv_ids=mask, ids_mode="eq")
    ref = jattn.multi_head_attention(
        _j(q), _j(k), _j(v), causal=True, impl="ref",
        **{key: (_j(x) if key != "ids_mode" else x) for key, x in kw.items()})
    out = tattn.multi_head_attention(
        _t(q), _t(k), _t(v), causal=True,
        **{key: (_t(x) if key != "ids_mode" else x) for key, x in kw.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("heads", [4, 12, 32])
def test_alibi_slopes_match(heads):
    np.testing.assert_allclose(tmasks.alibi_slopes(heads).numpy(),
                               np.asarray(jmasks.alibi_slopes(heads)),
                               rtol=1e-7)


@pytest.mark.parametrize("immediate,previous",
                         [(True, True), (False, True), (True, False)])
def test_media_attention_ids_match(immediate, previous):
    rng = np.random.default_rng(5)
    loc = rng.random((3, 20)) < 0.2
    ref = jmasks.media_attention_ids(
        jnp.asarray(loc), 3, 4, only_attend_immediate_media=immediate,
        attend_previous=previous)
    out = tmasks.media_attention_ids(
        torch.from_numpy(loc), 3, 4, only_attend_immediate_media=immediate,
        attend_previous=previous)
    for a, r in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
