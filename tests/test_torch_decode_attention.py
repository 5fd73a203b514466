"""Port parity: the decode-attention kernel's plain version against the JAX
stacked-cache `decode_attention` (Pallas in interpret mode), with f32 and
int8 caches, left padding (`starts`) and an ALiBi column bias; the
kernel's split of each span over CTAs (`split_plan`, `split_chunks`) and
its merge of the chunks (`merge_partials`), walked in plain f32 against
the same JAX kernel with f32, int8 and int4 caches."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.ops.decode_attention import decode_attention as jdecode
from otter_tpu.ops.masks import alibi_slopes
from otter_tpu.ops.quant import quantize_kv, quantize_kv_int4
from otter_tpu_torch.ops import decode_attention as da
from otter_tpu_torch.ops.decode_attention import (decode_attention,
                                                  decode_attention_plain)

TOL = 1e-5


def _inputs(seed, int8, b=3, nl=3, h=4, L=256, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, nl, h, L, d)).astype(np.float32)
    v = rng.standard_normal((b, nl, h, L, d)).astype(np.float32)
    lengths = np.asarray([200, 17, 256][:b], np.int32)
    starts = np.asarray([0, 5, 130][:b], np.int32)
    bias = (np.arange(L)[None, None, :] * np.asarray(alibi_slopes(h))[
        None, :, None]).astype(np.float32)
    kw = {}
    if int8:
        kq, ks = quantize_kv(jnp.asarray(k))
        vq, vs = quantize_kv(jnp.asarray(v))
        k, v = np.asarray(kq), np.asarray(vq)
        kw = dict(k_scale=np.asarray(ks), v_scale=np.asarray(vs))
    return q, k, v, lengths, bias, starts, kw


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("layer", [0, 2])
def test_plain_decode_matches_jax_kernel(int8, layer):
    q, k, v, lengths, bias, starts, kw = _inputs(layer, int8)
    ref = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(lengths), jnp.asarray(bias),
                  starts=jnp.asarray(starts), layer=layer, block_k=128,
                  interpret=True,
                  **{n: jnp.asarray(a) for n, a in kw.items()})
    t = lambda a: torch.from_numpy(np.array(a))
    before = decode_attention.launches
    out = decode_attention(t(q), t(k), t(v), t(lengths), t(bias),
                           starts=t(starts), layer=layer,
                           **{n: t(a) for n, a in kw.items()})
    assert decode_attention.launches == before   # CPU: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_unstacked_cache_matches_stacked_layer():
    q, k, v, lengths, bias, starts, _ = _inputs(7, False)
    t = lambda a: torch.from_numpy(np.array(a))
    stacked = decode_attention_plain(t(q), t(k), t(v), t(lengths), t(bias),
                                     t(starts), layer=1)
    single = decode_attention_plain(t(q), t(k[:, 1]), t(v[:, 1]),
                                    t(lengths), t(bias), t(starts))
    # the einsum may sum a strided slice in another order: f32 rounding
    np.testing.assert_allclose(stacked.numpy(), single.numpy(), atol=TOL,
                               rtol=TOL)


# ── the kernel's split over the cache ───────────────────────────────

KINDS = {"bf16": 0, "int8": 1, "int4": 2}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("cache", sorted(KINDS))
def test_split_plan_covers_each_span_once(cache, d):
    """Over a grid of batch, heads and cache lengths: the plan stays within
    one wave and the workspace, and every row's chunks cover its span
    [start, length) exactly once, in order, none empty and none under
    min_rows but the last, none at all for an empty span."""
    kind = KINDS[cache]
    for b in (1, 3, 8, 32):
        for h in (1, 8, 32, 64):
            for L in (1, 64, 255, 256, 2048, 2432, 8192):
                splits, min_rows = da.split_plan(b, h, L, d, kind)
                assert splits >= 1 and min_rows >= 1
                assert splits == 1 or b * h * splits <= \
                    da.SM_COUNT * da.CTAS_PER_SM
                floats, rows = da.workspace_size(b, h, splits, d)
                assert rows == b * h
                for start, length in ((0, L), (0, 1), (L // 3, L),
                                      (5, L - 7), (L, L), (L - 1, 3)):
                    chunks = da.split_chunks(start, length, splits, min_rows)
                    span = length - start
                    if span <= 0:
                        assert chunks == []
                        continue
                    assert 1 <= len(chunks) <= splits
                    assert chunks[0][0] == start and chunks[-1][1] == length
                    assert all(c[1] == n[0] for c, n in zip(chunks, chunks[1:]))
                    assert all(hi > lo for lo, hi in chunks)
                    assert all(hi - lo >= min(min_rows, span)
                               for lo, hi in chunks[:-1])
                    # the last partial of the last (batch, head) fits
                    last = ((b * h - 1) * splits + len(chunks) - 1) * (2 + d)
                    assert len(chunks) == 1 or last + 2 + d <= floats


def _split_inputs(cache, b=4, nl=2, h=4, L=256, d=64):
    """The bf16 kind is held in f32 here, where the point is the algorithm.
    Row 1 a short span inside one chunk, row 2 a start inside a chunk, row
    3 empty (starts >= lengths, and at a 128-block edge, where
    the JAX kernel runs no block and gives zeros)."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, nl, h, L, d)).astype(np.float32)
    v = rng.standard_normal((b, nl, h, L, d)).astype(np.float32)
    lengths = np.asarray([200, 17, 256, 100], np.int32)
    starts = np.asarray([0, 5, 130, 128], np.int32)
    bias = (np.arange(L)[None, None, :] * np.asarray(alibi_slopes(h))[
        None, :, None]).astype(np.float32)
    kw = {}
    if cache == "int8":
        (k, ks), (v, vs) = (quantize_kv(jnp.asarray(x)) for x in (k, v))
        k, v = np.asarray(k), np.asarray(v)
        kw = dict(k_scale=np.asarray(ks), v_scale=np.asarray(vs))
    elif cache == "int4":
        kv, ks, vs = (np.asarray(x) for x in quantize_kv_int4(
            jnp.asarray(k), jnp.asarray(v)))
        k = v = kv
        kw = dict(k_scale=ks, v_scale=vs, kv_bits=4)
    return q, k, v, lengths, bias, starts, kw


@functools.lru_cache(maxsize=None)
def _jax_split_ref(cache):
    q, k, v, lengths, bias, starts, kw = _split_inputs(cache)
    return np.asarray(jdecode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        jnp.asarray(bias), starts=jnp.asarray(starts), layer=1, block_k=128,
        interpret=True, **{n: jnp.asarray(a) if isinstance(a, np.ndarray)
                           else a for n, a in kw.items()}))


def _split_and_merge(q, k, v, lengths, bias, starts, edges, *, k_scale=None,
                     v_scale=None, kv_bits=8, layer=1):
    """The kernel's algorithm in plain f32: each chunk [lo, hi) of `edges`
    (a row's list, or one list for every row) gives its (m, l, acc) over
    the positions of [starts[b], lengths[b]) it holds, in the kernel's
    order of operations, and `merge_partials` adds them in chunk order."""
    k, v = k[:, layer], v[:, layer]
    if kv_bits == 4:   # sign-extended nibbles
        k, v = ((k & 0xF) ^ 8) - 8, v >> 4
    k, v = k.float(), v.float()
    d = q.shape[-1]
    out = []
    for b in range(q.shape[0]):
        parts = []
        row_edges = edges(int(starts[b]), int(lengths[b]))
        for lo, hi in row_edges:
            s = torch.einsum("hd,hld->hl", q[b], k[b, :, lo:hi])
            if k_scale is not None:
                s = s * k_scale[b, layer, :, lo:hi]
            s = s * d ** -0.5 + bias[0, :, lo:hi]
            pos = torch.arange(lo, hi)
            ok = (pos >= starts[b]) & (pos < lengths[b])
            s = torch.where(ok, s, torch.full_like(s, float("-inf")))
            m = s.amax(-1)
            p = torch.where(ok, torch.exp(s - m[:, None]),
                            torch.zeros_like(s))
            pv = p if v_scale is None else p * v_scale[b, layer, :, lo:hi]
            acc = torch.einsum("hl,hld->hd", pv.to(q.dtype),
                               v[b, :, lo:hi])
            parts.append((m, p.sum(-1), acc))
        out.append(da.merge_partials(parts) if parts
                   else torch.zeros(q.shape[1:]))
    return torch.stack(out)


@pytest.mark.parametrize("edges", ["kernel", "grid48"])
@pytest.mark.parametrize("cache", sorted(KINDS))
def test_split_and_merge_matches_jax_kernel(cache, edges):
    """The split and the merge rule against the JAX kernel (interpret
    mode): with the kernel's own cut of each span (split_chunks, five
    splits of at least 16 rows), and with chunks on a fixed 48-row grid
    whose edges cut through starts and lengths and whose chunks may hold no
    valid key. The empty row gives zeros."""
    q, k, v, lengths, bias, starts, kw = _split_inputs(cache)
    ref = _jax_split_ref(cache)
    cut = {"kernel": lambda s, e: da.split_chunks(s, e, 5, 16),
           "grid48": lambda s, e: [(lo, min(lo + 48, 256))
                                   for lo in range(0, 256, 48)]}[edges]
    t = lambda a: torch.from_numpy(np.array(a))
    out = _split_and_merge(t(q), t(k), t(v), t(lengths), t(bias), t(starts),
                           cut, **{n: t(a) if isinstance(a, np.ndarray) else a
                                   for n, a in kw.items()})
    if edges == "kernel":
        assert len(cut(5, 17)) == 1 and len(cut(0, 200)) > 1
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    assert not out[3].any()
