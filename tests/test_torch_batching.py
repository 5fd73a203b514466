"""The port's continuous batcher (`otter_tpu_torch.generation.batching`)
against the JAX package's `ContinuousBatcher` and against the port's own
`OtterGenerator` alone, on the tiny models in f32 on the CPU.

Greedy tokens must be equal: through the JAX batcher and through the
port's, concurrent, staggered (more requests than slots), beams, chunked
prefill and idefics, with f32, bf16 and int8 caches. A pooled step's
logits are held to JAX's decode step on the same pool state within 1e-4.
Sampled tokens cannot equal `jax.random`'s bits: the filter is held to
JAX's exactly, and sampling to its distribution and to one seed.

The JAX batchers run once a module (`jax_runs`), each at one bucket.
"""

import queue
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.config import GenerationConfig as JaxGen
from otter_tpu.generation import batching as jbatching
from otter_tpu_torch.config import GenerationConfig
from otter_tpu_torch.generation import batching, sampling
from otter_tpu_torch.generation.engine import OtterGenerator
from torch_parity_helpers import (idefics_inputs, idefics_pair, inputs,
                                  jax_tiny, spec_pair, torch_tiny)

SLOTS, L, BUCKET = 3, 64, 16
CACHES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "int8": (torch.int8, "int8")}


def _prompts(cfg, lengths, seed, media_at=None):
    """(vision_x, ids) per request: one image each, the media token first
    (or at `media_at[i]`)."""
    out = []
    for i, s in enumerate(lengths):
        vx, ids = inputs(cfg, seed + i, 1, s)
        if media_at is not None and media_at[i]:
            ids[0, 0] = 5
            ids[0, media_at[i]] = cfg.media_token_id
        out.append((vx, ids))
    return out


GREEDY = (8, 10, 12, 9)
BEAM = (9,)
CHUNKED = ((10, 0), (13, 5), (9, 0))


def _requests(cfg):
    return dict(
        greedy=_prompts(cfg, GREEDY, 40),
        beam=_prompts(cfg, BEAM, 50),
        chunked=_prompts(cfg, [s for s, _ in CHUNKED], 60,
                         media_at=[m for _, m in CHUNKED]))


def _cut(tokens, eos):
    """A stream's tokens from a generated continuation: up to its eos."""
    tokens = list(tokens)
    return tokens[:tokens.index(eos)] if eos in tokens else tokens


def _run(b, reqs, gens, stagger_after=None):
    """Every request through batcher `b` (each on its own thread; with
    `stagger_after` k, the rest are submitted 0.2 s after the first k)."""
    results = [None] * len(reqs)

    def run(i):
        results[i] = list(b.submit(*reqs[i], gens[i]))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(reqs))]
    for i, t in enumerate(threads):
        t.start()
        if stagger_after is not None and i + 1 == stagger_after:
            time.sleep(0.2)
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    return results


def _jax_batcher(cache, **kw):
    cfg, jmodel, params, _ = jax_tiny()
    return jbatching.ContinuousBatcher(
        jmodel, params, cfg, num_slots=kw.pop("num_slots", SLOTS),
        cache_len=kw.pop("cache_len", L), buckets=(BUCKET,),
        cache_dtype=CACHES[cache][1], **kw)


def _port_batcher(model, cache, **kw):
    return batching.ContinuousBatcher(
        model, num_slots=kw.pop("num_slots", SLOTS), cache_len=L,
        buckets=(BUCKET,), cache_dtype=CACHES[cache][0], **kw)


@pytest.fixture(scope="module")
def model():
    return torch_tiny().eval()


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX batcher's tokens: the greedy requests (f32, bf16 and int8
    caches) and the beam request (f32) on a pool of 3, the chunked
    requests (prefill_chunk=4, f32), and its stats keys."""
    cfg = jax_tiny()[0]
    reqs = _requests(cfg)
    out = {}
    for cache in CACHES:
        b = _jax_batcher(cache, max_admits_per_iter=4)
        try:
            out[cache] = [list(b.submit(vx, ids, JaxGen(max_new_tokens=5)))
                          for vx, ids in reqs["greedy"]]
            if cache == "f32":
                out["beam"] = list(b.submit(*reqs["beam"][0], JaxGen(
                    max_new_tokens=5, num_beams=2)))
                out["stats_keys"] = set(b.stats())
        finally:
            b.shutdown()
    b = _jax_batcher("f32", prefill_chunk=4)
    try:
        out["chunked"] = [list(b.submit(vx, ids, JaxGen(max_new_tokens=6)))
                          for vx, ids in reqs["chunked"]]
    finally:
        b.shutdown()
    return out


def _alone(model, reqs, max_new, cache=torch.float32, **gkw):
    """Each request through `OtterGenerator.generate` alone, cut at eos."""
    eng = OtterGenerator(model, cache_dtype=cache)
    out = []
    for vx, ids in reqs:
        toks = eng.generate(vx, ids, gen=GenerationConfig(
            max_new_tokens=max_new, **gkw))[0, ids.shape[1]:]
        out.append(_cut(toks.tolist(), model.cfg.eoc_token_id))
    return out


# ── sampling ─────────────────────────────────────────────────────────

def test_filter_rows_matches_jax():
    """Equal to JAX's filter, value for value, on every row with a
    nucleus (top_p < 1). At top_p = 1 the nucleus test `cum - p < 1`
    still drops tokens whose mass is lost when the cumulative sum rounds
    to 1 in f32, where JAX sums in f32 and torch's CPU cumsum in f64:
    there the two may differ only on tokens of probability below f32's
    epsilon."""
    rng = np.random.default_rng(3)
    scaled = (rng.standard_normal((6, 256)) * 3).astype(np.float32)
    top_k = np.asarray([0, 1, 5, 50, 0, 256], np.int32)
    top_p = np.asarray([1.0, 0.9, 0.5, 0.95, 0.3, 0.99], np.float32)
    want = np.asarray(jbatching.filter_rows(
        jnp.asarray(scaled), jnp.asarray(top_k), jnp.asarray(top_p)))
    got = sampling.filter_rows(torch.from_numpy(scaled),
                               torch.from_numpy(top_k),
                               torch.from_numpy(top_p)).numpy()
    nucleus = top_p < 1
    np.testing.assert_array_equal(got[nucleus], want[nucleus])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(scaled), -1))
    differ = got[~nucleus] != want[~nucleus]
    assert (probs[~nucleus][differ] < np.finfo(np.float32).eps).all()
    kept = (want > sampling.NEG_INF).sum(-1)
    assert kept[1] == 1 and 1 <= kept[2] <= 5


def test_sample_rows_controls_distribution_and_seed():
    """Greedy rows take the argmax, a sampled row at a tiny temperature
    too (JAX's own test); a sampled row draws from the softmax of JAX's
    filtered logits; one seed gives the same draws."""
    logits = torch.tensor([[0.0, 5.0, 1.0, 2.0]] * 2)
    toks = sampling.sample_rows(
        logits, do_sample=torch.tensor([False, True]),
        temperature=torch.tensor([1.0, 0.01]), top_k=torch.tensor([0, 2]),
        top_p=torch.tensor([1.0, 0.5]))
    assert toks.tolist() == [1, 1]
    n = 40000
    row = np.asarray([0.5, 1.5, -0.3, 1.0, 0.2], np.float32)
    ctl = dict(do_sample=torch.ones(n, dtype=torch.bool),
               temperature=torch.full((n,), 0.8),
               top_k=torch.full((n,), 4), top_p=torch.full((n,), 0.9))
    g = torch.Generator().manual_seed(5)
    draws = sampling.sample_rows(torch.from_numpy(np.tile(row, (n, 1))),
                                 generator=g, **ctl)
    want = np.asarray(jax.nn.softmax(jbatching.filter_rows(
        jnp.asarray(row / 0.8)[None], jnp.asarray([4]),
        jnp.asarray([0.9], jnp.float32))[0]))
    freq = np.bincount(draws.numpy(), minlength=5) / n
    np.testing.assert_allclose(freq, want, atol=0.01)
    again = sampling.sample_rows(torch.from_numpy(np.tile(row, (n, 1))),
                                 generator=torch.Generator().manual_seed(5),
                                 **ctl)
    assert torch.equal(draws, again)


# ── greedy requests: the JAX batcher, the port's, generate alone ─────

@pytest.mark.parametrize("cache", list(CACHES))
def test_concurrent_greedy_matches_jax_and_generate(model, jax_runs, cache):
    reqs = _requests(model.cfg)["greedy"]
    b = _port_batcher(model, cache, max_admits_per_iter=4)
    try:
        got = _run(b, reqs, [GenerationConfig(max_new_tokens=5)] * 4)
    finally:
        b.shutdown()
    assert got == jax_runs[cache]
    if cache == "f32":
        assert got == _alone(model, reqs, 5)


def test_staggered_admission_and_slot_reuse(model, jax_runs):
    """Four requests on two slots, the last two submitted mid-decode:
    later requests take freed slots and still give their tokens alone."""
    reqs = _requests(model.cfg)["greedy"]
    b = _port_batcher(model, "f32", num_slots=2)
    try:
        got = _run(b, reqs, [GenerationConfig(max_new_tokens=5)] * 4,
                   stagger_after=2)
        for _ in range(5):
            assert sum(s.active or s.pending for s in b._slots) <= 2
    finally:
        b.shutdown()
    assert got == jax_runs["f32"] == _alone(model, reqs, 5)


def test_stats_keys_and_admission_cap(model, jax_runs):
    reqs = _requests(model.cfg)["greedy"][:3]
    b = _port_batcher(model, "f32", max_admits_per_iter=1)
    try:
        outs = _run(b, reqs, [GenerationConfig(max_new_tokens=4)] * 3)
        stats = b.stats()
    finally:
        b.shutdown()
    assert all(len(o) >= 1 for o in outs)
    assert set(stats) == jax_runs["stats_keys"]
    assert stats["completed"] == 3
    assert stats["num_slots"] == SLOTS and stats["active_slots"] == 0
    assert stats["ttft_p50_s"] > 0
    for rec in stats["recent"]:
        assert rec["new_tokens"] >= 1
        assert rec["ttft_s"] >= rec["queue_s"] >= 0
        assert rec["total_s"] >= rec["ttft_s"]


def test_finished_row_at_the_cache_end(model):
    """A request that fills its row of the cache (written == cache_len)
    stops there while another keeps decoding: the finished row's step
    writes no column past the cache, and the other request gets its
    tokens alone."""
    reqs = _requests(model.cfg)["greedy"][:2]
    b = batching.ContinuousBatcher(model, num_slots=2, cache_len=20,
                                   buckets=(BUCKET,),
                                   cache_dtype=torch.float32,
                                   max_admits_per_iter=2)
    try:
        short = b.submit(*reqs[0], GenerationConfig(max_new_tokens=10))
        time.sleep(0.05)
        long_ = b.submit(*reqs[1], GenerationConfig(max_new_tokens=9))
        got_short, got_long = list(short), list(long_)
    finally:
        b.shutdown()
    assert b._failure is None
    # bucket 16 + 4 cache columns: the first token and 4 steps
    assert got_short == _alone(model, reqs[:1], 10)[0][:5]
    assert got_long == _alone(model, reqs[1:], 9)[0][:5]


# ── one pooled step against JAX's ───────────────────────────────────

def _pool_state(cfg, cache, n=4, length=32, seed=9):
    """A pool of 4 rows in numpy: two live (left-padded, different
    lengths; row 1 bans repeated bigrams), one finished at written ==
    cache_len, one never used."""
    rng = np.random.default_rng(seed)
    t = cfg.text
    shape = (n, t.num_hidden_layers, t.kv_heads, length, t.head_dim)
    if cache == "int8":
        kv = {k: rng.integers(-127, 128, shape).astype(np.int8)
              for k in ("k", "v")}
        kv.update({k: rng.uniform(0.002, 0.02, shape[:-1]).astype(np.float32)
                   for k in ("k_scale", "v_scale")})
    else:
        kv = {k: (rng.standard_normal(shape) * 0.5).astype(np.float32)
              for k in ("k", "v")}
        if cache == "bf16":   # values a bf16 cache holds exactly
            kv = {k: torch.from_numpy(v).bfloat16().float().numpy()
                  for k, v in kv.items()}
    valid = np.zeros((n, length), bool)
    valid[0, 5:16] = True
    valid[1, 2:21] = True
    valid[2, :] = True
    return dict(
        cache=kv, valid=valid,
        buffer=rng.integers(1, 200, (n, length)),
        latents=rng.standard_normal(
            (n, 1, cfg.perceiver.num_latents, cfg.perceiver.dim)
        ).astype(np.float32),
        toks=np.asarray([17, 33, 0, 5]),
        alive=np.asarray([True, True, False, False]),
        written=np.asarray([16, 21, length, 0]),
        emitted=np.asarray([1, 3, 17, 0]),
        real_len=np.asarray([11, 19, 16, 0]),
        media=np.asarray([1, 1, 1, 0]),
        lp_idx=np.asarray([-1, 0, -1, -1]),
        valid_from=np.asarray([5, 2, 0, 0]),
        do_sample=np.zeros(n, bool), temperature=np.ones(n, np.float32),
        top_k=np.zeros(n), top_p=np.ones(n, np.float32),
        eos=np.full(n, cfg.eoc_token_id), max_new=np.full(n, 10))


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_pooled_step_matches_jax_decode_step(model, cache):
    _pooled_step_case(model, cache, in_pool=False)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_pooled_step_on_the_pool_tensors_matches_jax(model, cache):
    """The same pool state copied into the batcher's own tensors, the step
    run by `_run_step` on them (what a graph captures and replays): JAX's
    step, as above, and every tensor of the pool still the one allocated
    at construction (the latents at the first admission)."""
    _pooled_step_case(model, cache, in_pool=True)


def _pooled_step_case(model, cache, in_pool):
    cfg = model.cfg
    st = _pool_state(cfg, cache)
    lp = ((2, None),)
    jb = _jax_batcher(cache, num_slots=4, cache_len=32)
    jb.shutdown()
    jdtype = jnp.bfloat16 if cache == "bf16" else None
    jcache = {k: jnp.asarray(v, jdtype if k in ("k", "v") and jdtype
                             else v.dtype) for k, v in st["cache"].items()}
    i32 = lambda k: jnp.asarray(st[k], jnp.int32)
    (jnxt, jalive, jwritten, jemitted, jcache2, jbuffer, jvalid,
     jlogits) = jb._get_decode(lp, True)(
        jax_tiny()[2], jcache, i32("buffer"), jnp.asarray(st["valid"]),
        jnp.asarray(st["latents"]), i32("toks"), jnp.asarray(st["alive"]),
        i32("written"), i32("emitted"), i32("real_len"), i32("media"),
        i32("lp_idx"), i32("valid_from"), jnp.asarray(st["do_sample"]),
        jnp.asarray(st["temperature"]), i32("top_k"),
        jnp.asarray(st["top_p"]), i32("eos"), i32("max_new"),
        jax.random.PRNGKey(0))

    b = batching.ContinuousBatcher(model, num_slots=4, cache_len=32,
                                   buckets=(BUCKET,),
                                   cache_dtype=CACHES[cache][0])
    b.shutdown()
    t = lambda k, dtype=torch.long: torch.as_tensor(st[k]).to(dtype)
    cache_t = {k: torch.from_numpy(v).to(CACHES[cache][0]
                                         if k in ("k", "v") else
                                         torch.float32)
               for k, v in st["cache"].items()}
    ca = dict(toks=t("toks"), alive=t("alive", torch.bool),
              written=t("written"), emitted=t("emitted"))
    statics = {k: t(k, dtype) for k, dtype in (
        ("real_len", torch.long), ("media", torch.int32),
        ("lp_idx", torch.long), ("valid_from", torch.long),
        ("do_sample", torch.bool), ("temperature", torch.float32),
        ("top_k", torch.long), ("top_p", torch.float32),
        ("eos", torch.long), ("max_new", torch.long))}
    if in_pool:
        # as the first admission allocates them
        b._latents = torch.zeros(st["latents"].shape)
        pool = _pool_tensors(b)
        for k, v in cache_t.items():
            b._cache[k].copy_(v)
        b._buffer.copy_(t("buffer"))
        b._valid.copy_(t("valid", torch.bool))
        b._latents.copy_(torch.from_numpy(st["latents"]))
        for mine, theirs in ((b._carried, ca), (b._statics, statics)):
            for k, v in theirs.items():
                mine[k].copy_(v)
        b._lp_list, b._dirty = lp, False
        nxt, alive, written, emitted, logits = b._run_step(True)
        assert nxt is b._carried["toks"]
        now = _pool_tensors(b)
        assert now.keys() == pool.keys()
        assert all(now[k] is pool[k] for k in pool)
    else:
        b._cache = cache_t
        b._buffer, b._valid = t("buffer"), t("valid", torch.bool)
        b._latents = torch.from_numpy(st["latents"])
        nxt, alive, written, emitted, logits = b._decode_step(ca, statics, lp,
                                                              True)
    live = [0, 1]
    want = np.asarray(jlogits, np.float32)
    np.testing.assert_allclose(logits.numpy()[live], want[live], atol=1e-4,
                               rtol=0)
    # the ban on row 1 is the same set of tokens
    assert ((want[1] <= sampling.NEG_INF)
            == (logits.numpy()[1] <= sampling.NEG_INF)).all()
    for got, ref in ((nxt, jnxt), (alive, jalive), (written, jwritten),
                     (emitted, jemitted)):
        assert got.tolist() == np.asarray(ref).tolist()
    assert np.array_equal(b._valid.numpy(), np.asarray(jvalid))
    # the finished row at written == cache_len: JAX drops its write, the
    # port writes its last column; every other row is JAX's
    rows = [0, 1, 3]
    assert np.array_equal(b._buffer.numpy()[rows], np.asarray(jbuffer)[rows])
    for k in jcache2:
        ref = np.asarray(jcache2[k], np.float32)[rows]
        got = b._cache[k].float().numpy()[rows]
        if k in ("k", "v") and cache == "int8":
            assert (np.abs(got.astype(np.int32) - ref) <= 1).all(), k
        else:
            np.testing.assert_allclose(got, ref, atol=1e-2 if cache == "bf16"
                                       else 1e-6, err_msg=k)


def _pool_tensors(b):
    """{name: tensor} of every tensor a pooled step reads or writes: the
    cache, the token buffer, the valid mask, the latents, the carried slot
    state and the per-admission values."""
    out = {f"cache/{k}": v for k, v in b._cache.items()}
    out.update(buffer=b._buffer, valid=b._valid, latents=b._latents)
    out.update({f"carried/{k}": v for k, v in b._carried.items()})
    out.update({f"statics/{k}": v for k, v in b._statics.items()
                if isinstance(v, torch.Tensor)})
    return out


def test_pool_tensors_stay_in_place(model, jax_runs):
    """Every tensor a pooled step reads or writes keeps its storage across
    decode steps, admissions (chunked prefills) and a beam group's reorder
    of its rows: what a captured graph replays on, the counterpart of the
    cache, buffer and valid mask that JAX's step donates. The requests'
    tokens stay the JAX batcher's."""
    reqs = _requests(model.cfg)
    b = _port_batcher(model, "f32", prefill_chunk=4)
    reorders, steps = [], []
    reorder, step = b._reorder, b._decode_step
    b._reorder = lambda *a: (reorders.append(1), reorder(*a))[1]
    b._decode_step = lambda *a: (steps.append(1), step(*a))[1]
    gen = GenerationConfig(max_new_tokens=6)
    try:
        first = list(b.submit(*reqs["chunked"][0], gen))
        pool = _pool_tensors(b)
        ptrs = {k: v.data_ptr() for k, v in pool.items()}
        n_steps = len(steps)
        chunked = _run(b, reqs["chunked"], [gen] * 3, stagger_after=1)
        beam = list(b.submit(*reqs["beam"][0], GenerationConfig(
            max_new_tokens=5, num_beams=2)))
    finally:
        b.shutdown()
    assert b._failure is None
    assert first == jax_runs["chunked"][0]
    assert chunked == jax_runs["chunked"]
    assert beam == jax_runs["beam"]
    assert n_steps > 0 and len(steps) > n_steps and reorders
    now = _pool_tensors(b)
    assert now.keys() == pool.keys()
    assert all(now[k] is pool[k] and now[k].data_ptr() == ptrs[k]
               for k in pool)


def test_graph_refused_where_it_cannot_run(model):
    """`cuda_graph=True` is refused on the CPU (with a draft too) and on a
    sharded model or draft; the default is off on each, before any thread
    starts. (A pool with a draft on the card is graphed by default.)"""
    plain = _port_batcher(model, "f32")
    plain.shutdown()
    assert plain.cuda_graph is False
    with pytest.raises(ValueError, match="CUDA model"):
        _port_batcher(model, "f32", cuda_graph=True)
    sharded = torch_tiny().eval()
    sharded._shard_layouts = {}
    with pytest.raises(ValueError, match="sharded"):
        _port_batcher(sharded, "f32", cuda_graph=True)
    draft = spec_pair("mpt")[1][3]
    with pytest.raises(ValueError, match="draft"):
        _port_batcher(model, "f32", draft=draft, cuda_graph=True)
    spec = _port_batcher(model, "f32", draft=draft)
    spec.shutdown()
    assert spec.cuda_graph is False
    sharded_d = SimpleNamespace(cfg=draft.cfg, device=draft.device,
                                _shard_layouts={})
    with pytest.raises(ValueError, match="sharded model and draft"):
        _port_batcher(model, "f32", draft=sharded_d, cuda_graph=True)


# ── beams ────────────────────────────────────────────────────────────

def test_beams_match_generate_and_jax(model, jax_runs):
    reqs = _requests(model.cfg)["beam"]
    b = _port_batcher(model, "f32")
    try:
        got = list(b.submit(*reqs[0], GenerationConfig(max_new_tokens=5,
                                                       num_beams=2)))
    finally:
        b.shutdown()
    assert got == jax_runs["beam"]
    assert got == _alone(model, reqs, 5, num_beams=2)[0]


def test_beam_and_greedy_requests_share_the_pool(model, jax_runs):
    reqs = _requests(model.cfg)
    b = _port_batcher(model, "f32", max_admits_per_iter=4)
    try:
        s_beam = b.submit(*reqs["beam"][0], GenerationConfig(
            max_new_tokens=5, num_beams=2))
        s_greedy = b.submit(*reqs["greedy"][1],
                            GenerationConfig(max_new_tokens=5))
        got_beam, got_greedy = list(s_beam), list(s_greedy)
    finally:
        b.shutdown()
    assert got_beam == jax_runs["beam"]
    assert got_greedy == jax_runs["f32"][1]


def test_beam_request_defers_until_slots_free(model):
    """num_beams=3 on a pool of 3 with a greedy request holding a slot:
    the beam request waits, then runs once the pool frees up."""
    reqs = _requests(model.cfg)
    b = _port_batcher(model, "f32")
    try:
        s_greedy = b.submit(*reqs["greedy"][0],
                            GenerationConfig(max_new_tokens=6))
        s_beam = b.submit(*reqs["beam"][0], GenerationConfig(
            max_new_tokens=4, num_beams=3))
        got_greedy, got_beam = list(s_greedy), list(s_beam)
    finally:
        b.shutdown()
    assert got_greedy == _alone(model, reqs["greedy"][:1], 6)[0]
    assert got_beam == _alone(model, reqs["beam"], 4, num_beams=3)[0]


def test_num_beams_capped_at_the_pool(model):
    reqs = _requests(model.cfg)["beam"]
    b = _port_batcher(model, "f32", num_slots=2)
    try:
        got = list(b.submit(*reqs[0], GenerationConfig(max_new_tokens=3,
                                                       num_beams=8)))
    finally:
        b.shutdown()
    assert got == _alone(model, reqs, 3, num_beams=2)[0]


# ── chunked prefill ──────────────────────────────────────────────────

def test_chunked_prefill_matches_one_shot_and_jax(model, jax_runs):
    """Chunks of 4 interleaved with decode steps (one prompt's media token
    mid-prompt, so early chunks precede it): the JAX batcher's chunked
    tokens, and each request's tokens alone."""
    reqs = _requests(model.cfg)["chunked"]
    b = _port_batcher(model, "f32", prefill_chunk=4)
    try:
        got = _run(b, reqs, [GenerationConfig(max_new_tokens=6)] * 3,
                   stagger_after=1)
    finally:
        b.shutdown()
    assert got == jax_runs["chunked"] == _alone(model, reqs, 6)


def test_chunked_cache_equals_one_shot_prefill(model):
    """The chunk-assembled cache equals the one-shot prefill's at every
    attendable position (1e-5), and so do the last logits (1e-4)."""
    from otter_tpu_torch.generation.engine import left_pad
    vx, ids = _requests(model.cfg)["chunked"][1]
    b = _port_batcher(model, "f32", prefill_chunk=4)
    b.shutdown()
    padded, mask = left_pad(ids, None, target_len=BUCKET)
    padded, mask = torch.from_numpy(padded).long(), torch.from_numpy(mask)
    ref_logits, ref_cache, _ = b._prefill(vx, padded, mask, BUCKET)
    task = b._chunk_begin(vx, ids, GenerationConfig(), queue.Queue())
    while b._chunk_tasks:
        b._advance_chunked()
    valid = mask[0].bool()
    for key, want in ref_cache.items():
        torch.testing.assert_close(task["cache"][key][:, :, :, valid],
                                   want[:, :, :, valid], atol=1e-5,
                                   rtol=1e-5)
    torch.testing.assert_close(task["last"], ref_logits, atol=1e-4,
                               rtol=1e-4)


# ── idefics ──────────────────────────────────────────────────────────

def test_idefics_through_the_batcher():
    """IdeficsVLM decodes through the same pooled step: two requests,
    their tokens the JAX batcher's and `generate`'s alone."""
    cfg, jmodel, params, tmodel = idefics_pair()
    reqs = []
    for seed, s in ((70, 12), (71, 14)):
        vx, ids = idefics_inputs(cfg, seed, batch=1, seq=s, images=1)
        reqs.append((vx, ids))
    jb = jbatching.ContinuousBatcher(jmodel, params, cfg, num_slots=2,
                                     cache_len=L, buckets=(BUCKET,),
                                     cache_dtype=jnp.float32)
    try:
        want = [list(jb.submit(vx, ids, JaxGen(max_new_tokens=4)))
                for vx, ids in reqs]
    finally:
        jb.shutdown()
    b = batching.ContinuousBatcher(tmodel, num_slots=2, cache_len=L,
                                   buckets=(BUCKET,),
                                   cache_dtype=torch.float32)
    try:
        got = _run(b, reqs, [GenerationConfig(max_new_tokens=4)] * 2)
    finally:
        b.shutdown()
    assert got == want == _alone(tmodel, reqs, 4)
    with pytest.raises(ValueError, match="IdeficsVLM"):
        batching.ContinuousBatcher(tmodel, num_slots=1, cache_len=L,
                                   buckets=(BUCKET,), prefill_chunk=4)


# ── sizing ───────────────────────────────────────────────────────────

@pytest.mark.parametrize("cache", list(CACHES))
def test_autotune_num_slots_matches_jax(model, cache):
    cfg, _, params, _ = jax_tiny()
    param_bytes = sum(int(np.prod(x.shape)) * jnp.dtype(x.dtype).itemsize
                      for x in jax.tree_util.tree_leaves(params))
    assert param_bytes == batching._param_bytes(model)
    t = cfg.text
    row = 2 * t.num_hidden_layers * t.kv_heads * L * t.head_dim * 4
    jd, td = CACHES[cache][1], CACHES[cache][0]
    for budget, kw in ((param_bytes + 3.5 * row, dict(headroom_bytes=0.0)),
                       (0.0, {}), (1e15, dict(max_slots=32)),
                       (param_bytes + 2e9 + 7.2 * row, {})):
        assert (batching.autotune_num_slots(model, L, td, hbm_bytes=budget,
                                            **kw)
                == jbatching.autotune_num_slots(params, cfg, L, jd,
                                                hbm_bytes=budget, **kw))
    b = batching.ContinuousBatcher(
        model, num_slots="auto", cache_len=L, buckets=(BUCKET,),
        cache_dtype=td, hbm_bytes=param_bytes + 3.5 * row + 1.5e9)
    b.shutdown()
    assert b.n == jbatching.autotune_num_slots(
        params, cfg, L, jd, hbm_bytes=param_bytes + 3.5 * row + 1.5e9)
    with pytest.raises(ValueError, match="hbm_bytes"):
        batching.autotune_num_slots(model, L, td)


# ── failure ──────────────────────────────────────────────────────────

def test_scheduler_failure_fails_every_stream(model):
    """A scheduler exception reaches every consumer stream (RuntimeError,
    the cause chained), and later submits raise."""
    vx, ids = _requests(model.cfg)["greedy"][0]
    b = _port_batcher(model, "f32")

    def boom(*a, **k):
        raise ValueError("injected scheduler fault")

    b._step = boom
    try:
        stream = b.submit(vx, ids, GenerationConfig(max_new_tokens=4))
        with pytest.raises(RuntimeError, match="scheduler thread"):
            list(stream)
        assert isinstance(b._failure, ValueError)
        with pytest.raises(RuntimeError, match="scheduler thread"):
            b.submit(vx, ids, GenerationConfig(max_new_tokens=4))
    finally:
        b.shutdown()


def test_finisher_failure_fails_every_stream(model):
    """A failure where the finisher waits for a first token (a device
    error surfaces where the host waits) fails the streams as a scheduler
    failure does; the JAX finisher thread would die alone and leave its
    stream waiting."""
    vx, ids = _requests(model.cfg)["greedy"][0]
    b = _port_batcher(model, "f32")

    def boom(copy):
        raise ValueError("injected readback fault")

    b._host_values = boom
    try:
        stream = b.submit(vx, ids, GenerationConfig(max_new_tokens=4))
        with pytest.raises(RuntimeError, match="scheduler thread") as e:
            list(stream)
        assert isinstance(e.value.__cause__, ValueError)
    finally:
        b.shutdown()


def test_a_submit_racing_a_failure_is_failed(model):
    """The scheduler fails while a submit is between its failure check
    and its put (held there by a queue whose put waits): the request must
    still be failed. Where the check and the put are not under the lock
    that the failure takes (the JAX batcher's `submit`), the failure
    drains an empty queue first and the stream waits forever."""
    vx, ids = _requests(model.cfg)["greedy"][0]
    b = _port_batcher(model, "f32")
    entered, failed = threading.Event(), threading.Event()
    fail = b._fail_streams

    def fail_streams(exc):
        fail(exc)
        failed.set()

    class HeldQueue(queue.Queue):
        def put(self, item, *a, **k):
            entered.set()
            failed.wait(timeout=2)
            super().put(item, *a, **k)

    def boom():
        entered.wait(10)
        raise ValueError("injected scheduler fault")

    b._fail_streams, b._pending, b._step = fail_streams, HeldQueue(), boom
    result = []

    def consume():
        try:
            list(b.submit(vx, ids, GenerationConfig(max_new_tokens=4)))
            result.append("finished")
        except RuntimeError as e:
            result.append(e)

    try:
        th = threading.Thread(target=consume, daemon=True)
        th.start()
        th.join(10)
        assert not th.is_alive(), "the stream was never failed"
        assert isinstance(result[0], RuntimeError)
        assert isinstance(result[0].__cause__, ValueError)
    finally:
        b.shutdown()


def test_refusals(model):
    """A draft of another vocabulary, or a cache with no room for a verify
    window after the largest bucket, is refused when the pool is built; a
    request with more media than the pool holds a slot is refused at
    submit (its stream never returns from the JAX batcher), and the pool
    serves on after it."""
    draft = spec_pair("mpt")[1][3]
    with pytest.raises(ValueError, match="vocabulary"):
        batching.ContinuousBatcher(model, draft=SimpleNamespace(
            cfg=SimpleNamespace(text=SimpleNamespace(vocab_size=7))))
    with pytest.raises(ValueError, match="gamma"):
        batching.ContinuousBatcher(model, cache_len=L, buckets=(60,),
                                   draft=draft, spec_gamma=4)
    vx, ids = inputs(model.cfg, 80, 1, 10, images=2)
    b = _port_batcher(model, "f32")
    try:
        with pytest.raises(ValueError, match="max_media=1"):
            b.submit(vx, ids, GenerationConfig(max_new_tokens=2))
        one = _requests(model.cfg)["greedy"][0]
        assert list(b.submit(*one, GenerationConfig(max_new_tokens=5))) \
            == _alone(model, [one], 5)[0]
    finally:
        b.shutdown()


# ── speculative rounds over the pool (draft=) ───────────────────────

SPEC = (8, 10, 12)


@pytest.fixture(scope="module")
def draft():
    return spec_pair("mpt")[1]


@pytest.fixture(scope="module")
def jax_spec_pool(draft):
    """The JAX batcher with the draft attached (gamma 3, three slots):
    three greedy requests of 7 new tokens."""
    cfg_d, jmodel_d, params_d, _ = draft
    reqs = _prompts(jax_tiny()[0], SPEC, 90)
    b = _jax_batcher("f32", draft=(jmodel_d, params_d, cfg_d), spec_gamma=3,
                     spec_adaptive=False)
    try:
        return [list(b.submit(vx, ids, JaxGen(max_new_tokens=7)))
                for vx, ids in reqs]
    finally:
        b.shutdown()


def _spec_batcher(model, draft_model, **kw):
    kw.setdefault("spec_adaptive", False)
    return batching.ContinuousBatcher(
        model, num_slots=kw.pop("num_slots", SLOTS),
        cache_len=kw.pop("cache_len", L), buckets=(BUCKET,),
        cache_dtype=torch.float32, draft=draft_model, **kw)


def _count_rounds(b):
    """Wrap `b._spec_round`: the gamma of each round that emitted a token
    (with pipelining one more round is queued before the host sees that
    the last row finished)."""
    rounds, spec_round = [], b._spec_round

    def counted(*a):
        out = spec_round(*a)
        if int(out[1].sum()):
            rounds.append(a[-1])
        return out

    b._spec_round = counted
    return rounds


def test_spec_pool_greedy_matches_single_stream(model, draft,
                                                jax_spec_pool):
    """Greedy requests through a pool with a draft (independent weights):
    the JAX batcher's tokens and each request's `generate` alone."""
    reqs = _prompts(model.cfg, SPEC, 90)
    b = _spec_batcher(model, draft[3], spec_gamma=3)
    rounds = _count_rounds(b)
    try:
        got = _run(b, reqs, [GenerationConfig(max_new_tokens=7)] * 3)
    finally:
        b.shutdown()
    assert got == jax_spec_pool == _alone(model, reqs, 7)
    assert rounds and set(rounds) == {3}


def test_spec_pool_self_draft_accepts_everything(model):
    """The target as its own draft: every greedy proposal is accepted, so
    9 tokens arrive in the first token and ceil(8 / 5) = 2 rounds."""
    vx, ids = _prompts(model.cfg, (10,), 91)[0]
    b = _spec_batcher(model, model, num_slots=2, spec_gamma=4)
    rounds = _count_rounds(b)
    try:
        got = list(b.submit(vx, ids, GenerationConfig(max_new_tokens=9)))
    finally:
        b.shutdown()
    assert got == _alone(model, [(vx, ids)], 9)[0]
    assert len(rounds) == 2
    assert b.stats()["spec"]["accept_ema_tok_per_round"][4] >= 4


def test_spec_pool_mixed_greedy_sampled_and_reuse(model, draft):
    """Greedy and sampled requests share one pool of 2 (four requests:
    slots are reused, the draft's pools rewritten): the greedy rows give
    their tokens alone; the sampled rows emit 1..5 tokens, none eos."""
    reqs = _prompts(model.cfg, (8, 9, 10, 11), 92)
    gens = [GenerationConfig(max_new_tokens=5),
            GenerationConfig(max_new_tokens=5),
            GenerationConfig(max_new_tokens=5, do_sample=True,
                             temperature=0.9, top_k=40),
            GenerationConfig(max_new_tokens=5, do_sample=True, top_p=0.9)]
    b = _spec_batcher(model, draft[3], num_slots=2, spec_gamma=3)
    try:
        got = _run(b, reqs, gens)
    finally:
        b.shutdown()
    assert got[:2] == _alone(model, reqs[:2], 5)
    for g in got[2:]:
        assert 0 < len(g) <= 5 and model.cfg.eoc_token_id not in g


def test_spec_pool_with_chunked_prefill(model, draft):
    """A chunked target prefill and the draft's one-shot prefill compose:
    the request's tokens alone."""
    reqs = _prompts(model.cfg, (13,), 93)
    b = _spec_batcher(model, draft[3], num_slots=2, spec_gamma=3,
                      prefill_chunk=4)
    try:
        got = list(b.submit(*reqs[0], GenerationConfig(max_new_tokens=6)))
    finally:
        b.shutdown()
    assert got == _alone(model, reqs, 6)[0]


def test_spec_pool_caps_beams_to_one(model):
    """A num_beams=3 request in a pool with a draft runs greedy (a beam
    revises its past; the cache never rolls back)."""
    reqs = _prompts(model.cfg, (9,), 94)
    b = _spec_batcher(model, model, num_slots=2, spec_gamma=2)
    try:
        got = list(b.submit(*reqs[0], GenerationConfig(max_new_tokens=5,
                                                       num_beams=3)))
    finally:
        b.shutdown()
    assert got == _alone(model, reqs, 5)[0]


class _Clock:
    """A host clock that moves 1 s a call: iteration times are the same
    in every mode, so the controller's choice follows acceptance alone."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_spec_adaptive_mode_switches_stay_exact(model, draft):
    """With a shrunken cadence the controller probes the gamma ladder and
    plain decode within one 40-token request, switching modes mid-stream
    (the draft's catch-up after plain steps), and the greedy tokens stay
    the request's alone. With the injected clock the choice is the mode
    of the most tokens a round: plain decode (1 a step) loses to any
    round."""
    reqs = _prompts(model.cfg, (9,), 95)
    b = _spec_batcher(model, draft[3], num_slots=2, cache_len=128,
                      spec_gamma=2, spec_adaptive=True)
    b._clock = _Clock()
    b._replan_every, b._probe_len, b._stale_every = 4, 2, 12
    catchups, run_catchup = [], b._run_catchup
    b._run_catchup = lambda: catchups.append(1) or run_catchup()
    rounds = _count_rounds(b)
    try:
        got = list(b.submit(*reqs[0], GenerationConfig(max_new_tokens=40)))
        st = b.stats()["spec"]
    finally:
        b.shutdown()
    assert got == _alone(model, reqs, 40)[0]
    assert st["adaptive"]
    assert set(st["iter_time_ema_s"]) == {"spec_gamma2", "spec_gamma1",
                                          "plain"}
    assert set(st["accept_ema_tok_per_round"]) == {1, 2}
    assert catchups and set(rounds) == {1, 2}
    assert st["mode"] != "plain"


def test_spec_controller_times_rounds_while_a_request_waits(model, draft):
    """Two requests on one slot: while the second waits in the queue, the
    first's rounds leave the carried state as it was, so the controller
    measures their time (a waiting request once rebuilt the state and
    reset the timing every iteration, as the JAX loop does, and the
    controller then measured nothing until the queue emptied)."""
    reqs = _prompts(model.cfg, (9, 11), 98)
    b = _spec_batcher(model, draft[3], num_slots=1, spec_gamma=2,
                      spec_adaptive=True)
    b._clock = _Clock()
    b._replan_every, b._probe_len = 2, 1
    seen, admit = [], b._admit_start

    def admit_start(*a, **k):
        seen.append(dict(b._iter_times))
        return admit(*a, **k)

    b._admit_start = admit_start
    try:
        got = _run(b, reqs, [GenerationConfig(max_new_tokens=12)] * 2)
    finally:
        b.shutdown()
    assert got == _alone(model, reqs, 12)
    assert len(seen) == 2 and seen[0] == {} and seen[1], seen


def test_spec_adaptive_off_pins_gamma(model):
    reqs = _prompts(model.cfg, (9,), 96)
    b = _spec_batcher(model, model, num_slots=2, spec_gamma=2)
    b._replan_every = 2
    rounds = _count_rounds(b)
    try:
        got = list(b.submit(*reqs[0], GenerationConfig(max_new_tokens=12)))
        st = b.stats()
    finally:
        b.shutdown()
    assert got == _alone(model, reqs, 12)[0]
    assert set(rounds) == {2}
    assert list(st["spec"]["iter_time_ema_s"]) in ([], ["spec_gamma2"])
    assert st["spec"]["mode"] == "spec_gamma2" and not st["spec"]["adaptive"]


def test_spec_row_finishing_at_the_cache_end(model, draft):
    """A row stops once a round would pass the cache's end (written +
    gamma + 1 > cache_len) and then steps on with the pool, dead, while a
    later request decodes: no round writes past the cache, and both give
    their tokens alone."""
    reqs = _prompts(model.cfg, (10, 12), 97)
    b = _spec_batcher(model, draft[3], num_slots=2, cache_len=24,
                      spec_gamma=3)
    try:
        first = b.submit(*reqs[0], GenerationConfig(max_new_tokens=20))
        got_first = list(first)
        second = b.submit(*reqs[1], GenerationConfig(max_new_tokens=6))
        got_second = list(second)
    finally:
        b.shutdown()
    assert b._failure is None
    # bucket 16, room 4: the first token and 5..8 more
    assert 6 <= len(got_first) <= 9
    assert got_first == _alone(model, reqs[:1], 20)[0][:len(got_first)]
    assert got_second == _alone(model, reqs[1:], 6)[0]


def test_spec_round_matches_jax(model, draft):
    """One round over a pool state built in numpy (two live rows at
    different offsets, one of them banning repeated bigrams; a finished
    row and an unused one) against the JAX batcher's round on the same
    state: every output, the buffer and valid rows and the live rows'
    caches."""
    cfg_d, jmodel_d, params_d, tdraft = draft
    st = _pool_state(model.cfg, "f32")
    st["toks"] = np.asarray([17, 33, 0, 5])
    lp, g = ((2, None),), 3
    t = model.cfg.text
    kv_d = {k: (np.random.default_rng(10 + i).standard_normal(
        (4, cfg_d.text.num_hidden_layers, t.kv_heads, 32, t.head_dim))
        * 0.5).astype(np.float32) for i, k in enumerate(("k", "v"))}
    lat_d = np.random.default_rng(12).standard_normal(
        (4, 1, cfg_d.perceiver.num_latents, cfg_d.perceiver.dim)).astype(
        np.float32)
    jb = _jax_batcher("f32", num_slots=4, cache_len=32,
                      draft=(jmodel_d, params_d, cfg_d), spec_gamma=g)
    jb.shutdown()
    i32 = lambda k: jnp.asarray(st[k], jnp.int32)
    jout = jb._get_spec_round(lp, g)(
        jax_tiny()[2], params_d,
        {k: jnp.asarray(v) for k, v in st["cache"].items()},
        {k: jnp.asarray(v) for k, v in kv_d.items()}, i32("buffer"),
        jnp.asarray(st["valid"]), jnp.asarray(st["latents"]),
        jnp.asarray(lat_d), i32("toks"), jnp.asarray(st["alive"]),
        i32("written"), i32("emitted"), i32("real_len"), i32("media"),
        i32("lp_idx"), i32("valid_from"), jnp.asarray(st["do_sample"]),
        jnp.asarray(st["temperature"]), i32("top_k"),
        jnp.asarray(st["top_p"]), i32("eos"), i32("max_new"),
        jax.random.PRNGKey(0))

    b = _spec_batcher(model, tdraft, num_slots=4, cache_len=32,
                      spec_gamma=g)
    b.shutdown()
    tt = lambda k, dtype=torch.long: torch.as_tensor(st[k]).to(dtype)
    b._cache = {k: torch.from_numpy(v.copy()) for k, v in st["cache"].items()}
    b._cache_d = {k: torch.from_numpy(v.copy()) for k, v in kv_d.items()}
    b._buffer, b._valid = tt("buffer"), tt("valid", torch.bool)
    b._latents = torch.from_numpy(st["latents"])
    b._latents_d = torch.from_numpy(lat_d)
    ca = dict(toks=tt("toks"), alive=tt("alive", torch.bool),
              written=tt("written"), emitted=tt("emitted"))
    statics = {k: tt(k, dtype) for k, dtype in (
        ("real_len", torch.long), ("media", torch.int32),
        ("lp_idx", torch.long), ("valid_from", torch.long),
        ("do_sample", torch.bool), ("temperature", torch.float32),
        ("top_k", torch.long), ("top_p", torch.float32),
        ("eos", torch.long), ("max_new", torch.long))}
    statics["sampled"] = False
    got = b._spec_round(ca, statics, lp, g)
    (jo, je, jtoks, jalive, jwritten, jemitted, jcache, jcache_d, jbuffer,
     jvalid) = jout
    live = [0, 1]
    assert got[0].numpy()[live].tolist() == np.asarray(jo)[live].tolist()
    for mine, ref in zip(got[1:], (je, jtoks, jalive, jwritten, jemitted)):
        assert mine.tolist() == np.asarray(ref).tolist()
    assert np.array_equal(b._valid.numpy(), np.asarray(jvalid))
    rows = [0, 1, 3]
    assert np.array_equal(b._buffer.numpy()[rows], np.asarray(jbuffer)[rows])
    for mine, ref in ((b._cache, jcache), (b._cache_d, jcache_d)):
        for k in ref:
            np.testing.assert_allclose(mine[k].numpy()[live],
                                       np.asarray(ref[k])[live], atol=1e-5,
                                       err_msg=k)


def test_spec_autotune_counts_the_draft(model, draft):
    """With a draft, its parameters and its cache row join the pool's
    footprint, as in JAX's `autotune_num_slots(draft=)`."""
    cfg, _, params, _ = jax_tiny()
    cfg_d, _, params_d, tdraft = draft
    pbytes = lambda p: sum(int(np.prod(x.shape)) * jnp.dtype(x.dtype).itemsize
                           for x in jax.tree_util.tree_leaves(p))
    for budget in (pbytes(params) + pbytes(params_d) + 5.5e5,
                   1e9, 0.0):
        assert (batching.autotune_num_slots(
            model, L, torch.float32, hbm_bytes=budget, headroom_bytes=0.0,
            draft=tdraft)
            == jbatching.autotune_num_slots(
                params, cfg, L, jnp.float32, hbm_bytes=budget,
                headroom_bytes=0.0, draft=(None, params_d, cfg_d)))


def test_spec_catchup_with_its_floor_tensor_matches_jax(model, draft):
    """The draft's catch-up over a pool state built in numpy (two live rows
    with generated columns the draft missed, their first decode columns
    in the pool's `floor` tensor that `_load_slot_state` sets; a
    finished row and an unused one) against the JAX batcher's catch-up on
    the same state, its floor from the slots: the live rows' draft
    caches; then a round on each side from there: its tokens, counts and
    carried state. The cache is 300 columns, so that both windows are 256
    wide (the port bounds its window inside the cache, ROADMAP Queue 3)."""
    cfg_d, jmodel_d, params_d, tdraft = draft
    L_, g, lp = 300, 3, ()
    st = _pool_state(model.cfg, "f32", length=L_)
    st["valid"][0, 16:24] = True           # 8 generated columns
    st["valid"][1, 21:26] = True           # 5
    st["written"] = np.asarray([24, 26, L_, 0])
    st["emitted"] = np.asarray([9, 6, 17, 0])
    floor = np.asarray([16, 21, 16, 0])
    t = model.cfg.text
    kv_d = {k: (np.random.default_rng(20 + i).standard_normal(
        (4, cfg_d.text.num_hidden_layers, t.kv_heads, L_, t.head_dim))
        * 0.5).astype(np.float32) for i, k in enumerate(("k", "v"))}
    lat_d = np.random.default_rng(22).standard_normal(
        (4, 1, cfg_d.perceiver.num_latents, cfg_d.perceiver.dim)).astype(
        np.float32)
    jb = _jax_batcher("f32", num_slots=4, cache_len=L_,
                      draft=(jmodel_d, params_d, cfg_d), spec_gamma=g)
    jb.shutdown()
    i32 = lambda k: jnp.asarray(st[k], jnp.int32)
    jcache_d = jb._get_catchup()(
        params_d, {k: jnp.asarray(v) for k, v in kv_d.items()},
        i32("buffer"), jnp.asarray(st["valid"]), jnp.asarray(lat_d),
        i32("written"), jnp.asarray(floor, jnp.int32), i32("valid_from"),
        i32("media"))
    jcache_d = {k: np.asarray(v) for k, v in jcache_d.items()}
    # (the round donates the caches it is given)
    jout = jb._get_spec_round(lp, g)(
        jax_tiny()[2], params_d,
        {k: jnp.asarray(v) for k, v in st["cache"].items()},
        {k: jnp.asarray(v) for k, v in jcache_d.items()},
        i32("buffer"), jnp.asarray(st["valid"]), jnp.asarray(st["latents"]),
        jnp.asarray(lat_d), i32("toks"), jnp.asarray(st["alive"]),
        i32("written"), i32("emitted"), i32("real_len"), i32("media"),
        i32("lp_idx"), i32("valid_from"), jnp.asarray(st["do_sample"]),
        jnp.asarray(st["temperature"]), i32("top_k"),
        jnp.asarray(st["top_p"]), i32("eos"), i32("max_new"),
        jax.random.PRNGKey(0))

    b = _spec_batcher(model, tdraft, num_slots=4, cache_len=L_,
                      spec_gamma=g)
    b.shutdown()
    assert b._catchup_w == 256
    tt = lambda k, dtype=torch.long: torch.as_tensor(st[k]).to(dtype)
    b._latents = torch.zeros(st["latents"].shape)
    b._latents_d = torch.zeros(lat_d.shape)
    for mine, theirs in (
            (b._cache, {k: torch.from_numpy(v) for k, v
                        in st["cache"].items()}),
            (b._cache_d, {k: torch.from_numpy(v) for k, v in kv_d.items()}),
            (b._carried, dict(toks=tt("toks"), alive=tt("alive", torch.bool),
                              written=tt("written"),
                              emitted=tt("emitted"))),
            (b._statics, {k: tt(k, dtype) for k, dtype in (
                ("real_len", torch.long), ("media", torch.int32),
                ("lp_idx", torch.long), ("valid_from", torch.long),
                ("do_sample", torch.bool), ("temperature", torch.float32),
                ("top_k", torch.long), ("top_p", torch.float32),
                ("eos", torch.long), ("max_new", torch.long))})):
        for k, v in theirs.items():
            mine[k].copy_(v)
    b._statics["floor"].copy_(torch.from_numpy(floor))
    b._buffer.copy_(tt("buffer"))
    b._valid.copy_(tt("valid", torch.bool))
    b._latents.copy_(torch.from_numpy(st["latents"]))
    b._latents_d.copy_(torch.from_numpy(lat_d))
    b._lp_list, b._dirty = lp, False
    b._run_catchup()
    live = [0, 1]
    assert not np.allclose(b._cache_d["k"].numpy()[live], kv_d["k"][live])
    for k in jcache_d:
        np.testing.assert_allclose(b._cache_d[k].numpy()[live],
                                   jcache_d[k][live], atol=1e-5, err_msg=k)
    got = b._spec_body(g).numpy()
    jo, je, jtoks, jalive, jwritten, jemitted = jout[:6]
    assert got[live, :g + 1].tolist() == np.asarray(jo)[live].tolist()
    assert got[:, g + 1].tolist() == np.asarray(je).tolist()
    for name, ref in (("toks", jtoks), ("alive", jalive),
                      ("written", jwritten), ("emitted", jemitted)):
        assert b._carried[name].tolist() == np.asarray(ref).tolist(), name


class _FakePoolGraph:
    """A captured pool body's stand-in on the CPU: a replay runs the body
    and writes its outputs into the tensors the capture returned, as a
    replay overwrites the graph's own."""

    def __init__(self, body, out):
        self.body, self.out, self.replays = body, out, 0

    def replay(self):
        self.replays += 1
        res = self.body()
        outs = self.out if isinstance(self.out, tuple) else (self.out,)
        ress = res if isinstance(res, tuple) else (res,)
        for dst, src in zip(outs, ress):
            if dst is not src:
                dst.copy_(src)

    def reset(self):
        pass


def test_spec_pool_graphs_one_key_a_mode(model, draft, monkeypatch):
    """A speculative pool through the graph path (`cuda_graph` forced on,
    `engine.capture` faked: the CPU has no graph), the controller probing
    gamma 2, gamma 1 and plain decode within one 40-token request: each
    mode's body is captured once under its key, the round's
    ("spec", gamma, lp_configs, sampled), the plain step's (lp_configs,
    need_logits) and the catch-up's, and replayed after; the greedy tokens
    stay the request's alone."""
    from otter_tpu_torch.generation import engine
    captures = []

    def capture(body, device, side, workspace, generator=None):
        out = body()
        captures.append(out)
        return out, engine.Captured(_FakePoolGraph(body, out), {}, out, 0.0,
                                    0, workspace)
    monkeypatch.setattr(engine, "capture", capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    reqs = _prompts(model.cfg, (9,), 95)
    b = _spec_batcher(model, draft[3], num_slots=2, cache_len=128,
                      spec_gamma=2, spec_adaptive=True)
    b.cuda_graph = True
    b._clock = _Clock()
    b._replan_every, b._probe_len, b._stale_every = 4, 2, 12
    try:
        got = list(b.submit(*reqs[0], GenerationConfig(max_new_tokens=40)))
        keys = list(b._graphs)
        replays = {k: g.graph.replays for k, g in b._graphs.items()}
    finally:
        b.shutdown()
    assert b._failure is None
    assert got == _alone(model, reqs, 40)[0]
    assert sorted(keys, key=str) == sorted(
        [("spec", 2, (), False), ("spec", 1, (), False), ((), False),
         ("catchup",)], key=str)
    assert len(captures) == 4 and all(n > 0 for n in replays.values())
