"""Port parity of the decode step with its state on the device: the step
body that a CUDA graph captures (its position and step index read from
device counters, every write in place), built once and called with no
per-step argument, against the JAX engine's `generate` for the tiny MPT
(ALiBi), LLaMA (rope) and idefics models over bf16, int8 and int4 caches;
`write_cache` at a device scalar position; the decode loop's early stop;
the graph entries' launch bookkeeping, their LRU bound and what the cache
ladder counts of them; the megakernel route's step with its position on
the device, against the JAX megakernel model; a second request of a beam
key and of an OtterHD key replaying with no capture (a faked graph). The
CPU has no graph: the
same step body runs eagerly, which is what these tests drive (the graphed
step is held to it on the card, `tests/test_torch_cuda.py` and
`chip_smoke.py --phases graph`)."""

import functools
import gc
import warnings
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.config import GenerationConfig as JGen
from otter_tpu.generation import engine as jengine
from otter_tpu_torch import _build
from otter_tpu_torch.config import GenerationConfig as TGen
from otter_tpu_torch.generation import engine as tengine
from otter_tpu_torch.models.decoder import init_cache, write_cache
from otter_tpu_torch.ops import decode_attention as tda
from otter_tpu_torch.ops import megakernel as tmk
from otter_tpu_torch.tools.bench_decode import _clone, _restore
from torch_parity_helpers import FakeGraph as _FakeGraph
from torch_parity_helpers import fake_capture as _fake_capture
from torch_parity_helpers import (idefics_inputs, idefics_pair, inputs,
                                  jax_tiny, jax_tiny_fused, llama_vlm_pair,
                                  torch_tiny, torch_tiny_fused)

NEW = 6
_TORCH_CACHE = {"bf16": torch.bfloat16, "int8": torch.int8, "int4": "int4"}
_JAX_CACHE = {"bf16": jnp.bfloat16, "int8": "int8", "int4": "int4"}


def _pair(arch):
    """(cfg, JAX model, params, port model, vision_x, left-padded ids, mask)
    of one tiny model and a ragged batch."""
    if arch == "idefics":
        cfg, jmodel, params, tmodel = idefics_pair("int8")
        vx, ids = idefics_inputs(cfg, 6)
        mask = np.ones_like(ids)
        mask[1, :2] = 0
        ids[1, :2] = 0
        return cfg, jmodel, params, tmodel, vx, ids, mask
    if arch == "llama":
        cfg, jmodel, params, tmodel = llama_vlm_pair()
    else:
        cfg, jmodel, params, _ = jax_tiny()
        tmodel = torch_tiny()
    vx, ids = inputs(cfg, 21, 2, 12)
    mask = np.ones_like(ids)
    mask[0, 8:] = 0
    lang_x, attn = tengine.left_pad(ids, mask)
    return cfg, jmodel, params, tmodel, vx, lang_x, attn


def _jax_generate(cfg, jmodel, params, vx, ids, mask, cache, **gen):
    return np.asarray(jengine.OtterGenerator(
        jmodel, params, cfg, cache_dtype=_JAX_CACHE[cache]).generate(
            jnp.asarray(vx), jnp.asarray(ids), jnp.asarray(mask),
            gen=JGen(**gen)))


@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("arch", ["mpt", "llama", "idefics"])
def test_step_body_called_with_no_argument_gives_jax_tokens(arch, cache):
    """The prefill fills an entry; the step is then one call built once
    and made NEW - 1 times with nothing that changes from one call to the
    next: the host's own step count and prompt width are wiped first, so
    the body can only read the device counters. The buffer equals JAX
    `generate`'s."""
    cfg, jmodel, params, tmodel, vx, ids, mask = _pair(arch)
    ref = _jax_generate(cfg, jmodel, params, vx, ids, mask, cache,
                        max_new_tokens=NEW)
    engine = tengine.OtterGenerator(tmodel, cache_dtype=_TORCH_CACHE[cache])
    assert not engine.cuda_graph
    st = engine._prefill(vx, ids, mask, TGen(max_new_tokens=NEW))
    p = st.p
    st.t = st.p = None
    step = functools.partial(engine._step_body, st)
    with torch.inference_mode():
        for _ in range(NEW - 1):
            step()
    assert int(st.t_dev) == NEW
    out = st.buffer[:, :p + NEW].clone().numpy()
    st.t, st.p = NEW, p
    engine._finish(st)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
def test_write_cache_at_a_device_position_equals_the_int_one(cache, s):
    cfg, _, _, _ = jax_tiny()
    text = cfg.text
    rng = np.random.default_rng(3)
    shape = (2, text.kv_heads, s, text.head_dim)
    a = init_cache(text, 2, 64, _TORCH_CACHE[cache], "cpu")
    b = init_cache(text, 2, 64, _TORCH_CACHE[cache], "cpu")
    for layer, pos in ((0, 0), (1, 37), (0, 64 - s)):
        k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        write_cache(a, layer, k, v, pos)
        write_cache(b, layer, k, v, torch.tensor(pos))
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
        assert a[key].abs().amax() > 0


def test_generate_stops_early_with_jax_buffer():
    """Every row ends within the first tokens: the loop reads `done` every
    DONE_EVERY steps from a copy made a check before, so it stops within
    2 * DONE_EVERY steps, long before max_new_tokens, and returns JAX's
    buffer (the steps past the end write pad where pad is)."""
    cfg, jmodel, params, tmodel, vx, ids, mask = _pair("mpt")
    vx, ids, mask = (np.repeat(x[1:], 2, axis=0) for x in (vx, ids, mask))
    engine = tengine.OtterGenerator(tmodel, cache_dtype=torch.int8)
    free = engine.generate(vx, ids, mask,
                           gen=TGen(max_new_tokens=4, eos_token_id=-1))
    eos = int(free[0, -1])
    new = 40
    ref = _jax_generate(cfg, jmodel, params, vx, ids, mask, "int8",
                        max_new_tokens=new, eos_token_id=eos)
    steps = []
    advance = engine._advance
    engine._advance = lambda st: (steps.append(st.t), advance(st))
    out = engine.generate(vx, ids, mask,
                          gen=TGen(max_new_tokens=new, eos_token_id=eos))
    np.testing.assert_array_equal(out, ref)
    assert (out[:, ids.shape[1] + 4:] == 0).all()
    assert len(steps) <= 2 * tengine.DONE_EVERY < new - 1


@pytest.mark.parametrize("sampled", [False, True])
def test_stream_generate_yields_what_generate_returns(sampled):
    cfg, jmodel, params, tmodel, vx, ids, mask = _pair("llama")
    vx, ids, mask = vx[:1], ids[:1], mask[:1]
    gen = TGen(max_new_tokens=NEW, eos_token_id=-1, do_sample=sampled,
               temperature=0.7, top_k=20, top_p=0.9)
    engine = tengine.OtterGenerator(tmodel, cache_dtype=torch.int8)
    seeded = lambda: torch.Generator().manual_seed(5) if sampled else None
    out = engine.generate(vx, ids, mask, gen=gen, generator=seeded())
    streamed = list(engine.stream_generate(vx, ids, mask, gen=gen,
                                           generator=seeded()))
    assert streamed == out[0, ids.shape[1]:].tolist()
    if not sampled:
        ref = _jax_generate(cfg, jmodel, params, vx, ids, mask, "int8",
                            max_new_tokens=NEW, eos_token_id=-1)
        np.testing.assert_array_equal(out, ref)


def test_sampled_request_advances_its_generator_as_eager_sampling_would():
    """The entry draws from its own generator with the request's state
    copied in, and the request's generator takes the state back: after a
    request it stands where NEW eager draws over [B, V] leave a generator
    seeded alike, and a second generator seeded alike repeats the
    request."""
    cfg, _, _, tmodel, vx, ids, mask = _pair("mpt")
    gen = TGen(max_new_tokens=NEW, do_sample=True, temperature=4.0,
               top_k=30, eos_token_id=-1)
    engine = tengine.OtterGenerator(tmodel, cache_dtype=torch.int8)
    g = torch.Generator().manual_seed(11)
    first = engine.generate(vx, ids, mask, gen=gen, generator=g)
    eager = torch.Generator().manual_seed(11)
    for _ in range(NEW):
        torch.empty(ids.shape[0], cfg.text.total_vocab).exponential_(
            generator=eager)
    assert torch.equal(g.get_state(), eager.get_state())
    h = torch.Generator().manual_seed(11)
    np.testing.assert_array_equal(
        engine.generate(vx, ids, mask, gen=gen, generator=h), first)
    assert torch.equal(h.get_state(), g.get_state())


def test_interleaved_sampled_streams_without_a_generator_differ():
    """Two sampled streams that bring no generator, run at once and read
    in turns: each entry's generator is seeded by its own draw from the
    default generator, so the two draw different numbers (one snapshot of
    the default's state would give both the same tokens); the default
    generator's seed repeats the pair."""
    _, _, _, tmodel, vx, ids, mask = _pair("mpt")
    vx, ids, mask = vx[:1], ids[:1], mask[:1]
    gen = TGen(max_new_tokens=NEW, do_sample=True, temperature=4.0,
               eos_token_id=-1)
    engine = tengine.OtterGenerator(tmodel, cache_dtype=torch.int8)

    def pair():
        torch.manual_seed(21)
        streams = [engine.stream_generate(vx, ids, mask, gen=gen)
                   for _ in range(2)]
        got = [[], []]
        for _ in range(NEW):
            for out, s in zip(got, streams):
                out.append(next(s))
        for s in streams:
            assert list(s) == []
        return got

    a, b = pair()
    assert len(a) == len(b) == NEW
    assert a != b
    assert pair() == [a, b]


def test_replays_add_the_launches_recorded_at_capture(monkeypatch):
    """A fake wrapper in the step's path: the launches it reports inside
    `recording_launches` (a capture) move no counter and land in the
    record; each replay then adds the record once, as the eager step adds
    its own launches; the tokens are the eager steps'."""
    _, _, _, tmodel, vx, ids, mask = _pair("mpt")
    real = tda.decode_attention

    def fake(*a, **kw):
        _build.count_launch(fake, int4=kw.get("kv_bits") == 4)
        return real(*a, **kw)
    fake.launches = fake.launches_int4 = 0
    monkeypatch.setattr(tda, "decode_attention", fake)
    layers = tmodel.cfg.text.num_hidden_layers

    engine = tengine.OtterGenerator(tmodel, cache_dtype="int4")
    gen = TGen(max_new_tokens=NEW, eos_token_id=-1)
    want = engine.generate(vx, ids, mask, gen=gen)
    assert fake.launches == fake.launches_int4 == (NEW - 1) * layers

    fake.launches = fake.launches_int4 = 0
    st = engine._prefill(vx, ids, mask, gen)
    entry = st.entry
    engine._advance(st)                     # the eager step before capture
    assert fake.launches == layers
    saved = _clone(st)
    with torch.inference_mode(), _build.recording_launches() as rec:
        engine._step_body(st)               # what a capture records
    _restore(st, saved)                     # (a capture runs nothing)
    assert rec == {(fake, True): layers}
    assert fake.launches == layers
    entry.graph = _FakeGraph(functools.partial(engine._step_body, st))
    entry.launches = rec
    for i in range(NEW - 2):
        engine._advance(st)
        assert fake.launches == fake.launches_int4 == (i + 2) * layers
    assert entry.graph.replays == NEW - 2
    got = st.buffer[:, :st.p + NEW].clone().numpy()
    engine._finish(st)
    np.testing.assert_array_equal(got, want)


def test_entries_are_bounded_least_recently_used_first(monkeypatch):
    """With a bound of 2, three keys (1, 2 and 3 rows) one after another
    leave the two most recent entries, the first's tensors freed; a request
    of a kept key reuses its entry; requests that run at once each lease
    their own entry, and the bound applies again once they end."""
    _, _, _, tmodel, vx, ids, mask = _pair("mpt")
    vx, ids, mask = (np.concatenate([x, x[:1]]) for x in (vx, ids, mask))
    monkeypatch.setattr(tengine, "MAX_ENTRIES", 2)
    engine = tengine.OtterGenerator(tmodel, cache_dtype=torch.int8)
    gen = TGen(max_new_tokens=3, eos_token_id=-1)
    refs = {}
    for rows in (1, 2, 3):
        engine.generate(vx[:rows], ids[:rows], mask[:rows], gen=gen)
        entry = engine._entries[-1]
        refs[entry.key[0]] = weakref.ref(entry.st.cache["k"])
    assert [e.key[0] for e in engine._entries] == [2, 3]
    gc.collect()
    assert refs[1]() is None
    assert refs[2]() is not None and refs[3]() is not None
    kept = engine._entries[0]
    engine.generate(vx[:2], ids[:2], mask[:2], gen=gen)
    assert engine._entries[-1] is kept and len(engine._entries) == 2
    assert kept.st.cache["k"] is refs[2]()

    streams = [engine.stream_generate(vx[:1], ids[:1], mask[:1],
                                      gen=TGen(max_new_tokens=4,
                                               eos_token_id=-1))
               for _ in range(3)]
    for s in streams:
        next(s)                           # each prefilled and busy
    assert len(engine._entries) == 3      # the two idle ones freed
    assert all(e.busy for e in engine._entries)
    for s in streams:
        assert len(list(s)) == 3
    assert len(engine._entries) == 2
    assert not any(e.busy for e in engine._entries)


def test_cache_ladder_counts_the_caches_entries_hold(monkeypatch):
    """A budget that fits a bf16 cache of 2 rows and nine tenths of one of
    3 rows beside the parameters: the first key gets bf16; a second key,
    held beside the first entry, degrades to int8; with room for one entry
    the first is freed first and the second key keeps bf16."""
    cfg, _, _, tmodel, vx, ids, mask = _pair("mpt")
    vx, ids, mask = (np.concatenate([x, x[:1]]) for x in (vx, ids, mask))
    need = lambda rows: tengine.cache_bytes(cfg.text, rows, 128,
                                            torch.bfloat16)
    params_b = sum(t.numel() * t.element_size() for t in
                   list(tmodel.parameters()) + list(tmodel.buffers()))
    hbm = 5e9 + params_b + need(2) + 0.9 * need(3)
    gen = TGen(max_new_tokens=3, eos_token_id=-1)
    for max_entries, second in ((2, torch.int8), (1, torch.bfloat16)):
        monkeypatch.setattr(tengine, "MAX_ENTRIES", max_entries)
        engine = tengine.OtterGenerator(tmodel, hbm_bytes=hbm)
        engine.generate(vx[:2], ids[:2], mask[:2], gen=gen)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            engine.generate(vx, ids, mask, gen=gen)
        degraded = [w for w in caught if "degraded" in str(w.message)]
        assert len(degraded) == (second == torch.int8)
        assert engine._cache_dtypes == {(2, 128): torch.bfloat16,
                                        (3, 128): second}


def test_cache_ladder_counts_the_pools_graphs_hold(monkeypatch):
    """On CUDA without `hbm_bytes` the budget is the card's memory less
    what live tensors hold and the headroom, less the memory pools of the
    live captured graphs on the card (their free blocks serve no other
    tensor). With the memory functions stood in for: a bf16 cache of 2
    rows fits beside 1 GB of tensors; an entry's graph holding a pool of
    0.8 of that cache leaves room for int8; a batcher graph's pool beside
    it, for int4; a pool on another card counts nothing, and a freed
    graph's pool nothing more."""
    from otter_tpu_torch.config import OtterConfig
    from types import SimpleNamespace
    text = OtterConfig.tiny("mpt").text
    need = tengine.cache_bytes(text, 2, 128, torch.bfloat16)
    total = 5e9 + 1e9 + 1.5 * need
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (0, total))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d=None: 1e9)
    card, other = torch.device("cuda", 0), torch.device("cuda", 1)

    def pick():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return tengine.select_cache_dtype(text, 2, 128, torch.bfloat16,
                                              device=card)
    assert pick() == torch.bfloat16
    entry = tengine._Entry("key", SimpleNamespace(), torch.bfloat16, None)
    entry.graph, entry.pool_bytes = _FakeGraph(lambda: None), 0.8 * need
    tengine.hold_pool(entry, card)
    elsewhere = tengine.Captured(_FakeGraph(lambda: None), {}, None, 1.0,
                                 10 * need, None)
    tengine.hold_pool(elsewhere, other)
    assert tengine.held_pool_bytes(card) == 0.8 * need
    assert pick() == torch.int8
    pooled = tengine.Captured(_FakeGraph(lambda: None), {}, None, 1.0,
                              0.3 * need, None)
    tengine.hold_pool(pooled, torch.device("cuda"))
    assert pick() == "int4"
    pooled.free()
    entry.free()
    assert tengine.held_pool_bytes(card) == 0 and pick() == torch.bfloat16


def test_graph_is_refused_where_it_cannot_run():
    """No graph on the CPU, and none on a sharded model (its hooks gather
    parameters every call): asking for one raises; the default is off
    there. The megakernel route is no exception any more: its default on
    the CPU is off for the CPU's sake alone."""
    tmodel = torch_tiny()
    assert tengine.OtterGenerator(tmodel).cuda_graph is False
    with pytest.raises(ValueError, match="CUDA model"):
        tengine.OtterGenerator(tmodel, cuda_graph=True)
    sharded = torch_tiny()
    sharded._shard_layouts = {}
    assert tengine.OtterGenerator(sharded).cuda_graph is False
    with pytest.raises(ValueError, match="sharded"):
        tengine.OtterGenerator(sharded, cuda_graph=True)
    mega = torch_tiny_fused("megakernel")
    assert tengine.OtterGenerator(mega).cuda_graph is False
    with pytest.raises(ValueError, match="CUDA model"):
        tengine.OtterGenerator(mega, cuda_graph=True)


@functools.lru_cache(maxsize=None)
def _jax_mega_step():
    """The JAX megakernel model's cached step, jitted with `cache_pos`
    traced (its kernel's scalar-prefetch operand)."""
    _, jmodel, params, _ = jax_tiny_fused("megakernel")
    return jax.jit(lambda tok, lat, cache, pos, kv_valid, counts: jmodel.apply(
        params, None, tok, vis_latents=lat, cache=cache, cache_pos=pos,
        kv_valid=kv_valid, media_counts=counts))


def test_device_position_never_reaches_the_megakernel():
    """(The name is from when a device position took the composed route;
    it now holds the opposite.) On a megakernel model a 0-d device
    position reaches the megakernel: after the engine's prefill, three
    greedy steps of the model with `cache_pos` a 0-d tensor and, from a
    copy of the same state, with the host's int call the kernel in every
    layer and give equal logits (bit for bit) and caches, and the tokens
    of the JAX model's step with its position traced (logits within
    1e-3, the BASELINE.md bar)."""
    cfg, _, _, _ = jax_tiny_fused("megakernel")
    mega = torch_tiny_fused("megakernel")
    vx, ids = inputs(cfg, 23, 2, 10)
    engine = tengine.OtterGenerator(mega, cache_dtype=torch.float32)
    st = engine._prefill(vx, ids, None, TGen(max_new_tokens=4))
    try:
        p, layers = st.p, cfg.text.num_hidden_layers
        tok = st.tok[:, None].clone()
        lat, counts = st.vis_latents, st.media_counts
        host_cache = {k: v.clone() for k, v in st.cache.items()}
        jcache = {k: jnp.asarray(v.numpy()) for k, v in st.cache.items()}
        kv_valid = st.kv_valid.clone()
        with torch.inference_mode(), _Calls() as calls:
            for t in range(3):
                kv_valid[:, p + t] = True
                dev, host = (mega(None, tok, vis_latents=lat, cache=cache,
                                  cache_pos=pos, kv_valid=kv_valid,
                                  media_counts=counts)[0][:, -1]
                             for cache, pos in (
                                 (st.cache, torch.tensor(p + t)),
                                 (host_cache, p + t)))
                assert len(calls) == 2 * layers * (t + 1)
                assert torch.equal(dev, host)
                jl, jcache, _ = _jax_mega_step()(
                    jnp.asarray(tok.numpy(), jnp.int32),
                    jnp.asarray(lat.numpy()), jcache, p + t,
                    jnp.asarray(kv_valid.numpy()),
                    jnp.asarray(counts.numpy(), jnp.int32))
                jl = np.asarray(jl[:, -1])
                np.testing.assert_allclose(dev.numpy(), jl, atol=1e-3,
                                           rtol=1e-3)
                tok = dev.argmax(-1)[:, None]
                assert (tok[:, 0].numpy() == jl.argmax(-1)).all()
        for key in st.cache:
            assert torch.equal(st.cache[key], host_cache[key]), key
    finally:
        engine._finish(st)


class _Calls(list):
    """Records each call of the megakernel's wrapper (on the CPU it runs
    the plain version and counts no launch)."""

    def __enter__(self):
        self.real = tmk.decode_attn_megakernel

        def wrapper(*a, **kw):
            self.append(a[3])
            return self.real(*a, **kw)
        tmk.decode_attn_megakernel = wrapper
        return self

    def __exit__(self, *exc):
        tmk.decode_attn_megakernel = self.real


def test_megakernel_engine_step_reads_the_device_counter():
    """`OtterGenerator`'s step on a megakernel model, built once and called
    NEW - 1 times with the host's step count and prompt width wiped (it
    can only read the device counters), passes the kernel a 0-d device
    position in every layer and gives the JAX engine's tokens on the JAX
    megakernel model (f32 caches)."""
    cfg, jmodel, params, _ = jax_tiny_fused("megakernel")
    vx, ids = inputs(cfg, 24, 2, 12)
    mask = np.ones_like(ids)
    ref = np.asarray(jengine.OtterGenerator(
        jmodel, params, cfg, cache_dtype=jnp.float32).generate(
            jnp.asarray(vx), jnp.asarray(ids), jnp.asarray(mask),
            gen=JGen(max_new_tokens=NEW)))
    engine = tengine.OtterGenerator(torch_tiny_fused("megakernel"),
                                    cache_dtype=torch.float32)
    st = engine._prefill(vx, ids, mask, TGen(max_new_tokens=NEW))
    p = st.p
    st.t = st.p = None
    with torch.inference_mode(), _Calls() as calls:
        for _ in range(NEW - 1):
            engine._step_body(st)
    assert len(calls) == (NEW - 1) * cfg.text.num_hidden_layers
    assert all(isinstance(x, torch.Tensor) and x.dim() == 0 for x in calls)
    out = st.buffer[:, :p + NEW].clone().numpy()
    st.t, st.p = NEW, p
    engine._finish(st)
    np.testing.assert_array_equal(out, ref)


def _beam_run(tmodel, vx, ids, mask):
    """A beam request's runner over an engine of `tmodel` (int8 cache)."""
    engine = tengine.OtterGenerator(tmodel, cache_dtype=torch.int8)
    gen = TGen(max_new_tokens=NEW, num_beams=2, no_repeat_ngram_size=2)
    return engine, lambda: engine.generate(vx, ids, mask, gen=gen)


def _fuyu_run(tmodel, req):
    from otter_tpu_torch.generation.fuyu import FuyuGenerator
    engine = FuyuGenerator(tmodel, torch.int8)
    gen = TGen(max_new_tokens=NEW, eos_token_id=-1)
    return engine, lambda: list(engine.generate(*req, gen))


@pytest.mark.parametrize("kind", ["beam", "fuyu"])
def test_second_request_of_a_key_replays_with_no_capture(kind, monkeypatch):
    """The beam step and OtterHD's step through the engines' graph path
    (`cuda_graph` forced on, the capture faked: the CPU has no graph): a
    fake decode_attention in the step's path counts its launches; the
    first request of a key captures once, at its first step, and replays
    the rest; a second request of the key only replays. The tokens and
    the launches of both equal the eager engine's (a replay adds what its
    capture recorded)."""
    real = tda.decode_attention

    def fake(*a, **kw):
        _build.count_launch(fake, int4=kw.get("kv_bits") == 4)
        return real(*a, **kw)
    fake.launches = fake.launches_int4 = 0
    monkeypatch.setattr(tda, "decode_attention", fake)
    if kind == "beam":
        _, _, _, tmodel, vx, ids, mask = _pair("mpt")
        make = lambda: _beam_run(tmodel, vx, ids, mask)
        layers = tmodel.cfg.text.num_hidden_layers
    else:
        from torch_parity_helpers import fuyu_pair
        from otter_tpu_torch.tools.random_weights import fuyu_request
        cfg, _, _, tmodel = fuyu_pair("int8", True)
        req = fuyu_request(cfg, 12, 8, 5, 3, left_pad=2)
        make = lambda: _fuyu_run(tmodel, req)
        layers = cfg.text.num_hidden_layers
    _, eager = make()
    want = eager()
    assert fake.launches == (NEW - 1) * layers
    engine, run = make()
    engine.cuda_graph = True
    captured = []
    monkeypatch.setattr(engine, "_capture", _fake_capture(engine, captured))
    for i in range(2):
        fake.launches = 0
        got = run()
        np.testing.assert_array_equal(got, want)
        assert fake.launches == (NEW - 1) * layers
        assert len(captured) == 1
        entry = captured[0]
        assert engine._entries == [entry] and not entry.busy
        assert entry.launches == {(fake, False): layers}
        assert entry.graph.replays == (i + 1) * (NEW - 1) - 1
