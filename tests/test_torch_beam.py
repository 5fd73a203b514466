"""Port parity: beam search against the JAX package on the CPU in f32.

`beam_search` and `beam_search_chunks` on a table-driven step function
(logits from a table, a token embedding and a per-beam state carried in
the cache, all exact in f32, so both frameworks see the same logits);
`OtterGenerator.generate(num_beams=K)` and `stream_beam_generate` on the
tiny int8 OTTER-MPT and LLaMA models with an int8 cache, and the beam
step's body on the device counters with no host step index (what a CUDA
graph captures), and the beam entries' leases; and the `api` wrappers'
forward and generate on the tiny f32 model.

Tolerances: tokens equal; beam scores within 1e-5; logits within 1e-4
max-abs and the loss within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from otter_tpu import api as japi
from otter_tpu.config import GenerationConfig as JGen
from otter_tpu.generation import beam as jbeam
from otter_tpu.generation import engine as jengine
from otter_tpu_torch import api as tapi
from otter_tpu_torch.config import GenerationConfig as TGen
from otter_tpu_torch.generation import beam as tbeam
from otter_tpu_torch.generation import engine as tengine
from torch_parity_helpers import (inputs, jax_tiny, llama_vlm_pair,
                                  port_cfg, torch_tiny)

# ── beam_search on a table-driven step ───────────────────────────────

V, B, K, D, MAX_NEW, EOS = 11, 2, 3, 4, 7, 5


def _table(eos_at):
    """Logits and weights in multiples of 1/8 (sums exact in f32): the
    prefill's logits [B, V], a logits table [MAX_NEW, B*K, V], a token
    embedding [V, D], a readout [D, V] and the cache's start state
    [B*K, D]. `eos_at` 0 makes eos row 0's best first token, 2 makes it
    likely at step 2."""
    rng = np.random.default_rng(61)
    eighths = lambda *s: rng.integers(-16, 17, s).astype(np.float32) / 8
    init, table = eighths(B, V), eighths(MAX_NEW, B * K, V)
    emb, w, h0 = eighths(V, D), eighths(D, V) / 4, eighths(B * K, D)
    if eos_at == 0:
        init[0, EOS] = 4.0
    elif eos_at == 2:
        table[2, :, EOS] += 3.0
    return init, table, emb, w, h0


def _jax_step(table, emb, w):
    table, emb, w = map(jnp.asarray, (table, emb, w))

    def step(tok, cache, t):
        h = cache["h"] + emb[tok[:, 0]]
        return table[t] + h @ w, {"h": h}
    return step


def _torch_step(table, emb, w):
    table, emb, w = map(torch.from_numpy, (table, emb, w))

    def step(tok, cache, t):
        cache["h"].add_(emb[tok[:, 0]])
        return table[t] + cache["h"] @ w, cache
    return step


def _jax_ban(logits, gen_tokens, t):
    return jnp.where(jnp.arange(V)[None] == (3 * t) % V, -1e9, logits)


def _torch_ban(logits, gen_tokens, t):
    return torch.where(torch.arange(V)[None] == (3 * t) % V,
                       torch.tensor(-1e9), logits)


BEAM_CASES = [(0, 1.0, False), (0, 0.7, True), (2, 1.0, True),
              (2, 0.7, False), (None, 1.0, False)]


def _both(eos_at, lp, ban, fn_j, fn_t, **kw):
    init, table, emb, w, h0 = _table(eos_at)
    common = dict(num_beams=K, max_new_tokens=MAX_NEW, eos_token_id=EOS,
                  pad_token_id=0, length_penalty=lp, **kw)
    ref = fn_j(_jax_step(table, emb, w), jnp.asarray(init),
               {"h": jnp.asarray(h0)}, logits_processor=_jax_ban if ban
               else None, **common)
    out = fn_t(_torch_step(table, emb, w), torch.from_numpy(init),
               {"h": torch.from_numpy(h0.copy())},
               logits_processor=_torch_ban if ban else None, **common)
    return out, ref


@pytest.mark.parametrize("eos_at,lp,ban", BEAM_CASES)
def test_beam_search_matches_jax(eos_at, lp, ban):
    (toks, scores), (rtoks, rscores) = _both(eos_at, lp, ban,
                                             jbeam.beam_search,
                                             tbeam.beam_search)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(rtoks))
    np.testing.assert_allclose(scores.numpy(), np.asarray(rscores),
                               atol=1e-5, rtol=0)
    if eos_at == 0:      # a one-token beam [eos] is in the finished pool
        assert scores.numpy()[0] > tbeam.NEG_INF


@pytest.mark.parametrize("eos_at,lp,ban", BEAM_CASES[:3])
def test_beam_search_chunks_matches_jax(eos_at, lp, ban):
    out, ref = _both(eos_at, lp, ban, jbeam.beam_search_chunks,
                     tbeam.beam_search_chunks, chunk=2)
    out, ref = list(out), list(ref)
    assert [t for _, t in out] == [t for _, t in ref] == [3, 5, 7]
    for (a, _), (r, _) in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    full, _ = _both(eos_at, lp, ban, jbeam.beam_search, tbeam.beam_search)
    np.testing.assert_array_equal(out[-1][0].numpy(), full[0].numpy())


def test_top_k_keeps_lax_order_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, -1e7, 3.0, -1e7]])
    vals, idx = tbeam._top_k(x, 5)
    rv, ri = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))


# ── the engine ───────────────────────────────────────────────────────

def _models(arch):
    if arch == "mpt":
        cfg, jmodel, params, _ = jax_tiny()
        return cfg, jmodel, params, torch_tiny()
    return llama_vlm_pair()


def _ragged(cfg, b=2, s=12):
    vx, ids = inputs(cfg, 70, b, s)
    mask = np.ones_like(ids)
    mask[0, 8:] = 0
    return (vx,) + tengine.left_pad(ids, mask)


ENGINE_CASES = [(arch, k, ng) for arch in ("mpt", "llama") for k in (2, 3)
                for ng in (0, 3)]


@pytest.fixture(scope="module")
def jax_beams():
    """The JAX engine's beam outputs for every ENGINE_CASES entry (ragged
    batch of 2, int8 cache, 8 new tokens), computed once."""
    out = {}
    for arch, k, ng in ENGINE_CASES:
        cfg, jmodel, params, _ = _models(arch)
        vx, lang_x, attn = _ragged(cfg)
        eng = jengine.OtterGenerator(jmodel, params, cfg, cache_dtype="int8")
        out[arch, k, ng] = np.asarray(eng.generate(
            jnp.asarray(vx), jnp.asarray(lang_x), jnp.asarray(attn),
            gen=JGen(max_new_tokens=8, num_beams=k,
                     no_repeat_ngram_size=ng)))
    return out


@pytest.mark.parametrize("arch,k,ng", ENGINE_CASES)
def test_beam_generate_matches_jax(jax_beams, arch, k, ng):
    cfg, _, _, tmodel = _models(arch)
    vx, lang_x, attn = _ragged(cfg)
    out = tengine.OtterGenerator(tmodel, cache_dtype=torch.int8).generate(
        vx, lang_x, attn, gen=TGen(max_new_tokens=8, num_beams=k,
                                   no_repeat_ngram_size=ng))
    assert out.shape == (2, 12 + 8)
    np.testing.assert_array_equal(out, jax_beams[arch, k, ng])


STREAM_CASES = [("mpt", 3, 3), ("llama", 2, 0)]


@pytest.fixture(scope="module")
def jax_beam_streams():
    out = {}
    for arch, k, ng in STREAM_CASES:
        cfg, jmodel, params, _ = _models(arch)
        vx, ids = inputs(cfg, 71, 1, 10)
        eng = jengine.OtterGenerator(jmodel, params, cfg, cache_dtype="int8")
        out[arch] = list(eng.stream_beam_generate(
            jnp.asarray(vx), jnp.asarray(ids),
            gen=JGen(max_new_tokens=9, num_beams=k, no_repeat_ngram_size=ng),
            chunk=3))
    return out


@pytest.mark.parametrize("arch,k,ng", STREAM_CASES)
def test_stream_beam_generate_matches_jax_and_generate(jax_beam_streams,
                                                       arch, k, ng):
    """Every yield equals the JAX engine's; the last one is `generate`'s
    continuation cut at eos."""
    cfg, _, _, tmodel = _models(arch)
    vx, ids = inputs(cfg, 71, 1, 10)
    eng = tengine.OtterGenerator(tmodel, cache_dtype=torch.int8)
    gen = TGen(max_new_tokens=9, num_beams=k, no_repeat_ngram_size=ng)
    yields = list(eng.stream_beam_generate(vx, ids, gen=gen, chunk=3))
    assert yields == jax_beam_streams[arch]
    assert len(yields) == 3            # steps 1-3, 4-6, 7-8
    cont = eng.generate(vx, ids, gen=gen)[0, 10:].tolist()
    if cfg.eoc_token_id in cont:
        cont = cont[:cont.index(cfg.eoc_token_id)]
    assert yields[-1] == cont


@pytest.mark.parametrize("arch,k,ng", ENGINE_CASES)
def test_beam_step_body_on_device_counters_gives_jax_tokens(jax_beams, arch,
                                                            k, ng):
    """The beam prefill fills a leased entry; each beam step is then the
    entry's body (`beam._beam_step` over the entry's tensors, what a graph
    captures), called 7 times with no argument: the host's step count and
    prompt width are wiped first, so the step, its cache position and its
    bans can only read the device counters. The best beams equal the JAX
    engine's."""
    cfg, _, _, tmodel = _models(arch)
    vx, lang_x, attn = _ragged(cfg)
    engine = tengine.OtterGenerator(tmodel, cache_dtype=torch.int8)
    gen = TGen(max_new_tokens=8, num_beams=k, no_repeat_ngram_size=ng)
    st = engine._beam_prefill(vx, lang_x, attn, gen)
    p = st.p
    st.t = st.p = None
    with torch.inference_mode():
        for _ in range(7):
            st.entry.body()
        out, _ = tbeam._beam_best(st.beam)
        got = torch.cat([st.buffer[::k, :p], out], 1).numpy()
    assert int(st.t_dev) == 8 and int(st.p_dev) == p
    st.t, st.p = 8, p
    engine._finish(st)
    np.testing.assert_array_equal(got, jax_beams[arch, k, ng])


def test_beam_entries_are_leased_released_and_bounded(monkeypatch):
    """A beam request leases an entry keyed by its rows (B*K), cache
    length and dtype, latents' shape and whole `gen`; a second request of
    the key reuses it (its cache the same tensor); a stream abandoned
    after its first yield gives it back; two streams at once lease two;
    with a bound of 2 a third key frees the least recently used."""
    monkeypatch.setattr(tengine, "MAX_ENTRIES", 2)
    cfg, _, _, tmodel = _models("mpt")
    vx, ids = inputs(cfg, 71, 1, 10)
    eng = tengine.OtterGenerator(tmodel, cache_dtype=torch.int8)
    gen = TGen(max_new_tokens=9, num_beams=3, no_repeat_ngram_size=3)
    full = list(eng.stream_beam_generate(vx, ids, gen=gen, chunk=3))
    entry = eng._entries[-1]
    assert entry.key[:3] == (3, 128, "int8") and entry.key[4] == gen
    cache = entry.st.cache["k"]
    stream = eng.stream_beam_generate(vx, ids, gen=gen, chunk=3)
    assert next(stream) == full[0] and entry.busy
    stream.close()
    assert not entry.busy and eng._entries == [entry]
    a, b = (eng.stream_beam_generate(vx, ids, gen=gen, chunk=3)
            for _ in range(2))
    assert next(a) == next(b) == full[0]
    assert len(eng._entries) == 2 and all(e.busy for e in eng._entries)
    assert [full[0]] + list(a) == [full[0]] + list(b) == full
    assert entry in eng._entries and entry.st.cache["k"] is cache
    older, newer = eng._entries       # a's entry, then b's: b ended last
    out = eng.generate(vx, ids, gen=TGen(max_new_tokens=9, num_beams=2))
    assert out.shape == (1, 19)
    assert [e.key[0] for e in eng._entries] == [3, 2]
    assert eng._entries[0] is newer and older.st is None


def test_stream_beam_generate_serves_one_request():
    cfg, _, _, tmodel = _models("mpt")
    vx, ids = inputs(cfg, 72, 2, 6)
    eng = tengine.OtterGenerator(tmodel)
    with pytest.raises(ValueError, match="one request"):
        next(eng.stream_beam_generate(vx, ids, gen=TGen(num_beams=2)))


def test_beam_cache_is_chosen_for_all_rows():
    """The cache dtype is chosen for b * K rows: a budget that fits a
    bf16 cache of b rows but not of b * K degrades the beam request."""
    cfg, _, _, tmodel = _models("mpt")
    vx, lang_x, attn = _ragged(cfg)
    need = tengine.cache_bytes(cfg.text, 4, 128, "int8")
    assert need >= tengine.cache_bytes(cfg.text, 2, 128, "bf16")
    params_b = sum(t.numel() * t.element_size() for t in
                   list(tmodel.parameters()) + list(tmodel.buffers()))
    eng = tengine.OtterGenerator(tmodel, hbm_bytes=5e9 + params_b + need)
    with pytest.warns(UserWarning, match="bf16 -> int8"):
        eng.generate(vx, lang_x, attn,
                     gen=TGen(max_new_tokens=2, num_beams=2))
    assert eng._cache_dtypes == {(4, 128): torch.int8}


# ── api ──────────────────────────────────────────────────────────────

@pytest.fixture(scope="module")
def api_pair():
    """The JAX api's tiny f32 model with its gates moved off zero, and the
    port's api over the same weights."""
    cfg = japi.CONFIGS["tiny"]()
    jm = japi.OtterForConditionalGeneration(cfg, dtype=jnp.float32)
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jm.params, sep="/").items()}
    for key in flat:
        if key.endswith(("attn_gate", "ff_gate")):
            flat[key] = np.full(flat[key].shape, 0.5, np.float32)
    jm.params = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    tm = tapi.OtterForConditionalGeneration(
        port_cfg(cfg), params=flat, dtype=torch.float32, device="cpu")
    return cfg, jm, tm


def test_api_call_matches_jax(api_pair):
    cfg, jm, tm = api_pair
    vx, ids = inputs(cfg, 80, 2, 10)
    labels = ids.copy()
    labels[:, :4] = -100
    loss, logits = tm(vx, ids, labels=labels)
    rloss, rlogits = jm(vx, ids, labels=labels)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(loss), float(rloss), atol=1e-5,
                               rtol=0)
    assert tm(vx, ids)[0] is None


@pytest.mark.parametrize("kw", [dict(max_length=16),
                                dict(max_new_tokens=6, num_beams=2),
                                dict(max_new_tokens=6, num_beams=3,
                                     no_repeat_ngram_size=3, unknown=1)])
def test_api_generate_matches_jax(api_pair, kw):
    cfg, jm, tm = api_pair
    vx, ids = inputs(cfg, 81, 1, 10)
    np.testing.assert_array_equal(tm.generate(vx, ids, **kw),
                                  np.asarray(jm.generate(vx, ids, **kw)))


def test_api_encode_vision_flamingo_and_from_pretrained(api_pair, tmp_path):
    cfg, jm, tm = api_pair
    vx, _ = inputs(cfg, 82, 1, 4)
    np.testing.assert_allclose(tm.encode_vision(vx).numpy(),
                               np.asarray(jm.encode_vision(vx)), atol=1e-4,
                               rtol=0)
    fl = tapi.FlamingoForConditionalGeneration(port_cfg(cfg),
                                               dtype=torch.float32,
                                               device="cpu", seed=3)
    assert fl.cfg.use_media_placement_augmentation
    again = tapi.OtterForConditionalGeneration(port_cfg(cfg),
                                               dtype=torch.float32,
                                               device="cpu", seed=3)
    for a, b in zip(fl.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)       # the seeded init repeats
    # from_pretrained: another seed's model, then an HF checkpoint of the
    # seed-3 weights loaded over it, gives the seed-3 model
    from otter_tpu_torch.models.convert import (export_flax_params,
                                                port_to_hf, save_state_dict)
    ckpt = str(tmp_path / "model.bin")
    save_state_dict(port_to_hf(export_flax_params(again.model),
                               port_cfg(cfg)), ckpt)
    loaded = tapi.OtterForConditionalGeneration.from_pretrained(
        ckpt, config=port_cfg(cfg), dtype=torch.float32, device="cpu")
    for a, b in zip(loaded.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)
