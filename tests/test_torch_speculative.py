"""The port's speculative decoding (`otter_tpu_torch.generation.speculative`)
against the JAX package's `SpeculativeGenerator` and against the port's
own `OtterGenerator`, on a tiny f32 target (MPT, ALiBi) with a 2-layer
mosaic_gpt draft (qk_ln, a cross-attention block before every layer) of
its vocabulary, and on a tiny LLaMA pair (RoPE), on the CPU.

The tests mirror `tests/test_speculative.py`. Greedy tokens must equal
the JAX generator's and the target's own greedy decode. Sampled rounds
draw from a `torch.Generator`, not `jax.random`: the accept rule is held
to the target's distribution and to JAX's rule by the frequency of its
first emitted token, and the processed distribution to JAX's value for
value. The JAX generator runs once a module (`jax_spec`).
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.config import GenerationConfig as JaxGen
from otter_tpu.generation import speculative as jspec
from otter_tpu_torch.config import GenerationConfig
from otter_tpu_torch.generation import speculative
from otter_tpu_torch.generation.engine import OtterGenerator
from torch_parity_helpers import inputs, spec_pair

MAX_NEW = 9


def _jax_generator(target, draft, gamma):
    cfg, jmodel, params, _ = target
    cfg_d, jmodel_d, params_d, _ = draft
    return jspec.SpeculativeGenerator(jmodel, params, cfg, jmodel_d,
                                      params_d, cfg_d, gamma=gamma,
                                      cache_dtype=jnp.float32)


def _port(target, draft, gamma):
    return speculative.SpeculativeGenerator(target[3], draft[3], gamma=gamma,
                                            cache_dtype=torch.float32)


@pytest.fixture(scope="module")
def pair():
    return spec_pair("mpt")


@pytest.fixture(scope="module")
def request_():
    cfg = spec_pair("mpt")[0][0]
    return inputs(cfg, 11, 1, 9)


@pytest.fixture(scope="module")
def jax_spec(pair, request_):
    """The JAX generator's outputs: `generate` at gamma 1, 3 and 4, with
    the target as its own draft, with an eos it emits; `stream` at max_new
    1, 7 and 10 and with an eos; a sampled round at T = 0.01."""
    target, draft = pair
    vx, ids = request_
    out = {}
    for gamma in (1, 3, 4):
        sg = _jax_generator(target, draft, gamma)
        out[gamma] = np.asarray(sg.generate(
            vx, ids, gen=JaxGen(max_new_tokens=MAX_NEW, eos_token_id=-5)))
        out["rounds", gamma] = (sg.last_emitted, sg.last_rounds)
    sg = _jax_generator(target, target, 4)
    out["self"] = np.asarray(sg.generate(
        vx, ids, gen=JaxGen(max_new_tokens=10, eos_token_id=-5)))
    out["self_rounds"] = (sg.last_emitted, sg.last_rounds)
    p = ids.shape[1]
    out["eos"] = int(out[3][0, p + 3])   # the 4th greedy token as eos
    sg = _jax_generator(target, draft, 3)
    out["eos_run"] = np.asarray(sg.generate(
        vx, ids, gen=JaxGen(max_new_tokens=8, eos_token_id=out["eos"])))
    out["rounds", "eos"] = (sg.last_emitted, sg.last_rounds)
    sg = _jax_generator(target, draft, 3)
    for max_new in (1, 7, 10):
        out["stream", max_new] = list(sg.stream(
            vx, ids, gen=JaxGen(max_new_tokens=max_new, eos_token_id=-5)))
    out["stream_eos"] = list(sg.stream(
        vx, ids, gen=JaxGen(max_new_tokens=8,
                            eos_token_id=out["stream", 10][4])))
    out["sampled"] = np.asarray(_jax_generator(target, draft, 3).generate(
        vx, ids, gen=JaxGen(max_new_tokens=8, eos_token_id=-5,
                            do_sample=True, temperature=0.01)))
    return out


def _engine(target):
    return OtterGenerator(target[3], cache_dtype=torch.float32)


@pytest.mark.parametrize("gamma", [1, 3, 4])
def test_speculative_equals_target_greedy(pair, request_, jax_spec, gamma):
    """An independent draft (any acceptance pattern): the JAX generator's
    tokens, and the target's greedy decode alone."""
    target, draft = pair
    vx, ids = request_
    gen = GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-5)
    got = _port(target, draft, gamma).generate(vx, ids, gen=gen)
    np.testing.assert_array_equal(got, jax_spec[gamma])
    np.testing.assert_array_equal(got, _engine(target).generate(vx, ids,
                                                                gen=gen))


def test_speculative_self_draft_full_acceptance(pair, request_, jax_spec):
    """The target as its own draft: every proposal accepted, 10 tokens in
    the prefill and ceil(9 / 5) = 2 rounds, as JAX's generator counts."""
    target, _ = pair
    vx, ids = request_
    sg = _port(target, target, 4)
    got = sg.generate(vx, ids, gen=GenerationConfig(max_new_tokens=10,
                                                    eos_token_id=-5))
    np.testing.assert_array_equal(got, jax_spec["self"])
    assert (sg.last_emitted, sg.last_rounds) == jax_spec["self_rounds"] \
        == (10, math.ceil(9 / 5))


def test_speculative_eos_termination(pair, request_, jax_spec):
    """An eos emitted mid-round cuts the output where the target's own
    decode stops (eos in the buffer, pad after)."""
    target, draft = pair
    vx, ids = request_
    gen = GenerationConfig(max_new_tokens=8, eos_token_id=jax_spec["eos"])
    got = _port(target, draft, 3).generate(vx, ids, gen=gen)
    np.testing.assert_array_equal(got, jax_spec["eos_run"])
    np.testing.assert_array_equal(got, _engine(target).generate(vx, ids,
                                                                gen=gen))
    assert (got[0, ids.shape[1]:] == 0).sum() > 0


def test_speculative_rejects_beams(pair):
    target, draft = pair
    sg = _port(target, draft, 4)
    for gen, lang in ((GenerationConfig(num_beams=4), np.zeros((1, 4))),
                      (GenerationConfig(), np.zeros((2, 4)))):
        with pytest.raises(ValueError):
            sg.generate(np.zeros((1, 1, 1, 3, 28, 28), np.float32), lang,
                        gen=gen)
    other = SimpleNamespace(cfg=SimpleNamespace(
        text=SimpleNamespace(vocab_size=target[0].text.vocab_size + 1)))
    with pytest.raises(ValueError, match="vocabulary"):
        speculative.SpeculativeGenerator(target[3], other)


def test_speculative_stream_matches_engine_stream(pair, request_, jax_spec):
    """Round-driven streaming yields the engine's `stream_generate` ids and
    the JAX generator's stream, with max_new cutting mid-round and an eos
    mid-stream."""
    target, draft = pair
    vx, ids = request_
    eng = _engine(target)
    sg = _port(target, draft, 3)
    for max_new in (1, 7, 10):
        gen = GenerationConfig(max_new_tokens=max_new, eos_token_id=-5)
        got = list(sg.stream(vx, ids, gen=gen))
        assert got == list(eng.stream_generate(vx, ids, gen=gen)) \
            == jax_spec["stream", max_new], max_new
    gen = GenerationConfig(max_new_tokens=8,
                           eos_token_id=jax_spec["stream", 10][4])
    got = list(sg.stream(vx, ids, gen=gen))
    assert got == list(eng.stream_generate(vx, ids, gen=gen)) \
        == jax_spec["stream_eos"]


def test_accept_resample_distribution():
    """Thm 1 of the rejection rule: the first emitted token is distributed
    as the target's p0 whatever the draft's q (20000 draws a row at once,
    frequencies within 0.01 of p0 and of JAX's rule's own frequencies);
    with q = p every proposal is accepted."""
    v, g, n = 11, 3, 20000
    kp, kq, kr = jax.random.split(jax.random.PRNGKey(42), 3)
    p = np.array(jax.nn.softmax(jax.random.normal(kp, (g + 1, v)) * 1.5, -1))
    q = np.array(jax.nn.softmax(jax.random.normal(kq, (g, v)) * 1.5, -1))
    gen = torch.Generator().manual_seed(3)
    pt, qt = torch.from_numpy(p), torch.from_numpy(q)
    d = speculative.categorical(qt.expand(n, g, v), gen)        # [n, g]
    out, m = speculative.accept_resample_rows(
        pt.expand(n, g + 1, v), qt.expand(n, g, v), d, gen)
    freq = np.bincount(out[:, 0].numpy(), minlength=v) / n
    np.testing.assert_allclose(freq, p[0], atol=0.01)

    def one(k):
        k1, k2 = jax.random.split(k)
        dj = jax.vmap(lambda kk, qq: jax.random.categorical(
            kk, jnp.log(qq)))(jax.random.split(k1, g), q).astype(jnp.int32)
        return jspec.accept_resample(jnp.asarray(p), jnp.asarray(q), dj,
                                     k2)[0][0]
    jfirst = np.asarray(jax.jit(jax.vmap(one))(jax.random.split(kr, n)))
    np.testing.assert_allclose(freq, np.bincount(jfirst, minlength=v) / n,
                               atol=0.01)
    assert ((m >= 1) & (m <= g + 1)).all()
    d = speculative.categorical(pt[:g].expand(2000, g, v), gen)
    _, m = speculative.accept_resample_rows(
        pt.expand(2000, g + 1, v), pt[:g].expand(2000, g, v), d, gen)
    assert (m == g + 1).all()
    one_out, one_n = speculative.accept_resample(pt, pt[:g], d[0], gen)
    assert one_out.shape == (g + 1,) and int(one_n) == g + 1


@pytest.mark.parametrize("kw", [dict(temperature=0.7),
                                dict(temperature=1.3, top_k=5),
                                dict(top_p=0.8), dict(top_k=3, top_p=0.5)])
def test_processed_probs_match_jax(kw):
    """The processed distribution that p and q go through equals JAX's."""
    logits = np.random.default_rng(4).standard_normal((3, 64)).astype(
        np.float32) * 3
    want = np.asarray(jspec.processed_probs(
        jnp.asarray(logits), JaxGen(do_sample=True, **kw)))
    got = speculative.processed_probs(torch.from_numpy(logits),
                                      GenerationConfig(do_sample=True, **kw))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_spec_sampling_near_zero_temperature_is_greedy(pair, request_,
                                                       jax_spec):
    """Sampled at T = 0.01 the processed distribution is a near-delta at
    the argmax: the sampled rounds give the greedy decode (an independent
    draft), through `generate` and `stream`, as JAX's do."""
    target, draft = pair
    vx, ids = request_
    greedy = GenerationConfig(max_new_tokens=8, eos_token_id=-5)
    sampled = GenerationConfig(max_new_tokens=8, eos_token_id=-5,
                               do_sample=True, temperature=0.01)
    want = _engine(target).generate(vx, ids, gen=greedy)
    g = torch.Generator().manual_seed(0)
    got = _port(target, draft, 3).generate(vx, ids, gen=sampled, generator=g)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_spec["sampled"])
    assert list(_port(target, draft, 2).stream(vx, ids, gen=sampled,
                                               generator=g)) \
        == list(_engine(target).stream_generate(vx, ids, gen=greedy))


def _rope_request():
    """The LLaMA pair and a left-padded prompt (3 pad columns of 10)."""
    target, draft = spec_pair("llama")
    vx, ids = inputs(target[0], 12, 1, 10)
    mask = np.ones_like(ids)
    mask[0, :3] = 0
    return target, draft, vx, ids, mask


# the LLaMA target's greedy tokens on this prompt vary (the tiny MPT's
# repeat one token): with itself as the draft an eos at its 5th token
# lands inside the first round
EOS_MID = dict(seed=30, length=9, eos=43, max_new=9)


@pytest.fixture(scope="module")
def jax_llama():
    """The JAX generator on the LLaMA pair: the left-padded prompt, gamma
    3, 7 new tokens ("rope"), and the target as its own draft, gamma 4,
    with an eos inside a round ("eos"): each (buffer, (last_emitted,
    last_rounds))."""
    target, draft, vx, ids, mask = _rope_request()
    out = {}
    sg = _jax_generator(target, draft, 3)
    out["rope"] = (np.asarray(sg.generate(vx, ids, mask, gen=JaxGen(
        max_new_tokens=7, eos_token_id=-5))), (sg.last_emitted,
                                               sg.last_rounds))
    vx, ids = inputs(target[0], EOS_MID["seed"], 1, EOS_MID["length"])
    sg = _jax_generator(target, target, 4)
    out["eos"] = (np.asarray(sg.generate(vx, ids, gen=JaxGen(
        max_new_tokens=EOS_MID["max_new"], eos_token_id=EOS_MID["eos"]))),
        (sg.last_emitted, sg.last_rounds))
    return out


def test_rope_pair_with_left_padding_matches_jax(jax_llama):
    """The LLaMA pair (RoPE: a window's positions are its columns less the
    prompt's left padding) on a left-padded prompt: the JAX generator's
    tokens and the target's greedy decode."""
    target, draft, vx, ids, mask = _rope_request()
    gen = GenerationConfig(max_new_tokens=7, eos_token_id=-5)
    got = _port(target, draft, 3).generate(vx, ids, mask, gen=gen)
    np.testing.assert_array_equal(got, jax_llama["rope"][0])
    np.testing.assert_array_equal(got, _engine(target).generate(
        vx, ids, mask, gen=gen))


# ── the round on device counters (what a CUDA graph captures) ───────

def _body_run(sg, vx, ids, mask, gen, extra: int = 0):
    """A request through the round body, called with no argument as a
    graph calls it: the prefill fills a leased entry, the host's prompt
    width and round count are wiped, and the body runs max_new_tokens - 1
    times (every round a request can need; those past its end change
    nothing) and `extra` more. Returns (the buffer padded after the
    emitted tokens, emitted, rounds, the state) and gives the entry
    back."""
    gen_, eos, cache_len = sg._setup(ids, gen)
    st = sg._prefill(vx, ids, mask, gen_, eos, None, cache_len)
    p = st.p
    st.p = st.t = None
    try:
        with torch.inference_mode():
            for _ in range(gen.max_new_tokens - 1 + extra):
                st.entry.body()
        emitted, rounds = int(st.emitted), int(st.rounds)
        cols = torch.arange(p + gen.max_new_tokens)
        out = torch.where(cols < p + emitted,
                          st.buffer[:, :p + gen.max_new_tokens],
                          gen.pad_token_id).numpy()
    finally:
        st.p = p
        sg._finish(st)
    return out, emitted, rounds, st


def _eos_mid_request():
    """The LLaMA target as its own draft (gamma 4) and `EOS_MID`'s
    prompt and generation settings."""
    target = spec_pair("llama")[0]
    vx, ids = inputs(target[0], EOS_MID["seed"], 1, EOS_MID["length"])
    gen = GenerationConfig(max_new_tokens=EOS_MID["max_new"],
                           eos_token_id=EOS_MID["eos"])
    return _port(target, target, 4), vx, ids, gen


@pytest.mark.parametrize("case", ["gamma1", "gamma4", "self", "eos",
                                  "rope"])
def test_round_body_called_with_no_argument_gives_jax_tokens(
        pair, request_, jax_spec, jax_llama, case):
    """The device-counter round, one call built once and made with nothing
    that changes from one call to the next, gives the JAX generator's
    buffer, last_emitted and last_rounds: an independent draft at gamma 1
    and 4, the target as its own draft (every proposal accepted), an eos
    emitted inside a round (the LLaMA target as its own draft), and the
    RoPE pair on a left-padded prompt."""
    target, draft = pair
    vx, ids = request_
    mask = None
    gen = GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-5)
    if case.startswith("gamma"):
        g = int(case[-1])
        sg, want, counts = (_port(target, draft, g), jax_spec[g],
                            jax_spec["rounds", g])
    elif case == "self":
        gen = GenerationConfig(max_new_tokens=10, eos_token_id=-5)
        sg, want, counts = (_port(target, target, 4), jax_spec["self"],
                            jax_spec["self_rounds"])
    elif case == "eos":
        sg, vx, ids, gen = _eos_mid_request()
        want, counts = jax_llama["eos"]
        # the eos is the 4th token of the first round
        assert counts == (5, 1)
    else:
        target, draft, vx, ids, mask = _rope_request()
        gen = GenerationConfig(max_new_tokens=7, eos_token_id=-5)
        sg, (want, counts) = _port(target, draft, 3), jax_llama["rope"]
    assert not sg.cuda_graph
    out, emitted, rounds, _ = _body_run(sg, vx, ids, mask, gen)
    np.testing.assert_array_equal(out, want)
    assert (emitted, rounds) == counts


@pytest.mark.parametrize("end", ["eos", "budget"])
def test_rounds_queued_past_the_end_change_nothing(pair, request_, end):
    """Rounds queued after a request ended (an eos emitted inside a round,
    or max_new_tokens reached: the target as its own draft emits 5 tokens
    a round) emit nothing: n = 0, the buffer and every counter as they
    were, and both caches unchanged below the next undecided column
    (their windows write from it on)."""
    if end == "eos":
        sg, vx, ids, gen = _eos_mid_request()
    else:
        target = pair[0]
        vx, ids = request_
        sg = _port(target, target, 4)
        gen = GenerationConfig(max_new_tokens=7, eos_token_id=-5)
    _, emitted, _, st = _body_run(sg, vx, ids, None, gen)
    assert bool(st.done) == (end == "eos")
    assert emitted == (5 if end == "eos" else 7)
    counters = ("pos", "emitted", "rounds", "done", "max_new")
    before = {k: getattr(st, k).clone() for k in counters + ("buffer",)}
    caches = {(c, k): v.clone() for c in ("cache_t", "cache_d")
              for k, v in getattr(st, c).items()}
    pos = int(st.pos)
    with torch.inference_mode():
        for _ in range(3):
            st.entry.body()
            assert int(st.n) == 0
    for k, v in before.items():
        assert torch.equal(getattr(st, k), v), k
    for (c, k), v in caches.items():
        assert torch.equal(getattr(st, c)[k][..., :pos, :],
                           v[..., :pos, :]), (c, k)


def test_requests_of_two_prompt_lengths_share_one_key(pair, monkeypatch):
    """Prompts of 9 and 12 tokens (one cache length) lease one entry and
    one graph (`cuda_graph` forced on, the capture faked: the CPU has no
    graph): the first request captures at its first round and replays the
    rest, the second only replays; their tokens are the eager generator's.
    A sampled key is a second entry, and a seeded request draws what its
    eager twin draws."""
    from torch_parity_helpers import fake_capture
    target, draft = pair
    reqs = [inputs(target[0], 11, 1, 9), inputs(target[0], 13, 1, 12)]
    greedy = GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-5)
    sampled = GenerationConfig(max_new_tokens=6, eos_token_id=-5,
                               do_sample=True, temperature=1.5, top_k=30)
    seeded = lambda: torch.Generator().manual_seed(3)
    eager = _port(target, draft, 3)
    want = [eager.generate(*r, gen=greedy) for r in reqs]
    want_s = [eager.generate(*r, gen=sampled, generator=seeded())
              for r in reqs]
    sg = _port(target, draft, 3)
    sg.cuda_graph = True
    captured, rounds, advance = [], [], sg._advance
    monkeypatch.setattr(sg, "_capture", fake_capture(sg, captured))
    sg._advance = lambda st: (rounds.append(1), advance(st))
    for r, w in zip(reqs, want):
        np.testing.assert_array_equal(sg.generate(*r, gen=greedy), w)
        assert len(captured) == 1
    entry = captured[0]
    assert sg._entries == [entry] and not entry.busy
    assert entry.key[1] == 128 and entry.graph.replays == len(rounds) - 1
    for r, w in zip(reqs, want_s):
        np.testing.assert_array_equal(
            sg.generate(*r, gen=sampled, generator=seeded()), w)
    assert len(captured) == 2 and len(sg._entries) == 2
    assert [len(list(sg.stream(*r, gen=greedy))) for r in reqs] == [
        MAX_NEW, MAX_NEW]
    assert len(captured) == 2


def test_graph_is_refused_where_it_cannot_run(pair):
    """No graph on the CPU and none where the target or the draft is
    sharded: asking for one raises; the default is off there, and the
    sessions over such a pair run eagerly."""
    from otter_tpu_torch.generation import session
    target, draft = pair
    sg = _port(target, draft, 3)
    assert sg.cuda_graph is False
    assert session.SpecChatSession(sg).steps.cuda_graph is False
    with pytest.raises(ValueError, match="CUDA model and draft"):
        speculative.SpeculativeGenerator(target[3], draft[3],
                                         cuda_graph=True)
    sharded = SimpleNamespace(cfg=draft[3].cfg, device=draft[3].device,
                              _shard_layouts={})
    assert speculative.SpeculativeGenerator(target[3],
                                            sharded).cuda_graph is False
    with pytest.raises(ValueError, match="sharded model and draft"):
        speculative.SpeculativeGenerator(target[3], sharded,
                                         cuda_graph=True)
    assert session.ChatSession(target[3]).steps.cuda_graph is False
    with pytest.raises(ValueError, match="CUDA model"):
        session.ChatSession(target[3], cuda_graph=True)
