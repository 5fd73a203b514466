"""The port's session cache (`otter_tpu_torch.generation.session`) against
the JAX package's `ChatSession` / `SpecChatSession` and against the
port's own stateless `OtterGenerator.stream_generate`, on the tiny f32
models on the CPU (MPT and LLaMA targets; the speculative sessions with
the 2-layer mosaic_gpt draft).

The tests mirror `tests/test_session.py`: every turn's tokens equal the
stateless stream on the full prompt and the JAX session's, while turns
2-3 reuse the cached prefix (`last_stats`). The JAX sessions run once a
module (`jax_sessions`); each turn's prompt is the previous one, its
reply, the end-of-chunk token and 5 new tokens.
"""

import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.config import GenerationConfig as JaxGen
from otter_tpu.generation import session as jsession
from otter_tpu.generation import speculative as jspec
from otter_tpu_torch.config import GenerationConfig
from otter_tpu_torch.generation import session, speculative
from otter_tpu_torch.generation.engine import OtterGenerator
from torch_parity_helpers import inputs, spec_pair

SESSION = dict(cache_len=128, prompt_bucket=16, window_bucket=8, min_reuse=4)


def _jax_conversation(sess, cfg, vx, ids, gen, seed, turns=3):
    """A JAX session's conversation: (prompts, replies, reuse stats)."""
    prompts, replies, stats = [ids], [], []
    rng = np.random.default_rng(seed)
    for t in range(turns):
        replies.append(list(sess.stream(jnp.asarray(vx),
                                        jnp.asarray(prompts[-1]), gen=gen)))
        stats.append(dict(sess.last_stats))
        if t + 1 < turns:
            extra = rng.integers(5, 200, (1, 5)).astype(np.int32)
            prompts.append(np.concatenate(
                [prompts[-1], np.asarray([replies[-1]], np.int32),
                 np.asarray([[cfg.eoc_token_id]], np.int32), extra], 1))
    return prompts, replies, stats


def _next(ids, first, seed):
    """The second turn's prompt: the first, its reply and 4 new tokens."""
    extra = np.random.default_rng(seed).integers(5, 200, (1, 4))
    return np.concatenate([ids, np.asarray([first], np.int32),
                           extra.astype(np.int32)], 1)


def _edited(ids, first, seed):
    """The second turn's prompt with a token inside the cached region
    edited (column 6)."""
    prompt = _next(ids, first, seed)
    prompt[0, 6] = (prompt[0, 6] + 1) % 200 + 5
    return prompt


def _jax_spec(target, draft, gamma=3):
    return jspec.SpeculativeGenerator(target[1], target[2], target[0],
                                      draft[1], draft[2], draft[0],
                                      gamma=gamma, cache_dtype=jnp.float32)


@pytest.fixture(scope="module")
def jax_sessions():
    """The JAX sessions' outputs: 3-turn conversations (MPT and LLaMA
    `ChatSession`s, the MPT `SpecChatSession`), the divergent-history and
    vision-change second turns, and the speculative session's eos cut and
    sampled T = 0.01 turns."""
    out = {}
    gen = JaxGen(max_new_tokens=6, eos_token_id=-5)
    for arch in ("mpt", "llama"):
        cfg, jmodel, params, _ = spec_pair(arch)[0]
        vx, ids = inputs(cfg, 21, 1, 9)
        sess = jsession.ChatSession(jmodel, params, cfg,
                                    cache_dtype=jnp.float32, **SESSION)
        out[arch] = _jax_conversation(sess, cfg, vx, ids, gen, 30)
    target, draft = spec_pair("mpt")
    cfg = target[0]
    vx, ids = inputs(cfg, 21, 1, 9)
    out["spec"] = _jax_conversation(
        jsession.SpecChatSession(_jax_spec(target, draft), **SESSION), cfg,
        vx, ids, gen, 30)
    gen5 = JaxGen(max_new_tokens=5, eos_token_id=-5)
    for kind in ("plain", "spec"):
        sess = (jsession.ChatSession(target[1], target[2], cfg,
                                     cache_dtype=jnp.float32, **SESSION)
                if kind == "plain" else
                jsession.SpecChatSession(_jax_spec(target, draft), **SESSION))
        first = list(sess.stream(jnp.asarray(vx), jnp.asarray(ids), gen=gen5))
        edited = _edited(ids, first, 40)
        out["divergent", kind] = (first, edited, list(sess.stream(
            jnp.asarray(vx), jnp.asarray(edited), gen=gen5)),
            dict(sess.last_stats))
    sess = jsession.SpecChatSession(_jax_spec(target, draft), **SESSION)
    probe = out["spec"][1][0]
    eos_gen = JaxGen(max_new_tokens=6, eos_token_id=probe[2])
    out["eos"] = list(sess.stream(jnp.asarray(vx), jnp.asarray(ids),
                                  gen=eos_gen))
    sess = jsession.SpecChatSession(_jax_spec(target, draft), **SESSION)
    sampled = JaxGen(max_new_tokens=5, eos_token_id=-5, do_sample=True,
                     temperature=0.01)
    first = list(sess.stream(jnp.asarray(vx), jnp.asarray(ids), gen=sampled))
    prompt2 = _next(ids, first, 41)
    out["sampled"] = (first, prompt2, list(sess.stream(
        jnp.asarray(vx), jnp.asarray(prompt2), gen=sampled)))
    return out


def _engine(model):
    return OtterGenerator(model, cache_dtype=torch.float32)


def _stateless(model, vx, ids, gen):
    return list(_engine(model).stream_generate(vx, ids, gen=gen))


def _port_session(model):
    return session.ChatSession(model, cache_dtype=torch.float32, **SESSION)


def _port_spec_session():
    target, draft = spec_pair("mpt")
    return session.SpecChatSession(speculative.SpeculativeGenerator(
        target[3], draft[3], gamma=3, cache_dtype=torch.float32), **SESSION)


def _replay(sess, model, vx, conversation, gen, spec: bool):
    """The JAX conversation's prompts through a port session: each turn
    equal to the JAX session's reply and the stateless stream, turns 2-3
    reusing what the cache held."""
    prompts, replies, jstats = conversation
    for t, (prompt, want) in enumerate(zip(prompts, replies)):
        got = list(sess.stream(vx, prompt, gen=gen))
        assert got == want == _stateless(model, vx, prompt, gen), t
        assert sess.last_stats == jstats[t], t
        if t == 0:
            assert sess.last_stats["restart"]
        else:
            assert not sess.last_stats["restart"]
            held = prompts[t - 1].shape[1] + len(replies[t - 1])
            # a speculative session re-ingests the newest token
            assert sess.last_stats["reused"] >= held - (1 if spec else 0)


@pytest.mark.parametrize("arch", ["mpt", "llama"])
def test_session_multi_turn_matches_stateless(jax_sessions, arch):
    """3 turns: the stateless stream's tokens and the JAX session's, turns
    2-3 reusing the whole cached prefix (ALiBi and RoPE)."""
    model = spec_pair(arch)[0][3]
    vx, _ = inputs(model.cfg, 21, 1, 9)
    _replay(_port_session(model), model, vx, jax_sessions[arch],
            GenerationConfig(max_new_tokens=6, eos_token_id=-5), False)


def test_session_divergent_history(jax_sessions):
    """An edit inside the cached history keeps the common prefix (0..5)
    and matches the stateless stream from the divergence on."""
    model = spec_pair("mpt")[0][3]
    vx, ids = inputs(model.cfg, 21, 1, 9)
    gen = GenerationConfig(max_new_tokens=5, eos_token_id=-5)
    first, edited, want, jstats = jax_sessions["divergent", "plain"]
    sess = _port_session(model)
    assert list(sess.stream(vx, ids, gen=gen)) == first
    got = list(sess.stream(vx, edited, gen=gen))
    assert got == want == _stateless(model, vx, edited, gen)
    assert sess.last_stats == jstats
    assert not sess.last_stats["restart"] and sess.last_stats["reused"] == 6


def test_session_vision_change_restarts():
    model = spec_pair("mpt")[0][3]
    vx, ids = inputs(model.cfg, 21, 1, 9)
    gen = GenerationConfig(max_new_tokens=4, eos_token_id=-5)
    sess = _port_session(model)
    list(sess.stream(vx, ids, gen=gen))
    vx2 = np.random.default_rng(5).standard_normal(vx.shape).astype(
        np.float32)
    prompt2 = np.concatenate([ids, np.asarray([[17, 18, 19]], np.int32)], 1)
    got = list(sess.stream(vx2, prompt2, gen=gen))
    assert got == _stateless(model, vx2, prompt2, gen)
    assert sess.last_stats["restart"]


def test_session_capacity_error():
    model = spec_pair("mpt")[0][3]
    vx, ids = inputs(model.cfg, 21, 1, 9)
    sess = _port_session(model)
    with pytest.raises(ValueError, match="cache_len"):
        list(sess.stream(vx, ids, gen=GenerationConfig(max_new_tokens=200,
                                                       eos_token_id=-5)))


def test_session_pool_lru():
    model = spec_pair("mpt")[0][3]
    pool = session.SessionPool(model, max_sessions=2,
                               cache_dtype=torch.float32, **SESSION)
    a = pool.get("a")
    b = pool.get("b")
    assert pool.get("a") is a
    pool.get("c")                      # evicts b (least recently used)
    assert pool.get("a") is a
    assert pool.get("b") is not b      # rebuilt from scratch
    assert isinstance(a, session.ChatSession) and a.cache_len == 128


def test_session_pool_holds_a_session_for_one_stream():
    """A session that a stream holds is never handed to a second request
    (None: the caller takes the stateless path) and is not evicted; a
    session free again is handed out once more. Many threads acquiring
    one id at once (more than the cores, with a short switch interval) get
    it once between them."""
    model = spec_pair("mpt")[0][3]
    pool = session.SessionPool(model, max_sessions=2,
                               cache_dtype=torch.float32, **SESSION)
    a = pool.acquire("a")
    assert a is not None and pool.acquire("a") is None
    b = pool.acquire("b")
    assert pool.acquire("c") is None           # full, every session held
    pool.release(b)
    c = pool.acquire("c")                      # evicts b, not the held a
    assert c is not None and pool.get("a") is a
    pool.release(a)
    assert pool.acquire("a") is a
    pool.release(a)
    pool.release(c)
    n = 4 * (os.cpu_count() or 8)
    got, barrier = [], threading.Barrier(n)

    def take():
        barrier.wait()
        got.append(pool.acquire("x"))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=take) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == n and sum(s is not None for s in got) == 1


def test_spec_session_multi_turn_matches_stateless(jax_sessions):
    """3 turns through the speculative session: the target's stateless
    stream and the JAX session's tokens, turns 2-3 reusing the prefix
    (less the newest token, which a round leaves unlearned)."""
    target = spec_pair("mpt")[0]
    vx, _ = inputs(target[0], 21, 1, 9)
    _replay(_port_spec_session(), target[3], vx, jax_sessions["spec"],
            GenerationConfig(max_new_tokens=6, eos_token_id=-5), True)


def test_spec_session_divergent_history(jax_sessions):
    model = spec_pair("mpt")[0][3]
    vx, ids = inputs(model.cfg, 21, 1, 9)
    gen = GenerationConfig(max_new_tokens=5, eos_token_id=-5)
    first, edited, want, jstats = jax_sessions["divergent", "spec"]
    sess = _port_spec_session()
    assert list(sess.stream(vx, ids, gen=gen)) == first
    got = list(sess.stream(vx, edited, gen=gen))
    assert got == want == _stateless(model, vx, edited, gen)
    assert sess.last_stats == jstats
    assert not sess.last_stats["restart"] and sess.last_stats["reused"] == 6


def test_spec_session_eos_and_capacity(jax_sessions):
    """An eos mid-round ends the turn where the stateless stream does and
    the next turn still matches; a turn that cannot fit raises ValueError
    before any output."""
    model = spec_pair("mpt")[0][3]
    vx, ids = inputs(model.cfg, 21, 1, 9)
    probe = jax_sessions["spec"][1][0]
    sess = _port_spec_session()
    gen = GenerationConfig(max_new_tokens=6, eos_token_id=probe[2])
    got = list(sess.stream(vx, ids, gen=gen))
    assert got == jax_sessions["eos"] == _stateless(model, vx, ids, gen)
    assert len(got) < len(probe)
    prompt2 = _next(ids, got, 6)
    gen2 = GenerationConfig(max_new_tokens=4, eos_token_id=-5)
    assert list(sess.stream(vx, prompt2, gen=gen2)) == _stateless(
        model, vx, prompt2, gen2)
    assert not sess.last_stats["restart"]
    with pytest.raises(ValueError, match="cache_len"):
        list(sess.stream(vx, ids, gen=GenerationConfig(max_new_tokens=200,
                                                       eos_token_id=-5)))


def test_spec_session_sampled_t0_matches_greedy(jax_sessions):
    """Sampled at T = 0.01 through the composition: the greedy stateless
    stream and the JAX session's tokens, with reuse on the second turn."""
    model = spec_pair("mpt")[0][3]
    vx, ids = inputs(model.cfg, 21, 1, 9)
    greedy = GenerationConfig(max_new_tokens=5, eos_token_id=-5)
    sampled = GenerationConfig(max_new_tokens=5, eos_token_id=-5,
                               do_sample=True, temperature=0.01)
    first, prompt2, second = jax_sessions["sampled"]
    sess = _port_spec_session()
    g = torch.Generator().manual_seed(0)
    assert list(sess.stream(vx, ids, gen=sampled, generator=g)) == first \
        == _stateless(model, vx, ids, greedy)
    assert list(sess.stream(vx, prompt2, gen=sampled, generator=g)) \
        == second == _stateless(model, vx, prompt2, greedy)
    assert not sess.last_stats["restart"]


def test_window_at_the_cache_end_stays_in_the_cache():
    """A reused turn whose bucketed window would pass the cache's last
    column: the window is cut to the cache and the turn still equals the
    stateless stream (the JAX session's scalar-offset write would shift
    the whole window back over cached columns instead)."""
    model = spec_pair("mpt")[0][3]
    vx, ids = inputs(model.cfg, 21, 1, 9)
    sess = session.ChatSession(model, cache_len=40, prompt_bucket=16,
                               window_bucket=32, min_reuse=4,
                               cache_dtype=torch.float32)
    gen = GenerationConfig(max_new_tokens=4, eos_token_id=-5)
    first = list(sess.stream(vx, ids, gen=gen))
    prompt2 = np.concatenate([ids, np.asarray([first], np.int32),
                              np.asarray([[21, 22, 23, 24, 25, 26, 27, 28,
                                           29, 30, 31]], np.int32)], 1)
    got = list(sess.stream(vx, prompt2, gen=gen))
    stats = sess.last_stats
    assert not stats["restart"]
    assert sess.valid_from + stats["reused"] + 32 > 40 \
        and stats["window_pad"] == 40 - sess.valid_from - stats["reused"]
    assert got == _stateless(model, vx, prompt2, gen)
