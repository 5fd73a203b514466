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
        out[gamma] = np.asarray(_jax_generator(target, draft, gamma).generate(
            vx, ids, gen=JaxGen(max_new_tokens=MAX_NEW, eos_token_id=-5)))
    sg = _jax_generator(target, target, 4)
    out["self"] = np.asarray(sg.generate(
        vx, ids, gen=JaxGen(max_new_tokens=10, eos_token_id=-5)))
    out["self_rounds"] = (sg.last_emitted, sg.last_rounds)
    p = ids.shape[1]
    out["eos"] = int(out[3][0, p + 3])   # the 4th greedy token as eos
    out["eos_run"] = np.asarray(_jax_generator(target, draft, 3).generate(
        vx, ids, gen=JaxGen(max_new_tokens=8, eos_token_id=out["eos"])))
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


def test_rope_pair_with_left_padding_matches_jax():
    """The LLaMA pair (RoPE: a window's positions are its columns less the
    prompt's left padding) on a left-padded prompt: the JAX generator's
    tokens and the target's greedy decode."""
    target, draft = spec_pair("llama")
    vx, ids = inputs(target[0], 12, 1, 10)
    mask = np.ones_like(ids)
    mask[0, :3] = 0
    gen = GenerationConfig(max_new_tokens=7, eos_token_id=-5)
    got = _port(target, draft, 3).generate(vx, ids, mask, gen=gen)
    want = _jax_generator(target, draft, 3).generate(
        vx, ids, mask, gen=JaxGen(max_new_tokens=7, eos_token_id=-5))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, _engine(target).generate(
        vx, ids, mask, gen=gen))
