"""Port parity: the decoder's archs (llama, persimmon, falcon, mosaic_gpt
with qk_ln, MPT multiquery with clip_qkv, learned positions) against the JAX
decoder built from the same parameters, in f32 on the CPU: the full forward
and a prefill followed by cached steps over a ragged left-padded batch with
explicit positions, unquantized and with int8 (int4) weights, over f32,
bf16 and int8 caches. With quantized weights the untied head of a decode step goes
through `int8_matmul` on both sides (Pallas in interpret mode there, the
plain version here), the MLPs through `int8_mlp` where the arch allows.

Tolerance: logits within 1e-3 max-abs (the BASELINE.md logit-parity bar).
Over an int8 (or bf16) cache an entry that sits near a rounding boundary
may land one step apart in the two frameworks, which moves later logits by
about 2e-3 (int8): the port's cache takes the JAX entries (checked to be at
most one step away) after each comparison, as in test_torch_vlm.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.models.decoder import init_cache as jinit_cache
from otter_tpu_torch import config as tcfg
from otter_tpu_torch.models.decoder import Decoder, init_cache
from otter_tpu_torch.ops import quant as tquant
from torch_parity_helpers import ARCH_CASES, decoder_pair, ragged

LOGIT_TOL = 1e-3
CASES = sorted(ARCH_CASES)


def _close(out, ref, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("case", CASES)
def test_full_forward_matches_jax(case):
    cfg, jmodel, params, tmodel = decoder_pair(case)
    ids, mask, positions = ragged(np.random.default_rng(31), cfg.vocab_size,
                                  seq=12)
    ref, _ = jax.jit(jmodel.apply)(
        params, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        positions=jnp.asarray(positions))
    with torch.no_grad():
        out, _ = tmodel(torch.from_numpy(ids).long(),
                        attention_mask=torch.from_numpy(mask),
                        positions=torch.from_numpy(positions).long())
    assert out.shape == (2, 12, cfg.total_vocab)
    _close(out, ref)


def _cached_decode(case, quant, cache, quant_embed=False, steps=3):
    cfg, jmodel, params, tmodel = decoder_pair(case, quant, quant_embed)
    b, p, L = 2, 10, 128
    ids, mask, positions = ragged(np.random.default_rng(32), cfg.vocab_size,
                                  b, p)
    jdt, tdt = {"int8": (jnp.int8, torch.int8),
                "bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[cache]
    jcache = jinit_cache(cfg, b, L, jdt)
    tcache = init_cache(tmodel.cfg, b, L, tdt, "cpu")
    prefill = jax.jit(lambda ids, mask, pos, cache: jmodel.apply(
        params, ids, attention_mask=mask, positions=pos, cache=cache,
        head_last_only=True))
    step = jax.jit(lambda tok, cache, cpos, kv_valid, pos: jmodel.apply(
        params, tok, cache=cache, cache_pos=cpos, kv_valid=kv_valid,
        positions=pos))
    jl, jcache = prefill(jnp.asarray(ids), jnp.asarray(mask),
                         jnp.asarray(positions), jcache)
    with torch.no_grad():
        tl, tcache = tmodel(torch.from_numpy(ids).long(),
                            attention_mask=torch.from_numpy(mask),
                            positions=torch.from_numpy(positions).long(),
                            cache=tcache, head_last_only=True)
    assert tl.shape == (b, 1, cfg.total_vocab)
    _close(tl, jl)

    def sync_cache(n):
        # entries: equal in f32, at most one rounding step apart in bf16
        # (2^-7 relative) and int8 (1); scales equal
        tol = {"f32": 1e-4, "bf16": 2.0 ** -7, "int8": 1.0}[cache]
        for key in tcache:
            ref = np.array(jcache[key][:, :, :, :n], np.float32)
            _close(tcache[key][:, :, :, :n].float(), ref,
                   1e-4 if key.endswith("scale") else tol)
            if cache != "f32":
                tcache[key][:, :, :, :n] = torch.from_numpy(ref).to(
                    tcache[key].dtype)

    sync_cache(p)
    real_len = mask.sum(-1)
    kv_valid = np.zeros((b, L), bool)
    kv_valid[:, :p] = mask.astype(bool)
    head = []
    for t in range(steps):
        tok = np.full((b, 1), 7 + 2 * t, np.int32)
        pos = (real_len + t)[:, None].astype(np.int32)
        kv_valid[:, p + t] = True
        jl, jcache = step(jnp.asarray(tok), jcache, p + t,
                          jnp.asarray(kv_valid), jnp.asarray(pos))
        calls = _Counting(tquant, "int8_matmul")
        with torch.no_grad(), calls:
            tl, tcache = tmodel(
                torch.from_numpy(tok).long(), cache=tcache, cache_pos=p + t,
                kv_valid=torch.from_numpy(kv_valid.copy()),
                positions=torch.from_numpy(pos).long())
        head.append(calls.n)
        _close(tl, jl)
        sync_cache(p + t + 1)
    # an untied quantized head takes int8_matmul once a step, no other does
    want = int(quant is not None and not cfg.tie_embeddings)
    assert head == [want] * steps


class _Counting:
    """Counts the calls of `module.name` inside the `with` block (on the
    CPU a wrapper's launch counter never moves)."""

    def __init__(self, module, name):
        self.module, self.name, self.n = module, name, 0

    def __enter__(self):
        self.saved = getattr(self.module, self.name)

        def counted(*a, **kw):
            self.n += 1
            return self.saved(*a, **kw)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", CASES)
def test_cached_decode_matches_jax(case, cache):
    _cached_decode(case, None, cache)


@pytest.mark.parametrize("cache", ["f32", "int8"])
@pytest.mark.parametrize("case", CASES)
def test_cached_decode_int8_weights_matches_jax(case, cache):
    _cached_decode(case, "int8", cache)


@pytest.mark.parametrize("case", ["llama", "persimmon"])
def test_cached_decode_int4_weights_matches_jax(case):
    """`quant="int4"`: the gated (llama) and the biased (persimmon) MLPs
    stay int8 and no weight is packed."""
    _, _, _, tmodel = decoder_pair(case, "int4")
    assert not any(n.endswith("kernel_q4") for n, _ in
                   tmodel.named_buffers())
    _cached_decode(case, "int4", "int8")


def test_cached_decode_quant_embed_matches_jax():
    _, _, _, tmodel = decoder_pair("persimmon", "int8", True)
    assert tmodel.wte_q.dtype == torch.int8 and not hasattr(tmodel, "wte")
    _cached_decode("persimmon", "int8", "int8", quant_embed=True)


def test_decode_kernel_is_gated_off_for_multiquery():
    """A cache narrower than the query (kv_heads != heads) takes the dense
    decode path even where `decode_kernel` asks for the kernel."""
    from otter_tpu_torch.ops import decode_attention as da
    for case, want in (("falcon", 0), ("llama", 2)):
        cfg, _, _, tmodel = decoder_pair(case)
        cache = init_cache(tmodel.cfg, 1, 128, torch.int8, "cpu")
        ids = torch.arange(1, 7)[None]
        calls = _Counting(da, "decode_attention")
        with torch.no_grad(), calls:
            _, cache = tmodel(ids, cache=cache)
            kv_valid = torch.zeros((1, 128), dtype=torch.bool)
            kv_valid[:, :7] = True
            tmodel(ids[:, :1], cache=cache, cache_pos=6, kv_valid=kv_valid,
                   positions=torch.full((1, 1), 6))
        assert calls.n == want, case


def test_rotary_tables_are_not_buffers():
    _, _, _, tmodel = decoder_pair("llama")
    names = [n for n, _ in tmodel.named_buffers()]
    assert not any("cos" in n or "sin" in n or "rot" in n for n in names)


# prefix_lm and attn_uses_sequence_id were refused until the masks were
# ported: the decoder now builds with them, and a prefix-LM forward asks
# for its mask as the reference does (their parity: test_torch_masks.py)
PORTED_SINCE_REFUSED = ("prefix_lm", "attn_uses_sequence_id")


@pytest.mark.parametrize("field,value", [
    ("lora_rank", 4), ("prefix_lm", True), ("attn_uses_sequence_id", True),
    ("quant", "fp8")])
def test_decoder_refuses_what_is_not_ported(field, value):
    cfg = tcfg.OtterConfig.tiny("mpt").text.replace(**{field: value})
    if field in PORTED_SINCE_REFUSED:
        model = Decoder(cfg, device="cpu")
        assert getattr(model.cfg, field) is True
        if field == "prefix_lm":
            with pytest.raises(ValueError, match="prefix_mask"):
                model(torch.zeros((1, 4), dtype=torch.long))
        return
    with pytest.raises(NotImplementedError, match=field):
        Decoder(cfg, device="cpu")


def test_decoder_refuses_multi_token_cached_steps():
    """Cached steps of several tokens were refused until the block-causal
    bias was ported: a 2-token step now gives a full forward's logits at
    those positions (their parity with JAX: test_torch_masks.py)."""
    _, _, _, tmodel = decoder_pair("llama")
    ids = torch.arange(1, 7, dtype=torch.long)[None] * 11
    cache = init_cache(tmodel.cfg, 1, 128, torch.float32, "cpu")
    with torch.no_grad():
        tmodel(ids[:, :4], cache=cache)
        out, _ = tmodel(ids[:, 4:], cache=cache, cache_pos=4,
                        kv_valid=torch.arange(128)[None] < 6,
                        positions=torch.tensor([[4, 5]]))
        full, _ = tmodel(ids)
    _close(out, full[:, 4:], tol=1e-4)


def test_quant_embed_requires_untied_head():
    cfg = tcfg.OtterConfig.tiny("mpt").text.replace(quant_embed=True)
    with pytest.raises(ValueError, match="untied"):
        Decoder(cfg, device="cpu")
