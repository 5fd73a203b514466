"""Port parity: the mask functions, the decoder's prefix-LM and
sequence-id masks, `output_hidden`, and cached steps of several tokens,
against the JAX package on the CPU in f32.

Tolerances: the mask functions are exact (booleans, ids, and biases built
from the same constants); logits and hidden states within 1e-4 max-abs in
f32 (the same weights and the same math; what is left is the order of
sums). A cached step of several tokens must also give a full forward's
logits at those positions, within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.models.decoder import init_cache as jinit_cache
from otter_tpu.ops import masks as jmasks
from otter_tpu_torch.models.decoder import init_cache
from otter_tpu_torch.ops import masks as tmasks
from torch_parity_helpers import (_LLAMA, _MPT, _small_text, decoder_pair,
                                  text_decoder_pair)

TOL = 1e-4


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=tol,
                               rtol=0)


def _t(x, dtype=torch.long):
    return torch.from_numpy(np.asarray(x)).to(dtype)


# ── the mask functions ───────────────────────────────────────────────

@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("heads", [4, 6])
def test_alibi_bias_matches_jax(full, heads):
    ref = jmasks.alibi_bias(heads, 9, full=full, alibi_bias_max=8.0)
    out = tmasks.alibi_bias(heads, 9, full=full, alibi_bias_max=8.0)
    assert out.shape == ref.shape == (1, heads, 9 if full else 1, 9)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_padding_mask_bias_and_mask_to_bias_match_jax():
    rng = np.random.default_rng(3)
    mask = rng.integers(0, 2, (3, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        tmasks.padding_mask_bias(_t(mask, torch.int32)).numpy(),
        np.asarray(jmasks.padding_mask_bias(jnp.asarray(mask))))
    keep = rng.integers(0, 2, (2, 1, 5, 6)).astype(bool)
    np.testing.assert_array_equal(
        tmasks.mask_to_bias(_t(keep, torch.bool)).numpy(),
        np.asarray(jmasks.mask_to_bias(jnp.asarray(keep))))


@pytest.mark.parametrize("immediate", [True, False])
@pytest.mark.parametrize("previous", [True, False])
def test_media_cross_attention_mask_matches_jax(immediate, previous):
    rng = np.random.default_rng(4)
    loc = rng.random((3, 11)) < 0.25
    loc[0, 0] = True
    kw = dict(only_attend_immediate_media=immediate,
              attend_previous=previous)
    ref = jmasks.media_cross_attention_mask(jnp.asarray(loc), 4, **kw)
    out = tmasks.media_cross_attention_mask(_t(loc, torch.bool), 4, **kw)
    for a, r in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    np.testing.assert_array_equal(
        tmasks.expand_media_mask_to_latents(out[0], 3).numpy(),
        np.asarray(jmasks.expand_media_mask_to_latents(ref[0], 3)))


# ── prefix-LM and sequence-id masks ──────────────────────────────────

MASK_ARCHS = {"mpt": _MPT, "llama": _LLAMA}


def _mask_pair(arch, **flags):
    return text_decoder_pair(_small_text(**MASK_ARCHS[arch]), **flags)


def _mask_inputs(b=2, s=12):
    rng = np.random.default_rng(41)
    ids = rng.integers(1, 200, (b, s)).astype(np.int32)
    prefix = np.zeros((b, s), bool)
    prefix[0, :5] = True
    prefix[1, :8] = True
    seq_id = np.repeat(np.array([[0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2]]),
                       b, 0)[:, :s].astype(np.int32)
    seq_id[1] = np.minimum(seq_id[1], 1)
    mask = np.ones((b, s), np.int32)
    mask[1, s - 3:] = 0            # right padding on row 1
    return ids, prefix, seq_id, mask


@pytest.mark.parametrize("arch", sorted(MASK_ARCHS))
@pytest.mark.parametrize("which", ["prefix", "sequence_id", "both"])
def test_prefix_lm_and_sequence_id_match_jax(arch, which):
    """Prefix-LM alone rides the kernel's "ge" ids (not causal, symmetric
    ALiBi on MPT), sequence ids the "eq" ids, both a materialised bias;
    each with right padding on one row."""
    flags = {"prefix": dict(prefix_lm=True),
             "sequence_id": dict(attn_uses_sequence_id=True),
             "both": dict(prefix_lm=True, attn_uses_sequence_id=True)}[which]
    cfg, jmodel, params, tmodel = _mask_pair(arch, **flags)
    ids, prefix, seq_id, mask = _mask_inputs()
    kw_j = dict(attention_mask=jnp.asarray(mask))
    kw_t = dict(attention_mask=_t(mask, torch.int32))
    if "prefix_lm" in flags:
        kw_j["prefix_mask"] = jnp.asarray(prefix)
        kw_t["prefix_mask"] = _t(prefix, torch.bool)
    if "attn_uses_sequence_id" in flags:
        kw_j["sequence_id"] = jnp.asarray(seq_id)
        kw_t["sequence_id"] = _t(seq_id, torch.int32)
    ref, _ = jax.jit(jmodel.apply)(params, jnp.asarray(ids), **kw_j)
    with torch.no_grad():
        out, _ = tmodel(_t(ids), **kw_t)
    keep = mask.astype(bool)     # padded queries' rows are not compared
    _close(out.numpy()[keep], np.asarray(ref)[keep])
    # and the masks change the answer (against plain causal attention)
    if "prefix_lm" not in flags:
        with torch.no_grad():
            causal, _ = tmodel(_t(ids), attention_mask=kw_t["attention_mask"])
        assert np.abs(causal.numpy()[keep] - np.asarray(ref)[keep]).max() \
            > 10 * TOL


def test_prefix_lm_requires_prefix_mask():
    _, _, _, tmodel = _mask_pair("mpt", prefix_lm=True)
    ids = _t(_mask_inputs()[0])
    with pytest.raises(ValueError, match="prefix_mask"):
        tmodel(ids)


def test_lora_is_still_refused():
    from otter_tpu_torch import config as tcfg
    from otter_tpu_torch.models.decoder import Decoder
    with pytest.raises(NotImplementedError, match="lora_rank"):
        Decoder(tcfg.TextConfig(hidden_size=64, num_hidden_layers=1,
                                num_attention_heads=4, vocab_size=64,
                                lora_rank=4), device="cpu")


# ── output_hidden ────────────────────────────────────────────────────

@pytest.mark.parametrize("last_only", [False, True])
def test_output_hidden_matches_jax(last_only):
    cfg, jmodel, params, tmodel = decoder_pair("llama")
    ids = np.random.default_rng(5).integers(1, 200, (2, 9)).astype(np.int32)
    ref = jmodel.apply(params, jnp.asarray(ids), output_hidden=True,
                       head_last_only=last_only)
    with torch.no_grad():
        out = tmodel(_t(ids), output_hidden=True, head_last_only=last_only)
    assert len(out) == len(ref) == 3
    assert out[2].shape == ref[2].shape == (2, 1 if last_only else 9,
                                            cfg.hidden_size)
    _close(out[0], ref[0])
    _close(out[2], ref[2])


# ── cached steps of several tokens ───────────────────────────────────

STEP_CASES = ["llama", "mosaic_gpt_qk_ln", "mpt_mqa"]


def _prefill(cfg, jmodel, params, tmodel, ids, mask, positions, L):
    b = ids.shape[0]
    jc = jinit_cache(cfg, b, L, jnp.float32)
    tc = init_cache(cfg, b, L, torch.float32, "cpu")
    _, jc = jax.jit(jmodel.apply)(params, jnp.asarray(ids), cache=jc,
                                  attention_mask=jnp.asarray(mask),
                                  positions=jnp.asarray(positions))
    with torch.no_grad():
        tmodel(_t(ids), cache=tc, attention_mask=_t(mask, torch.int32),
               positions=_t(positions))
    return jc, tc


@pytest.mark.parametrize("case", STEP_CASES)
def test_multi_token_step_scalar_pos_matches_jax_and_full_forward(case):
    """A left-padded prompt of 8, then one cached step of 3 tokens at
    cache_pos 8 (the block-causal bias inside the step)."""
    cfg, jmodel, params, tmodel = decoder_pair(case)
    rng = np.random.default_rng(51)
    b, p, s, L = 2, 8, 3, 128
    ids = rng.integers(1, 200, (b, p + s)).astype(np.int32)
    mask = np.ones((b, p + s), np.int32)
    mask[0, :3] = 0
    positions = np.clip(np.cumsum(mask, -1) - 1, 0, None).astype(np.int32)
    jc, tc = _prefill(cfg, jmodel, params, tmodel, ids[:, :p], mask[:, :p],
                      positions[:, :p], L)
    kv_valid = np.zeros((b, L), bool)
    kv_valid[:, :p + s] = mask.astype(bool)
    ref, _ = jmodel.apply(params, jnp.asarray(ids[:, p:]), cache=jc,
                          cache_pos=p, kv_valid=jnp.asarray(kv_valid),
                          positions=jnp.asarray(positions[:, p:]))
    with torch.no_grad():
        out, _ = tmodel(_t(ids[:, p:]), cache=tc, cache_pos=p,
                        kv_valid=_t(kv_valid, torch.bool),
                        positions=_t(positions[:, p:]))
        full, _ = tmodel(_t(ids), attention_mask=_t(mask, torch.int32),
                         positions=_t(positions))
    assert out.shape == (b, s, cfg.total_vocab)
    _close(out, ref)
    _close(out, full[:, p:])


@pytest.mark.parametrize("case", STEP_CASES)
def test_multi_token_step_per_row_pos_matches_jax_and_full_forward(case):
    """Per-row offsets [B]: row r's prompt of lens[r] tokens sits at
    0 .. lens[r] - 1 (right-padded in the prefill), and its 3-token step
    goes to lens[r] .. lens[r] + 2, over the padding."""
    cfg, jmodel, params, tmodel = decoder_pair(case)
    rng = np.random.default_rng(52)
    b, p, s, L = 2, 8, 3, 128
    lens = np.array([8, 5])
    ids = rng.integers(1, 200, (b, p)).astype(np.int32)
    mask = (np.arange(p)[None] < lens[:, None]).astype(np.int32)
    positions = np.broadcast_to(np.arange(p), (b, p)).astype(np.int32)
    jc, tc = _prefill(cfg, jmodel, params, tmodel, ids, mask, positions, L)
    new = rng.integers(1, 200, (b, s)).astype(np.int32)
    new_pos = (lens[:, None] + np.arange(s)[None]).astype(np.int32)
    kv_valid = np.arange(L)[None] < (lens + s)[:, None]
    ref, _ = jmodel.apply(params, jnp.asarray(new), cache=jc,
                          cache_pos=jnp.asarray(lens.astype(np.int32)),
                          kv_valid=jnp.asarray(kv_valid),
                          positions=jnp.asarray(new_pos))
    with torch.no_grad():
        out, _ = tmodel(_t(new), cache=tc, cache_pos=_t(lens),
                        kv_valid=_t(kv_valid, torch.bool),
                        positions=_t(new_pos))
    _close(out, ref)
    for r in range(b):
        row = np.concatenate([ids[r, :lens[r]], new[r]])[None]
        with torch.no_grad():
            full, _ = tmodel(_t(row))
        _close(out[r], full[0, lens[r]:])
