"""Port parity: FuyuVLM (image patches projected into the token stream of a
Persimmon decoder) and its generation loop against the JAX package, tiny
size, f32 on the CPU, same weights through `load_flax_params`. Tolerance:
logits within 1e-3 max-abs (the BASELINE.md logit-parity bar); greedy tokens
equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.generation import sampling as jsampling
from otter_tpu.models.decoder import init_cache as jinit_cache
from otter_tpu_torch.config import GenerationConfig
from otter_tpu_torch.generation.fuyu import fuyu_cache_len, fuyu_generate
from otter_tpu_torch.models.convert import export_flax_params
from otter_tpu_torch.tools.random_weights import fuyu_request
from torch_parity_helpers import fuyu_pair

LOGIT_TOL = 1e-3


def _request(cfg, left_pad=2, prompt=5, seed=0):
    """A 12x8-pixel image (3 x 2 patches of 4) and a prompt, left-padded."""
    return fuyu_request(cfg, 12, 8, prompt, seed, left_pad=left_pad)


def test_fuyu_request_is_laid_out_as_the_processor_lays_it_out():
    cfg, _, _, _ = fuyu_pair()
    ids, patches, idx, mask = _request(cfg)
    ph, nl = cfg.image_placeholder_id, cfg.image_newline_id
    assert ids[0, :11].tolist() == [0, 0, ph, ph, nl, ph, ph, nl, ph, ph, nl]
    assert idx[0].tolist() == [-1, -1, 0, 1, -1, 2, 3, -1, 4, 5, -1] + [-1] * 5
    assert mask[0].tolist() == [0, 0] + [1] * 14
    assert patches.shape == (1, 6, 48) and ids.shape == (1, 16)
    assert (ids[0, 11:] < min(ph, nl)).all()


@pytest.mark.parametrize("height,width", [(448, 448), (100, 70)])
def test_fuyu_request_matches_the_jax_processor(height, width):
    """The same token stream and patch indices as the JAX package's
    `FuyuProcessor.encode_sample` gives for an image of that size (448 x
    448: 15 x 15 patches of 30 and 15 newlines, 240 image tokens)."""
    from PIL import Image
    from otter_tpu.data.fuyu_processor import FuyuProcessor
    from otter_tpu_torch.config import FuyuConfig

    class Tok:
        bos_token_id = None

        def __call__(self, text, **kw):
            return {"input_ids": [int(t) for t in text.split()]}

    cfg = FuyuConfig()
    ids, patches, idx, mask = fuyu_request(cfg, height, width, 16, seed=1)
    text = " ".join(str(t) for t in ids[0, -16:])
    ref = FuyuProcessor(Tok()).encode_sample(
        text, Image.new("RGB", (width, height)))
    np.testing.assert_array_equal(ids[0], ref["input_ids"])
    np.testing.assert_array_equal(idx[0], ref["image_patches_indices"])
    assert patches.shape == (1,) + ref["image_patches"].shape
    assert mask.all()
    if height == 448:
        assert patches.shape[1] == 225 and ids.shape[1] == 240 + 16


@pytest.mark.parametrize("quant,quant_embed", [(None, False), ("int8", True)])
def test_fuyu_logits_match_jax(quant, quant_embed):
    cfg, jmodel, params, tmodel = fuyu_pair(quant, quant_embed)
    ids, patches, idx, mask = _request(cfg)
    positions = np.clip(np.cumsum(mask, -1) - 1, 0, None)
    ref, _ = jax.jit(jmodel.apply)(
        params, jnp.asarray(ids, jnp.int32),
        image_patches=jnp.asarray(patches),
        image_patches_indices=jnp.asarray(idx, jnp.int32),
        attention_mask=jnp.asarray(mask), positions=jnp.asarray(positions))
    with torch.no_grad():
        out, _ = tmodel(torch.from_numpy(ids),
                        image_patches=torch.from_numpy(patches),
                        image_patches_indices=torch.from_numpy(idx),
                        attention_mask=torch.from_numpy(mask),
                        positions=torch.from_numpy(positions))
        text_only, _ = tmodel(torch.from_numpy(ids),
                              attention_mask=torch.from_numpy(mask),
                              positions=torch.from_numpy(positions))
    assert out.shape == (1, 16, cfg.text.total_vocab)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    # the patches were merged: without them the logits move
    assert float((out - text_only).abs().max()) > 10 * LOGIT_TOL


def _jax_generate(cfg, jmodel, params, req, max_new, cache_dtype):
    """The greedy loop of the JAX package's Fuyu worker, from `model.apply`:
    prefill with positions from the mask and the logits of every position,
    then single-token steps with kv_valid and positions advanced."""
    ids, patches, idx, mask = req
    b, s = ids.shape
    cache_len = fuyu_cache_len(s, max_new)
    cache = jinit_cache(cfg.text, 1, cache_len, cache_dtype)
    positions = jnp.clip(jnp.cumsum(jnp.asarray(mask), -1) - 1, 0, None
                         ).astype(jnp.int32)
    logits, cache = jax.jit(jmodel.apply)(
        params, jnp.asarray(ids, jnp.int32),
        image_patches=jnp.asarray(patches),
        image_patches_indices=jnp.asarray(idx, jnp.int32),
        attention_mask=jnp.asarray(mask), positions=positions, cache=cache)
    logits = logits[:, -1]
    step = jax.jit(lambda tok, cache, cpos, kv_valid, pos: jmodel.apply(
        params, tok, cache=cache, cache_pos=cpos, kv_valid=kv_valid,
        positions=pos))
    real_len = int(mask.sum())
    kv_valid = np.zeros((b, cache_len), bool)
    kv_valid[:, :s] = mask.astype(bool)
    out, rng = [], jax.random.PRNGKey(0)
    for t in range(max_new):
        tok = int(jsampling.sample_token(rng, logits, do_sample=False,
                                         temperature=1.0, top_k=0,
                                         top_p=1.0)[0])
        out.append(tok)
        if t == max_new - 1:
            break
        kv_valid[:, s + t] = True
        logits, cache = step(jnp.full((b, 1), tok, jnp.int32), cache, s + t,
                             jnp.asarray(kv_valid),
                             jnp.full((b, 1), real_len + t, jnp.int32))
        logits = logits[:, -1]
    return out


@pytest.mark.parametrize("quant,cache", [(None, "f32"), ("int8", "int8")])
def test_fuyu_generate_tokens_equal_the_jax_loop(quant, cache):
    """Greedy, one left-padded request with an image; with int8 weights the
    head of every step goes through `int8_matmul` on both sides, the MLPs
    through `int8_mlp` with biases and squared ReLU, over an int8 cache."""
    cfg, jmodel, params, tmodel = fuyu_pair(quant, quant == "int8")
    req = _request(cfg, seed=3)
    jdt, tdt = ((jnp.int8, torch.int8) if cache == "int8"
                else (jnp.float32, torch.float32))
    ref = _jax_generate(cfg, jmodel, params, req, 6, jdt)
    out = list(fuyu_generate(tmodel, *req,
                             gen=GenerationConfig(max_new_tokens=6),
                             cache_dtype=tdt))
    assert out == ref and len(out) == 6


def test_fuyu_generate_stops_at_eos_and_takes_no_image():
    cfg, _, _, tmodel = fuyu_pair()
    ids, _, _, mask = _request(cfg, seed=4)
    gen = GenerationConfig(max_new_tokens=5)
    free = list(fuyu_generate(tmodel, ids, None, None, mask, gen,
                              cache_dtype=torch.float32))
    assert len(free) == 5
    stop = free.index(free[2])   # its first occurrence ends the stream
    gen = GenerationConfig(max_new_tokens=5, eos_token_id=free[2])
    assert list(fuyu_generate(tmodel, ids, None, None, mask, gen,
                              cache_dtype=torch.float32)) == free[:stop]


@pytest.mark.parametrize("prompt,new,want", [(100, 28, 128), (100, 29, 256),
                                             (1000, 25, 1536), (2356, 32, 2560)])
def test_fuyu_cache_len_rounds_as_the_jax_worker(prompt, new, want):
    assert fuyu_cache_len(prompt, new) == want


def test_fuyu_params_round_trip_under_the_flax_names():
    cfg, _, params, tmodel = fuyu_pair("int8", True)
    from flax import traverse_util
    flat = traverse_util.flatten_dict(params["params"], sep="/")
    out = export_flax_params(tmodel)
    assert sorted(out) == sorted(flat)
    for key in ("language_model/wte_q", "language_model/lm_head/kernel_q",
                "language_model/layers_0/attn/q_ln/scale",
                "language_model/layers_1/ffn/up_proj/bias",
                "vision_embed_tokens/kernel"):
        np.testing.assert_array_equal(out[key], np.asarray(flat[key]))
