"""Port parity: each module of the serving path (CLIP, perceiver, gated
cross-attention, MPT decoder) against the JAX module built from the same
parameters, in f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.models.clip import CLIPVisionModel
from otter_tpu.models.decoder import Decoder
from otter_tpu.models.perceiver import PerceiverResampler
from otter_tpu.models.xattn import GatedCrossAttentionBlock
from otter_tpu.ops.masks import media_attention_ids
from otter_tpu_torch.ops import masks as tmasks
from torch_parity_helpers import inputs, jax_tiny, torch_tiny

MODULE_TOL = 1e-4


def _close(out, ref, tol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module")
def pair():
    cfg, jmodel, params, _ = jax_tiny()
    return cfg, params["params"], torch_tiny()


def test_clip_matches_jax(pair):
    cfg, p, tmodel = pair
    rng = np.random.default_rng(10)
    pix = rng.standard_normal((3, 3, 28, 28)).astype(np.float32)
    ref = jax.jit(CLIPVisionModel(cfg.vision).apply)(
        {"params": p["vision_encoder"]}, jnp.asarray(pix))
    with torch.no_grad():
        out = tmodel.vision_encoder(torch.from_numpy(pix))
    _close(out, ref, MODULE_TOL)


def test_perceiver_matches_jax(pair):
    cfg, p, tmodel = pair
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((2, 1, 2, 4, 64)).astype(np.float32)
    ref = jax.jit(PerceiverResampler(cfg.perceiver).apply)(
        {"params": p["perceiver"]}, jnp.asarray(feats))
    with torch.no_grad():
        out = tmodel.perceiver(torch.from_numpy(feats))
    _close(out, ref, MODULE_TOL)


@pytest.mark.parametrize("seq", [7, 20])   # 14 tokens: int8_mlp; 40: Int8Dense
def test_xattn_block_matches_jax(pair, seq):
    cfg, p, tmodel = pair
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, seq, 64)).astype(np.float32)
    media = rng.standard_normal((2, 2, 8, 64)).astype(np.float32)
    loc = np.zeros((2, seq), bool)
    loc[0, [1, 4]] = True
    loc[1, 0] = True
    ids = media_attention_ids(jnp.asarray(loc), 2, 8)
    block = GatedCrossAttentionBlock(
        dim=64, dim_visual=64, dim_head=cfg.xattn_dim_head,
        heads=cfg.xattn_heads, ff_mult=cfg.xattn_ff_mult, quant="int8")
    ref = jax.jit(block.apply)({"params": p["lang_encoder"]["xattn_1"]},
                               jnp.asarray(x), jnp.asarray(media), *ids)
    tids = tmasks.media_attention_ids(torch.from_numpy(loc), 2, 8)
    with torch.no_grad():
        out = tmodel.lang_encoder.xattn_1(torch.from_numpy(x),
                                          torch.from_numpy(media), *tids)
    _close(out, ref, MODULE_TOL)


@pytest.mark.parametrize("padded", [False, True])
def test_decoder_matches_jax(pair, padded):
    cfg, p, tmodel = pair
    _, ids = inputs(cfg, 13, 2, 16)
    mask = np.ones_like(ids)
    if padded:
        mask[1, :5] = 0
    rng = np.random.default_rng(14)
    lat = rng.standard_normal((2, 1, 8, 64)).astype(np.float32)
    q_ids, kv_ids, keep = media_attention_ids(
        jnp.asarray(ids == cfg.media_token_id), 1, 8)
    ref, _ = jax.jit(Decoder(cfg.text, otter_cfg=cfg).apply)(
        {"params": p["lang_encoder"]}, jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), vis_latents=jnp.asarray(lat),
        xattn_q_ids=q_ids, xattn_kv_ids=kv_ids, xattn_out_keep=keep)
    with torch.no_grad():
        out, _ = tmodel.lang_encoder(
            torch.from_numpy(ids).long(),
            attention_mask=torch.from_numpy(mask),
            vis_latents=torch.from_numpy(lat),
            xattn_q_ids=torch.from_numpy(np.array(q_ids)),
            xattn_kv_ids=torch.from_numpy(np.array(kv_ids)),
            xattn_out_keep=torch.from_numpy(np.array(keep)))
    _close(out, ref, MODULE_TOL)
