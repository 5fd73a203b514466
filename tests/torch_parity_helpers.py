"""Shared fixtures for the port's parity tests: one tiny JAX model with
int8 weights and its PyTorch twin built from the same parameters.

The JAX package is the reference. Parameters travel as numpy through
`otter_tpu_torch.models.convert.load_flax_params`, the port's only weight
bridge.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

from otter_tpu import config as jcfg
from otter_tpu.models.otter import OtterVLM as JaxOtterVLM
from otter_tpu.ops.quant import quantize_params as jax_quantize_params
from otter_tpu_torch import config as tcfg
from otter_tpu_torch.models.convert import load_flax_params
from otter_tpu_torch.models.otter import OtterVLM as TorchOtterVLM


def tiny_cfg(decode_kernel="auto"):
    cfg = jcfg.OtterConfig.tiny("mpt")
    return cfg.replace(text=cfg.text.replace(quant="int8",
                                             decode_kernel=decode_kernel))


def port_cfg(cfg):
    """The same configuration as the port's dataclasses (JSON round trip)."""
    return tcfg.OtterConfig.from_dict(cfg.to_dict())


@functools.lru_cache(maxsize=None)
def jax_tiny(seed: int = 0, decode_kernel="auto"):
    """(cfg, model, params, flat numpy params) of a tiny int8 OtterVLM. The
    tanh gates are set away from their zero init so the cross-attention
    blocks contribute to the output."""
    cfg = tiny_cfg(decode_kernel)
    model = JaxOtterVLM(cfg)
    vx = jnp.zeros((1, 1, 1, 3, 28, 28), jnp.float32)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax_quantize_params(
        jax.jit(model.init)(jax.random.PRNGKey(seed), vx, ids))
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    rng = np.random.default_rng(seed + 100)
    for k in flat:
        if k.endswith(("attn_gate", "ff_gate")):
            flat[k] = rng.uniform(0.3, 0.9, flat[k].shape).astype(np.float32)
    params = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    return cfg, model, params, flat


def torch_tiny(seed: int = 0, decode_kernel="auto"):
    cfg, _, _, flat = jax_tiny(seed, decode_kernel)
    model = TorchOtterVLM(port_cfg(cfg), dtype=torch.float32, device="cpu")
    load_flax_params(model, flat)
    return model


def inputs(cfg, seed: int, batch: int, seq: int, images: int = 1):
    """Pixels [B, T, 1, 3, H, W] f32 and token ids [B, S] whose first
    token is the media token (numpy, from a seeded generator)."""
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    vision_x = rng.standard_normal(
        (batch, images, 1, 3, size, size)).astype(np.float32)
    ids = rng.integers(0, cfg.text.vocab_size - 8, (batch, seq)).astype(
        np.int32)
    ids[:, 0] = cfg.media_token_id
    return vision_x, ids


@functools.lru_cache(maxsize=None)
def jax_tiny_train(seed: int = 0):
    """(cfg, model, params, flat numpy params) of the tiny f32 OtterVLM as
    the trainer sees it: no quantization, params without the "params"
    level, tanh gates set away from their zero init."""
    cfg = jcfg.OtterConfig.tiny("mpt")
    model = JaxOtterVLM(cfg)
    vx = jnp.zeros((1, 1, 1, 3, 28, 28), jnp.float32)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), vx, ids)["params"]
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    rng = np.random.default_rng(seed + 200)
    for k in flat:
        if k.endswith(("attn_gate", "ff_gate")):
            flat[k] = rng.uniform(0.3, 0.9, flat[k].shape).astype(np.float32)
    params = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    return cfg, model, params, flat


def torch_tiny_train(seed: int = 0, remat: bool = False):
    cfg, _, _, flat = jax_tiny_train(seed)
    model = TorchOtterVLM(port_cfg(cfg), dtype=torch.float32, device="cpu",
                          remat=remat)
    load_flax_params(model, flat)
    return model


def train_batch(cfg, seed: int, batch: int = 2, seq: int = 24):
    """A train-step batch (numpy): one image per sample, the media
    token at position 1, an <answer> span labelled up to <|endofchunk|>,
    and right padding on the last row."""
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    vision_x = rng.standard_normal(
        (batch, 1, 1, 3, size, size)).astype(np.float32)
    ids = rng.integers(5, 200, (batch, seq)).astype(np.int32)
    ids[:, 1] = cfg.media_token_id
    ids[:, 8] = cfg.answer_token_id
    ids[:, 18] = cfg.eoc_token_id
    mask = np.ones((batch, seq), np.int32)
    mask[-1, seq - 4:] = 0
    ids[-1, seq - 4:] = 0
    labels = np.full((batch, seq), -100, np.int32)
    labels[:, 9:19] = ids[:, 9:19]
    return {"vision_x": vision_x, "input_ids": ids, "attention_mask": mask,
            "labels": labels}
