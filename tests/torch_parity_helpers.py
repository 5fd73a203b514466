"""Shared fixtures for the port's parity tests: one tiny JAX model with
int8 weights (another with int4 weights, another unquantized as the
trainer sees it, others with a fused decode route on) and its PyTorch twin
built from the same parameters.

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
from otter_tpu.models.decoder import Decoder as JaxDecoder
from otter_tpu.models.fuyu import FuyuVLM as JaxFuyuVLM
from otter_tpu.models.otter import OtterVLM as JaxOtterVLM
from otter_tpu.ops.quant import quantize_embed as jax_quantize_embed
from otter_tpu.ops.quant import add_fused_wqo as jax_add_fused_wqo
from otter_tpu.ops.quant import quantize_params as jax_quantize_params
from otter_tpu.ops.quant import quantize_params_int4 as jax_quantize_int4
from otter_tpu_torch import config as tcfg
from otter_tpu_torch.models.convert import load_flax_params
from otter_tpu_torch.models.decoder import Decoder as TorchDecoder
from otter_tpu_torch.models.fuyu import FuyuVLM as TorchFuyuVLM
from otter_tpu_torch.models.otter import OtterVLM as TorchOtterVLM


def tiny_cfg(decode_kernel="auto"):
    cfg = jcfg.OtterConfig.tiny("mpt")
    return cfg.replace(text=cfg.text.replace(quant="int8",
                                             decode_kernel=decode_kernel))


def port_cfg(cfg):
    """The same configuration as the port's dataclasses (JSON round trip)."""
    return tcfg.OtterConfig.from_dict(cfg.to_dict())


def _quantized_tiny(quant, decode_kernel, seed, gate_seed, quantize):
    """(cfg, model, params, flat numpy params) of a tiny OtterVLM with
    `quant` weights: the unquantized model's random weights, the tanh gates
    set away from their zero init so the cross-attention blocks contribute
    to the output, through the JAX package's `quantize`. (A model
    initialised with `quant` already set would hold all-zero `kernel_q`
    leaves.)"""
    base = jcfg.OtterConfig.tiny("mpt")
    cfg = base.replace(text=base.text.replace(quant=quant,
                                              decode_kernel=decode_kernel))
    vx = jnp.zeros((1, 1, 1, 3, 28, 28), jnp.float32)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.jit(JaxOtterVLM(base).init)(jax.random.PRNGKey(seed), vx,
                                             ids)
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    rng = np.random.default_rng(gate_seed)
    for k in flat:
        if k.endswith(("attn_gate", "ff_gate")):
            flat[k] = rng.uniform(0.3, 0.9, flat[k].shape).astype(np.float32)
    params = quantize(traverse_util.unflatten_dict(flat, sep="/"))
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    return cfg, JaxOtterVLM(cfg), params, flat


@functools.lru_cache(maxsize=None)
def jax_tiny(seed: int = 0, decode_kernel="auto"):
    """(cfg, model, params, flat numpy params) of a tiny OtterVLM with
    non-zero int8 weights (`quantize_params` of the unquantized init)."""
    return _quantized_tiny("int8", decode_kernel, seed, seed + 100,
                           jax_quantize_params)


def torch_tiny(seed: int = 0, decode_kernel="auto"):
    cfg, _, _, flat = jax_tiny(seed, decode_kernel)
    model = TorchOtterVLM(port_cfg(cfg), dtype=torch.float32, device="cpu")
    load_flax_params(model, flat)
    return model


@functools.lru_cache(maxsize=None)
def jax_tiny_fused(route: str, seed: int = 0):
    """The tiny int8 OtterVLM (`decode_kernel=False`) with one of the fused
    decode routes switched on: `route` is "megakernel" (the parameters gain
    the JAX package's `add_fused_wqo` leaves) or "fused_tail"."""
    cfg, _, params, flat = jax_tiny(seed, False)
    cfg = cfg.replace(text=cfg.text.replace(**{route: True}))
    if route == "megakernel":
        params = jax_add_fused_wqo(params)
        flat = {k: np.asarray(v) for k, v in
                traverse_util.flatten_dict(params, sep="/").items()}
    return cfg, JaxOtterVLM(cfg), params, flat


def torch_tiny_fused(route: str, seed: int = 0):
    cfg, _, _, flat = jax_tiny_fused(route, seed)
    model = TorchOtterVLM(port_cfg(cfg), dtype=torch.float32, device="cpu")
    load_flax_params(model, flat)
    return model


@functools.lru_cache(maxsize=None)
def jax_tiny_int4(seed: int = 0, decode_kernel="auto"):
    """The same with `quant="int4"`, through `quantize_params_int4`."""
    return _quantized_tiny("int4", decode_kernel, seed, seed + 300,
                           jax_quantize_int4)


def torch_tiny_int4(seed: int = 0, decode_kernel="auto"):
    cfg, _, _, flat = jax_tiny_int4(seed, decode_kernel)
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


# ── the decoder's other archs, the llama VLM and Fuyu ────────────────

def _small_text(**kw):
    base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128, max_seq_len=128,
                tie_embeddings=False, no_bias=True)
    base.update(kw)
    return jcfg.TextConfig(**base)


_LLAMA = dict(arch="llama", pos="rope", norm_type="rmsnorm", act="silu_glu")
_MPT = dict(pos="alibi", norm_type="low_precision_layernorm", act="gelu",
            tie_embeddings=True)
ARCH_CASES = {
    "llama": lambda: _small_text(**_LLAMA),
    "llama_qk_ln": lambda: _small_text(qk_ln=True, **_LLAMA),
    "persimmon": lambda: jcfg.FuyuConfig.tiny().text,
    "falcon": lambda: _small_text(
        arch="falcon", num_kv_heads=1, intermediate_size=256, pos="rope",
        norm_type="low_precision_layernorm", act="gelu"),
    "mosaic_gpt_qk_ln": lambda: _small_text(arch="mosaic_gpt", qk_ln=True,
                                            **_MPT),
    "mpt_mqa": lambda: _small_text(arch="mpt", num_kv_heads=1, qk_ln=True,
                                   clip_qkv=1.5, **_MPT),
    "mpt_learned": lambda: _small_text(
        arch="mpt", logit_scale=0.5, **{**_MPT, "pos": "learned"}),
}


def _randomize_norms_and_biases(flat, seed):
    """flax initialises biases to 0 and norm scales to 1: move both, so a
    dropped bias or scale shows."""
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith("/bias"):
            flat[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith("/scale"):
            flat[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)


def _quantized(model_for, base_cfg, cfg, init_args, seed, quant, quant_embed):
    """(JAX params, flat numpy params) of `model_for(cfg)` from the random
    unquantized weights of `model_for(base_cfg)`, through the JAX package's
    load transforms."""
    params = jax.jit(model_for(base_cfg).init)(jax.random.PRNGKey(seed),
                                               *init_args)
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    _randomize_norms_and_biases(flat, seed + 400)
    for k in flat:
        if k.endswith(("attn_gate", "ff_gate")):
            flat[k] = np.full(flat[k].shape, 0.6, np.float32)
    params = traverse_util.unflatten_dict(flat, sep="/")
    if quant == "int8":
        params = jax_quantize_params(params)
    elif quant == "int4":
        params = jax_quantize_int4(params)
    if quant_embed:
        params = jax_quantize_embed(params)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    return params, flat


@functools.lru_cache(maxsize=None)
def decoder_pair(case: str, quant=None, quant_embed: bool = False,
                 decode_kernel="auto", seed: int = 0):
    """(text cfg, JAX Decoder, its params, the port's Decoder with the same
    weights in f32 on the CPU) for one of ARCH_CASES."""
    return text_decoder_pair(ARCH_CASES[case](), quant, quant_embed,
                             decode_kernel, seed)


def text_decoder_pair(base, quant=None, quant_embed: bool = False,
                      decode_kernel="auto", seed: int = 0, **overrides):
    """`decoder_pair` for any JAX TextConfig `base`; `overrides` change the
    pair's config but not the one initialised (e.g. `prefix_lm`, whose
    forward asks for a mask that `init` does not pass)."""
    cfg = base.replace(quant=quant, quant_embed=quant_embed,
                       decode_kernel=decode_kernel, **overrides)
    params, flat = _quantized(JaxDecoder, base, cfg,
                              (jnp.zeros((1, 8), jnp.int32),), seed, quant,
                              quant_embed)
    tmodel = TorchDecoder(tcfg.TextConfig.from_dict(cfg.to_dict()),
                          dtype=torch.float32, device="cpu")
    load_flax_params(tmodel, flat)
    return cfg, JaxDecoder(cfg), params, tmodel.eval()


@functools.lru_cache(maxsize=None)
def llama_vlm_pair(seed: int = 0):
    """(cfg, JAX OtterVLM, params, port OtterVLM) of the tiny llama model
    with int8 weights and `decode_kernel="auto"`."""
    base = jcfg.OtterConfig.tiny("llama")
    cfg = base.replace(text=base.text.replace(quant="int8",
                                              decode_kernel="auto"))
    init_args = (jnp.zeros((1, 1, 1, 3, 28, 28), jnp.float32),
                 jnp.zeros((1, 8), jnp.int32))
    params, flat = _quantized(JaxOtterVLM, base, cfg, init_args, seed, "int8",
                              False)
    tmodel = TorchOtterVLM(port_cfg(cfg), dtype=torch.float32, device="cpu")
    load_flax_params(tmodel, flat)
    return cfg, JaxOtterVLM(cfg), params, tmodel.eval()


@functools.lru_cache(maxsize=None)
def fuyu_pair(quant=None, quant_embed: bool = False, seed: int = 0):
    """(cfg, JAX FuyuVLM, params, port FuyuVLM) of the tiny Fuyu model."""
    base = jcfg.FuyuConfig.tiny()
    cfg = base.replace(text=base.text.replace(
        quant=quant, quant_embed=quant_embed, decode_kernel="auto"))
    pd = base.patch_size ** 2 * base.num_channels
    init_args = (jnp.zeros((1, 8), jnp.int32),)
    init_kw = dict(image_patches=jnp.zeros((1, 2, pd), jnp.float32),
                   image_patches_indices=jnp.zeros((1, 8), jnp.int32))
    model_for = lambda c: _WithKwargs(JaxFuyuVLM(c), init_kw)
    params, flat = _quantized(model_for, base, cfg, init_args, seed, quant,
                              quant_embed)
    tmodel = TorchFuyuVLM(tcfg.FuyuConfig.from_dict(cfg.to_dict()),
                          dtype=torch.float32, device="cpu")
    load_flax_params(tmodel, flat)
    return cfg, JaxFuyuVLM(cfg), params, tmodel.eval()


class _WithKwargs:
    """A flax module whose `init` also gets fixed keyword arguments."""

    def __init__(self, module, kw):
        self.module, self.kw = module, kw

    def init(self, rng, *args):
        return self.module.init(rng, *args, **self.kw)


def ragged(rng, vocab: int, batch: int = 2, seq: int = 10, pad: int = 3):
    """Token ids [B, S], a left-padded mask (row 0 starts with `pad`
    padding tokens) and the positions that count real tokens only."""
    ids = rng.integers(1, vocab - 8, (batch, seq)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, :pad] = 0
    positions = np.clip(np.cumsum(mask, -1) - 1, 0, None).astype(np.int32)
    return ids, mask, positions


# ── IDEFICS ──────────────────────────────────────────────────────────

def _idefics_init_args(cfg):
    size = cfg.vision.image_size
    return (jnp.zeros((1, 1, 3, size, size), jnp.float32),
            jnp.zeros((1, 8), jnp.int32))


@functools.lru_cache(maxsize=None)
def idefics_flat(seed: int = 0):
    """{flax path: numpy} of the tiny JAX IdeficsVLM's unquantized f32
    weights: the flax init with its norms and biases moved
    (`_randomize_norms_and_biases`) and its `alpha_cross_attn` /
    `alpha_dense` gates (0 at init) set away from zero, so that the
    cross-attention reaches the logits."""
    from otter_tpu.models.idefics import IdeficsVLM as JaxIdeficsVLM
    base = jcfg.idefics_tiny()
    params = jax.jit(JaxIdeficsVLM(base).init)(jax.random.PRNGKey(seed),
                                                *_idefics_init_args(base))
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    _randomize_norms_and_biases(flat, seed + 500)
    rng = np.random.default_rng(seed + 600)
    for k in flat:
        if k.endswith(("alpha_cross_attn", "alpha_dense")):
            flat[k] = rng.uniform(0.3, 0.9, flat[k].shape).astype(np.float32)
    return flat


def idefics_port_cfg(cfg):
    return tcfg.IdeficsModelConfig.from_dict(cfg.to_dict())


@functools.lru_cache(maxsize=None)
def idefics_pair(quant=None, decode_kernel="auto", seed: int = 0):
    """(cfg, JAX IdeficsVLM, its params, port IdeficsVLM with the same
    weights in f32 on the CPU) of the tiny idefics model; `quant="int8"`
    quantizes the decoder layers through the JAX package's
    `quantize_params(..., patterns=FROZEN_DECODER_PATTERNS)`."""
    from otter_tpu.models.idefics import IdeficsVLM as JaxIdeficsVLM
    from otter_tpu.ops.quant import FROZEN_DECODER_PATTERNS
    from otter_tpu_torch.models.idefics import IdeficsVLM
    base = jcfg.idefics_tiny()
    cfg = base.replace(text=base.text.replace(quant=quant,
                                              decode_kernel=decode_kernel))
    params = traverse_util.unflatten_dict(dict(idefics_flat(seed)), sep="/")
    if quant is not None:
        params = jax_quantize_params(params,
                                     patterns=FROZEN_DECODER_PATTERNS)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    tmodel = IdeficsVLM(idefics_port_cfg(cfg), dtype=torch.float32,
                        device="cpu")
    load_flax_params(tmodel, flat)
    return cfg, JaxIdeficsVLM(cfg), params, tmodel.eval()


def idefics_inputs(cfg, seed: int, batch: int = 2, seq: int = 14,
                   images: int = 2):
    """Pixels [B, N, 3, H, W] f32 and token ids [B, S] (numpy): the image
    token at positions 1 and 7 (as many as `images`), an eos at 4 on row
    0 (tokens 5-6 attend no image), a token of the additional vocab at 10
    on the last row, ordinary tokens elsewhere."""
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    vision_x = rng.standard_normal(
        (batch, images, 3, size, size)).astype(np.float32)
    ids = rng.integers(3, cfg.text.vocab_size, (batch, seq)).astype(np.int32)
    for i, p in enumerate((1, 7)[:images]):
        ids[:, p] = cfg.media_token_id
    ids[0, 4] = cfg.eos_token_id
    ids[-1, 10] = cfg.text.vocab_size + 3
    return vision_x, ids


# ── speculative pairs: a target and a draft of one vocabulary ────────

def _vlm(cfg, seed: int):
    """(cfg, JAX OtterVLM, params, port OtterVLM) of `cfg`, unquantized, in
    f32: the flax init with its norms moved and its gates at 0.6."""
    init_args = (jnp.zeros((1, 1, 1, 3, 28, 28), jnp.float32),
                 jnp.zeros((1, 8), jnp.int32))
    params, flat = _quantized(JaxOtterVLM, cfg, cfg, init_args, seed, None,
                              False)
    tmodel = TorchOtterVLM(port_cfg(cfg), dtype=torch.float32, device="cpu")
    load_flax_params(tmodel, flat)
    return cfg, JaxOtterVLM(cfg), params, tmodel.eval()


@functools.lru_cache(maxsize=None)
def spec_pair(arch: str = "mpt", seed: int = 0):
    """(target, draft), each (cfg, JAX OtterVLM, params, port OtterVLM):
    the tiny `arch` ("mpt" or "llama") OtterVLM, and a 2-layer draft of the
    same vocabulary with a cross-attention block before every layer (for
    "mpt" a mosaic_gpt decoder with qk_ln, as Flamingo-MPT-1B)."""
    base = jcfg.OtterConfig.tiny(arch)
    text = base.text.replace(num_hidden_layers=2)
    if arch == "mpt":
        text = text.replace(arch="mosaic_gpt", qk_ln=True)
    draft = base.replace(text=text, cross_attn_every_n_layers=1)
    return _vlm(base, seed), _vlm(draft, seed + 7)
