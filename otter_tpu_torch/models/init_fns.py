"""From-scratch parameter initialization zoo for the decoder backbones
(counterpart of `otter_tpu/models/init_fns.py`, the reference's
`param_init_fns.py` `MODEL_INIT_REGISTRY`, :357-366): the same eight
schemes, applied in place to the parameters of the port's `Decoder`.
Selection and knobs mirror MPTConfig's `init_config`
(`configuration_mpt.py:17-26`): name, init_std, init_gain, fan_mode,
init_nonlinearity, init_div_is_residual, emb_init_std,
emb_init_uniform_lim.

The rules, as the JAX module applies them:
  - Linear kernels get the scheme's base distribution; biases zero.
  - Residual-output projections (`attn/out_proj`, `ffn/down_proj`, which
    the reference tags `_is_residual`) are divided by sqrt(2 * n_layers)
    (True), a numeric override, or the neox n_layers / sqrt(10)
    (`param_init_fns.py:67-69, 212-219`).
  - The fused Wqkv is drawn per logical chunk (`fused_init_helper_`,
    :19-28), which matters for fan-dependent schemes.
  - Embeddings (wte / wpe) use emb_init_std / emb_init_uniform_lim when
    given, else the scheme's base init on the transposed shape (:71-95).
  - Norm scales are ones, norm biases zeros (:96-102).

Fans: the port's `Dense` keeps flax's [in, out] kernel layout (not
torch's [out, in]), so fan_in = shape[0] and fan_out = shape[-1], as in
the JAX module. Draws come from a `torch.Generator` in sorted path order,
so values are not `jax.random`'s; the distributions are the same.
Quantized tensors and LoRA adapters are not initialized here (the JAX
module raises on them too): initialize the float model, then quantize.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

_NORM_NAMES = re.compile(
    r"(^|/)(norm_1|norm_2|norm_f|q_ln|k_ln|ln_1|ln_2|ln_f)(/|$)")
# projections the reference tags `_is_residual`
_RESIDUAL_NAMES = re.compile(r"(^|/)(attn/out_proj|ffn/down_proj)/kernel$")
_EMBED_NAMES = re.compile(r"(^|/)(wte/embedding|wpe)$")
_WQKV = re.compile(r"(^|/)attn/Wqkv/kernel$")

INIT_REGISTRY = (
    "default_", "baseline_", "kaiming_uniform_", "kaiming_normal_",
    "neox_init_", "small_init_", "xavier_uniform_", "xavier_normal_")

Draw = Callable[[tuple], torch.Tensor]


def _gain(nonlinearity: str, a: float) -> float:
    """torch.nn.init.calculate_gain for the subsets the registry uses."""
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1.0 + a * a))
    if nonlinearity in ("linear", "sigmoid"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    raise ValueError(f"unsupported nonlinearity {nonlinearity!r}")


def _fan(shape, mode: str) -> float:
    fan_in, fan_out = shape[0], shape[-1]
    if mode == "fan_in":
        return fan_in
    if mode == "fan_out":
        return fan_out
    if mode == "fan_avg":
        return (fan_in + fan_out) / 2.0
    raise ValueError(f"unsupported fan_mode {mode!r}")


def _base_init(name: str, icfg: Dict[str, Any], d_model: int,
               normal: Draw, uniform) -> Draw:
    """draw(shape) for the scheme's base distribution."""
    gain = float(icfg.get("init_gain", 0.0))
    fan_mode = icfg.get("fan_mode", "fan_in")
    nonlin = icfg.get("init_nonlinearity", "leaky_relu")

    if name in ("baseline_", "small_init_", "neox_init_"):
        if name == "baseline_":
            std = icfg.get("init_std")
            if std is None:
                raise ValueError(
                    "init_config['init_std'] must be set for baseline_ "
                    "(reference param_init_fns.py:178-179)")
        else:
            std = math.sqrt(2.0 / (5.0 * d_model))
        return lambda shape: normal(shape) * std
    if name == "kaiming_normal_":
        return lambda shape: normal(shape) * (
            _gain(nonlin, gain) / math.sqrt(_fan(shape, fan_mode)))
    if name in ("kaiming_uniform_", "default_"):
        a = math.sqrt(5.0) if name == "default_" else gain
        act = "leaky_relu" if name == "default_" else nonlin
        return lambda shape: uniform(
            shape, _gain(act, a) * math.sqrt(3.0 / _fan(shape, fan_mode)))
    if name == "xavier_uniform_":
        return lambda shape: uniform(
            shape, gain * math.sqrt(6.0 / (shape[0] + shape[-1])))
    if name == "xavier_normal_":
        return lambda shape: normal(shape) * (
            gain * math.sqrt(2.0 / (shape[0] + shape[-1])))
    raise ValueError(
        f"unknown init scheme {name!r}; known: {sorted(INIT_REGISTRY)}")


def _qkv_chunks(cfg, out_dim: int):
    """Chunk boundaries of the fused Wqkv out axis (q | k | v)."""
    d, hk, hd = cfg.hidden_size, cfg.kv_heads, cfg.head_dim
    if out_dim == 3 * d:
        return [(0, d), (d, 2 * d), (2 * d, 3 * d)]
    # MQA/GQA fused layout [q (d) | k (hk*hd) | v (hk*hd)]
    if out_dim == d + 2 * hk * hd:
        return [(0, d), (d, d + hk * hd), (d + hk * hd, out_dim)]
    h = cfg.num_attention_heads
    if out_dim == (h + 2 * hk) * hd:          # falcon layout
        return [(0, h * hd), (h * hd, (h + hk) * hd),
                ((h + hk) * hd, out_dim)]
    return [(0, out_dim)]


def _residual_div(name: str, icfg: Dict[str, Any],
                  n_layers: int) -> Optional[float]:
    div = icfg.get("init_div_is_residual", True)
    if name == "default_":
        # torch_default_param_init_fn_ is plain reset_parameters(); it
        # ignores init_div_is_residual (param_init_fns.py:11-16)
        return None
    if name == "neox_init_":
        return n_layers / math.sqrt(10.0)
    if div is True:
        return math.sqrt(2.0 * n_layers)
    if div is False:
        return None
    return float(div)


@torch.no_grad()
def init_decoder_params(gen: torch.Generator, decoder: nn.Module, cfg,
                        init_config: Optional[Dict[str, Any]] = None
                        ) -> nn.Module:
    """Redraw every parameter of `decoder` (a `models.decoder.Decoder` of
    text config `cfg`, or an `OtterVLM`'s `lang_encoder`) in place by the
    scheme `init_config` (default `cfg.init_config`, else
    kaiming_normal_) selects, drawing from `gen` (on the decoder's
    device). Returns the decoder."""
    icfg = dict(init_config or cfg.init_config or {})
    name = icfg.get("name", "kaiming_normal_")
    div = _residual_div(name, icfg, cfg.num_hidden_layers)
    dev = gen.device

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def uniform(shape, bound, lo=None):
        lo = -bound if lo is None else lo
        return lo + (bound - lo) * torch.rand(shape, generator=gen,
                                              device=dev)

    draw = _base_init(name, icfg, cfg.hidden_size, normal, uniform)
    emb_std = icfg.get("emb_init_std")
    emb_lim = icfg.get("emb_init_uniform_lim")

    def emb_draw(shape):
        if emb_std is not None:
            return normal(shape) * emb_std
        if emb_lim is not None:
            lo, hi = ((-emb_lim, emb_lim)
                      if not isinstance(emb_lim, (tuple, list))
                      else (emb_lim[0], emb_lim[-1]))
            return uniform(shape, hi, lo)
        if name == "default_":
            # torch nn.Embedding.reset_parameters: normal(0, 1)
            return normal(shape)
        # embeddings keep torch's [V, D] layout, so fan-dependent schemes
        # see torch's fans: draw on the reversed shape, transpose back
        return draw(tuple(shape[::-1])).t()

    flat = {n.replace(".", "/"): t for n, t in decoder.named_parameters()}
    for n, t in decoder.named_buffers():
        flat[n.replace(".", "/")] = t
    for path, leaf in sorted(flat.items()):
        shape = tuple(leaf.shape)
        if _EMBED_NAMES.search(path):
            val = emb_draw(shape)
        elif _NORM_NAMES.search(path):
            val = (torch.zeros(shape) if path.endswith("/bias")
                   else torch.ones(shape))
        elif path.endswith("/bias"):
            if name == "default_":
                # torch Linear default: uniform(+-1/sqrt(fan_in)); the
                # matching kernel supplies fan_in
                kpath = path[:-len("bias")] + "kernel"
                fi = flat[kpath].shape[0] if kpath in flat else shape[-1]
                val = uniform(shape, 1.0 / math.sqrt(fi))
            else:
                val = torch.zeros(shape)
        elif path.endswith("/kernel"):
            if _WQKV.search(path):
                # per-chunk init of the fused projection
                val = torch.cat([draw((shape[0], s1 - s0)) for s0, s1 in
                                 _qkv_chunks(cfg, shape[1])], dim=1)
            else:
                val = draw(shape)
            if div is not None and _RESIDUAL_NAMES.search(path):
                val = val / div
        elif path.endswith("/embedding"):      # untied lm_head variants
            val = emb_draw(shape)
        else:
            raise NotImplementedError(
                f"init zoo does not know how to initialize {path!r} "
                "(reference param_init_fns.py:131-133 raises here too)")
        leaf.copy_(val.to(leaf.device, leaf.dtype))
    return decoder
