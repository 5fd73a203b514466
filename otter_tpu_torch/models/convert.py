"""Weight bridges into the port: the JAX package's parameter tree and HF
checkpoints (counterpart of `otter_tpu/models/convert.py`).

`load_flax_params(model, flat)` takes `{"/"-joined flax path: array}` as
`flax.traverse_util.flatten_dict(params, sep="/")` gives it (int8
`kernel_q` / `scale_q` leaves included) and copies every leaf into the
port module of the same path: the port names its submodules and
parameters as the flax modules do, so `a/b/kernel` is the state-dict key
`a.b.kernel`. The mapping must be one to one: a leaf with no home, a
port tensor left unfilled, or a shape mismatch raises. With
`partial=True` it fills what it is given and leaves the rest (a trainer's
checkpoint holds only the trainable tensors). Arrays may be numpy (the
port holds no jax) or torch tensors already on the device.
`export_flax_params(model)` is the inverse: the port's tensors as numpy
under their flax paths, without the decode megakernel's fused
`attn/wqo_q` / `attn/wqo_scale` leaves, which `ops.quant.add_fused_wqo`
derives from the others.

The HF side maps checkpoint names (the state_dict of the reference's
`OtterForConditionalGeneration`, `modeling_otter.py:739`, and of
adept/fuyu-8b and of HF `IdeficsForVisionText2Text`) to those flax paths
with the JAX package's rule tables:
torch Linear weight [out, in] -> Dense kernel [in, out] (transposed), Conv2d
weight [O, I, kh, kw] -> [kh, kw, I, O], norms weight/bias -> scale/bias.
`hf_to_port` / `fuyu_hf_to_port` / `idefics_hf_to_port` give a lazy
{flax path: tensor} mapping: a tensor is read, transformed, cast and moved
when it is indexed, so a 7B checkpoint passes through
`ops.quant.quantize_params` one tensor at a time in its own dtype.
`port_to_hf` is the inverse (the idefics rules for an
`IdeficsModelConfig`).
"""

from __future__ import annotations

import os
import re
from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

ArrayLike = Union[np.ndarray, torch.Tensor]


def load_flax_params(model: nn.Module, flat: Dict[str, ArrayLike], *,
                     partial: bool = False) -> int:
    """Copy `flat` into `model`; returns the number of tensors filled.
    `partial`: skip the leaves the model does not have and leave the
    tensors `flat` does not hold, as the JAX package's
    `load_otter_checkpoint` does (a shape mismatch still raises)."""
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    filled = set()
    for path, value in flat.items():
        key = path[len("params/"):] if path.startswith("params/") else path
        key = key.replace("/", ".")
        dst = targets.get(key)
        if dst is None:
            if partial:
                continue
            raise KeyError(f"load_flax_params: no port tensor for {path!r}")
        if isinstance(value, np.ndarray):
            if value.dtype.kind not in "fiub":   # e.g. ml_dtypes bfloat16
                value = value.astype(np.float32)
            src = torch.from_numpy(np.array(value))
        else:
            src = value
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"load_flax_params: {path!r} has shape "
                             f"{tuple(src.shape)}, port expects "
                             f"{tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src.to(device=dst.device, dtype=dst.dtype))
        filled.add(key)
    missing = sorted(set(targets) - filled)
    if missing and not partial:
        raise KeyError(f"load_flax_params: {len(missing)} port tensors not "
                       f"in the checkpoint, e.g. {missing[:5]}")
    return len(filled)


def export_flax_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """{flax path: numpy array} of every parameter and buffer, the paths as
    `flatten_dict(params, sep="/")` gives them (without the "params/"
    prefix). bf16 tensors come back as f32."""
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    out = {}
    for name, t in tensors.items():
        if name.endswith((".attn.wqo_q", ".attn.wqo_scale")):
            continue   # derived at load time
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name.replace(".", "/")] = t.cpu().numpy()
    return out


# ── HF checkpoints: file loading ─────────────────────────────────────


class StateDict(Mapping):
    """{name: tensor} of one or many checkpoint shards, on the CPU in their
    own dtypes. `.bin` / `.pt` shards are memory-mapped (`torch.load(...,
    mmap=True)`), `.safetensors` shards read a tensor when it is indexed:
    the checkpoint is never read whole into memory."""

    def __init__(self, paths: Iterable[str]):
        self._where: Dict[str, Union[str, torch.Tensor]] = {}
        for p in paths:
            if p.endswith(".safetensors"):
                from safetensors import safe_open
                with safe_open(p, framework="pt") as f:
                    self._where.update((k, p) for k in f.keys())
                continue
            sd = torch.load(p, map_location="cpu", weights_only=True,
                            mmap=True)
            if isinstance(sd, dict) and "model_state_dict" in sd:
                sd = sd["model_state_dict"]
            self._where.update(sd)

    def __getitem__(self, name: str) -> torch.Tensor:
        src = self._where[name]
        if isinstance(src, torch.Tensor):
            return src
        from safetensors import safe_open
        with safe_open(src, framework="pt") as f:
            return f.get_tensor(name)

    def __iter__(self):
        return iter(self._where)

    def __len__(self):
        return len(self._where)


def load_state_dict(path: str) -> StateDict:
    """A checkpoint file, or a directory of shards (`.safetensors`, `.bin`,
    `.pt`), as {name: tensor} (`otter_tpu/models/convert.py:31`, which
    widens bf16 to f32 numpy; here every tensor keeps its dtype)."""
    paths = []
    if os.path.isdir(path):
        for f in sorted(os.listdir(path)):
            if f.endswith((".safetensors", ".bin", ".pt")):
                paths.append(os.path.join(path, f))
    else:
        paths = [path]
    return StateDict(paths)


# ── name mapping: the JAX package's rule tables ───────────────────────
# Each rule is (HF name regex, flax path template, transform); the
# transform takes a tensor in HF layout and `_INVERSE` undoes it.

Rule = Tuple[Any, str, Optional[Callable]]


def _t(x):  # torch Linear -> flax Dense
    return x.t().contiguous()


def _conv(x):  # [O, I, kh, kw] -> [kh, kw, I, O]
    return x.permute(2, 3, 1, 0).contiguous()


def _conv_inverse(x):
    return x.permute(3, 2, 0, 1).contiguous()


_INVERSE = {_t: _t, _conv: _conv_inverse}


def _clip_rules(hf_prefix: str = "vision_encoder.vision_model."
                ) -> Iterable[Rule]:
    """(hf regex, flax template, transform). The same ViT layout serves
    Otter's CLIP tower and the idefics vision tower (different prefix)."""
    p = hf_prefix
    yield (re.escape(p) + r"embeddings\.class_embedding",
           "vision_encoder/class_embedding", None)
    yield (re.escape(p) + r"embeddings\.patch_embedding\.weight",
           "vision_encoder/patch_embedding/kernel", _conv)
    yield (re.escape(p) + r"embeddings\.position_embedding\.weight",
           "vision_encoder/position_embedding", None)
    yield (re.escape(p) + r"pre_layrnorm\.weight",
           "vision_encoder/pre_layernorm/scale", None)
    yield (re.escape(p) + r"pre_layrnorm\.bias",
           "vision_encoder/pre_layernorm/bias", None)
    yield (re.escape(p) + r"post_layernorm\.weight",
           "vision_encoder/post_layernorm/scale", None)
    yield (re.escape(p) + r"post_layernorm\.bias",
           "vision_encoder/post_layernorm/bias", None)
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        yield (re.escape(p) + rf"encoder\.layers\.(\d+)\.self_attn\.{proj}"
               r"\.weight",
               f"vision_encoder/layers_{{0}}/self_attn/{proj}/kernel", _t)
        yield (re.escape(p) + rf"encoder\.layers\.(\d+)\.self_attn\.{proj}"
               r"\.bias",
               f"vision_encoder/layers_{{0}}/self_attn/{proj}/bias", None)
    for ln in ("layer_norm1", "layer_norm2"):
        yield (re.escape(p) + rf"encoder\.layers\.(\d+)\.{ln}\.weight",
               f"vision_encoder/layers_{{0}}/{ln}/scale", None)
        yield (re.escape(p) + rf"encoder\.layers\.(\d+)\.{ln}\.bias",
               f"vision_encoder/layers_{{0}}/{ln}/bias", None)
    for fc in ("fc1", "fc2"):
        yield (re.escape(p) + rf"encoder\.layers\.(\d+)\.mlp\.{fc}\.weight",
               f"vision_encoder/layers_{{0}}/{fc}/kernel", _t)
        yield (re.escape(p) + rf"encoder\.layers\.(\d+)\.mlp\.{fc}\.bias",
               f"vision_encoder/layers_{{0}}/{fc}/bias", None)


def _perceiver_rules() -> Iterable[Rule]:
    yield (r"perceiver\.latents", "perceiver/latents", None)
    yield (r"perceiver\.frame_embs", "perceiver/frame_embs", None)
    yield (r"perceiver\.media_time_embs", "perceiver/media_time_embs", None)
    yield (r"perceiver\.norm\.weight", "perceiver/norm/scale", None)
    yield (r"perceiver\.norm\.bias", "perceiver/norm/bias", None)
    for tn in ("to_q", "to_kv", "to_out"):
        yield (rf"perceiver\.layers\.(\d+)\.{tn}\.weight",
               f"perceiver/layers_{{0}}/{tn}/kernel", _t)
    for tn in ("norm_media", "norm_latents"):
        yield (rf"perceiver\.layers\.(\d+)\.{tn}\.weight",
               f"perceiver/layers_{{0}}/{tn}/scale", None)
        yield (rf"perceiver\.layers\.(\d+)\.{tn}\.bias",
               f"perceiver/layers_{{0}}/{tn}/bias", None)
    # feed_forward ModuleList: 0=LN, 1=up, 3=down (modeling_otter.py:142-149)
    yield (r"perceiver\.layers\.(\d+)\.feed_forward\.0\.weight",
           "perceiver/layers_{0}/ff_norm/scale", None)
    yield (r"perceiver\.layers\.(\d+)\.feed_forward\.0\.bias",
           "perceiver/layers_{0}/ff_norm/bias", None)
    yield (r"perceiver\.layers\.(\d+)\.feed_forward\.1\.weight",
           "perceiver/layers_{0}/ff_up/kernel", _t)
    yield (r"perceiver\.layers\.(\d+)\.feed_forward\.3\.weight",
           "perceiver/layers_{0}/ff_down/kernel", _t)


def _xattn_rules(lang_prefix: str, block_attr: str) -> Iterable[Rule]:
    """Gated xattn blocks wrapped around decoder layers (`OtterLayer`)."""
    p = rf"{lang_prefix}\.{block_attr}\.(\d+)\.gated_cross_attn_layer\."
    yield (p + r"attn_gate", "lang_encoder/xattn_{0}/attn_gate", None)
    yield (p + r"ff_gate", "lang_encoder/xattn_{0}/ff_gate", None)
    yield (p + r"attn\.norm\.weight",
           "lang_encoder/xattn_{0}/attn/norm/scale", None)
    yield (p + r"attn\.norm\.bias",
           "lang_encoder/xattn_{0}/attn/norm/bias", None)
    for proj in ("to_q", "to_kv", "to_out"):
        yield (p + rf"attn\.{proj}\.weight",
               f"lang_encoder/xattn_{{0}}/attn/{proj}/kernel", _t)
    yield (p + r"feed_forward\.0\.weight",
           "lang_encoder/xattn_{0}/ff_norm/scale", None)
    yield (p + r"feed_forward\.0\.bias",
           "lang_encoder/xattn_{0}/ff_norm/bias", None)
    yield (p + r"feed_forward\.1\.weight",
           "lang_encoder/xattn_{0}/ff_up/kernel", _t)
    yield (p + r"feed_forward\.3\.weight",
           "lang_encoder/xattn_{0}/ff_down/kernel", _t)


def _mpt_rules(wrapped: bool) -> Iterable[Rule]:
    """MPT/MosaicGPT decoder (`transformer.*`). `wrapped`: blocks are inside
    `OtterLayer.decoder_layer` after init_otter."""
    mid = r"\.decoder_layer\." if wrapped else r"\."
    p = r"lang_encoder\.transformer\."
    yield (p + r"wte\.weight", "lang_encoder/wte/embedding", None)
    yield (p + r"norm_f\.weight", "lang_encoder/norm_f/scale", None)
    yield (p + r"norm_f\.bias", "lang_encoder/norm_f/bias", None)
    # mosaic_gpt (mpt_redpajama) names the final norm ln_f
    yield (p + r"ln_f\.weight", "lang_encoder/norm_f/scale", None)
    yield (p + r"ln_f\.bias", "lang_encoder/norm_f/bias", None)
    b = p + r"blocks\.(\d+)" + mid
    for ln in ("norm_1", "norm_2"):
        yield (b + rf"{ln}\.weight", f"lang_encoder/layers_{{0}}/{ln}/scale",
               None)
        yield (b + rf"{ln}\.bias", f"lang_encoder/layers_{{0}}/{ln}/bias",
               None)
    yield (b + r"attn\.Wqkv\.weight",
           "lang_encoder/layers_{0}/attn/Wqkv/kernel", _t)
    yield (b + r"attn\.Wqkv\.bias",
           "lang_encoder/layers_{0}/attn/Wqkv/bias", None)
    yield (b + r"attn\.q_ln\.weight",
           "lang_encoder/layers_{0}/attn/q_ln/scale", None)
    yield (b + r"attn\.k_ln\.weight",
           "lang_encoder/layers_{0}/attn/k_ln/scale", None)
    yield (b + r"attn\.out_proj\.weight",
           "lang_encoder/layers_{0}/attn/out_proj/kernel", _t)
    yield (b + r"ffn\.up_proj\.weight",
           "lang_encoder/layers_{0}/ffn/up_proj/kernel", _t)
    yield (b + r"ffn\.down_proj\.weight",
           "lang_encoder/layers_{0}/ffn/down_proj/kernel", _t)
    # mosaic_gpt variant uses mlp_up/mlp_down inside GPTBlock
    yield (b + r"mlp\.mlp_up\.weight",
           "lang_encoder/layers_{0}/ffn/up_proj/kernel", _t)
    yield (b + r"mlp\.mlp_down\.weight",
           "lang_encoder/layers_{0}/ffn/down_proj/kernel", _t)
    yield (b + r"ln_1\.weight", "lang_encoder/layers_{0}/norm_1/scale", None)
    yield (b + r"ln_2\.weight", "lang_encoder/layers_{0}/norm_2/scale", None)


def _llama_rules(wrapped: bool) -> Iterable[Rule]:
    mid = r"\.decoder_layer\." if wrapped else r"\."
    p = r"lang_encoder\.model\."
    yield (p + r"embed_tokens\.weight", "lang_encoder/wte/embedding", None)
    yield (p + r"norm\.weight", "lang_encoder/norm_f/scale", None)
    yield (r"lang_encoder\.lm_head\.weight", "lang_encoder/lm_head/kernel",
           _t)
    b = p + r"layers\.(\d+)" + mid
    for proj in ("q_proj", "k_proj", "v_proj"):
        yield (b + rf"self_attn\.{proj}\.weight",
               f"lang_encoder/layers_{{0}}/attn/{proj}/kernel", _t)
    yield (b + r"self_attn\.o_proj\.weight",
           "lang_encoder/layers_{0}/attn/out_proj/kernel", _t)
    for proj in ("gate_proj", "up_proj", "down_proj"):
        yield (b + rf"mlp\.{proj}\.weight",
               f"lang_encoder/layers_{{0}}/ffn/{proj}/kernel", _t)
    yield (b + r"input_layernorm\.weight",
           "lang_encoder/layers_{0}/norm_1/scale", None)
    yield (b + r"post_attention_layernorm\.weight",
           "lang_encoder/layers_{0}/norm_2/scale", None)


def _falcon_rules(wrapped: bool) -> Iterable[Rule]:
    """Falcon/RW decoder (reference `falcon/modelling_RW.py:507+`:
    transformer.word_embeddings / h.N.self_attention.query_key_value /
    .dense / mlp.dense_h_to_4h / dense_4h_to_h / input_layernorm / ln_f)."""
    mid = r"\.decoder_layer\." if wrapped else r"\."
    p = r"lang_encoder\.transformer\."
    yield (p + r"word_embeddings\.weight", "lang_encoder/wte/embedding",
           None)
    yield (p + r"ln_f\.weight", "lang_encoder/norm_f/scale", None)
    yield (p + r"ln_f\.bias", "lang_encoder/norm_f/bias", None)
    yield (r"lang_encoder\.lm_head\.weight", "lang_encoder/lm_head/kernel",
           _t)
    b = p + r"h\.(\d+)" + mid
    yield (b + r"self_attention\.query_key_value\.weight",
           "lang_encoder/layers_{0}/attn/Wqkv/kernel", _t)
    yield (b + r"self_attention\.dense\.weight",
           "lang_encoder/layers_{0}/attn/out_proj/kernel", _t)
    yield (b + r"mlp\.dense_h_to_4h\.weight",
           "lang_encoder/layers_{0}/ffn/up_proj/kernel", _t)
    yield (b + r"mlp\.dense_4h_to_h\.weight",
           "lang_encoder/layers_{0}/ffn/down_proj/kernel", _t)
    yield (b + r"input_layernorm\.weight",
           "lang_encoder/layers_{0}/norm_1/scale", None)
    yield (b + r"input_layernorm\.bias",
           "lang_encoder/layers_{0}/norm_1/bias", None)


def otter_rules(cfg, wrapped: bool = True) -> List[Rule]:
    """The rule table of an `OtterConfig`'s decoder arch."""
    rules = list(_clip_rules()) + list(_perceiver_rules())
    if cfg.text.arch in ("mpt", "mosaic_gpt"):
        rules += list(_xattn_rules(r"lang_encoder\.transformer", "blocks"))
        rules += list(_mpt_rules(wrapped))
    elif cfg.text.arch == "llama":
        rules += list(_xattn_rules(r"lang_encoder\.model", "layers"))
        rules += list(_llama_rules(wrapped))
    elif cfg.text.arch == "falcon":
        rules += list(_xattn_rules(r"lang_encoder\.transformer", "h"))
        rules += list(_falcon_rules(wrapped))
    else:
        raise NotImplementedError(cfg.text.arch)
    return [(re.compile(pat + r"$"), tmpl, tr) for pat, tmpl, tr in rules]


def fuyu_rules(num_heads: int = 64) -> List[Rule]:
    """adept/fuyu-8b checkpoint names -> FuyuVLM param paths
    (reference `fuyu/modeling_fuyu.py`/`modeling_persimmon.py` attribute
    names). The HF persimmon fused qkv is per-head INTERLEAVED
    ([h, 3, d] row blocks, `PersimmonAttention._split_heads`); our
    decoder splits flat [q | k | v], so the qkv weight/bias rows are
    de-interleaved here (a pure permutation)."""

    def _deint_w(x):          # [3hd, in] torch -> [in, 3hd] flat qkv
        out, inn = x.shape
        d = out // (3 * num_heads)
        x = x.reshape(num_heads, 3, d, inn).transpose(0, 1)
        return x.reshape(out, inn).t().contiguous()

    def _deint_b(x):          # [3hd] bias
        d = x.shape[0] // (3 * num_heads)
        return x.reshape(num_heads, 3, d).transpose(0, 1).reshape(-1)\
            .contiguous()

    def _int_w(x):            # the inverse of _deint_w
        inn, out = x.shape
        d = out // (3 * num_heads)
        x = x.t().reshape(3, num_heads, d, inn).transpose(0, 1)
        return x.reshape(out, inn).contiguous()

    def _int_b(x):
        d = x.shape[0] // (3 * num_heads)
        return x.reshape(3, num_heads, d).transpose(0, 1).reshape(-1)\
            .contiguous()

    _deint_w.inverse, _deint_b.inverse = _int_w, _int_b
    rules = [
        (r"vision_embed_tokens\.weight", "vision_embed_tokens/kernel", _t),
        (r"vision_embed_tokens\.bias", "vision_embed_tokens/bias", None),
        (r"language_model\.model\.embed_tokens\.weight",
         "language_model/wte/embedding", None),
        (r"language_model\.model\.final_layernorm\.weight",
         "language_model/norm_f/scale", None),
        (r"language_model\.model\.final_layernorm\.bias",
         "language_model/norm_f/bias", None),
        (r"language_model\.lm_head\.weight",
         "language_model/lm_head/kernel", _t),
    ]
    b = r"language_model\.model\.layers\.(\d+)\."
    rules += [
        (b + r"self_attn\.query_key_value\.weight",
         "language_model/layers_{0}/attn/Wqkv/kernel", _deint_w),
        (b + r"self_attn\.query_key_value\.bias",
         "language_model/layers_{0}/attn/Wqkv/bias", _deint_b),
        (b + r"self_attn\.dense\.weight",
         "language_model/layers_{0}/attn/out_proj/kernel", _t),
        (b + r"self_attn\.dense\.bias",
         "language_model/layers_{0}/attn/out_proj/bias", None),
        (b + r"self_attn\.q_layernorm\.weight",
         "language_model/layers_{0}/attn/q_ln/scale", None),
        (b + r"self_attn\.q_layernorm\.bias",
         "language_model/layers_{0}/attn/q_ln/bias", None),
        (b + r"self_attn\.k_layernorm\.weight",
         "language_model/layers_{0}/attn/k_ln/scale", None),
        (b + r"self_attn\.k_layernorm\.bias",
         "language_model/layers_{0}/attn/k_ln/bias", None),
        (b + r"mlp\.dense_h_to_4h\.weight",
         "language_model/layers_{0}/ffn/up_proj/kernel", _t),
        (b + r"mlp\.dense_h_to_4h\.bias",
         "language_model/layers_{0}/ffn/up_proj/bias", None),
        (b + r"mlp\.dense_4h_to_h\.weight",
         "language_model/layers_{0}/ffn/down_proj/kernel", _t),
        (b + r"mlp\.dense_4h_to_h\.bias",
         "language_model/layers_{0}/ffn/down_proj/bias", None),
        (b + r"input_layernorm\.weight",
         "language_model/layers_{0}/norm_1/scale", None),
        (b + r"input_layernorm\.bias",
         "language_model/layers_{0}/norm_1/bias", None),
        (b + r"post_attention_layernorm\.weight",
         "language_model/layers_{0}/norm_2/scale", None),
        (b + r"post_attention_layernorm\.bias",
         "language_model/layers_{0}/norm_2/bias", None),
    ]
    return [(re.compile(p + r"$"), tmpl, tr) for p, tmpl, tr in rules]


def idefics_rules(cfg) -> List[Rule]:
    """HF `IdeficsForVisionText2Text` state_dict names -> `IdeficsVLM`
    param paths. `cfg` is an `IdeficsModelConfig`: the gated xattn blocks
    are indexed densely in HF (`gated_cross_attn_layers.J`) and by the
    decoder layer they precede here (`xattn_{J * cross_layer_interval}`)."""
    rules: list = list(_clip_rules("model.vision_model."))

    # decoupled embedding / lm_head
    rules += [
        (r"model\.embed_tokens\.weight", "wte/embedding", None),
        (r"model\.embed_tokens\.additional_embedding\.weight",
         "additional_embedding/embedding", None),
        (r"lm_head\.weight", "lm_head/kernel", _t),
        (r"lm_head\.additional_fc\.weight", "additional_fc/kernel", _t),
        (r"model\.norm\.weight", "norm_f/scale", None),
    ]

    # perceiver resampler (blocks.N.0 = attention, blocks.N.1 = MLP)
    p = r"model\.perceiver_resampler\."
    rules += [
        (p + r"latents", "perceiver/latents", None),
        (p + r"layer_norm\.weight", "perceiver/layer_norm/scale", None),
        (p + r"layer_norm\.bias", "perceiver/layer_norm/bias", None),
    ]
    for ln in ("context_layer_norm", "latents_layer_norm",
               "q_layer_norm", "k_layer_norm"):
        rules += [
            (p + rf"blocks\.(\d+)\.0\.{ln}\.weight",
             f"perceiver/blocks_{{0}}_attn/{ln}/scale", None),
            (p + rf"blocks\.(\d+)\.0\.{ln}\.bias",
             f"perceiver/blocks_{{0}}_attn/{ln}/bias", None),
        ]
    for proj in ("q_proj", "k_proj", "v_proj", "output_proj"):
        rules.append((p + rf"blocks\.(\d+)\.0\.{proj}\.weight",
                      f"perceiver/blocks_{{0}}_attn/{proj}/kernel", _t))
    rules += [
        (p + r"blocks\.(\d+)\.1\.ln\.weight",
         "perceiver/blocks_{0}_mlp/ln/scale", None),
        (p + r"blocks\.(\d+)\.1\.ln\.bias",
         "perceiver/blocks_{0}_mlp/ln/bias", None),
        (p + r"blocks\.(\d+)\.1\.fc\.weight",
         "perceiver/blocks_{0}_mlp/fc/kernel", _t),
        (p + r"blocks\.(\d+)\.1\.c_proj\.weight",
         "perceiver/blocks_{0}_mlp/c_proj/kernel", _t),
    ]

    # gated cross-attention, one concrete name set per block
    n_xattn = cfg.text.num_hidden_layers // cfg.cross_layer_interval
    for j in range(n_xattn):
        g = re.escape(f"model.gated_cross_attn_layers.{j}.")
        fx = f"xattn_{j * cfg.cross_layer_interval}"
        for hf_p, fl_p in (("cross_attn.q_proj", "q_proj"),
                           ("cross_attn.k_proj", "k_proj"),
                           ("cross_attn.v_proj", "v_proj"),
                           ("cross_attn.o_proj", "o_proj"),
                           ("mlp.gate_proj", "gate_proj"),
                           ("mlp.up_proj", "up_proj"),
                           ("mlp.down_proj", "down_proj")):
            rules.append((g + re.escape(hf_p) + r"\.weight",
                          f"{fx}/{fl_p}/kernel", _t))
        for hf_n, fl_n in (("input_layernorm", "input_layernorm"),
                           ("post_attention_layernorm",
                            "post_attention_layernorm"),
                           ("cross_attn.q_layer_norm", "q_layer_norm"),
                           ("cross_attn.k_layer_norm", "k_layer_norm")):
            rules.append((g + re.escape(hf_n) + r"\.weight",
                          f"{fx}/{fl_n}/scale", None))
        rules.append((g + r"alpha_cross_attn", f"{fx}/alpha_cross_attn",
                      None))
        rules.append((g + r"alpha_dense", f"{fx}/alpha_dense", None))

    # the LLaMA trunk (+ per-head q/k RMS norms)
    b = r"model\.layers\.(\d+)\."
    for proj in ("q_proj", "k_proj", "v_proj"):
        rules.append((b + rf"self_attn\.{proj}\.weight",
                      f"layers_{{0}}/attn/{proj}/kernel", _t))
    rules += [
        (b + r"self_attn\.o_proj\.weight",
         "layers_{0}/attn/out_proj/kernel", _t),
        (b + r"self_attn\.q_layer_norm\.weight",
         "layers_{0}/attn/q_ln/scale", None),
        (b + r"self_attn\.k_layer_norm\.weight",
         "layers_{0}/attn/k_ln/scale", None),
        (b + r"input_layernorm\.weight", "layers_{0}/norm_1/scale", None),
        (b + r"post_attention_layernorm\.weight",
         "layers_{0}/norm_2/scale", None),
    ]
    for proj in ("gate_proj", "up_proj", "down_proj"):
        rules.append((b + rf"mlp\.{proj}\.weight",
                      f"layers_{{0}}/ffn/{proj}/kernel", _t))
    return [(re.compile(pat + r"$"), tmpl, tr) for pat, tmpl, tr in rules]


def _normalize_fuyu_key(name: str) -> str:
    """Accept both checkpoint vintages: adept/fuyu-8b files use
    `language_model.model.layers...` / `language_model.lm_head`, while
    post-refactor transformers state_dicts use `model.language_model.
    layers...` / top-level `lm_head` (HF remaps old files through
    `_checkpoint_conversion_mapping`). Normalize to the on-disk naming
    the rules target."""
    if name.startswith("model.language_model."):
        name = "language_model.model." + name[len("model.language_model."):]
    elif name.startswith("model.vision_embed_tokens."):
        name = name[len("model."):]
    elif name == "lm_head.weight":
        name = "language_model.lm_head.weight"
    return name


# ── conversion ───────────────────────────────────────────────────────


class ConvertedParams(Mapping):
    """{flax path: tensor} over an HF state_dict: the names are matched
    when the mapping is made, each tensor is read, moved to `device`,
    transformed and cast (floating tensors to `dtype`) when it is indexed.
    Where two checkpoint names map to one path, the later one wins, as in
    the JAX package's dict."""

    def __init__(self, state_dict: Mapping, rules: List[Rule], *,
                 dtype=None, device=None, strict: bool = False,
                 rename: Callable[[str], str] = lambda n: n):
        self._sd, self._dtype, self._device = state_dict, dtype, device
        self._src: Dict[str, Tuple[str, Optional[Callable]]] = {}
        unmatched = []
        for name in state_dict:
            key = rename(name)
            for pat, tmpl, tr in rules:
                m = pat.fullmatch(key)
                if m:
                    self._src[tmpl.format(*m.groups())] = (name, tr)
                    break
            else:
                unmatched.append(name)
        if strict and unmatched:
            raise KeyError(f"unmatched checkpoint keys: {unmatched[:20]}"
                           f"{'...' if len(unmatched) > 20 else ''}")

    def __getitem__(self, path: str) -> torch.Tensor:
        name, tr = self._src[path]
        val = self._sd[name]
        if isinstance(val, np.ndarray):
            val = torch.from_numpy(val)
        if self._device is not None:
            val = val.to(self._device)
        if tr is not None:
            val = tr(val)
        if self._dtype is not None and val.is_floating_point():
            val = val.to(self._dtype)
        return val

    def __iter__(self):
        return iter(self._src)

    def __len__(self):
        return len(self._src)

    def __contains__(self, path):
        return path in self._src   # without reading the tensor


def hf_to_port(state_dict: Mapping, cfg, *, wrapped: bool = True,
               dtype=None, device=None, strict: bool = False,
               rules=None) -> ConvertedParams:
    """HF state_dict -> {flax path: tensor} (`hf_to_flax`,
    `otter_tpu/models/convert.py:463`), lazily. Checkpoints saved by the
    trainer contain only trainable params (`get_checkpoint`,
    train_utils.py:60-67): non-strict mode converts whatever is present.
    `rules` overrides the Otter rule table."""
    rules = rules if rules is not None else otter_rules(cfg, wrapped)
    return ConvertedParams(state_dict, rules, dtype=dtype, device=device,
                           strict=strict)


def fuyu_hf_to_port(state_dict: Mapping, *, dtype=None, device=None,
                    strict: bool = False,
                    num_heads: int = 64) -> ConvertedParams:
    """adept/fuyu-8b state_dict (either vintage) -> {flax path: tensor}
    (`fuyu_hf_to_flax`, `otter_tpu/models/convert.py:441`), lazily."""
    return ConvertedParams(state_dict, fuyu_rules(num_heads), dtype=dtype,
                           device=device, strict=strict,
                           rename=_normalize_fuyu_key)


def idefics_hf_to_port(state_dict: Mapping, cfg, *, dtype=None,
                       device=None, strict: bool = False) -> ConvertedParams:
    """HF `IdeficsForVisionText2Text` state_dict -> {flax path: tensor}
    (`hf_to_flax(..., rules=idefics_rules(cfg))` in the JAX package),
    lazily."""
    return ConvertedParams(state_dict, idefics_rules(cfg), dtype=dtype,
                           device=device, strict=strict)


def port_to_hf(flat: Mapping, cfg, *, wrapped: bool = True,
               rules=None) -> Dict[str, torch.Tensor]:
    """Inverse mapping for HF-interop export (`flax_to_hf`,
    `otter_tpu/models/convert.py:496`; `save_hf_model` parity,
    train_utils.py:234-262): {flax path: array} (a leading "params/" is
    dropped) -> {HF name: tensor} through the same rule table (the idefics
    rules for an `IdeficsModelConfig`), the first rule that produces a
    path giving its name. Paths no rule produces (quantized leaves among
    them) are left out. A LoRA model's adapters are merged into their
    bases first (`ops.lora.merge_adapters`), where the JAX export leaves
    the wrapped projections out."""
    if any(k.endswith("/lora_a") for k in flat):
        from otter_tpu_torch.ops.lora import merge_adapters
        flat = merge_adapters(flat, cfg.text.lora_alpha / cfg.text.lora_rank)
    if rules is None:
        # an IdeficsModelConfig (as `train.step.split_params` tells it)
        rules = (idefics_rules(cfg) if hasattr(cfg, "additional_vocab_size")
                 else otter_rules(cfg, wrapped))
    inverse = [(re.compile(re.escape(tmpl).replace(r"\{0\}", r"(\d+)")),
                pat, tr) for pat, tmpl, tr in rules]
    out: Dict[str, torch.Tensor] = {}
    for path in flat:
        key = path[len("params/"):] if path.startswith("params/") else path
        for tmpl_re, pat, tr in inverse:
            m = tmpl_re.fullmatch(key)
            if m is None:
                continue
            arr = flat[path]
            if isinstance(arr, np.ndarray):
                arr = torch.from_numpy(arr)
            if tr is not None:
                arr = _INVERSE[tr](arr) if tr in _INVERSE else \
                    tr.inverse(arr)
            out[_expand_pattern(pat.pattern, m.groups())] = arr
            break
    return out


def _expand_pattern(pattern: str, groups) -> str:
    """Turn a checkpoint-name regex back into a concrete name."""
    s = pattern[:-1] if pattern.endswith("$") else pattern
    for g in groups:
        s = s.replace(r"(\d+)", g, 1)
    return s.replace(r"\.", ".")


def load_otter_checkpoint(path: str, cfg, model: nn.Module) -> nn.Module:
    """Load an HF Otter checkpoint (file or directory of shards) into
    `model`, an `OtterVLM` of `cfg`'s arch, as a partial update
    (`otter_tpu/models/convert.py:531`, mirroring the reference's
    `--trained_ckpt` partial load, instruction_following.py:438-443): the
    tensors the checkpoint holds are filled, the others keep their values.
    Each tensor is converted on the model's device in the dtype of the
    model's tensor it fills (a bf16 model's f32 norm scales and latents
    keep an f32 checkpoint's values), then quantized as `model.cfg` asks
    (`ops.quant.quantize_for`) from the checkpoint's own dtype, as the JAX
    package quantizes its f32 parameters. In a LoRA model
    (`lora_rank` > 0) a target projection's tensors fill its `base/`
    (`ops.lora.into_base`, the JAX loader's lookup) and the adapters keep
    their values. A shape mismatch raises, and so does a checkpoint that
    fills nothing (wrong config or arch)."""
    from otter_tpu_torch.ops.lora import into_base
    from otter_tpu_torch.ops.quant import quantize_for
    converted = hf_to_port(load_state_dict(path), cfg, dtype=None,
                           device=model.device)
    n = load_flax_params(
        model, into_base(quantize_for(model.cfg.text, converted), model),
        partial=True)
    if n == 0:
        n_model = len(dict(model.named_parameters())) \
            + len(dict(model.named_buffers()))
        raise ValueError(
            f"checkpoint {path} matched 0 of {n_model} params "
            f"({len(converted)} converted keys) — wrong config/arch?")
    return model


def save_state_dict(state_dict: Mapping, path: str) -> None:
    """Write {name: tensor} as one checkpoint file that `load_state_dict`
    reads: `.safetensors` through safetensors, any other name through
    `torch.save`. Tensors are written from the CPU."""
    sd = {k: v.detach().cpu().contiguous() for k, v in state_dict.items()}
    if path.endswith(".safetensors"):
        from safetensors.torch import save_file
        save_file(sd, path)
    else:
        torch.save(sd, path)
