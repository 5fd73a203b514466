"""Configuration tree for the PyTorch port (counterpart of `otter_tpu/config.py`).

The dataclasses are copied, not imported: importing anything under
`otter_tpu` pulls in jax. Field names, defaults and JSON round-tripping are
the same as the JAX package's, so one JSON file configures either package.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


class _JsonMixin:
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict):
        known = {f.name: f for f in dataclasses.fields(cls)}
        # `from __future__ import annotations` stringizes f.type, so the
        # nested-dataclass check goes through the resolved type hints
        hints = typing.get_type_hints(cls)
        kwargs = {}
        for k, v in d.items():
            if k not in known:
                continue
            t = hints.get(k, known[k].type)
            if dataclasses.is_dataclass(t) and isinstance(v, dict):
                kwargs[k] = t.from_dict(v)
            else:
                kwargs[k] = v
        return cls(**kwargs)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class VisionConfig(_JsonMixin):
    """CLIP ViT vision tower; defaults are CLIP ViT-L/14."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class PerceiverConfig(_JsonMixin):
    dim: int = 1024
    depth: int = 6
    dim_head: int = 64
    heads: int = 8
    num_latents: int = 64
    ff_mult: int = 4
    max_num_media: Optional[int] = None
    max_num_frames: Optional[int] = None


@dataclass(frozen=True)
class TextConfig(_JsonMixin):
    """Decoder-only LM backbone; `arch` selects the family: "mpt" (ALiBi,
    low-precision LayerNorm, fused Wqkv, tied embeddings, GELU MLP),
    "mosaic_gpt" (the older MPT variant), "llama" (RoPE, RMSNorm, SwiGLU,
    untied head), "falcon" (rotary, fused multiquery qkv, parallel
    attention + MLP) and "persimmon" (partial rotary, per-head q/k
    LayerNorm, squared-ReLU MLP, biases)."""

    arch: str = "mpt"
    vocab_size: int = 50432
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_kv_heads: Optional[int] = None
    intermediate_size: Optional[int] = None
    max_seq_len: int = 2048
    pos: str = "alibi"
    alibi_bias_max: float = 8.0
    rope_theta: float = 10000.0
    rope_partial_factor: float = 1.0
    norm_type: str = "low_precision_layernorm"
    norm_eps: float = 1e-5
    qk_ln: bool = False
    tie_embeddings: bool = True
    no_bias: bool = True
    clip_qkv: Optional[float] = None
    logit_scale: Optional[float] = None
    act: str = "gelu"
    # weight-only quantization of decoder attn/ffn kernels: None | "int8"
    quant: Optional[str] = None
    quant_embed: bool = False
    # gated-xattn quant policy: "follow" mirrors `quant`; None keeps bf16
    quant_xattn: Any = "follow"
    lora_rank: int = 0
    lora_alpha: float = 16.0
    # cached-decode attention kernel: False | True | "auto" (kernel when the
    # cache is int8 or at least 1024 long)
    decode_kernel: Any = False
    fused_tail: bool = False
    megakernel: bool = False
    extra_vocab: int = 0
    prefix_lm: bool = False
    attn_uses_sequence_id: bool = False
    init_config: Optional[Dict[str, Any]] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_attention_heads

    @property
    def mlp_dim(self) -> int:
        if self.intermediate_size is not None:
            return self.intermediate_size
        if self.act == "silu_glu":
            return 11008
        return 4 * self.hidden_size

    @property
    def total_vocab(self) -> int:
        return self.vocab_size + self.extra_vocab


@dataclass(frozen=True)
class OtterConfig(_JsonMixin):
    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    perceiver: PerceiverConfig = field(default_factory=PerceiverConfig)
    cross_attn_every_n_layers: int = 4
    only_attend_immediate_media: bool = True
    use_media_placement_augmentation: bool = False
    xattn_dim_head: int = 64
    xattn_heads: int = 8
    xattn_ff_mult: int = 4
    media_token_id: int = 50278
    eoc_token_id: int = 50277
    answer_token_id: Optional[int] = None
    pad_token_id: Optional[int] = None

    @classmethod
    def tiny(cls, arch: str = "mpt") -> "OtterConfig":
        """Small config for tests: 4 decoder layers, xattn every 2."""
        return cls(
            vision=VisionConfig(
                hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, image_size=28, patch_size=14),
            text=TextConfig(
                arch=arch, vocab_size=256, hidden_size=64,
                num_hidden_layers=4, num_attention_heads=4, max_seq_len=128,
                pos="alibi" if arch == "mpt" else "rope",
                norm_type="low_precision_layernorm" if arch == "mpt" else "rmsnorm",
                act="gelu" if arch == "mpt" else "silu_glu",
                intermediate_size=128,
                tie_embeddings=(arch == "mpt"), no_bias=True),
            perceiver=PerceiverConfig(dim=64, depth=2, dim_head=16, heads=4,
                                      num_latents=8, max_num_frames=8),
            cross_attn_every_n_layers=2,
            xattn_dim_head=16, xattn_heads=4,
            media_token_id=253, eoc_token_id=252, answer_token_id=251,
        )


def otter_mpt7b() -> OtterConfig:
    """OTTER-Image-MPT7B (reference `flamingo/flamingo-mpt-7B.json`)."""
    return OtterConfig(
        vision=VisionConfig(),
        text=TextConfig(arch="mpt", vocab_size=50432, hidden_size=4096,
                        num_hidden_layers=32, num_attention_heads=32,
                        max_seq_len=2048, pos="alibi",
                        norm_type="low_precision_layernorm", act="gelu",
                        tie_embeddings=True, no_bias=True),
        perceiver=PerceiverConfig(dim=1024, max_num_frames=None),
        cross_attn_every_n_layers=4,
        media_token_id=50278, eoc_token_id=50277,
    )


def otter_mpt1b() -> OtterConfig:
    """Flamingo-MPT-1B-RedPajama (reference
    `flamingo/flamingo-mpt-1B-redpajama.json`): MosaicGPT 1B, ALiBi, qk_ln,
    gated xattn every layer."""
    return OtterConfig(
        vision=VisionConfig(),
        text=TextConfig(arch="mosaic_gpt", vocab_size=50432, hidden_size=2048,
                        num_hidden_layers=24, num_attention_heads=16,
                        max_seq_len=2048, pos="alibi", qk_ln=True,
                        norm_type="low_precision_layernorm", act="gelu",
                        tie_embeddings=True, no_bias=True),
        perceiver=PerceiverConfig(dim=1024, max_num_frames=None),
        cross_attn_every_n_layers=1,
        media_token_id=50278, eoc_token_id=50277,
    )


def otter_llama7b_video(max_num_frames: int = 128) -> OtterConfig:
    """OTTER-Video-LLaMA7B-DenseCaption."""
    return OtterConfig(
        vision=VisionConfig(),
        text=TextConfig(arch="llama", vocab_size=32000, extra_vocab=4,
                        hidden_size=4096, num_hidden_layers=32,
                        num_attention_heads=32, intermediate_size=11008,
                        max_seq_len=2048, pos="rope", norm_type="rmsnorm",
                        norm_eps=1e-6, act="silu_glu", tie_embeddings=False,
                        no_bias=True),
        perceiver=PerceiverConfig(dim=1024, max_num_frames=max_num_frames),
        cross_attn_every_n_layers=4,
        media_token_id=32001, eoc_token_id=32002,
    )


def otter_mpt30b() -> OtterConfig:
    """Flamingo-MPT-30B (reference `flamingo/flamingo-mpt-30B.json`):
    d=7168, 64 heads, 48 layers, 8k context, gated xattn every 7 layers."""
    return OtterConfig(
        vision=VisionConfig(),
        text=TextConfig(arch="mpt", vocab_size=50432, hidden_size=7168,
                        num_hidden_layers=48, num_attention_heads=64,
                        max_seq_len=8192, pos="alibi",
                        norm_type="low_precision_layernorm", act="gelu",
                        tie_embeddings=True, no_bias=True),
        perceiver=PerceiverConfig(dim=1024, max_num_frames=None),
        cross_attn_every_n_layers=7,
        media_token_id=50278, eoc_token_id=50277,
    )


def otter_falcon7b() -> OtterConfig:
    """Flamingo-Falcon-7B (reference `flamingo/flamingo-falcon-7B.json`):
    rotary + fused-qkv multiquery, parallel attn+MLP block, LN with bias."""
    return OtterConfig(
        vision=VisionConfig(),
        text=TextConfig(arch="falcon", vocab_size=65024, extra_vocab=2,
                        hidden_size=4544, num_hidden_layers=32,
                        num_attention_heads=71, num_kv_heads=1,
                        intermediate_size=4 * 4544, max_seq_len=2048,
                        pos="rope", norm_type="low_precision_layernorm",
                        act="gelu", tie_embeddings=False, no_bias=True),
        perceiver=PerceiverConfig(dim=1024, max_num_frames=None),
        cross_attn_every_n_layers=4,
        media_token_id=65025, eoc_token_id=65024,
    )


def _otter_llama(hidden: int, layers: int, heads: int, ffn: int,
                 norm_eps: float, xattn_every: int,
                 max_seq_len: int = 2048) -> OtterConfig:
    """LLaMA-family flamingo preset. The injection scripts resize the
    embedding 32000 -> 32002 (`injecting_llama2_into_flamingo.py:82-89`,
    `injecting_vicuna_into_flamingo.py:87-94`): <|endofchunk|>=32000,
    <image>=32001."""
    return OtterConfig(
        vision=VisionConfig(),
        text=TextConfig(arch="llama", vocab_size=32000, extra_vocab=2,
                        hidden_size=hidden, num_hidden_layers=layers,
                        num_attention_heads=heads, intermediate_size=ffn,
                        max_seq_len=max_seq_len, pos="rope",
                        norm_type="rmsnorm", norm_eps=norm_eps,
                        act="silu_glu", tie_embeddings=False, no_bias=True),
        perceiver=PerceiverConfig(dim=1024, max_num_frames=None),
        cross_attn_every_n_layers=xattn_every,
        media_token_id=32001, eoc_token_id=32000,
    )


def otter_llama2_chat7b() -> OtterConfig:
    """Flamingo-LLaMA2-Chat-7B (reference
    `flamingo/flamingo-llama2-chat-7B.json`)."""
    return _otter_llama(4096, 32, 32, 11008, 1e-5, 4)


def otter_llama2_chat13b() -> OtterConfig:
    """Flamingo-LLaMA2-Chat-13B (reference
    `flamingo/flamingo-llama2-chat-13B.json`): xattn every 8 layers,
    4k context."""
    return _otter_llama(5120, 40, 40, 13824, 1e-5, 8, max_seq_len=4096)


def otter_vicuna7b() -> OtterConfig:
    """Flamingo-Vicuna-7B-v1.3 (reference
    `flamingo/flamingo-vicuna-7B-v1.3.json`)."""
    return _otter_llama(4096, 32, 32, 11008, 1e-6, 4)


def otter_vicuna33b() -> OtterConfig:
    """Flamingo-Vicuna-33B-v1.3 (reference
    `flamingo/flamingo-vicuna-33B-v1.3.json`)."""
    return _otter_llama(6656, 60, 52, 17920, 1e-6, 4)


@dataclass(frozen=True)
class IdeficsPerceiverConfig(_JsonMixin):
    """HF IdeficsPerceiverConfig: latents live at the VISION embed dim;
    heads*head_dim need not equal embed_dim (idefics-9b: 16*96 vs 1280)."""

    depth: int = 6
    n_heads: int = 16
    head_dim: int = 96
    n_latents: int = 64
    qk_layer_norms: bool = False


@dataclass(frozen=True)
class IdeficsModelConfig(_JsonMixin):
    """IDEFICS VLM config (HF `IdeficsForVisionText2Text`). It has the
    accessors `OtterGenerator` reads (`.text`, `.media_token_id`,
    `.eoc_token_id`), so the engine drives `IdeficsVLM` unchanged.

    HF's IdeficsDecoderLayer never enables q/k norms in SELF attention, so
    `text.qk_ln` stays False; `qk_layer_norms` governs the gated xattn
    blocks and the perceiver."""

    vision: VisionConfig = field(default_factory=lambda: VisionConfig(
        hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
        num_attention_heads=16, hidden_act="gelu"))
    text: TextConfig = field(default_factory=lambda: TextConfig(
        arch="llama", vocab_size=32000, hidden_size=4096,
        num_hidden_layers=32, num_attention_heads=32,
        intermediate_size=11008, max_seq_len=2048, pos="rope",
        norm_type="rmsnorm", norm_eps=1e-6, act="silu_glu",
        tie_embeddings=False, no_bias=True))
    perceiver: IdeficsPerceiverConfig = field(
        default_factory=IdeficsPerceiverConfig)
    use_resampler: bool = True
    cross_layer_interval: int = 4
    # gate scalars: "float" (scalar) | "vector" (per-feature)
    alpha_type: str = "float"
    qk_layer_norms: bool = True
    # decoupled trainable vocab appended after the frozen embedding
    # (IdeficsDecoupledEmbedding / IdeficsDecoupledLinear)
    additional_vocab_size: int = 0
    media_token_id: int = 32001   # <image> (additional vocab)
    eoc_token_id: int = 2         # generation stops at eos
    eos_token_id: int = 2         # resets the image-attention window
    answer_token_id: Optional[int] = None


def idefics_tiny() -> IdeficsModelConfig:
    """Small idefics config for tests."""
    return IdeficsModelConfig(
        vision=VisionConfig(hidden_size=48, intermediate_size=96,
                            num_hidden_layers=2, num_attention_heads=4,
                            image_size=28, patch_size=14, hidden_act="gelu"),
        text=TextConfig(arch="llama", vocab_size=120, hidden_size=64,
                        num_hidden_layers=4, num_attention_heads=4,
                        intermediate_size=96, max_seq_len=128, pos="rope",
                        norm_type="rmsnorm", norm_eps=1e-6,
                        act="silu_glu", tie_embeddings=False, no_bias=True),
        perceiver=IdeficsPerceiverConfig(depth=2, n_heads=4, head_dim=16,
                                         n_latents=6, qk_layer_norms=True),
        cross_layer_interval=2, qk_layer_norms=True,
        additional_vocab_size=8,
        media_token_id=126, eoc_token_id=2, eos_token_id=2,
        answer_token_id=125)


def idefics9b() -> IdeficsModelConfig:
    """HuggingFaceM4/idefics-9b: ViT-H/14 tower, LLaMA-7B trunk, xattn every
    4 layers, 64 latents, qk layer norms everywhere."""
    return IdeficsModelConfig(
        additional_vocab_size=68,
        perceiver=IdeficsPerceiverConfig(qk_layer_norms=True))


# every reference model JSON preset
# (`src/otter_ai/models/flamingo/flamingo-*.json`) by short name
PRESETS = {
    "mpt1b": otter_mpt1b,
    "mpt7b": otter_mpt7b,
    "mpt30b": otter_mpt30b,
    "llama7b-video": otter_llama7b_video,
    "llama2-chat-7b": otter_llama2_chat7b,
    "llama2-chat-13b": otter_llama2_chat13b,
    "vicuna-7b": otter_vicuna7b,
    "vicuna-33b": otter_vicuna33b,
    "falcon7b": otter_falcon7b,
}


@dataclass(frozen=True)
class FuyuConfig(_JsonMixin):
    """Fuyu/OtterHD: encoder-free VLM (reference `fuyu/modeling_fuyu.py:19`).
    Variable-resolution image patches are linearly projected into the token
    stream of a Persimmon-8B decoder."""

    text: TextConfig = field(default_factory=lambda: TextConfig(
        arch="persimmon", vocab_size=262144, hidden_size=4096,
        num_hidden_layers=36, num_attention_heads=64, intermediate_size=16384,
        max_seq_len=16384, pos="rope", rope_theta=25000.0,
        rope_partial_factor=0.5, norm_type="layernorm", qk_ln=True,
        act="sq_relu", tie_embeddings=False, no_bias=False))
    patch_size: int = 30
    num_channels: int = 3
    max_image_height: int = 1080
    max_image_width: int = 1920
    image_newline_id: int = 71019
    image_placeholder_id: int = 71011

    @classmethod
    def tiny(cls) -> "FuyuConfig":
        return cls(
            text=TextConfig(arch="persimmon", vocab_size=512, hidden_size=64,
                            num_hidden_layers=2, num_attention_heads=4,
                            intermediate_size=256, max_seq_len=256, pos="rope",
                            rope_partial_factor=0.5, norm_type="layernorm",
                            qk_ln=True, act="sq_relu", tie_embeddings=False,
                            no_bias=False),
            patch_size=4, max_image_height=16, max_image_width=16,
            image_newline_id=509, image_placeholder_id=508)


@dataclass(frozen=True)
class GenerationConfig(_JsonMixin):
    """Decode-loop settings (the HF `generate_kwargs` surface)."""

    max_new_tokens: int = 512
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    num_beams: int = 1
    length_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    early_stopping: bool = True
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    bad_words_ids: Optional[Tuple[Tuple[int, ...], ...]] = None

    def __post_init__(self):
        if self.bad_words_ids is not None:
            object.__setattr__(
                self, "bad_words_ids",
                tuple(tuple(int(t) for t in seq)
                      for seq in self.bad_words_ids))


def load_config(path: str) -> OtterConfig:
    with open(path) as f:
        return OtterConfig.from_dict(json.load(f))


def save_config(cfg: OtterConfig, path: str) -> None:
    with open(path, "w") as f:
        f.write(cfg.to_json())
