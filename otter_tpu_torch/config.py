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
    """Decoder-only LM backbone. The port implements `arch="mpt"` (ALiBi,
    low-precision LayerNorm, fused Wqkv, tied embeddings, GELU MLP); the
    other fields are kept so configs load unchanged."""

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
