"""Port parity of the init zoo (`otter_tpu_torch.models.init_fns`) against
the JAX package's (`otter_tpu.models.init_fns`) on a small MPT decoder:
the two draw from different generators, so each leaf is held by its
distribution, as the JAX package's own test holds it to the reference's
torch zoo (std within 12%, mean within 5 standard errors, constant leaves
exact); the residual division within 5%; the fans on a non-square
kernel."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from otter_tpu.config import TextConfig as JaxTextConfig
from otter_tpu.models.decoder import Decoder as JaxDecoder
from otter_tpu.models.init_fns import INIT_REGISTRY as JAX_REGISTRY
from otter_tpu.models.init_fns import init_decoder_params as jax_init
from otter_tpu_torch.config import TextConfig
from otter_tpu_torch.models.convert import export_flax_params
from otter_tpu_torch.models.decoder import Decoder
from otter_tpu_torch.models.init_fns import (INIT_REGISTRY,
                                             init_decoder_params)

D, HEADS, LAYERS, VOCAB = 128, 4, 3, 512


def _jcfg():
    return JaxTextConfig(arch="mpt", vocab_size=VOCAB, hidden_size=D,
                         num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                         intermediate_size=4 * D, max_seq_len=32, pos="alibi",
                         norm_type="low_precision_layernorm", act="gelu",
                         tie_embeddings=True, no_bias=True)


@functools.lru_cache(maxsize=None)
def _jax_params0():
    return JaxDecoder(_jcfg()).init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 8), jnp.int32))["params"]


def _jax_tree(name, icfg):
    tree = jax_init(jax.random.PRNGKey(1), _jax_params0(), _jcfg(),
                    init_config=dict(icfg, name=name))
    return {k: np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _port_tree(name, icfg, seed=1, cfg=None):
    cfg = cfg or TextConfig.from_dict(_jcfg().to_dict())
    model = Decoder(cfg, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    init_decoder_params(gen, model, cfg, init_config=dict(icfg, name=name))
    return export_flax_params(model)


SCHEMES = [
    ("baseline_", {"init_std": 0.04}),
    ("small_init_", {}),
    ("neox_init_", {}),
    ("kaiming_normal_", {"fan_mode": "fan_in",
                         "init_nonlinearity": "relu", "init_gain": 0.0}),
    ("kaiming_uniform_", {"fan_mode": "fan_in",
                          "init_nonlinearity": "relu", "init_gain": 0.0}),
    ("xavier_uniform_", {"init_gain": 1.0}),
    ("xavier_normal_", {"init_gain": 1.0}),
    ("default_", {}),
    ("small_init_", {"emb_init_std": 0.3}),
    ("small_init_", {"emb_init_uniform_lim": [-0.2, 0.1]}),
    ("small_init_", {"init_div_is_residual": 7.0}),
]


def test_registry_matches_jax():
    assert INIT_REGISTRY == JAX_REGISTRY


@pytest.mark.parametrize("name,icfg", SCHEMES,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(SCHEMES)])
def test_scheme_matches_jax(name, icfg):
    ref = _jax_tree(name, icfg)
    ours = _port_tree(name, icfg)
    assert set(ours) == set(ref)
    for path in sorted(ours):
        a = ours[path].astype(np.float64)
        b = ref[path].astype(np.float64)
        assert a.shape == b.shape, path
        sa, sb = a.std(), b.std()
        if sb < 1e-12:   # constant leaves: norm scales 1, zeros
            np.testing.assert_array_equal(a, b, err_msg=path)
            continue
        assert abs(sa - sb) / sb < 0.12, (path, sa, sb)
        assert abs(a.mean() - b.mean()) < 5 * sb / math.sqrt(a.size), \
            (path, a.mean(), b.mean())


def test_residual_division_matches_jax():
    want = math.sqrt(2 * LAYERS)
    for tree in (_port_tree, _jax_tree):
        base = tree("small_init_", {"init_div_is_residual": False})
        div = tree("small_init_", {"init_div_is_residual": True})
        for path in base:
            if path.endswith(("attn/out_proj/kernel",
                              "ffn/down_proj/kernel")):
                ratio = base[path].std() / div[path].std()
                assert abs(ratio - want) / want < 0.05, (path, ratio)


@pytest.mark.parametrize("fan_mode", ["fan_in", "fan_out"])
def test_fans_on_a_non_square_kernel(fan_mode):
    """`ffn/up_proj/kernel` is [D, 4D] ([in, out], flax's layout and the
    port's): kaiming_normal's std is gain / sqrt(D) by fan_in and
    gain / sqrt(4D) by fan_out, on both sides. The tied embedding [V, D]
    draws on its transpose (fan_in = D)."""
    icfg = {"fan_mode": fan_mode, "init_nonlinearity": "relu",
            "init_gain": 0.0}
    fan = {"fan_in": D, "fan_out": 4 * D}[fan_mode]
    emb_fan = {"fan_in": D, "fan_out": VOCAB}[fan_mode]
    for tree in (_port_tree("kaiming_normal_", icfg),
                 _jax_tree("kaiming_normal_", icfg)):
        k = tree["layers_0/ffn/up_proj/kernel"]
        assert k.shape == (D, 4 * D)
        np.testing.assert_allclose(k.std(), math.sqrt(2.0 / fan), rtol=0.05)
        np.testing.assert_allclose(tree["wte/embedding"].std(),
                                   math.sqrt(2.0 / emb_fan), rtol=0.05)


def test_fused_qkv_is_drawn_per_chunk():
    """Multiquery Wqkv [D, D + 2 * hd]: kaiming by fan_out draws q with
    fan D and k, v with fan hd, chunk by chunk, as JAX does."""
    cfg = TextConfig.from_dict(_jcfg().replace(num_kv_heads=1).to_dict())
    icfg = {"fan_mode": "fan_out", "init_nonlinearity": "relu",
            "init_gain": 0.0}
    w = _port_tree("kaiming_normal_", icfg, cfg=cfg)["layers_1/attn/Wqkv/kernel"]
    hd = D // HEADS
    assert w.shape == (D, D + 2 * hd)
    np.testing.assert_allclose(w[:, :D].std(), math.sqrt(2.0 / D), rtol=0.05)
    np.testing.assert_allclose(w[:, D:].std(), math.sqrt(2.0 / hd),
                               rtol=0.05)


def test_draws_follow_the_generator_and_refuse_what_jax_refuses():
    a = _port_tree("small_init_", {}, seed=4)
    b = _port_tree("small_init_", {}, seed=4)
    c = _port_tree("small_init_", {}, seed=5)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert any(not np.array_equal(a[k], c[k]) for k in a)
    with pytest.raises(ValueError, match="init_std"):
        _port_tree("baseline_", {})
    cfg = TextConfig.from_dict(_jcfg().replace(lora_rank=2).to_dict())
    with pytest.raises(NotImplementedError, match="lora_a"):
        _port_tree("small_init_", {}, cfg=cfg)
