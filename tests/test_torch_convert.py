"""Port parity: the HF checkpoint converter (`models/convert.py`, HF side)
against the JAX package's. The rule tables give the JAX `hf_to_flax`'s
{path: array} exactly on HF-named tiny state_dicts of every arch and of
idefics;
`port_to_hf` inverts them; the partial load, its errors and
`from_pretrained` behave as JAX's on checkpoint files written in the test
(`.bin` and `.safetensors`); nothing is downloaded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from otter_tpu import api as japi
from otter_tpu import config as jcfg
from otter_tpu.models import convert as jconvert
from otter_tpu.ops.quant import quantize_params as jax_quantize_params
from otter_tpu_torch import api as tapi
from otter_tpu_torch.config import FuyuConfig
from otter_tpu_torch.models import convert
from otter_tpu_torch.models.fuyu import FuyuVLM
from otter_tpu_torch.models.idefics import IdeficsVLM
from otter_tpu_torch.models.otter import OtterVLM
from otter_tpu_torch.serve.worker import (load_fuyu_model,
                                          load_idefics_model,
                                          load_otter_model)
from torch_parity_helpers import (ARCH_CASES, idefics_port_cfg,
                                  jax_tiny_train, port_cfg)

LOGIT_TOL = 1e-3   # tests/test_torch_vlm.py's f32 logit bar


def _otter_cfg(arch: str):
    """The tiny Otter config with the decoder of `arch` (JAX's)."""
    base = jcfg.OtterConfig.tiny("mpt" if arch == "mpt" else "llama")
    if arch == "falcon":
        text = ARCH_CASES["falcon"]().replace(num_hidden_layers=4)
        base = base.replace(text=text)
    return base


def _bf16_exact(x: np.ndarray) -> np.ndarray:
    """f32 values that bf16 holds exactly (a bf16 model loads them
    unrounded, so it quantizes what an f32 model does)."""
    return torch.tensor(x).bfloat16().float().numpy()


def _random_flat(model, seed: int):
    """{flax path: f32 numpy} of random bf16-exact values in `model`'s
    shapes."""
    rng = np.random.default_rng(seed)
    return {n.replace(".", "/"): _bf16_exact(
        rng.standard_normal(tuple(t.shape)).astype(np.float32))
            for n, t in model.named_parameters()}


def _otter_flat(arch: str, seed: int = 0):
    cfg = _otter_cfg(arch)
    meta = OtterVLM(port_cfg(cfg), dtype=torch.float32, device="meta")
    return cfg, _random_flat(meta, seed)


def _fuyu_flat(seed: int = 0):
    cfg = jcfg.FuyuConfig.tiny()
    meta = FuyuVLM(FuyuConfig.from_dict(cfg.to_dict()), dtype=torch.float32,
                   device="meta")
    return cfg, _random_flat(meta, seed)


def _idefics_flat(seed: int = 0):
    cfg = jcfg.idefics_tiny()
    meta = IdeficsVLM(idefics_port_cfg(cfg), dtype=torch.float32,
                      device="meta")
    return cfg, _random_flat(meta, seed)


def _assert_same(port: dict, ref: dict):
    assert set(port) == set(ref)
    for k, v in ref.items():
        got = port[k]
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert got.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)


@pytest.mark.parametrize("arch", ["mpt", "llama", "falcon"])
def test_otter_rules_match_jax(arch):
    """HF names from the JAX package's `flax_to_hf`; both `hf_to_*` give
    the same paths and arrays, and `port_to_hf` gives the JAX names and
    arrays back (the round trip is the identity both ways)."""
    cfg, flat = _otter_flat(arch)
    hf = jconvert.flax_to_hf(flat, cfg)
    assert len(hf) == len(flat)
    ref = jconvert.hf_to_flax(hf, cfg, strict=True)
    tcfg = port_cfg(cfg)
    got = dict(convert.hf_to_port(hf, tcfg, strict=True))
    _assert_same(got, ref)
    _assert_same(got, flat)
    _assert_same(convert.port_to_hf(got, tcfg), hf)
    # the flax paths with the "params/" root, as RandomParams gives them
    rooted = {"params/" + k: torch.from_numpy(v) for k, v in flat.items()}
    _assert_same(convert.port_to_hf(rooted, tcfg), hf)


def test_rule_names_look_like_the_reference():
    cfg, flat = _otter_flat("mpt")
    hf = convert.port_to_hf(flat, port_cfg(cfg))
    assert "lang_encoder.transformer.wte.weight" in hf
    assert ("lang_encoder.transformer.blocks.0.decoder_layer.attn.Wqkv."
            "weight") in hf
    assert "vision_encoder.vision_model.pre_layrnorm.weight" in hf
    w = hf["lang_encoder.transformer.blocks.0.decoder_layer.attn.Wqkv."
           "weight"]
    assert tuple(w.shape) == (3 * cfg.text.hidden_size,
                              cfg.text.hidden_size)
    conv = hf["vision_encoder.vision_model.embeddings.patch_embedding."
              "weight"]
    assert tuple(conv.shape) == (cfg.vision.hidden_size, 3,
                                 cfg.vision.patch_size, cfg.vision.patch_size)


def _refactored(name: str) -> str:
    """An adept/fuyu-8b name as post-refactor transformers names it."""
    if name.startswith("language_model.model."):
        return "model.language_model." + name[len("language_model.model."):]
    if name == "language_model.lm_head.weight":
        return "lm_head.weight"
    return "model." + name   # vision_embed_tokens


@pytest.mark.parametrize("vintage", ["adept", "refactored"])
def test_fuyu_rules_match_jax(vintage):
    """adept/fuyu-8b names (the persimmon qkv interleaved per head) from
    the port's `port_to_hf`, in either checkpoint vintage: the port's
    `fuyu_hf_to_port` gives JAX's `fuyu_hf_to_flax` exactly and the
    original parameters back."""
    cfg, flat = _fuyu_flat()
    heads = cfg.text.num_attention_heads
    hf = convert.port_to_hf(flat, None, rules=convert.fuyu_rules(heads))
    assert len(hf) == len(flat)
    hf = {k: v.numpy() for k, v in hf.items()}
    if vintage == "refactored":
        hf = {_refactored(k): v for k, v in hf.items()}
        assert "model.language_model.layers.0.self_attn.dense.weight" in hf
    ref = jconvert.fuyu_hf_to_flax(hf, strict=True, num_heads=heads)
    got = dict(convert.fuyu_hf_to_port(hf, strict=True, num_heads=heads))
    _assert_same(got, ref)
    _assert_same(got, flat)


def test_idefics_rules_match_jax():
    """HF `IdeficsForVisionText2Text` names from the JAX package's
    `flax_to_hf(..., rules=idefics_rules(cfg))`: the port's
    `idefics_hf_to_port` gives JAX's `hf_to_flax` with the same rules
    exactly and the original parameters back, and `port_to_hf` (which
    takes the idefics rules for an `IdeficsModelConfig`) the HF names and
    arrays."""
    cfg, flat = _idefics_flat()
    rules = jconvert.idefics_rules(cfg)
    hf = jconvert.flax_to_hf(flat, cfg, rules=rules)
    assert len(hf) == len(flat)
    assert "model.gated_cross_attn_layers.1.alpha_dense" in hf
    assert "lm_head.additional_fc.weight" in hf
    ref = jconvert.hf_to_flax(hf, cfg, rules=rules, strict=True)
    tcfg = idefics_port_cfg(cfg)
    got = dict(convert.idefics_hf_to_port(hf, tcfg, strict=True))
    _assert_same(got, ref)
    _assert_same(got, flat)
    _assert_same(convert.port_to_hf(got, tcfg), hf)
    rooted = {"params/" + k: torch.from_numpy(v) for k, v in flat.items()}
    _assert_same(convert.port_to_hf(rooted, tcfg), hf)


def test_idefics_worker_load_matches_jax(tmp_path):
    """The worker's idefics start-up (`load_idefics_model`) from an
    HF-named checkpoint: at `--load-bit int8` (and int4, which loads the
    same) the tensors of JAX's `hf_to_flax` with the idefics rules under
    `quantize_params(..., patterns=FROZEN_DECODER_PATTERNS)` (decoder
    layers int8, the head float: the JAX worker's default patterns would
    quantize the head, ROADMAP Queue 3); at fp32 the parameters
    themselves."""
    from otter_tpu.ops.quant import FROZEN_DECODER_PATTERNS
    cfg, flat = _idefics_flat(4)
    tcfg = idefics_port_cfg(cfg)
    path = str(tmp_path / "idefics.safetensors")
    convert.save_state_dict(convert.port_to_hf(flat, tcfg), path)
    conv = jconvert.hf_to_flax(jconvert.load_state_dict(path), cfg,
                               rules=jconvert.idefics_rules(cfg),
                               dtype=np.float32)
    tree = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in conv.items()}, sep="/")
    tree = jax_quantize_params(tree, patterns=FROZEN_DECODER_PATTERNS)
    ref = {k: np.asarray(v) for k, v in
           traverse_util.flatten_dict(tree, sep="/").items()}
    assert "lm_head/kernel" in ref and "layers_0/attn/q_proj/kernel_q" in ref
    for bits in ("int8", "int4"):
        model, mcfg = load_idefics_model(path, tcfg, load_bit=bits,
                                         device="cpu")
        assert mcfg.text.quant == bits and mcfg.text.decode_kernel == "auto"
        assert model.dtype == torch.bfloat16
        _assert_same(convert.export_flax_params(model), ref)
    plain, _ = load_idefics_model(path, tcfg, load_bit="fp32", device="cpu")
    _assert_same(convert.export_flax_params(plain), flat)


def test_strict_conversion_names_unmatched_keys():
    cfg, flat = _otter_flat("mpt")
    hf = jconvert.flax_to_hf(flat, cfg)
    hf["lang_encoder.transformer.blocks.0.mystery.weight"] = np.zeros(2)
    with pytest.raises(KeyError, match="mystery"):
        jconvert.hf_to_flax(hf, cfg, strict=True)
    with pytest.raises(KeyError, match="mystery"):
        convert.hf_to_port(hf, port_cfg(cfg), strict=True)
    lazy = convert.hf_to_port(hf, port_cfg(cfg))    # not strict: dropped
    assert set(lazy) == set(flat)


@pytest.mark.parametrize("fmt", [".bin", ".safetensors"])
def test_state_dict_files_keep_dtypes(tmp_path, fmt):
    """Both file formats read back what was written, bf16 kept as bf16
    (JAX's loader widens it to f32), one tensor at a time; a directory of
    shards reads as one state_dict."""
    sd = {"a.weight": torch.randn(3, 4, dtype=torch.bfloat16),
          "b.bias": torch.randn(5)}
    convert.save_state_dict({"a.weight": sd["a.weight"]},
                            str(tmp_path / f"part1{fmt}"))
    convert.save_state_dict({"b.bias": sd["b.bias"]},
                            str(tmp_path / f"part2{fmt}"))
    back = convert.load_state_dict(str(tmp_path))
    assert sorted(back) == ["a.weight", "b.bias"]
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v)
    ref = jconvert.load_state_dict(str(tmp_path))
    np.testing.assert_array_equal(back["a.weight"].float().numpy(),
                                  ref["a.weight"])


# ── loading into models ──────────────────────────────────────────────

def _write(hf: dict, path):
    convert.save_state_dict({k: torch.from_numpy(np.asarray(v))
                             for k, v in hf.items()}, str(path))
    return str(path)


def _partial_hf(seed: int):
    """A trainer's checkpoint of the tiny MPT model: only the perceiver
    and the gated xattn blocks, new random values."""
    cfg, flat = _otter_flat("mpt", seed)
    hf = jconvert.flax_to_hf(flat, cfg)
    return {k: v for k, v in hf.items()
            if k.startswith("perceiver.") or "gated_cross_attn" in k}


def test_partial_load_matches_jax(tmp_path):
    """A checkpoint of the trainable tensors only: the port fills those
    into the model's existing tensors and leaves the others, as JAX's
    `load_otter_checkpoint` does to its tree."""
    cfg, _, params, flat = jax_tiny_train(0)
    path = _write(_partial_hf(7), tmp_path / "trained.bin")
    ref = jconvert.load_otter_checkpoint(path, cfg, {"params": params})
    ref = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        ref["params"], sep="/").items()}
    model = OtterVLM(port_cfg(cfg), dtype=torch.float32, device="cpu")
    convert.load_flax_params(model, flat)
    convert.load_otter_checkpoint(path, port_cfg(cfg), model)
    got = convert.export_flax_params(model)
    _assert_same(got, ref)
    changed = {k for k in ref if not np.array_equal(ref[k], flat[k])}
    assert changed and all(k.startswith(("perceiver/", "lang_encoder/xattn"))
                           for k in changed)


def test_load_errors_match_jax(tmp_path):
    """A checkpoint of another arch matches nothing, and a tensor of the
    wrong shape is refused: ValueError on both sides."""
    cfg, _, params, flat = jax_tiny_train(0)
    model = OtterVLM(port_cfg(cfg), dtype=torch.float32, device="cpu")
    llama_cfg, llama_flat = _otter_flat("llama")
    llama_hf = {k: v for k, v in
                jconvert.flax_to_hf(llama_flat, llama_cfg).items()
                if k.startswith("lang_encoder.model.layers.0.")}
    wrong = _write(llama_hf, tmp_path / "llama.bin")
    with pytest.raises(ValueError, match="matched 0"):
        jconvert.load_otter_checkpoint(wrong, cfg, {"params": params})
    with pytest.raises(ValueError, match="matched 0"):
        convert.load_otter_checkpoint(wrong, port_cfg(cfg), model)
    hf = _partial_hf(3)
    name = "perceiver.latents"
    hf[name] = np.zeros((hf[name].shape[0] + 1,) + hf[name].shape[1:],
                        np.float32)
    bad = _write(hf, tmp_path / "bad.bin")
    with pytest.raises(ValueError, match="shape"):
        jconvert.load_otter_checkpoint(bad, cfg, {"params": params})
    with pytest.raises(ValueError, match="shape"):
        convert.load_otter_checkpoint(bad, port_cfg(cfg), model)


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """The tiny MPT model's unquantized weights (gates moved off 0; rounded
    to bf16-exact f32) as an HF checkpoint in both formats, and JAX's
    logits of it through `from_pretrained` (f32)."""
    cfg, _, _, flat = jax_tiny_train(0)
    hf = jconvert.flax_to_hf({k: _bf16_exact(v) for k, v in flat.items()},
                             cfg)
    d = tmp_path_factory.mktemp("ckpt")
    paths = {fmt: _write(hf, d / f"model{fmt}")
             for fmt in (".bin", ".safetensors")}
    rng = np.random.default_rng(5)
    size = cfg.vision.image_size
    vx = rng.standard_normal((2, 1, 1, 3, size, size)).astype(np.float32)
    ids = rng.integers(0, 240, (2, 10)).astype(np.int32)
    ids[:, 0] = cfg.media_token_id
    ref = japi.OtterForConditionalGeneration.from_pretrained(
        paths[".bin"], config=cfg, dtype=jnp.float32)
    _, logits = ref(vx, ids)
    return cfg, hf, paths, vx, ids, np.asarray(logits)


@pytest.mark.parametrize("fmt", [".bin", ".safetensors"])
def test_from_pretrained_logits_match_jax(tiny_checkpoint, fmt):
    cfg, _, paths, vx, ids, ref = tiny_checkpoint
    model = tapi.OtterForConditionalGeneration.from_pretrained(
        paths[fmt], config=port_cfg(cfg), dtype=torch.float32, device="cpu")
    _, logits = model(vx, ids)
    np.testing.assert_allclose(logits.numpy(), ref, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_worker_int8_load_matches_jax_worker(tiny_checkpoint):
    """The worker's start-up at `--load-bit int8` (zeros, the checkpoint,
    each kernel quantized as it loads) against the JAX worker's (a zero
    tree, `load_otter_checkpoint`, `quantize_params`): the same int8
    kernels and scales, and the same logits within the f32 bar."""
    cfg, _, paths, vx, ids, _ = tiny_checkpoint
    zeros = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), jax.eval_shape(
            jax_model_init(cfg), jax.random.PRNGKey(0)))
    loaded = jconvert.load_otter_checkpoint(paths[".bin"], cfg, zeros,
                                            dtype=jnp.float32)
    qparams = {"params": jax_quantize_params(loaded["params"])}
    qcfg = cfg.replace(text=cfg.text.replace(quant="int8",
                                             decode_kernel="auto"))
    ref = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        qparams["params"], sep="/").items()}
    model = OtterVLM(port_cfg(qcfg), dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            t.zero_()
    convert.load_otter_checkpoint(paths[".safetensors"], port_cfg(cfg),
                                  model)
    _assert_same(convert.export_flax_params(model), ref)
    from otter_tpu.models.otter import OtterVLM as JaxOtterVLM
    jlogits, _, _ = jax.jit(JaxOtterVLM(qcfg).apply)(
        qparams, jnp.asarray(vx), jnp.asarray(ids))
    with torch.no_grad():
        logits, _, _ = model(torch.from_numpy(vx),
                             torch.from_numpy(ids).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    # the worker's own loader: bf16 weights (the checkpoint's values are
    # bf16-exact), the same int8 kernels and scales
    wmodel, wcfg = load_otter_model(paths[".bin"], port_cfg(cfg),
                                    load_bit="int8", device="cpu")
    assert wcfg.text.quant == "int8" and wcfg.text.decode_kernel == "auto"
    assert wmodel.dtype == torch.bfloat16
    _assert_same(convert.export_flax_params(wmodel), ref)


def jax_model_init(cfg):
    """flax's init of the tiny unquantized OtterVLM as a function of the
    key (for `eval_shape`: the JAX worker's zero tree)."""
    from otter_tpu.models.otter import OtterVLM as JaxOtterVLM
    size = cfg.vision.image_size
    return lambda key: JaxOtterVLM(cfg).init(
        key, jnp.zeros((1, 1, 1, 3, size, size), jnp.float32),
        jnp.zeros((1, 8), jnp.int32))


def test_fuyu_worker_load_matches_jax(tmp_path):
    """The worker's fuyu start-up (`load_fuyu_model`, int8 weights and the
    int8 embedding table) from an adept-named checkpoint: the tensors JAX's
    fuyu worker builds from the same file (`fuyu_hf_to_flax`,
    `quantize_params`, `quantize_embed`)."""
    from otter_tpu.ops.quant import quantize_embed as jax_quantize_embed
    cfg, flat = _fuyu_flat(3)
    heads = cfg.text.num_attention_heads
    hf = convert.port_to_hf(flat, None, rules=convert.fuyu_rules(heads))
    path = str(tmp_path / "fuyu.safetensors")
    convert.save_state_dict(hf, path)
    conv = jconvert.fuyu_hf_to_flax(jconvert.load_state_dict(path),
                                    dtype=np.float32, num_heads=heads)
    tree = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in conv.items()}, sep="/")
    tree = jax_quantize_embed(jax_quantize_params(tree))
    ref = {k: np.asarray(v) for k, v in
           traverse_util.flatten_dict(tree, sep="/").items()}
    tcfg = FuyuConfig.from_dict(cfg.to_dict())
    model, mcfg = load_fuyu_model(path, tcfg, load_bit="int8",
                                  quant_embed=True, device="cpu")
    assert mcfg.text.quant == "int8" and mcfg.text.quant_embed
    _assert_same(convert.export_flax_params(model), ref)
    plain, _ = load_fuyu_model(path, tcfg, load_bit="fp32", device="cpu")
    _assert_same(convert.export_flax_params(plain), flat)
