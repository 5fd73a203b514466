"""Port parity of the LoRA adapters (`otter_tpu_torch.ops.lora`) against
the JAX package's (`otter_tpu.ops.lora`): the targets per arch, the
decoder's logits with the JAX weights carried across (f32 within 1e-5,
over an int8 base within 1e-4), the trainer's sets, the HF loader's
`base/` lookup and the export of a LoRA tree, and the fused decode routes
under LoRA (the megakernel refused, `fused_tail` keeping the adapter, as
the JAX routes do)."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from otter_tpu import config as jcfg
from otter_tpu.models import convert as jconvert
from otter_tpu.models.decoder import Decoder as JaxDecoder
from otter_tpu.models.decoder import init_cache as jinit_cache
from otter_tpu.models.otter import OtterVLM as JaxOtterVLM
from otter_tpu.ops.lora import LORA_TARGETS as JAX_TARGETS
from otter_tpu.ops.quant import quantize_params as jquantize
from otter_tpu.train import step as jstep
from otter_tpu_torch import config as tcfg
from otter_tpu_torch.models import convert
from otter_tpu_torch.models.decoder import Decoder, init_cache
from otter_tpu_torch.models.otter import OtterVLM
from otter_tpu_torch.ops import lora
from otter_tpu_torch.ops.quant import quantize_for
from otter_tpu_torch.train import step as tstep
from torch_parity_helpers import ARCH_CASES, port_cfg

RANK = 4


def _flat(tree):
    return {k: np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _text(arch):
    if arch in ("mpt", "mosaic_gpt"):
        return jcfg.OtterConfig.tiny("mpt").text.replace(arch=arch)
    return ARCH_CASES[{"persimmon": "persimmon", "falcon": "falcon",
                       "llama": "llama"}[arch]]()


@functools.lru_cache(maxsize=None)
def _jax_lora(arch, quant=None, seed=0):
    """(cfg, JAX LoRA decoder, its flat numpy params): the LoRA-free
    init's weights (quantized through JAX's `quantize_params` for int8)
    grafted under `base/`, `lora_a` from the LoRA init and `lora_b` random
    (0 at init would hide the adapter), norms and biases moved."""
    base = _text(arch)
    ids = jnp.zeros((1, 8), jnp.int32)
    plain = JaxDecoder(base).init(jax.random.PRNGKey(seed), ids)["params"]
    rng = np.random.default_rng(seed + 11)
    pflat = _flat(plain)
    for k, v in pflat.items():
        if k.endswith(("/bias", "/scale")):
            pflat[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    plain = traverse_util.unflatten_dict(pflat, sep="/")
    if quant == "int8":
        plain = jquantize(plain)
    src = _flat(plain)
    cfg = base.replace(quant=quant, lora_rank=RANK)
    flat = _flat(JaxDecoder(cfg).init(jax.random.PRNGKey(seed + 1),
                                      ids)["params"])
    for k in flat:
        if k.replace("/base/", "/") in src:
            flat[k] = src[k.replace("/base/", "/")]
        elif k.endswith("lora_b"):
            flat[k] = (0.05 * rng.standard_normal(flat[k].shape)).astype(
                np.float32)
    return cfg, JaxDecoder(cfg), flat


def _port_decoder(cfg, flat):
    model = Decoder(tcfg.TextConfig.from_dict(cfg.to_dict()),
                    dtype=torch.float32, device="cpu")
    convert.load_flax_params(model, flat)
    return model.eval()


@pytest.mark.parametrize("arch", sorted(JAX_TARGETS))
def test_targets_and_leaves_match_jax(arch):
    assert lora.LORA_TARGETS == JAX_TARGETS
    cfg, _, flat = _jax_lora(arch)
    model = _port_decoder(cfg, flat)
    names = set(convert.export_flax_params(model))
    assert names == set(flat)
    adapted = {k.split("/")[-2] for k in names if k.endswith("lora_a")}
    assert adapted == set(JAX_TARGETS[arch])
    # the adapters train and take no decay, as in JAX
    trainable = {k for k in names if tstep.path_is_trainable(k, True)}
    assert {k for k in trainable if "lora" in k} == {
        k for k in names if k.endswith(("lora_a", "lora_b"))}
    decay = tstep.weight_decay_mask(trainable)
    jdecay = _flat(jstep.weight_decay_mask(traverse_util.unflatten_dict(
        {k: 0 for k in trainable}, sep="/")))
    assert decay == {k: bool(v) for k, v in jdecay.items()}
    assert not any(decay[k] for k in decay if "lora" in k)


@pytest.mark.parametrize("arch,quant,tol", [("mpt", None, 1e-5),
                                            ("llama", None, 1e-5),
                                            ("mpt", "int8", 1e-4)])
def test_decoder_logits_match_jax(arch, quant, tol):
    cfg, jmodel, flat = _jax_lora(arch, quant)
    ids = np.random.default_rng(5).integers(0, 200, (2, 12)).astype(
        np.int32)
    params = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    ref, _ = jmodel.apply({"params": params}, jnp.asarray(ids))
    got, _ = _port_decoder(cfg, flat)(torch.from_numpy(ids).long())
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=tol * max(
        1.0, float(np.abs(ref).max())), rtol=0)


def test_zero_adapter_is_the_base_model():
    """B = 0 at init: a LoRA model loaded from the LoRA-free weights
    (`into_base`) gives the LoRA-free model's logits exactly, f32 and over
    an int8 base."""
    base = jcfg.OtterConfig.tiny("mpt").text
    plain = _flat(JaxDecoder(base).init(jax.random.PRNGKey(3), jnp.zeros(
        (1, 8), jnp.int32))["params"])
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 200, (2, 9))).long()
    for quant in (None, "int8"):
        pcfg = tcfg.TextConfig.from_dict(base.replace(quant=quant).to_dict())
        weights = quantize_for(pcfg, plain)
        ref_model = Decoder(pcfg, dtype=torch.float32, device="cpu")
        convert.load_flax_params(ref_model, weights)
        model = Decoder(pcfg.replace(lora_rank=RANK), dtype=torch.float32,
                        device="cpu")
        n = convert.load_flax_params(model, lora.into_base(weights, model),
                                     partial=True)
        assert n == len(weights)
        assert float(model.layers_0.attn.Wqkv.lora_a.detach().std()) > 0.01
        torch.testing.assert_close(model(ids)[0], ref_model(ids)[0],
                                   atol=0, rtol=0)


def _hf_checkpoint(tmp_path, seed=0):
    """An HF Otter checkpoint (f32) of the tiny LoRA-free model, and the
    model's flat params."""
    cfg = jcfg.OtterConfig.tiny("mpt")
    vx = jnp.zeros((1, 1, 1, 3, 28, 28), jnp.float32)
    ids = jnp.zeros((1, 8), jnp.int32)
    flat = _flat(JaxOtterVLM(cfg).init(jax.random.PRNGKey(seed), vx,
                                       ids)["params"])
    path = str(tmp_path / "otter.safetensors")
    convert.save_state_dict(convert.port_to_hf(flat, port_cfg(cfg)), path)
    return cfg, flat, path


def test_hf_base_lookup_loads_what_jax_loads(tmp_path):
    """`load_otter_checkpoint` into a LoRA OtterVLM: every tensor the JAX
    loader fills (the projection under `base/`) equal to JAX's, the
    adapters as they were. Over an int8 base the file's projection is
    quantized as JAX's `quantize_params` quantizes it."""
    cfg, plain, path = _hf_checkpoint(tmp_path)
    lcfg = cfg.replace(text=cfg.text.replace(lora_rank=RANK))
    vx = jnp.zeros((1, 1, 1, 3, 28, 28), jnp.float32)
    jinit = JaxOtterVLM(lcfg).init(jax.random.PRNGKey(9), vx,
                                   jnp.zeros((1, 8), jnp.int32))["params"]
    jloaded = _flat(jconvert.load_otter_checkpoint(path, lcfg, jinit))
    model = OtterVLM(port_cfg(lcfg), dtype=torch.float32, device="cpu")
    before = convert.export_flax_params(model)
    convert.load_otter_checkpoint(path, port_cfg(lcfg), model)
    got = convert.export_flax_params(model)
    assert set(got) == set(jloaded)
    bases = [k for k in got if "/Wqkv/base/" in k]
    assert len(bases) == cfg.text.num_hidden_layers
    for k, v in got.items():
        if k.endswith(("lora_a", "lora_b")):
            np.testing.assert_array_equal(v, before[k], err_msg=k)
        else:
            np.testing.assert_array_equal(v, jloaded[k], err_msg=k)

    qcfg = lcfg.replace(text=lcfg.text.replace(quant="int8"))
    qmodel = OtterVLM(port_cfg(qcfg), dtype=torch.float32, device="cpu")
    convert.load_otter_checkpoint(path, port_cfg(qcfg), qmodel)
    qgot = convert.export_flax_params(qmodel)
    jq = _flat(jquantize(traverse_util.unflatten_dict(plain, sep="/")))
    for k, v in jq.items():
        if "/attn/Wqkv/" in k:
            np.testing.assert_array_equal(
                qgot[k.replace("/Wqkv/", "/Wqkv/base/")], v, err_msg=k)


def test_export_of_a_lora_tree_does_what_jax_does():
    """The JAX export of a LoRA tree leaves out the LoRA-wrapped
    projections (no rule names `base/` or the adapters), so a checkpoint
    it writes has no attention projections (a fault of the reference,
    ROADMAP Queue 3). The port's export holds every tensor JAX's does,
    equal, and each wrapped projection with its adapter merged: the
    export of the LoRA-free decoder `merge_adapters` gives, whose logits
    are the LoRA decoder's."""
    cfg, _, flat = _jax_lora("mpt")
    ocfg = jcfg.OtterConfig.tiny("mpt")
    lang = {f"lang_encoder/{k}": v for k, v in flat.items()}
    ref = jconvert.flax_to_hf(lang, ocfg.replace(text=cfg))
    got = convert.port_to_hf(lang, port_cfg(ocfg.replace(text=cfg)))
    assert not any("Wqkv" in k for k in ref)
    assert {k for k in got if "Wqkv" in k} and set(ref) < set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)

    merged = lora.merge_adapters(flat, cfg.lora_alpha / cfg.lora_rank)
    plain_cfg = cfg.replace(lora_rank=0)
    want = convert.port_to_hf({f"lang_encoder/{k}": v
                               for k, v in merged.items()},
                              port_cfg(ocfg.replace(text=plain_cfg)))
    assert set(want) == set(got)
    for k in got:
        torch.testing.assert_close(torch.as_tensor(got[k]).float(),
                                   torch.as_tensor(want[k]).float(),
                                   atol=0, rtol=0, msg=k)
    ids = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 8)))
    torch.testing.assert_close(_port_decoder(plain_cfg, merged)(ids)[0],
                               _port_decoder(cfg, flat)(ids)[0],
                               atol=1e-5, rtol=1e-5)


def test_export_refuses_adapters_over_a_quantized_base(tmp_path):
    """An int8 base cannot take the adapter's product and the export
    leaves int8 leaves out: `port_to_hf` raises, and `sft.main` with
    `--save_hf_model` refuses before it trains."""
    from otter_tpu_torch.train import sft
    from otter_tpu_torch.train.args import TrainArgs
    cfg, _, flat = _jax_lora("mpt", "int8")
    ocfg = jcfg.OtterConfig.tiny("mpt")
    with pytest.raises(ValueError, match="quantized base"):
        convert.port_to_hf({f"lang_encoder/{k}": v for k, v in flat.items()},
                           port_cfg(ocfg.replace(text=cfg)))
    custom = tmp_path / "cfg.json"
    custom.write_text(json.dumps(tcfg.OtterConfig.tiny("mpt").replace(
        text=port_cfg(ocfg).text.replace(lora_rank=RANK, quant="int8")
    ).to_dict()))
    args = TrainArgs(model_config="tiny", customized_config=str(custom),
                     precision="fp32", save_hf_model=True)
    with pytest.raises(ValueError, match="--save_hf_model"):
        sft.main(args, tokenizer=object(), batches=[], device="cpu")


def test_megakernel_with_lora_raises_as_jax_does():
    """JAX: `add_fused_wqo` finds no `Wqkv/kernel_q` in a LoRA tree, and
    the first megakernel decode step raises for the missing operand. The
    port refuses the pair when the decoder is built."""
    cfg, _, flat = _jax_lora("mpt", "int8")
    mcfg = cfg.replace(megakernel=True, decode_kernel=False)
    from otter_tpu.ops.quant import add_fused_wqo
    params = add_fused_wqo(traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/"))
    assert not any("wqo" in k for k in _flat(params))
    ids = jnp.asarray(np.arange(1, 9)[None], jnp.int32)
    model = JaxDecoder(mcfg)
    _, cache = model.apply({"params": params}, ids,
                           cache=jinit_cache(mcfg, 1, 16, jnp.float32))
    with pytest.raises(Exception, match="wqo_q"):
        model.apply({"params": params}, ids[:, :1], cache=cache,
                    cache_pos=8, kv_valid=jnp.arange(16)[None] <= 8)
    with pytest.raises(ValueError, match="megakernel"):
        Decoder(tcfg.TextConfig.from_dict(mcfg.to_dict()),
                dtype=torch.float32, device="cpu")


def test_fused_tail_keeps_the_adapter_as_jax_does():
    """`fused_tail` runs the attention (LoRA on Wqkv included) and then the
    fused tail: a cached step's logits equal JAX's route within 1e-4, and
    differ from the adapter-free model's."""
    cfg, _, flat = _jax_lora("mpt", "int8")
    fcfg = cfg.replace(fused_tail=True, decode_kernel=False)
    params = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    ids = np.arange(1, 9, dtype=np.int32)[None]
    kv = np.arange(16)[None] <= 8
    jm = JaxDecoder(fcfg)
    _, jc = jm.apply({"params": params}, jnp.asarray(ids),
                     cache=jinit_cache(fcfg, 1, 16, jnp.float32))
    ref, _ = jm.apply({"params": params}, jnp.asarray(ids[:, :1]), cache=jc,
                      cache_pos=8, kv_valid=jnp.asarray(kv))
    outs = []
    for lora_b_scale in (1.0, 0.0):
        model = _port_decoder(fcfg, flat)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, lora.LoraDense):
                    m.lora_b.mul_(lora_b_scale)
            cache = init_cache(model.cfg, 1, 16, torch.float32, "cpu")
            model(torch.from_numpy(ids).long(), cache=cache)
            out, _ = model(torch.from_numpy(ids[:, :1]).long(), cache=cache,
                           cache_pos=8, kv_valid=torch.from_numpy(kv))
        outs.append(out.numpy())
    np.testing.assert_allclose(outs[0], np.asarray(ref), atol=1e-4, rtol=0)
    assert np.abs(outs[0] - outs[1]).max() > 1e-3
