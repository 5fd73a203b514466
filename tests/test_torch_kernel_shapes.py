"""Which of the port's kernels refuse which model configuration on the
card. The wrappers never fall back to the plain version for a CUDA tensor,
so a shape a kernel refuses makes that model raise there. This walks every
preset of `config.PRESETS`, `FuyuConfig` and the head dims of idefics-9b
(ViT-H/14 tower 1280 / 16 = 80, perceiver 96: `otter_tpu/config.py:389,
405-407`; the port has no idefics config yet) through the kernels' own
guards and pins the refusals that remain, so that any change shows."""

import pytest
import torch

from otter_tpu_torch import config
from otter_tpu_torch.ops import decode_attention as da
from otter_tpu_torch.ops import flash_attention as fa
from otter_tpu_torch.ops import megakernel as mk
from otter_tpu_torch.ops import quant

# (model, kernel) -> why it refuses; every other pair is taken
REFUSED = {
    ("mpt30b", "decode_attention"): "head dim 112",
    ("mpt30b", "megakernel"): "head dim 112",
}
IDEFICS_HEAD_DIMS = {"vision": 80, "perceiver": 96, "text": 128, "xattn": 128}


def _flash_takes(d: int) -> bool:
    try:
        fa.check_kernel_inputs(d, torch.bfloat16)
    except ValueError:
        return False
    return True


def _models():
    for name, factory in config.PRESETS.items():
        cfg = factory()
        yield name, cfg.text, {
            "vision": cfg.vision.head_dim, "perceiver": cfg.perceiver.dim_head,
            "xattn": cfg.xattn_dim_head, "text": cfg.text.head_dim}
    fuyu = config.FuyuConfig()
    yield "fuyu-8b", fuyu.text, {"text": fuyu.text.head_dim}


def _refusals(name, text, head_dims):
    out = {}
    for site, d in head_dims.items():
        if not _flash_takes(d):
            out[(name, "flash")] = f"{site} head dim {d}"
    d = text.head_dim
    if d not in da.KERNEL_HEAD_DIMS:
        out[(name, "decode_attention")] = f"head dim {d}"
    if d not in mk.KERNEL_HEAD_DIMS:
        out[(name, "megakernel")] = f"head dim {d}"
    k, h = text.hidden_size, text.mlp_dim
    if quant.int4_mlp_refusal(1, k, h, k) is not None:
        out[(name, "int4_mlp")] = f"K = {k} is not a multiple of 32"
    for site, hid in _mlp_sites(name, text):
        for m in (1, 8, 32):
            if quant.int8_mlp_refusal(m, k, hid, k) is not None:
                out[(name, "int8_mlp")] = f"{site} K = {k}, H = {hid}"
    return out


def _mlp_sites(name, text):
    """The decoder MLP and, where the model has one, the xattn FF: the two
    sites that run the fused int8 MLP at decode."""
    yield "decoder MLP", text.mlp_dim
    if name in config.PRESETS:
        yield "xattn FF", text.hidden_size * config.PRESETS[name]().xattn_ff_mult


def test_refusals_by_preset():
    found = {}
    for name, text, head_dims in _models():
        found.update(_refusals(name, text, head_dims))
    assert found == REFUSED


@pytest.mark.parametrize("site,d", sorted(IDEFICS_HEAD_DIMS.items()))
def test_flash_takes_idefics_head_dims(site, d):
    assert _flash_takes(d), (site, d)


@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
def test_flash_takes_every_multiple_of_16(d):
    assert _flash_takes(d)


@pytest.mark.parametrize("d", [8, 24, 72, 136, 256])
def test_flash_refuses_other_head_dims(d):
    with pytest.raises(ValueError, match="head dim"):
        fa.check_kernel_inputs(d, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_flash_takes_bf16_only(dtype):
    with pytest.raises(TypeError, match="bf16"):
        fa.check_kernel_inputs(64, torch.bfloat16, dtype)


def test_int4_mlp_refusal_names_the_shape():
    assert quant.int4_mlp_refusal(8, 4096, 16384, 4096) is None
    # falcon7b's widths: K % 128 != 0, taken since the kernel steps K / 2
    # in 16-row k steps
    assert quant.int4_mlp_refusal(8, 4544, 18176, 4544) is None
    assert "K=4560" in quant.int4_mlp_refusal(8, 4560, 18176, 4560)
    assert "H=18240" in quant.int4_mlp_refusal(8, 4544, 18240, 4544)
    assert "N=4560" in quant.int4_mlp_refusal(8, 4544, 18176, 4560)
    assert "M=33" in quant.int4_mlp_refusal(33, 4096, 16384, 4096)


def test_int8_mlp_refusal_names_the_shape():
    assert quant.int8_mlp_refusal(32, 4544, 18176, 4544) is None
    assert quant.int8_mlp_refusal(8, 7168, 28672, 7168) is None
    assert "M=33" in quant.int8_mlp_refusal(33, 4096, 16384, 4096)
    assert "K=4100" in quant.int8_mlp_refusal(8, 4100, 16384, 4096)
    assert "H=16400" in quant.int8_mlp_refusal(8, 4096, 16400, 4096)
    assert "N=4104" in quant.int8_mlp_refusal(8, 4096, 16384, 4104)


@pytest.mark.parametrize("name", sorted(config.PRESETS) + ["fuyu-8b"])
def test_int8_mlp_takes_every_preset_mlp(name):
    text = (config.FuyuConfig() if name == "fuyu-8b"
            else config.PRESETS[name]()).text
    for site, hid in _mlp_sites(name, text):
        for m in (1, 8, 32):
            assert quant.int8_mlp_refusal(m, text.hidden_size, hid,
                                          text.hidden_size) is None, (site, m)


def _megakernel_presets():
    """The presets whose decoder layer the megakernel route takes: MPT's
    ALiBi attention without q/k LayerNorm, heads == kv heads, a head dim
    the kernel has."""
    for name, factory in sorted(config.PRESETS.items()):
        text = factory().text
        if text.pos == "alibi" and not text.qk_ln \
                and text.num_attention_heads == text.kv_heads \
                and text.head_dim in mk.KERNEL_HEAD_DIMS:
            yield name, text


def test_megakernel_presets_are_known():
    assert [name for name, _ in _megakernel_presets()] == ["mpt7b"]


@pytest.mark.parametrize("name,text", list(_megakernel_presets()))
def test_megakernel_attention_split_covers_each_span_once(name, text):
    # the kernel cuts [0, pos) as split_chunks does, with the plan that
    # attention_plan gives for the cache length: every row below pos in
    # exactly one chunk, at most `splits` chunks, and a grid of one wave
    h, dh = text.num_attention_heads, text.head_dim
    wave = da.SM_COUNT * da.CTAS_PER_SM
    for cache_len in (256, 1024, text.max_seq_len):
        for b in range(1, 9):
            splits, min_rows = mk.attention_plan(b, h, cache_len, dh)
            assert splits * b * h <= wave, (cache_len, b, splits)
            poss = {0, 1, min_rows - 1, min_rows, min_rows + 1,
                    cache_len // 2, cache_len - 1,
                    *range(0, cache_len, 37)}
            for pos in sorted(p for p in poss if 0 <= p < cache_len):
                chunks = da.split_chunks(0, pos, splits, min_rows)
                assert len(chunks) <= splits
                rows = [r for lo, hi in chunks for r in range(lo, hi)]
                assert rows == list(range(pos)), (cache_len, b, pos)
                assert all(hi - lo >= min(min_rows, pos)
                           for lo, hi in chunks[:-1])


@pytest.mark.parametrize("name", sorted(config.PRESETS))
def test_split_k_rows_keeps_one_wave(name):
    # the tensor-core split-K product at every preset's qkv and
    # out-projection widths: a grid within one wave of the CTAs an SM
    # holds (three at M <= 8, two above), whole 128-row stages a CTA
    d = config.PRESETS[name]().text.hidden_size
    for n in (3 * d, d):
        for m in (1, 8, 9, 32):
            splits = quant.split_k_rows(d, n, m)
            per_sm = 3 if m <= 8 else 2
            assert (n // 128) * splits <= per_sm * da.SM_COUNT \
                or splits == 1
            assert splits == 1 or d % (128 * splits) == 0


def test_split_k_rows_at_mpt7b():
    assert [quant.split_k_rows(4096, n, m) for n, m in
            ((12288, 8), (4096, 8), (12288, 32), (4096, 32))] == [4, 8, 2, 8]
