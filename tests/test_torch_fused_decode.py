"""Port parity of the fused decode layer as a whole: the tiny OtterVLM with
non-zero int8 weights and `megakernel=True` (or `fused_tail=True`) against
the JAX model built from the same parameters (prefill, then cached greedy
steps, f32 on the CPU), the conditions under which the megakernel route is
taken, its behaviour on left-padded rows, the weight bridge for the fused
leaves, and the decode bench at the tiny size."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.models.decoder import init_cache as jinit_cache
from otter_tpu_torch.config import OtterConfig
from otter_tpu_torch.models.convert import (export_flax_params,
                                            load_flax_params)
from otter_tpu_torch.models.decoder import init_cache
from otter_tpu_torch.models.otter import OtterVLM
from otter_tpu_torch.ops import megakernel as tmk
from otter_tpu_torch.ops import quant as tquant
from otter_tpu_torch.tools import bench_decode
from torch_parity_helpers import (inputs, jax_tiny, jax_tiny_fused, port_cfg,
                                  torch_tiny, torch_tiny_fused)

LOGIT_TOL = 1e-3   # the BASELINE.md logit-parity bar
L = 128


def test_int8_parity_weights_are_not_zero():
    _, _, _, flat = jax_tiny()
    kernels = [v for k, v in flat.items() if k.endswith("kernel_q")]
    assert len(kernels) == 26
    assert all(v.dtype == np.int8 and np.abs(v).max() == 127
               for v in kernels)


class _Counting:
    """Counts the calls of a kernel wrapper (its own launch counter counts
    kernel launches only, and the CPU takes the plain version)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0
        self.real = getattr(module, name)

    def __enter__(self):
        def wrapper(*a, **kw):
            self.calls += 1
            return self.real(*a, **kw)
        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


@functools.lru_cache(maxsize=None)
def _jax_fns(route):
    """Jitted (prefill, step) of the JAX model with `route` on."""
    _, jmodel, params, _ = jax_tiny_fused(route)
    prefill = jax.jit(lambda vx, ids, mask, cache: jmodel.apply(
        params, vx, ids, attention_mask=mask, cache=cache,
        head_last_only=True))
    step = jax.jit(lambda tok, lat, cache, pos, kv_valid, counts: jmodel.apply(
        params, None, tok, vis_latents=lat, cache=cache, cache_pos=pos,
        kv_valid=kv_valid, media_counts=counts))
    return prefill, step


def _prefill_torch(model, vx, ids, mask, cache_dtype=torch.float32):
    cache = init_cache(model.cfg.text, ids.shape[0], L, cache_dtype, "cpu")
    with torch.no_grad():
        logits, cache, lat = model(
            torch.from_numpy(vx), torch.from_numpy(ids).long(),
            attention_mask=torch.from_numpy(mask), cache=cache,
            head_last_only=True)
    return logits, cache, lat


def _step_torch(model, tok, lat, cache, pos, kv_valid, counts):
    with torch.no_grad():
        logits, cache, _ = model(
            None, torch.from_numpy(tok).long(), vis_latents=lat, cache=cache,
            cache_pos=pos, kv_valid=torch.from_numpy(kv_valid.copy()),
            media_counts=torch.from_numpy(counts))
    return logits


@pytest.mark.parametrize("route", ["megakernel", "fused_tail"])
def test_fused_decode_matches_jax(route):
    """Unpadded prompts, prefill + 3 cached greedy steps: logits within
    1e-3 of the JAX model's, the same greedy tokens, and every decoder
    layer of every step through the fused kernel's wrapper."""
    cfg, _, _, _ = jax_tiny_fused(route)
    tmodel = torch_tiny_fused(route)
    prefill, step = _jax_fns(route)
    b, p, steps = 2, 10, 3
    vx, ids = inputs(cfg, 21, b, p)
    mask = np.ones_like(ids)
    jl, jcache, jlat = prefill(jnp.asarray(vx), jnp.asarray(ids),
                               jnp.asarray(mask),
                               jinit_cache(cfg.text, b, L, jnp.float32))
    tl, tcache, tlat = _prefill_torch(tmodel, vx, ids, mask)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    counts = (ids == cfg.media_token_id).sum(-1).astype(np.int32)
    kv_valid = np.zeros((b, L), bool)
    kv_valid[:, :p] = True
    module, name = ((tmk, "decode_attn_megakernel") if route == "megakernel"
                    else (tquant, "int8_attn_tail"))
    with _Counting(module, name) as counted:
        for t in range(steps):
            tok = np.array(jl[:, -1].argmax(-1), np.int32)[:, None]
            assert (tl[:, -1].argmax(-1).numpy() == tok[:, 0]).all()
            kv_valid[:, p + t] = True
            jl, jcache, _ = step(jnp.asarray(tok), jlat, jcache, p + t,
                                 jnp.asarray(kv_valid), jnp.asarray(counts))
            tl = _step_torch(tmodel, tok, tlat, tcache, p + t, kv_valid,
                             counts)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert counted.calls == steps * cfg.text.num_hidden_layers
    for key in ("k", "v"):
        np.testing.assert_allclose(
            tcache[key][:, :, :, :p + steps].numpy(),
            np.asarray(jcache[key][:, :, :, :p + steps]), atol=1e-4,
            rtol=1e-4)


def test_megakernel_model_needs_the_fused_leaves():
    cfg, _, _, flat = jax_tiny_fused("megakernel")
    bare = {k: v for k, v in flat.items()
            if not k.endswith(("wqo_q", "wqo_scale"))}
    assert len(bare) == len(flat) - 2 * cfg.text.num_hidden_layers
    model = OtterVLM(port_cfg(cfg), dtype=torch.float32, device="cpu")
    with pytest.raises(KeyError, match="wqo"):
        load_flax_params(model, bare)
    # and a model without the route has no home for them
    plain_cfg = cfg.replace(text=cfg.text.replace(megakernel=False))
    model = OtterVLM(port_cfg(plain_cfg), dtype=torch.float32, device="cpu")
    with pytest.raises(KeyError, match="wqo"):
        load_flax_params(model, flat)


def test_fused_leaves_load_by_name_and_are_not_exported():
    """The JAX package's `add_fused_wqo(quantize_params(params))` loads
    into a `megakernel=True` port model byte for byte; the export leaves
    the derived leaves out, and the port's `add_fused_wqo` rebuilds them."""
    _, _, _, flat = jax_tiny_fused("megakernel")
    model = torch_tiny_fused("megakernel")
    state = dict(model.named_buffers())
    fused = [k for k in flat if k.endswith(("wqo_q", "wqo_scale"))]
    assert fused
    for k in fused:
        t = state[k[len("params/"):].replace("/", ".")]
        assert t.numpy().tobytes() == flat[k].tobytes()
    exported = export_flax_params(model)
    assert not [k for k in exported if "wqo" in k]
    assert set(exported) == {k[len("params/"):] for k in flat} \
        - {k[len("params/"):] for k in fused}
    rebuilt = tquant.add_fused_wqo(exported)
    for k in fused:
        assert rebuilt[k[len("params/"):]].tobytes() == flat[k].tobytes()


@pytest.mark.parametrize("why", ["int8 cache", "per-row cache_pos", "B=9"])
def test_megakernel_route_refused(why):
    """The route is taken only under the JAX module's conditions: an int8
    cache, per-row [B] cache positions and more than 8 rows fall to the
    composed path, which gives what a model without the flag gives."""
    cfg, _, _, _ = jax_tiny_fused("megakernel")
    fused, composed = torch_tiny_fused("megakernel"), torch_tiny(0, False)
    b, p = (9 if why == "B=9" else 2), 10
    vx, ids = inputs(cfg, 22, b, p)
    mask = np.ones_like(ids)
    cache_dtype = torch.int8 if why == "int8 cache" else torch.float32
    pos = (torch.full((b,), p, dtype=torch.long)
           if why == "per-row cache_pos" else p)
    counts = (ids == cfg.media_token_id).sum(-1).astype(np.int32)
    kv_valid = np.zeros((b, L), bool)
    kv_valid[:, :p + 1] = True
    tok = np.full((b, 1), 7, np.int32)
    outs = []
    with _Counting(tmk, "decode_attn_megakernel") as counted:
        for model in (fused, composed):
            _, cache, lat = _prefill_torch(model, vx, ids, mask, cache_dtype)
            outs.append(_step_torch(model, tok, lat, cache, pos, kv_valid,
                                    counts))
    assert counted.calls == 0
    assert torch.equal(outs[0], outs[1])


def test_megakernel_route_ignores_left_padding():
    """The megakernel takes no kv_valid: it attends every cache row below
    the position, pad slots of left-padded rows included. That is the JAX
    route's behaviour (`otter_tpu/models/decoder.py`, "assumes the uniform
    single-stream kv_valid"), which the port keeps: on a left-padded batch
    the route differs from the composed path in the padded row only, and
    agrees with the JAX megakernel route; on an unpadded batch the two
    paths agree."""
    cfg, _, _, _ = jax_tiny_fused("megakernel")
    prefill, step = _jax_fns("megakernel")
    fused, composed = torch_tiny_fused("megakernel"), torch_tiny(0, False)
    b, p = 2, 10
    vx, ids = inputs(cfg, 23, b, p)
    counts = (ids == cfg.media_token_id).sum(-1).astype(np.int32)
    tok = np.full((b, 1), 7, np.int32)
    for padded in (True, False):
        mask = np.ones_like(ids)
        if padded:
            mask[0, :4] = 0
        kv_valid = np.zeros((b, L), bool)
        kv_valid[:, :p] = mask.astype(bool)
        kv_valid[:, p] = True
        outs = []
        for model in (fused, composed):
            _, cache, lat = _prefill_torch(model, vx, ids, mask)
            outs.append(_step_torch(model, tok, lat, cache, p, kv_valid,
                                    counts).numpy())
        diff = np.abs(outs[0] - outs[1]).max(axis=(1, 2))
        if not padded:
            assert diff.max() < 1e-4
            continue
        assert diff[0] > 1e-2 and diff[1] < 1e-4
        _, jcache, jlat = prefill(jnp.asarray(vx), jnp.asarray(ids),
                                  jnp.asarray(mask),
                                  jinit_cache(cfg.text, b, L, jnp.float32))
        jl, _, _ = step(jnp.asarray(tok), jlat, jcache, p,
                        jnp.asarray(kv_valid), jnp.asarray(counts))
        np.testing.assert_allclose(outs[0], np.asarray(jl), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


@pytest.mark.parametrize("route", ["composed", "megakernel", "fused_tail"])
def test_bench_decode_on_the_tiny_config(route):
    kw = {} if route == "composed" else {route: True}
    cache_bit = "int8" if route == "fused_tail" else "bf16"
    res = bench_decode.run(device="cpu", cfg=OtterConfig.tiny("mpt"),
                           batch=2, windows=(2, 5), reps=2,
                           cache_bit=cache_bit, **kw)
    assert {"metric", "step_ms", "tokens_per_s", "decode_step_bytes",
            "roofline_share", "launches_per_step", "tokens_equal",
            "weight_bytes", "device"} <= set(res)
    assert res["device"] == "cpu" and res["roofline_share"] is None
    # (no sign is asked of the step time: two tiny windows on a shared
    # CPU can come out in either order)
    assert res["tokens_equal"] and res["tokens_valid"]
    assert np.isfinite(res["step_ms"])
    assert res["tokens_per_s"] == pytest.approx(2 / (res["step_ms"] / 1e3))
    assert set(res["launches_per_step"]) == {
        "flash_fwd", "int8_mlp", "int4_mlp", "int4_matmul",
        "decode_attention", "decode_attention_int4",
        "decode_attn_megakernel", "int8_attn_tail", "int8_matmul"}
    # the bytes a step reads, by hand from the tiny configuration: the
    # language model's tensors once (the fused copy in place of Wqkv and
    # out_proj under the megakernel) and the cache of 256
    text = OtterConfig.tiny("mpt").text
    d, nl, hid, v = (text.hidden_size, text.num_hidden_layers, text.mlp_dim,
                     text.total_vocab)
    attn_w = 4 * d * d + 4 * 4 * d                  # int8 kernels + f32 scales
    layer = attn_w + 2 * d * hid + 4 * (hid + d) + 2 * 4 * d   # + mlp, norms
    if route == "megakernel":
        layer += 4 * 4 * d                          # wqo_scale; wqo_q = Wqkv|Wo
    want_weights = nl * layer + 2 * v * d + 4 * d + _xattn_bytes()
    rows = 2 * nl * text.kv_heads * 256
    want_cache = (2 * rows * text.head_dim + 2 * 4 * rows
                  if cache_bit == "int8" else 2 * rows * text.head_dim * 2)
    assert res["decode_step_bytes"] == want_weights + want_cache


def test_bench_decode_device_step_is_none_on_the_cpu():
    """The device's own step time (the difference of the two windows'
    torch.profiler kernel sums) is reported beside the wall-clock
    estimate, and is None where there is no device."""
    res = bench_decode.run(device="cpu", cfg=OtterConfig.tiny("mpt"),
                           batch=1, windows=(1, 2), reps=1)
    assert "device_step_ms" in res and "device_step_ms_estimates" in res
    assert res["device_step_ms"] is None
    assert res["device_step_ms_estimates"] is None
    assert len(res["step_ms_estimates"]) == 1


def test_bench_decode_device_step_profiles_the_steps_between_windows(
        monkeypatch):
    """The device step profiles steps first .. max_new_tokens of one
    request, in `parts` runs of `generate`'s decode loop, and divides each
    run's kernel time by its steps; the tokens are `generate`'s."""
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.tools.random_weights import build_model

    cfg = OtterConfig.tiny("mpt")
    engine = OtterGenerator(build_model(cfg, torch.device("cpu"), 0))
    seen = []

    def kernel_ms(fn):
        t0 = state[0].t
        fn()
        seen.append((t0, state[0].t))
        return 6.0

    state = []
    prefill = engine._prefill
    monkeypatch.setattr(engine, "_prefill",
                        lambda *a: state.append(prefill(*a)) or state[0])
    monkeypatch.setattr(bench_decode, "_kernel_ms", kernel_ms)
    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    vision_x = rng.standard_normal((1, 1, 1, 3, size, size)).astype(np.float32)
    ids = rng.integers(5, 50, (1, 6))
    ids[:, 0] = cfg.media_token_id
    gen = GenerationConfig(max_new_tokens=8, do_sample=False, eos_token_id=-1)
    mean, parts = bench_decode._device_step_ms(engine, vision_x, ids, gen, 2)
    assert seen == [(2, 4), (4, 6), (6, 8)]
    assert parts == [3.0, 3.0, 3.0] and mean == 3.0
    monkeypatch.undo()
    assert np.array_equal(state[0].buffer[:, :6 + 8].numpy(),
                          engine.generate(vision_x, ids, gen=gen))


def _xattn_bytes():
    """Bytes of the tiny model's gated cross-attention blocks (bf16 model,
    int8 kernels with f32 scales), from a model on the meta device."""
    cfg = OtterConfig.tiny("mpt")
    cfg = cfg.replace(text=cfg.text.replace(quant="int8"))
    model = OtterVLM(cfg, dtype=torch.bfloat16, device="meta")
    tensors = dict(model.lang_encoder.named_parameters())
    tensors.update(model.lang_encoder.named_buffers())
    return sum(t.numel() * t.element_size() for n, t in tensors.items()
               if n.startswith("xattn_"))
