#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`otter_tpu_torch`) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

It imports torch and the port only (never jax or `otter_tpu`) and fails
unless every phase passes:

  1. device   CUDA must be available; prints the card's name and power limit.
  2. build    nvcc compiles every kernel in otter_tpu_torch/csrc (one process
              per source, started together) into otter_tpu_torch/_build/.
  3. kernels  each kernel against its plain PyTorch version on the card, in
              bf16, at the shapes the serving path gives it, with the
              tolerance printed; kernel, plain and library-call times and
              the bound (least time for the same bytes / operations).
  4. parity   OTTER-MPT7B at full width with its depth cut: first-step
              logits (prefill and first cached decode step) through the
              kernels against the same model with every kernel swapped for
              its plain version.
  5. serve    OTTER-MPT7B at full width (32 layers, 8 xattn blocks, CLIP
              ViT-L/14, perceiver depth 6; random weights from a seed,
              quantized to int8), int8 KV cache, decode_kernel="auto":
              greedy requests through OtterGenerator.generate at batch 1
              and 8, ragged left-padded 32-128-token prompts, each with one
              224x224 image, 32 new tokens. Prints TTFT and decode tok/s
              (medians of 3 runs), with the card's name and power limit.
              Every kernel's launch count must rise during this phase.

The last two lines of standard output are the kernels JSON object and the
device JSON object. `--phases` runs a subset (for bring-up); the default
runs the five above. `--phases kernels,parity,serve,profile` also runs
torch.profiler over one batch-8 request and writes the kernel tables to
chiprun_out/.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12      # HBM3, NVIDIA H100 SXM data sheet
H100_BF16_FLOP_PER_S = 989e12   # dense bf16 tensor-core peak
SEED = 0
REPS = 3          # timed repetitions of each serve request
OUT_DIR = "chiprun_out"
DEV = "cuda"


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(out, ref, keep=None):
    import torch
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    if keep is not None:
        d, r = d[keep], r[keep]
    return float(d.max()), float((d - (2e-2 + 2e-2 * r)).max())


# ── phase 1: device ─────────────────────────────────────────────────

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


# ── phase 2: build ──────────────────────────────────────────────────

def phase_build():
    from otter_tpu_torch import _build
    t0 = time.perf_counter()
    logs = _build.build(_build.all_sources())
    log(f"build: {sorted(logs)} compiled in {time.perf_counter() - t0:.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "build_log.txt"), "w") as f:
        for name, text in sorted(logs.items()):
            f.write(f"== {name}.cu\n{text}\n")


# ── phase 3: kernels against their plain versions ───────────────────

def _flash_cases(gen):
    """(name, kwargs) at the serving path's prefill shapes, batch 8."""
    import torch
    from otter_tpu_torch.ops.masks import alibi_slopes
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    b = 8
    cases = [("clip", dict(q=rnd(b, 16, 257, 64), k=rnd(b, 16, 257, 64),
                           v=rnd(b, 16, 257, 64)), None),
             ("perceiver", dict(q=rnd(b, 8, 64, 64), k=rnd(b, 8, 320, 64),
                                v=rnd(b, 8, 320, 64)), None)]
    s = 128
    lens = torch.tensor([128, 100, 77, 32, 128, 64, 45, 90], device=dev)
    pos = torch.arange(s, device=dev)
    mask = (pos[None, :] >= s - lens[:, None]).int()       # left padding
    bias = (torch.arange(1 - s, 1, device=dev)[None, None, None, :]
            * alibi_slopes(32, device=dev)[None, :, None, None])
    cases.append(("mpt_prefill", dict(
        q=rnd(b, 32, s, 128), k=rnd(b, 32, s, 128), v=rnd(b, 32, s, 128),
        bias=bias, q_ids=mask, kv_ids=mask, causal=True,
        sm_scale=128 ** -0.5), None))
    # text_time: 0 on the left padding before the media token, 1 after
    text_time = mask.clone()
    kv_ids = torch.ones((b, 64), dtype=torch.int32, device=dev)
    cases.append(("xattn_prefill", dict(
        q=rnd(b, 8, s, 64), k=rnd(b, 8, 64, 64), v=rnd(b, 8, 64, 64),
        q_ids=text_time, kv_ids=kv_ids, ids_mode="eq",
        sm_scale=64 ** -0.5), text_time > 0))
    return cases


def _flash_cost(kw):
    q, k = kw["q"], kw["k"]
    b, h, sq, d = q.shape
    sk = k.shape[2]
    pairs = sq * (sq + 1) // 2 if kw.get("causal") else sq * sk
    nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * b * h * sq
    if kw.get("bias") is not None:
        nbytes += 4 * kw["bias"].numel()
    if kw.get("q_ids") is not None:
        nbytes += 4 * (b * sq + b * sk)
    return nbytes, 4.0 * b * h * d * pairs


def _sdpa_args(kw):
    """An additive mask that makes SDPA compute the same attention."""
    import torch
    q = kw["q"]
    b, h, sq, _ = q.shape
    sk = kw["k"].shape[2]
    ok = torch.ones((b, 1, sq, sk), dtype=torch.bool, device=q.device)
    if kw.get("q_ids") is not None:
        qi = kw["q_ids"][:, None, :, None]
        ki = kw["kv_ids"][:, None, None, :]
        ok = ok & ((qi == ki) if kw.get("ids_mode", "eq") == "eq"
                   else (qi >= ki))
    if kw.get("causal"):
        ok = ok & torch.ones(sq, sk, dtype=torch.bool,
                             device=q.device).tril()[None, None]
    add = torch.zeros((b, h, sq, sk), device=q.device)
    if kw.get("bias") is not None:
        add = add + kw["bias"]
    add = add.masked_fill(~ok, float("-inf")).to(q.dtype)
    return add


def phase_kernels(gen):
    import torch
    import torch.nn.functional as F
    from otter_tpu_torch.ops import decode_attention as da
    from otter_tpu_torch.ops import flash_attention as fa
    from otter_tpu_torch.ops import quant
    from otter_tpu_torch.ops.masks import alibi_slopes

    tol = "|err| <= 2e-2 + 2e-2*|plain| (bf16 in/out, f32 inside)"
    log(f"kernels: tolerance {tol}")
    entries = {}
    failed = []

    def report(kernel, case, err, excess, ms, plain_ms, lib_ms, nbytes,
               flops):
        b_ms, b_by = bound_ms(nbytes, flops)
        ok = excess <= 0 and math.isfinite(err)
        log(f"  {kernel}[{case}]: max_abs_err {err:.3e} "
            f"{'ok' if ok else 'FAIL'} | kernel {ms:.4f} ms | plain "
            f"{plain_ms:.4f} ms | library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} | bound "
            f"{b_ms:.4f} ms ({b_by})")
        if not ok:
            failed.append(f"{kernel}[{case}]")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

    # flash attention forward: four prefill configurations
    for case, kw, keep in _flash_cases(gen):
        out = fa.flash_attention(**kw)
        ref = fa.flash_attention_plain(**kw)
        torch.cuda.synchronize()
        keep4 = None if keep is None else keep[:, None, :, None].expand_as(out)
        err, excess = max_err(out, ref, keep4)
        sdpa_mask = _sdpa_args(kw)
        lib = lambda kw=kw, m=sdpa_mask: F.scaled_dot_product_attention(
            kw["q"], kw["k"], kw["v"], attn_mask=m,
            scale=kw.get("sm_scale", kw["q"].shape[-1] ** -0.5))
        r = report("flash_fwd", case, err, excess,
                   time_ms(lambda kw=kw: fa.flash_attention(**kw)),
                   time_ms(lambda kw=kw: fa.flash_attention_plain(**kw), 5),
                   time_ms(lib), *_flash_cost(kw))
        if case == "mpt_prefill":
            entries["flash_fwd"] = r

    # int8 MLP: decoder MLP 4096 -> 16384 -> 4096 at M = 1 and 8
    k_in, hid = 4096, 16384
    w1q, s1 = quant.quantize_kernel(0.02 * torch.randn(
        k_in, hid, generator=gen, device="cuda"))
    w2q, s2 = quant.quantize_kernel(0.02 * torch.randn(
        hid, k_in, generator=gen, device="cuda"))
    for m in (1, 8):
        x = torch.randn(m, k_in, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        args = (x, w1q, s1, w2q, s2)
        out = quant.int8_mlp(*args)
        ref = quant.int8_mlp_plain(*args)
        torch.cuda.synchronize()
        err, excess = max_err(out, ref)
        nbytes = 2 * k_in * hid + 4 * (hid + k_in) + 2 * 2 * m * k_in
        r = report("int8_mlp", f"M={m}", err, excess,
                   time_ms(lambda: quant.int8_mlp(*args)),
                   time_ms(lambda: quant.int8_mlp_plain(*args), 5), None,
                   nbytes, 2.0 * m * 2 * k_in * hid)
        if m == 8:
            entries["int8_mlp"] = r

    # decode attention on a stacked cache [8, 32 layers, 32, 256, 128]
    b, nl, h, L, d = 8, 32, 32, 256, 128
    starts = torch.tensor([0, 10, 37, 96, 0, 5, 64, 100], device="cuda",
                          dtype=torch.int32)
    lengths = torch.tensor([160, 150, 141, 129, 200, 133, 170, 190],
                           device="cuda", dtype=torch.int32)
    bias = (torch.arange(L, device="cuda")[None, None, :]
            * alibi_slopes(h, device="cuda")[None, :, None])
    q = torch.randn(b, h, d, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    rows = int((lengths - starts).sum()) * h
    for cache in ("bf16", "int8"):
        k = torch.randn(b, nl, h, L, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        v = torch.randn(b, nl, h, L, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        kw = dict(starts=starts, sm_scale=d ** -0.5)
        elt = 2
        if cache == "int8":
            (k, ks), (v, vs) = quant.quantize_kv(k), quant.quantize_kv(v)
            kw.update(k_scale=ks, v_scale=vs)
            elt = 1
        layer = 5
        out = da.decode_attention(q, k, v, lengths, bias, layer=layer, **kw)
        ref = da.decode_attention_plain(q, k, v, lengths, bias, layer=layer,
                                        **kw)
        torch.cuda.synchronize()
        err, excess = max_err(out, ref)
        it = iter(range(10 ** 9))
        # each launch reads another layer, as a decode step does, so the
        # timed reads come from device memory and not from L2
        kern = lambda: da.decode_attention(q, k, v, lengths, bias,
                                           layer=next(it) % nl, **kw)
        plain = lambda: da.decode_attention_plain(q, k, v, lengths, bias,
                                                  layer=next(it) % nl, **kw)
        lib_ms = None
        if cache == "bf16":
            pos = torch.arange(L, device="cuda")
            ok = (pos[None, :] >= starts[:, None]) \
                & (pos[None, :] < lengths[:, None])
            m = bias.expand(b, h, L).masked_fill(
                ~ok[:, None, :], float("-inf"))[:, :, None, :].to(q.dtype)
            lib = lambda: (lambda li: F.scaled_dot_product_attention(
                q[:, :, None], k[:, li], v[:, li], attn_mask=m,
                scale=d ** -0.5))(next(it) % nl)
            lib_ms = time_ms(lib)
        nbytes = (2 * rows * d * elt + (2 * 4 * rows if cache == "int8" else 0)
                  + 4 * h * L + 2 * 2 * b * h * d + 2 * 4 * b)
        r = report("decode_attention", f"{cache} cache", err, excess,
                   time_ms(kern), time_ms(plain, 5), lib_ms, nbytes,
                   4.0 * rows * d)
        if cache == "int8":
            entries["decode_attention"] = r
        del k, v
    if failed:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{failed}")
    return entries


# ── model construction ──────────────────────────────────────────────

def build_model(cfg, gen, std: float = 0.02):
    """Full-width OtterVLM on the card with random bf16 weights from `gen`,
    made in the flax parameter layout, quantized by the port's
    quantize_params and loaded through models.convert."""
    import torch
    from otter_tpu_torch.models.convert import load_flax_params
    from otter_tpu_torch.models.otter import OtterVLM
    from otter_tpu_torch.ops.quant import quantize_params

    model = OtterVLM(cfg, dtype=torch.bfloat16, device=DEV)
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    flat = {}
    for name, t in tensors.items():
        if name.endswith("scale_q"):
            continue
        path = "params/" + name.replace(".", "/")
        if name.endswith("kernel_q"):
            path = path[: -len("kernel_q")] + "kernel"
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("attn_gate", "ff_gate"):
            val = torch.ones(t.shape, device=DEV)   # tanh(1) ~ 0.76
        else:
            val = std * torch.randn(t.shape, generator=gen, device=DEV,
                                    dtype=torch.bfloat16)
            if leaf == "scale":                       # LayerNorm scales
                val = val + 1
        flat[path] = val
    load_flax_params(model, quantize_params(flat))
    del flat
    return model.eval()


def serving_cfg(depth_cut: bool = False):
    from otter_tpu_torch.config import otter_mpt7b
    cfg = otter_mpt7b()
    text = cfg.text.replace(quant="int8", decode_kernel="auto")
    if not depth_cut:
        return cfg.replace(text=text)
    return cfg.replace(
        text=text.replace(num_hidden_layers=4),
        vision=cfg.vision.replace(num_hidden_layers=2),
        perceiver=cfg.perceiver.replace(depth=1))


def make_requests(cfg, batch: int, seed: int):
    """Ragged 32-128-token prompts, each starting with the media token,
    left-padded to 128, with one 224x224 image each (numpy)."""
    import numpy as np
    from otter_tpu_torch.generation.engine import left_pad
    rng = np.random.default_rng(seed)
    p = 128
    lens = rng.integers(32, p + 1, batch)
    ids = rng.integers(0, cfg.eoc_token_id, (batch, p)).astype(np.int64)
    ids[:, 0] = cfg.media_token_id
    mask = (np.arange(p)[None, :] < lens[:, None]).astype(np.int32)
    lang_x, attn = left_pad(ids, mask, target_len=p)
    size = cfg.vision.image_size
    vision_x = rng.standard_normal((batch, 1, 1, 3, size, size)
                                   ).astype(np.float32)
    return vision_x, lang_x, attn


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel wrapper for its plain version at the call sites."""
    from otter_tpu_torch.ops import decode_attention as da
    from otter_tpu_torch.ops import flash_attention as fa
    from otter_tpu_torch.ops import quant
    saved = (fa.flash_attention, quant.int8_mlp, da.decode_attention)
    fa.flash_attention = fa.flash_attention_plain
    quant.int8_mlp = quant.int8_mlp_plain
    da.decode_attention = da.decode_attention_plain
    try:
        yield
    finally:
        fa.flash_attention, quant.int8_mlp, da.decode_attention = saved


# ── phase 4: kernel path against the plain path ─────────────────────

def first_step_logits(model, cfg, vision_x, lang_x, attn):
    import torch
    from otter_tpu_torch.models.decoder import init_cache
    with torch.inference_mode():
        dev = model.device
        vx = torch.from_numpy(vision_x).to(dev)
        ids = torch.from_numpy(lang_x).to(dev)
        mask = torch.from_numpy(attn).to(dev)
        b, p = ids.shape
        cache = init_cache(cfg.text, b, 256, torch.int8, dev)
        logits0, cache, lat = model(vx, ids, attention_mask=mask,
                                    cache=cache, head_last_only=True)
        tok = torch.full((b, 1), cfg.text.vocab_size // 2, device=dev)
        kv_valid = torch.zeros((b, 256), dtype=torch.bool, device=dev)
        kv_valid[:, :p] = mask.bool()
        kv_valid[:, p] = True
        media = (ids == cfg.media_token_id).int().sum(-1)
        logits1, _, _ = model(None, tok, vis_latents=lat, cache=cache,
                              cache_pos=p, kv_valid=kv_valid,
                              media_counts=media)
        return logits0[:, -1].float(), logits1[:, -1].float()


def phase_parity(gen):
    import torch
    cfg = serving_cfg(depth_cut=True)
    model = build_model(cfg, gen)
    req = make_requests(cfg, 8, SEED + 1)
    kern = first_step_logits(model, cfg, *req)
    with plain_kernels():
        plain = first_step_logits(model, cfg, *req)
    for name, a, r in zip(("prefill", "decode step 1"), kern, plain):
        err = float((a - r).abs().max())
        scale = float(r.abs().max())
        ok = torch.isfinite(a).all() and err <= 5e-2 * scale
        log(f"parity[{name}]: logits max_abs_err {err:.4e} vs max|plain| "
            f"{scale:.4e} (tolerance 5e-2 * max|plain|) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"kernel path disagrees with the plain path "
                               f"at the {name} logits")
    del model


# ── phase 5: serve requests at full width ───────────────────────────

def phase_serve(gen, smi: str):
    import numpy as np
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.ops import decode_attention as da
    from otter_tpu_torch.ops import flash_attention as fa
    from otter_tpu_torch.ops import quant

    cfg = serving_cfg()
    t0 = time.perf_counter()
    model = build_model(cfg, gen)
    log(f"serve: {cfg.text.num_hidden_layers}-layer model built and loaded "
        f"in {time.perf_counter() - t0:.1f} s")
    engine = OtterGenerator(model, cache_dtype=torch.int8)
    wrappers = (fa.flash_attention, quant.int8_mlp, da.decode_attention)
    for w in wrappers:
        w.launches = 0
    for b in (1, 8):
        vision_x, lang_x, attn = make_requests(cfg, b, SEED + 10 + b)
        engine.generate(vision_x, lang_x, attn,
                        gen=GenerationConfig(max_new_tokens=2))   # warm-up
        # REPS pairs of (1-token, 32-token) requests; medians of each
        times = {1: [], 32: []}
        outs = []
        for _ in range(REPS):
            for n_new in (1, 32):
                t = time.perf_counter()
                out = engine.generate(
                    vision_x, lang_x, attn,
                    gen=GenerationConfig(max_new_tokens=n_new))
                times[n_new].append(time.perf_counter() - t)
            outs.append(out)
        out = outs[0]
        p = lang_x.shape[1]
        if out.shape != (b, p + 32):
            raise RuntimeError(f"serve b={b}: output shape {out.shape}")
        if not ((out >= 0) & (out < cfg.text.total_vocab)).all():
            raise RuntimeError(f"serve b={b}: token outside the vocabulary")
        if any(not np.array_equal(outs[0], o) for o in outs[1:]):
            raise RuntimeError(f"serve b={b}: greedy output differs between "
                               f"runs of the same request")
        ttft = float(np.median(times[1]))
        decode_s = float(np.median(times[32])) - ttft
        tok_s = b * 31 / decode_s
        log(f"serve b={b}: prompts {attn.sum(1).tolist()} tokens + 1 image "
            f"each, 32 new tokens | TTFT {ttft * 1e3:.2f} ms | decode "
            f"{tok_s:.2f} tok/s ({decode_s / 31 * 1e3:.2f} ms/step) | "
            f"medians of {REPS}; TTFT runs "
            f"{[round(x * 1e3, 2) for x in times[1]]} ms, 32-token runs "
            f"{[round(x * 1e3, 2) for x in times[32]]} ms | {smi} | first "
            f"tokens {out[0, p:p + 8].tolist()}")
    launches = {"flash_fwd": fa.flash_attention.launches,
                "int8_mlp": quant.int8_mlp.launches,
                "decode_attention": da.decode_attention.launches}
    log(f"serve: kernel launches during the requests {launches}")
    dead = [k for k, n in launches.items() if n == 0]
    if dead:
        raise RuntimeError(f"serving path never launched {dead}")
    return launches, engine


# ── optional: where the time goes in one b=8 request ────────────────

def phase_profile(engine):
    """torch.profiler over a b=8 request: prefill alone (1 new token), then
    prefill + 31 decode steps. Writes the kernel tables to chiprun_out/
    and prints the device-busy share and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from otter_tpu_torch.config import GenerationConfig

    cfg = engine.cfg
    req = make_requests(cfg, 8, SEED + 18)
    os.makedirs(OUT_DIR, exist_ok=True)
    for n_new in (1, 32):
        gen_cfg = GenerationConfig(max_new_tokens=n_new)
        engine.generate(*req, gen=gen_cfg)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            engine.generate(*req, gen=gen_cfg)
            wall = time.perf_counter() - t
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        dev_us = lambda e: getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0))
        busy = sum(dev_us(e) for e in kern) / 1e6
        kern.sort(key=dev_us, reverse=True)
        path = os.path.join(OUT_DIR, f"profile_b8_new{n_new}.txt")
        with open(path, "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=60))
        log(f"profile b=8 new={n_new}: wall {wall * 1e3:.2f} ms, device "
            f"kernels {busy * 1e3:.2f} ms ({100 * busy / wall:.1f}% busy), "
            f"{sum(e.count for e in kern)} kernel launches; table in {path}")
        for e in kern[:12]:
            log(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
                f"{e.key[:90]}")


KERNELS = {
    "flash_fwd": ("otter_tpu_torch/csrc/flash_fwd.cu",
                  "otter_tpu/ops/flash_attention.py:84"),
    "int8_mlp": ("otter_tpu_torch/csrc/int8_mlp.cu",
                 "otter_tpu/ops/quant.py:84"),
    "decode_attention": ("otter_tpu_torch/csrc/decode_attention.cu",
                         "otter_tpu/ops/decode_attention.py:219"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernels,parity,serve",
                    help="comma-separated subset of kernels,parity,serve, "
                         "plus profile (after serve; not run by default). "
                         "Device and build always run.")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    import torch
    smi = phase_device()
    import otter_tpu_torch  # noqa: F401  (the checkout must hold the port)
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    entries = phase_kernels(gen) if "kernels" in phases else {}
    if "parity" in phases:
        phase_parity(gen)
    launches = {}
    if "serve" in phases:
        launches, engine = phase_serve(gen, smi)
        if "profile" in phases:
            phase_profile(engine)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        e = entries.get(name, {})
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches.get(name, 0),
            max_abs_err=e.get("max_abs_err"), ms=e.get("ms"),
            plain_ms=e.get("plain_ms"), bound_ms=e.get("bound_ms"),
            bound_by=e.get("bound_by"), library_ms=e.get("library_ms")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
