#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`otter_tpu_torch`) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

It imports torch and the port only (never jax or `otter_tpu`) and fails
unless every phase passes:

  1. device      CUDA must be available; prints the card's name and power
                 limit.
  2. build       nvcc compiles every kernel in otter_tpu_torch/csrc (one
                 process per source, started together) into
                 otter_tpu_torch/_build/.
  3. kernels     each kernel against its plain PyTorch version on the card,
                 in bf16, at the shapes the serving and training paths give
                 it, with the tolerance printed; kernel, plain and
                 library-call times and the bound (least time for the same
                 bytes / operations).
  4. parity      OTTER-MPT7B at full width with its depth cut: first-step
                 logits (prefill and first cached decode step) through the
                 kernels against the same model with every kernel swapped
                 for its plain version.
  5. serve       OTTER-MPT7B at full width (32 layers, 8 xattn blocks, CLIP
                 ViT-L/14, perceiver depth 6; random weights from a seed,
                 the decoder's and xattn's quantized to int8), int8 KV cache, decode_kernel="auto":
                 greedy requests through OtterGenerator.generate at batch 1
                 and 8, ragged left-padded 32-128-token prompts, each with
                 one 224x224 image, 32 new tokens. Prints TTFT and decode
                 tok/s (medians of 3 runs). Every serving kernel's launch
                 count must rise during this phase.
  6. trainparity the depth-cut model in bf16 (not quantized): one SFT step
                 (b=2, 1024 tokens, one image each, remat, fused CE) through
                 the kernels against the same step with every kernel swapped
                 for its plain version: loss, every trainable gradient,
                 grad norm.
  7. train       OTTER-MPT7B at full width in bf16 through train/sft.py's
                 main: 2 warm-up and 5 timed SFT steps on one synthetic
                 batch (b=2, 1024 tokens, one 224x224 image each, remat,
                 fused CE, embedding-row mask, lr 1e-4 constant). Checks
                 finite and falling loss, frozen weights bit-identical,
                 every trainable group moved, and the flash forward and
                 both backward kernels launched; prints step time,
                 samples/s, tokens/s, peak memory and model FLOP share.

The last two lines of standard output are the kernels JSON object and the
device JSON object. `--phases` runs a subset (for bring-up); the default
runs all seven. `profile` (not run by default) adds torch.profiler tables
of one batch-8 request (with serve) and of one train step (with train) to
chiprun_out/.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
import zlib
from collections.abc import Mapping

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


def _sdpa_args(kw, fill=float("-inf")):
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
    add = add.masked_fill(~ok, fill).to(q.dtype)
    return add


def _flash_bwd_cases(gen):
    """(name, kwargs) at the training path's shapes, b=2, S=1024."""
    import torch
    from otter_tpu_torch.ops.masks import alibi_slopes
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def mpt(s, real):
        pos = torch.arange(s, device=dev)
        ids = (pos[None, :] < torch.tensor(real, device=dev)[:, None]).int()
        bias = (torch.arange(1 - s, 1, device=dev)[None, None, None, :]
                * alibi_slopes(32, device=dev)[None, :, None, None])
        return dict(q=rnd(2, 32, s, 128), k=rnd(2, 32, s, 128),
                    v=rnd(2, 32, s, 128), bias=bias, q_ids=ids, kv_ids=ids,
                    causal=True, sm_scale=128 ** -0.5)

    def xattn(mode):
        # text_time 0 before the media token at position 3: rows that may
        # attend no key (their forward averaged v)
        tt = torch.ones((2, 1024), dtype=torch.int32, device=dev)
        tt[:, :3] = 0
        return dict(q=rnd(2, 8, 1024, 64), k=rnd(2, 8, 64, 64),
                    v=rnd(2, 8, 64, 64), q_ids=tt,
                    kv_ids=torch.ones((2, 64), dtype=torch.int32, device=dev),
                    ids_mode=mode, sm_scale=64 ** -0.5)

    return [("mpt", mpt(1024, [1024, 900])),
            ("perceiver", dict(q=rnd(2, 8, 64, 64), k=rnd(2, 8, 320, 64),
                               v=rnd(2, 8, 320, 64), sm_scale=64 ** -0.5)),
            ("xattn_eq", xattn("eq")), ("xattn_ge", xattn("ge")),
            ("mpt_s1000", mpt(1000, [1000, 777]))]


def _flash_bwd_cost(kw, products: int, outputs: int):
    """(bytes, operations) of one backward kernel: q, k, v, do read once
    (bf16), lse and di (f32), bias and ids, `outputs` of dq/dk/dv written
    (bf16); `products` [S_q x S_k x D] products over the pairs the mask
    can reach (half for causal)."""
    q, k = kw["q"], kw["k"]
    b, h, sq, d = q.shape
    sk = k.shape[2]
    pairs = sq * (sq + 1) // 2 if kw.get("causal") else sq * sk
    nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 2 * 4 * b * h * sq
    nbytes += 2 * (q.numel() if outputs == 1 else 2 * k.numel())
    if kw.get("bias") is not None:
        nbytes += 4 * kw["bias"].numel()
    if kw.get("q_ids") is not None:
        nbytes += 4 * (b * sq + b * sk)
    return nbytes, 2.0 * products * b * h * d * pairs


def _sdpa_backward_ms(kw, do):
    """SDPA's backward on the same inputs: time(forward + backward) -
    time(forward), with the mask as a float attn_mask (a finite fill, so
    rows that attend nothing average v as the port does)."""
    import torch
    import torch.nn.functional as F
    mask = _sdpa_args(kw, fill=-1e30)
    leaves = [kw[n].detach().requires_grad_() for n in ("q", "k", "v")]
    scale = kw.get("sm_scale", kw["q"].shape[-1] ** -0.5)
    fwd = lambda: F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                 scale=scale)
    both = lambda: torch.autograd.grad(fwd(), leaves, do)
    return time_ms(both, 10) - time_ms(fwd, 10)


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

    # flash attention backward: the training path's three attention sites
    # and a length that is not a multiple of the 64-row tile
    log("kernels: flash at the training shapes; forward tolerance as "
        "above; backward |err| <= 2e-2*max|plain| + 2e-2*|plain| (bf16 "
        "out, f32 inside); backward plain = the whole plain backward (dq, "
        "dk, dv); backward library = SDPA forward+backward - forward")
    for case, kw in _flash_bwd_cases(gen):
        args = [kw["q"], kw["k"], kw["v"], kw.get("bias"), kw.get("q_ids"),
                kw.get("kv_ids")]
        opts = {n: kw[n] for n in ("causal", "sm_scale", "ids_mode")
                if n in kw}
        out, lse = fa.flash_attention(*args, return_lse=True, **opts)
        # the forward at the training shapes too (row 1 of PERF.md's table)
        err, excess = max_err(out, fa.flash_attention_plain(*args, **opts))
        sdpa_mask = _sdpa_args(kw, fill=-1e30)
        report("flash_fwd", f"train {case}", err, excess,
               time_ms(lambda: fa.flash_attention(*args, **opts), 10),
               time_ms(lambda: fa.flash_attention_plain(*args, **opts), 3, 1),
               time_ms(lambda: F.scaled_dot_product_attention(
                   kw["q"], kw["k"], kw["v"], attn_mask=sdpa_mask,
                   scale=opts["sm_scale"]), 10), *_flash_cost(kw))
        do = torch.randn(out.shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        di = (out.float() * do.float()).sum(-1)
        dk, dv = fa.flash_bwd_dkv(*args, lse, di, do, **opts)
        dq = fa.flash_bwd_dq(*args, lse, di, do, **opts)
        pq, pk, pv = fa.flash_attention_bwd_plain(*args, out, lse, do, **opts)
        torch.cuda.synchronize()
        errs = {}
        for name, a, r in (("dq", dq, pq), ("dk", dk, pk), ("dv", dv, pv)):
            d = (a.float() - r.float()).abs()
            rr = r.float().abs()
            errs[name] = (float(d.max()), float(
                (d - (2e-2 * rr.max() + 2e-2 * rr)).max()), bool(
                    torch.isfinite(a).all()))
        plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
            *args, out, lse, do, **opts), 3, 1)
        lib_ms = _sdpa_backward_ms(kw, do)
        for kernel, names, products, fn in (
                ("flash_bwd_dkv", ("dk", "dv"), 4,
                 lambda: fa.flash_bwd_dkv(*args, lse, di, do, **opts)),
                ("flash_bwd_dq", ("dq",), 3,
                 lambda: fa.flash_bwd_dq(*args, lse, di, do, **opts))):
            err = max(errs[n][0] for n in names)
            excess = max(errs[n][1] for n in names)
            if not all(errs[n][2] for n in names):
                excess = float("inf")
            r = report(kernel, case, err, excess, time_ms(fn, 10), plain_ms,
                       lib_ms, *_flash_bwd_cost(kw, products, len(names)))
            if case == "mpt":
                entries[kernel] = r
        del out, lse, do, di, dk, dv, dq, pq, pk, pv

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

def build_model(cfg):
    """Full-width OtterVLM on the card with RandomParams weights, quantized
    by the port's quantize_params and loaded through models.convert."""
    import torch
    from otter_tpu_torch.models.convert import load_flax_params
    from otter_tpu_torch.models.otter import OtterVLM
    from otter_tpu_torch.ops.quant import quantize_params

    model = OtterVLM(cfg, dtype=torch.bfloat16, device=DEV)
    bf16_cfg = cfg.replace(text=cfg.text.replace(quant=None))
    load_flax_params(model, quantize_params(RandomParams(bf16_cfg)))
    return model.eval()


class RandomParams(Mapping):
    """{flax path: tensor} of a model's random bf16 weights, made on the
    card when read, each from its own seed: normal(0, std), LayerNorm
    scales 1 + that, tanh gates 1 (tanh(1) ~ 0.76, so the xattn blocks
    contribute). Any tensor can be made again to check a trained copy,
    and the whole set never sits in memory beside the model."""

    def __init__(self, cfg, std: float = 0.02, seed: int = SEED):
        import torch
        from otter_tpu_torch.models.otter import OtterVLM
        meta = OtterVLM(cfg, dtype=torch.bfloat16, device="meta")
        self.specs = {"params/" + n.replace(".", "/"): (tuple(t.shape),
                                                        t.dtype)
                      for n, t in meta.named_parameters()}
        self.std, self.seed = std, seed

    def __iter__(self):
        return iter(self.specs)

    def __len__(self):
        return len(self.specs)

    def __getitem__(self, path):
        import torch
        shape, dtype = self.specs[path]
        leaf = path.rsplit("/", 1)[-1]
        if leaf in ("attn_gate", "ff_gate"):
            return torch.ones(shape, device=DEV, dtype=dtype)   # tanh(1)
        gen = torch.Generator(device=DEV)
        gen.manual_seed(self.seed + zlib.crc32(path.encode()))
        val = self.std * torch.randn(shape, generator=gen, device=DEV,
                                     dtype=torch.bfloat16)
        if leaf == "scale":
            val = val + 1
        return val.to(dtype)


def train_cfg(depth_cut: bool = False):
    """OTTER-MPT7B with bf16 weights (no quantization), as SFT trains it."""
    from otter_tpu_torch.config import otter_mpt7b
    cfg = otter_mpt7b()
    if not depth_cut:
        return cfg
    return cfg.replace(
        text=cfg.text.replace(num_hidden_layers=4),
        vision=cfg.vision.replace(num_hidden_layers=2),
        perceiver=cfg.perceiver.replace(depth=1))


class SmokeTokenizer:
    """The special-token ids `sft.prepare_batch` asks for, as OTTER-MPT7B's
    tokenizer (GPT-NeoX vocabulary plus Otter's added tokens) numbers
    them."""

    eos_token_id = 0       # <|endoftext|>
    pad_token_id = 50280   # <PAD>

    def __init__(self, cfg):
        self.ids = {"<|endofchunk|>": cfg.eoc_token_id,
                    "<image>": cfg.media_token_id, "<answer>": 50279}

    def convert_tokens_to_ids(self, token):
        return self.ids[token]


def make_train_batch(cfg, tok, seed: int, b: int = 2, s: int = 1024):
    """One collated batch in MimicitLoader's format (numpy): 3 text tokens,
    the media token, an instruction, <answer> at 400, the answer up to
    <|endofchunk|> and eos, right padding (lengths 1024 and 900), one
    224x224 image per sample."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.eoc_token_id, (b, s)).astype(np.int64)
    mask = np.zeros((b, s), np.int64)
    for i, n in enumerate([1024, 900][:b]):
        ids[i, 3] = cfg.media_token_id
        ids[i, 400] = tok.convert_tokens_to_ids("<answer>")
        ids[i, n - 2] = cfg.eoc_token_id
        ids[i, n - 1] = tok.eos_token_id
        ids[i, n:] = tok.pad_token_id
        mask[i, :n] = 1
    size = cfg.vision.image_size
    images = rng.standard_normal((b, 1, 1, 3, size, size)).astype(np.float32)
    return {"net_input": {"input_ids": ids, "attention_masks": mask,
                          "patch_images": images}}


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
    saved = (fa.flash_attention_fwd, fa.flash_attention_bwd,
             quant.int8_mlp, da.decode_attention)
    fa.flash_attention_fwd = fa.flash_attention_plain
    fa.flash_attention_bwd = fa.flash_attention_bwd_plain
    quant.int8_mlp = quant.int8_mlp_plain
    da.decode_attention = da.decode_attention_plain
    try:
        yield
    finally:
        (fa.flash_attention_fwd, fa.flash_attention_bwd, quant.int8_mlp,
         da.decode_attention) = saved


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


def phase_parity():
    import torch
    cfg = serving_cfg(depth_cut=True)
    model = build_model(cfg)
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

def phase_serve(smi: str):
    import numpy as np
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.ops import decode_attention as da
    from otter_tpu_torch.ops import flash_attention as fa
    from otter_tpu_torch.ops import quant

    cfg = serving_cfg()
    t0 = time.perf_counter()
    model = build_model(cfg)
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
        _report_profile(prof, wall, f"profile b=8 new={n_new}",
                        f"profile_b8_new{n_new}.txt")


def _report_profile(prof, wall: float, label: str, fname: str):
    """Device-busy share, launch count and the top kernels of a
    torch.profiler run; the whole table goes to OUT_DIR/<fname>."""
    from torch.autograd import DeviceType
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    busy = sum(dev_us(e) for e in kern) / 1e6
    kern.sort(key=dev_us, reverse=True)
    path = os.path.join(OUT_DIR, fname)
    with open(path, "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=80))
    log(f"{label}: wall {wall * 1e3:.2f} ms, device kernels "
        f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}% busy), "
        f"{sum(e.count for e in kern)} kernel launches; table in {path}")
    for e in kern[:15]:
        log(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")


# ── phase 6: one SFT step, kernel path against the plain path ──────

FLASH_COUNTERS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def _flash_wrappers():
    from otter_tpu_torch.ops import flash_attention as fa
    return {"flash_fwd": fa.flash_attention,
            "flash_bwd_dkv": fa.flash_bwd_dkv, "flash_bwd_dq": fa.flash_bwd_dq}


class _GradRecorder:
    """Stands in for the optimizer: keeps the step's gradients (f32) and
    leaves the weights as they were."""

    grads = None

    def init(self, params):
        return None

    def update(self, grads, state, params):
        self.grads = {k: g.detach().float().clone() for k, g in grads.items()}


def _step_grads(cfg, dtype, batch, ctx):
    """(loss, grad_norm, {path: f32 gradient}, launches) of one SFT step
    (remat, fused CE 256, embedding mask) of the model `cfg` in `dtype`
    from RandomParams weights; the weights are left as they were."""
    import torch
    from otter_tpu_torch.models.convert import load_flax_params
    from otter_tpu_torch.models.otter import OtterVLM
    from otter_tpu_torch.train.step import TrainState, make_train_step
    model = OtterVLM(cfg, dtype=dtype, device=DEV, remat=True)
    load_flax_params(model, RandomParams(cfg))
    rec = _GradRecorder()
    state = TrainState.create(model, cfg, rec)
    step = make_train_step(model, cfg, rec, mask_embedding=True,
                           fused_ce_chunk=256)
    wrappers = _flash_wrappers()
    for w in wrappers.values():
        w.launches = 0
    with ctx:
        _, m = step(state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    return loss, gnorm, rec.grads, {k: w.launches for k, w in
                                    wrappers.items()}


def phase_trainparity():
    import torch
    from otter_tpu_torch.train import sft
    from otter_tpu_torch.train.args import TrainArgs

    cfg = train_cfg(depth_cut=True)
    tok = SmokeTokenizer(cfg)
    batch = sft.prepare_batch(make_train_batch(cfg, tok, SEED + 30), tok,
                              TrainArgs())
    runs = {}
    for name, dtype, ctx in (
            ("kernels", torch.bfloat16, contextlib.nullcontext()),
            ("plain", torch.bfloat16, plain_kernels()),
            ("plain_f32", torch.float32, plain_kernels())):
        runs[name] = _step_grads(cfg, dtype, batch, ctx)
        loss, gnorm, _, counts = runs[name]
        log(f"trainparity[{name}]: loss {loss:.6f} grad_norm {gnorm:.6f} "
            f"launches {counts}")
    (lk, gk, grads_k, ck), (lp, gp, grads_p, cp) = runs["kernels"], \
        runs["plain"]
    grads_f = runs["plain_f32"][2]
    failed = []
    if not (math.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp)):
        failed.append(f"loss {lk} vs {lp} (limit 1e-2 relative)")
    if not (math.isfinite(gk) and abs(gk - gp) <= 2e-2 * abs(gp)):
        failed.append(f"grad_norm {gk} vs {gp} (limit 2e-2 relative)")
    # Each gradient: kernels within 5e-2 * max|plain| of the bf16 plain
    # path. Where the bf16 plain path itself is farther than that from the
    # same step in f32 (a gradient at bf16's noise floor: at random init
    # the perceiver's latents are near-identical, so the xattn q path's
    # ds = p * (dp - di) cancels), the kernel path must instead be within
    # the limit plus the bf16 plain path's own error of the f32 step.
    rel = lambda a, r: float((a - r).abs().max()) / max(
        float(r.abs().max()), 1e-30)
    log("trainparity: per gradient, max err / max|ref|: kernels vs bf16 "
        "plain (limit 5e-2) | kernels vs f32 plain | bf16 plain vs f32 "
        "plain")
    floor = []
    for k, g in grads_p.items():
        e_kp, e_kf, e_pf = (rel(grads_k[k], g), rel(grads_k[k], grads_f[k]),
                            rel(g, grads_f[k]))
        log(f"    {e_kp:.3e} | {e_kf:.3e} | {e_pf:.3e}  {k} (max|plain| "
            f"{float(g.abs().max()):.3e})")
        ok = e_kp <= 5e-2
        if not ok and e_pf > 5e-2:
            ok = e_kf <= e_pf + 5e-2
            floor.append(k)
        if not ok or not torch.isfinite(grads_k[k]).all():
            failed.append(f"grad {k}: {e_kp:.3e} (vs f32 {e_kf:.3e}, bf16 "
                          f"plain vs f32 {e_pf:.3e})")
    log(f"trainparity: {len(grads_p)} gradients; held against the f32 step "
        f"(bf16 plain itself beyond 5e-2 of it): {floor}")
    if any(ck[k] == 0 for k in FLASH_COUNTERS) or any(cp.values()):
        failed.append(f"launches: kernel run {ck}, plain run {cp}")
    if failed:
        raise RuntimeError("train step: kernel path disagrees with the "
                           "plain path: " + "; ".join(failed))


# ── phase 7: SFT steps at full width through train/sft.py ───────────

class TimedBatches:
    """The same collated batch `n` times, as the trainer's data: each
    request for the next batch waits for the device and notes the time and
    the kernels' launch counts, so step i took times[i + 1] - times[i]."""

    def __init__(self, batch, n: int, counters):
        self.batch, self.n, self.counters = batch, n, counters
        self.times, self.counts = [], []

    def __len__(self):
        return self.n

    def __iter__(self):
        for _ in range(self.n):
            self._mark()
            yield self.batch
        self._mark()

    def _mark(self):
        import torch
        torch.cuda.synchronize()
        self.times.append(time.perf_counter())
        self.counts.append({k: w.launches for k, w in self.counters.items()})


def _model_flops(model, cfg, b: int, s: int) -> float:
    """Matmul FLOPs of one step, from the parameter counts (attention's
    own q.k and p.v products are not counted)."""
    groups = {"dec": 0, "xattn": 0, "head": 0, "clip": 0, "perc": 0}
    for name, p in model.named_parameters():
        if name.startswith("vision_encoder."):
            groups["clip"] += p.numel()
        elif name.startswith("perceiver."):
            groups["perc"] += p.numel()
        elif ".xattn_" in name:
            groups["xattn"] += p.numel()
        elif ".wte." in name:
            groups["head"] += p.numel()
        else:
            groups["dec"] += p.numel()
    t, t_img, t_lat = b * s, b * (cfg.vision.num_patches + 1), \
        b * cfg.perceiver.num_latents
    lm = groups["dec"] + groups["xattn"] + groups["head"]
    return (4 * t * lm + 2 * t * (groups["xattn"] + groups["head"])
            + 2 * t * (groups["dec"] + groups["head"])
            + 2 * t_img * groups["clip"] + 6 * t_lat * groups["perc"])


FLOPS_FORMULA = ("4*T*(P_dec+P_xattn+P_head) [forward + activation grads] "
                 "+ 2*T*(P_xattn+P_head) [weight grads] + 2*T*(P_dec+P_head) "
                 "[remat and fused-CE recompute] + 2*T_img*P_clip + "
                 "6*T_lat*P_perc, T = b*s text tokens, T_img = b*257, "
                 "T_lat = b*64")


def phase_train(smi: str, profile: bool = False):
    import numpy as np
    import torch
    from otter_tpu_torch.train import sft
    from otter_tpu_torch.train.args import TrainArgs

    b, s, warm, timed = 2, 1024, 2, 5
    args = TrainArgs(
        model_name="otter", model_config="mpt7b", precision="bf16",
        batch_size=b, gradient_checkpointing=True, fused_ce_chunk=256,
        mask_lm_head=True, learning_rate=1e-4, lr_scheduler="constant",
        warmup_steps=0, logging_steps=1, final_checkpoint=False,
        external_save_dir=os.path.join(OUT_DIR, "train"), run_name="mpt7b",
        seed=SEED)
    run_dir = os.path.join(args.external_save_dir, args.run_name)
    shutil.rmtree(run_dir, ignore_errors=True)
    cfg = sft.CONFIG_FACTORIES[args.model_config]()
    tok = SmokeTokenizer(cfg)
    params = RandomParams(cfg)
    wrappers = _flash_wrappers()
    batches = TimedBatches(make_train_batch(cfg, tok, SEED + 40, b, s),
                           warm + timed, wrappers)
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    state = sft.main(args, tok, batches, params=params, device=DEV)
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()

    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    steps = np.diff(batches.times)
    per_step = [{k: c1[k] - c0[k] for k in c0}
                for c0, c1 in zip(batches.counts, batches.counts[1:])]
    step_s = float(np.median(steps[warm:]))
    n_train = sum(p.numel() for p in state.trainable.values())
    n_all = sum(p.numel() for p in state.model.parameters())
    flops = _model_flops(state.model, cfg, b, s)
    log(f"train: OTTER-MPT7B bf16, {n_all / 1e9:.3f}B parameters, "
        f"{n_train / 1e9:.3f}B trainable (f32 masters + moments), b={b} "
        f"s={s}, one 224x224 image each, remat, fused CE 256, lr 1e-4 | "
        f"{smi}")
    log(f"train: main() {wall:.1f} s for {warm + timed} steps; losses "
        f"{[round(x, 5) for x in losses]}")
    log(f"train: step ms {[round(float(x) * 1e3, 2) for x in steps]} | "
        f"median of "
        f"the last {timed}: {step_s * 1e3:.2f} ms, {b / step_s:.3f} "
        f"samples/s, {b * s / step_s:.1f} tokens/s | {smi}")
    log(f"train: peak memory (torch.cuda.max_memory_allocated) "
        f"{peak / 2 ** 30:.2f} GiB ({peak} bytes)")
    log(f"train: model FLOPs {flops / 1e12:.2f} TFLOP a step = "
        f"{FLOPS_FORMULA}; {flops / step_s / 1e12:.1f} TFLOP/s = "
        f"{100 * flops / step_s / H100_BF16_FLOP_PER_S:.2f}% of 989 TFLOP/s "
        f"| {smi}")
    log(f"train: launches per step {per_step}; whole run {launches}")

    failed = []
    if len(losses) != warm + timed or not all(map(math.isfinite, losses)):
        failed.append(f"losses {losses}")
    elif not losses[-1] < losses[0]:
        failed.append(f"loss did not fall: {losses}")
    with torch.no_grad():
        for path in ("vision_encoder/layers_0/fc1/kernel",
                     "lang_encoder/layers_0/attn/Wqkv/kernel",
                     "lang_encoder/norm_f/scale"):
            now = state.frozen[path]
            before = params["params/" + path]
            same = torch.equal(now, before)
            log(f"train: frozen {path} checksum before "
                f"{float(before.double().sum()):.10e} after "
                f"{float(now.double().sum()):.10e} "
                f"{'bit-identical' if same else 'CHANGED'}")
            if not same:
                failed.append(f"frozen {path} changed")
            del before
        moved = {}
        for path, p in state.trainable.items():
            group = ("wte" if "/wte/" in path else "xattn" if "xattn_" in path
                     else "perceiver")
            n_moved, n = moved.get(group, (0, 0))
            moved[group] = (n_moved + int(not torch.equal(
                p, params["params/" + path])), n + 1)
    log(f"train: trainable tensors changed by group {moved}")
    if sorted(moved) != ["perceiver", "wte", "xattn"] or any(
            m != n for m, n in moved.values()):
        failed.append(f"trainable tensors unchanged: {moved}")
    dead = [k for k in FLASH_COUNTERS if launches[k] == 0]
    if dead:
        failed.append(f"never launched: {dead}")
    if failed:
        raise RuntimeError("train phase failed: " + "; ".join(failed))
    if profile:
        _profile_train_step(state, cfg, args, batches.batch, tok)
    del state
    return launches


def _profile_train_step(state, cfg, args, batch, tok):
    """torch.profiler over one more step of the trained state (after the
    phase's checks): where a step's time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from otter_tpu_torch.train import sft
    from otter_tpu_torch.train.step import make_optimizer, make_train_step
    tx = make_optimizer(state.trainable, lr=args.learning_rate)
    step = make_train_step(state.model, cfg, tx, mask_embedding=True,
                           fused_ce_chunk=args.fused_ce_chunk)
    prepared = sft.prepare_batch(batch, tok, args)
    step(state, prepared)
    torch.cuda.synchronize()
    os.makedirs(OUT_DIR, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(state, prepared)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    _report_profile(prof, wall, "profile train step", "profile_train.txt")


KERNELS = {
    "flash_fwd": ("otter_tpu_torch/csrc/flash_fwd.cu",
                  "otter_tpu/ops/flash_attention.py:84"),
    "int8_mlp": ("otter_tpu_torch/csrc/int8_mlp.cu",
                 "otter_tpu/ops/quant.py:84"),
    "decode_attention": ("otter_tpu_torch/csrc/decode_attention.cu",
                         "otter_tpu/ops/decode_attention.py:219"),
    "flash_bwd_dkv": ("otter_tpu_torch/csrc/flash_bwd.cu",
                      "otter_tpu/ops/flash_attention.py:347"),
    "flash_bwd_dq": ("otter_tpu_torch/csrc/flash_bwd.cu",
                     "otter_tpu/ops/flash_attention.py:444"),
}
PHASES = "kernels,parity,serve,trainparity,train"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=PHASES,
                    help=f"comma-separated subset of {PHASES}, plus profile "
                         "(after serve and train; not run by default). "
                         "Device and build always run.")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    import torch
    smi = phase_device()
    import otter_tpu_torch  # noqa: F401  (the checkout must hold the port)
    walls = {}
    t = time.perf_counter()
    phase_build()
    walls["build"] = time.perf_counter() - t
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)

    def run(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = time.perf_counter() - t0
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        return out

    entries = run("kernels", phase_kernels, gen) if "kernels" in phases \
        else {}
    if "parity" in phases:
        run("parity", phase_parity)
    by_path = {}
    if "serve" in phases:
        def serve():
            launches, engine = phase_serve(smi)
            if "profile" in phases:
                phase_profile(engine)
            return launches
        by_path["serve"] = run("serve", serve)
    if "trainparity" in phases:
        run("trainparity", phase_trainparity)
    if "train" in phases:
        by_path["train"] = run("train", phase_train, smi,
                               "profile" in phases)
    log("phase wall times (s): " + json.dumps(
        {k: round(v, 1) for k, v in walls.items()}))
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        e = entries.get(name, {})
        counts = {path: n[name] for path, n in by_path.items() if name in n}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(counts.values()), launches_by_path=counts,
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
