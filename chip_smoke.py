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
                 otter_tpu_torch/_build/; counts the tensor-core (HMMA /
                 HGMMA) and f32 FFMA instructions of the weight-streaming
                 kernels (the fused int8 and int4 MLPs' main kernels, the
                 fused layer's split-K product) in `cuobjdump -sass` and
                 fails if one has no HMMA.
  3. kernels     each kernel against its plain PyTorch version on the card,
                 in bf16, at the shapes the serving and training paths give
                 it (flash also at OtterHD's full-HD prefill and at head
                 dims 80, 96 and 112), with the tolerance printed; kernel,
                 plain and library-call times and the bound (least time
                 for the same bytes / operations); for every flash case
                 also the device times of the kernel and the library call
                 (below ~0.05 ms a call's wall time is the host's);
                 `int8_mlp` at 4096 -> 16384 -> 4096 (M = 1, 8, 32),
                 OtterHD's with biases and sq_relu (M = 1) and falcon7b's
                 4544 -> 18176 -> 4544 (M = 8), `int8_attn_tail` at M = 1,
                 8 and 32, `decode_attn_megakernel` at b = 1 and 8 over
                 caches of 256 and 2048, each with its device time and two
                 calls compared bit for bit (the megakernel also with the
                 device time of each of its kernels at b=8 pos 255),
                 `int4_mlp` at 4096 -> 16384 -> 4096 (M = 1, 8, 32; the
                 xattn FF at M = 8) and falcon7b's widths (M = 8), each
                 with its device time and two calls compared bit for bit;
                 `int8_matmul` and `int4_matmul` with their device times.
  4. parity      OTTER-MPT7B at full width with its depth cut, once with
                 int8 weights and an int8 KV cache and once with int4
                 weights and an int4 cache, then OTTER-LLaMA2-Chat-7B and
                 OtterHD-8B cut the same way with int8 weights and cache:
                 first-step logits (prefill and
                 first cached decode step) through the kernels against the
                 same model with every kernel swapped for its plain version.
                 Then the int8 model with `megakernel=True` (bf16 cache) and
                 with `fused_tail=True` (int8 cache) on full-length prompts:
                 kernels against plain, and against the composed route of
                 the same weights.
  5. serve       OTTER-MPT7B at full width (32 layers, 8 xattn blocks, CLIP
                 ViT-L/14, perceiver depth 6; random weights from a seed,
                 the decoder's and xattn's quantized to int8), int8 KV cache, decode_kernel="auto":
                 greedy requests through OtterGenerator.generate at batch 1
                 and 8, ragged left-padded 32-128-token prompts, each with
                 one 224x224 image, 32 new tokens. Prints TTFT and decode
                 tok/s (medians of 3 runs). Every serving kernel's launch
                 count must rise during this phase.
  6. serve4      the same requests on the same model with its MLP pairs
                 packed to int4 (`quant="int4"`: decoder ffn and xattn ff at
                 0.5 byte a weight, attention projections int8) and the
                 nibble-fused int4 KV cache, through `generate` and, at
                 batch 1, `stream_generate`. flash_fwd, int4_mlp and the
                 int4 decode_attention must launch, int8_mlp must not; a
                 b=8 decode step launches int4_mlp exactly 40 times and
                 the int4 decode_attention 32, a prefill flash_fwd 70.
  7. trainparity the depth-cut model in bf16 (not quantized): one SFT step
                 (b=2, 1024 tokens, one image each, remat, fused CE) through
                 the kernels against the same step with every kernel swapped
                 for its plain version: loss, every trainable gradient,
                 grad norm.
  8. fused       the decode bench (otter_tpu_torch/tools/bench_decode.py) at
                 full width and depth, b=8, prompt 128, cache 256, int8
                 weights, three times: (a) the composed decode layer with a
                 bf16 cache, (b) `megakernel=True` with a bf16 cache, (c)
                 `fused_tail=True` with an int8 cache. Checks the launches a
                 decode step of every kernel on each route, that greedy
                 tokens repeat between runs, and that (b) holds one more
                 int8 copy of Wqkv and Wo; prints step ms (wall, and the
                 device's from the kernels' own times), tok/s and the
                 share of the memory roofline of the three.
  9. llama       OTTER-LLaMA2-Chat-7B at full width and depth (32 layers of
                 RoPE, RMSNorm and SwiGLU 11008, 8 xattn blocks, CLIP
                 ViT-L/14, perceiver depth 6, untied head of 32002 rows),
                 int8 weights and KV cache, decode_kernel="auto": the serve
                 phase's requests through `generate` and, at batch 1,
                 `stream_generate`. A decode step must launch `int8_matmul`
                 once (the head), the int8 decode_attention 32 times and
                 `int8_mlp` 8 times (the xattn FFs: the gated MLPs never
                 reach it), a prefill `flash_fwd` 70 times.
 10. otterhd     OtterHD-8B (Fuyu: Persimmon-8B, 36 layers, 64 heads of 64,
                 per-head q/k LayerNorm, partial rotary, squared-ReLU MLP
                 16384 with biases, untied head of 262144 rows; image
                 patches projected into the token stream), int8 weights,
                 int8 embedding table, int8 KV cache: one request at a time
                 through `generation.fuyu.fuyu_generate`, a 448x448 image
                 (240 image tokens) and a 1080x1920 image (2340) with a
                 16-token prompt each, 32 greedy tokens. A decode step must
                 launch `int8_matmul` once, `int8_mlp` 36 times and the int8
                 decode_attention 36 times, a prefill `flash_fwd` 36 times.
 11. train       OTTER-MPT7B at full width in bf16 through train/sft.py's
                 main: 2 warm-up and 5 timed SFT steps on one synthetic
                 batch (b=2, 1024 tokens, one 224x224 image each, remat,
                 fused CE, embedding-row mask, lr 1e-4 constant). Checks
                 finite and falling loss, frozen weights bit-identical,
                 every trainable group moved, and the flash forward and
                 both backward kernels launched; prints step time,
                 samples/s, tokens/s, peak memory and model FLOP share.

The last two lines of standard output are the kernels JSON object and the
device JSON object. `--phases` runs a subset (for bring-up); the default
runs all eleven. `flashkernels` runs the flash part of the kernels phase
alone, `mlpkernels` its `int8_mlp` and `int8_attn_tail` cases,
`fusedkernels` the tail and the megakernel, `int4kernels` `int4_mlp` and
`int4_matmul`, `headkernels` `int8_matmul`, `decodekernels`
`decode_attention`. `--port-root
DIR` imports `otter_tpu_torch` from another checkout, so that two versions
of the port run one after the other in one call. `profile` (not run by default) adds torch.profiler tables
of one batch-8 request (with serve, serve4 and llama), of OtterHD's two
requests (with otterhd), of the three fused runs (with fused: device ms
and launches a decode step) and of one train
step (with train) to the output directory, `OUT_DIR`.
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


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one call of fn: CUDA events around `iters` calls
    queued behind a ~10 ms spin kernel, so the card runs them back to back
    whatever the host's pace. Where the host takes longer to launch a call
    than the card to run it, `time_ms` measures the host; this does not."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)   # cycles: longer than the host's queueing
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(out, ref, keep=None, per_row=False, slack=None):
    """(max |err|, its largest excess over |err| <= 2e-2 + 2e-2 |plain|).
    `per_row`: the absolute 2e-2 scaled down to each row's (last dim's)
    largest |plain| where that is below 1, so that a row of small values,
    as a long decode span averages to, is held to its own scale. `slack`:
    a tensor added to the bound (a rounding that the function itself does
    before a cancellation)."""
    import torch
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    floor = torch.full_like(r, 2e-2)
    if per_row:
        floor = floor * r.amax(-1, keepdim=True).clamp(max=1)
    if slack is not None:
        floor = floor + slack.float()
    if keep is not None:
        d, r, floor = d[keep], r[keep], floor[keep]
    return float(d.max()), float((d - (floor + 2e-2 * r)).max())


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

# the weight-streaming kernels that must run on the tensor cores, and the
# sources they are built into
TENSOR_CORE_KERNELS = {
    "int8_mlp_hidden_kernel": ("int8_mlp", "int8_attn_tail"),
    "int4_mlp_hidden_kernel": ("int4_mlp",),
    "int8_matmul_partial_kernel": ("megakernel", "int8_attn_tail"),
    "int8_matmul_kernel": ("int8_matmul",),
    "int4_matmul_kernel": ("int4_mlp",),
}


def phase_build(check_sass: bool = True):
    """`check_sass`: fail if an instantiation of a kernel of
    `TENSOR_CORE_KERNELS` runs no tensor-core instruction (off for another
    version of the port)."""
    from otter_tpu_torch import _build
    t0 = time.perf_counter()
    logs = _build.build(_build.all_sources())
    log(f"build: {sorted(logs)} compiled in {time.perf_counter() - t0:.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    counts = {kernel: _sass_counts(_build, sources, kernel)
              for kernel, sources in TENSOR_CORE_KERNELS.items()}
    with open(os.path.join(OUT_DIR, "build_log.txt"), "w") as f:
        for name, text in sorted(logs.items()):
            f.write(f"== {name}.cu\n{text}\n")
        for kernel, c in counts.items():
            f.write(f"== SASS of {kernel}\n{json.dumps(c)}\n")
    for kernel, c in counts.items():
        log(f"build: SASS of {kernel}<n-tiles...>: {c}")
        if check_sass and any(n["HMMA"] + n["HGMMA"] == 0
                              for n in c.values()):
            raise RuntimeError(f"{kernel} runs no tensor-core instruction")


def _sass_counts(build, sources, kernel: str) -> dict:
    """{source:function: counts of tensor-core (HMMA, HGMMA) and f32 FFMA
    instructions} for every function of the built `sources` whose name
    holds `kernel`, from `cuobjdump -sass`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for src in sources:
        sass = subprocess.run([tool, "-sass", str(build._target(src))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                fn = f"{src}:{fn}" if kernel in fn else None
                if fn:
                    counts[fn] = {"HMMA": 0, "HGMMA": 0, "FFMA": 0}
            elif fn:
                for op in ("HGMMA", "HMMA", "FFMA"):
                    if f" {op}." in line or f" {op} " in line:
                        counts[fn][op] += 1
                        break
    if not counts:
        raise RuntimeError(f"no {kernel} in the SASS of {sources}")
    return counts


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


def _fuyu_prefill_case(gen):
    """OtterHD-8B's full-HD prefill: one request of 2356 tokens (a
    1080x1920 image and a 16-token prompt), 64 heads of 64, causal, ids of
    its attention mask (all ones)."""
    import torch
    s = 2356
    q, k, v = (torch.randn(1, 64, s, 64, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    ids = torch.ones((1, s), dtype=torch.int32, device="cuda")
    return ("fuyu_prefill", dict(q=q, k=k, v=v, q_ids=ids, kv_ids=ids,
                                 causal=True, sm_scale=64 ** -0.5), None)


def _flash_head_dim_cases(gen):
    """Small cases at the head dims of mpt30b (112) and idefics-9b's ViT-H
    tower and perceiver (80, 96): causal with ALiBi and left-padding ids
    (the decoder), and non-causal with a full [B, 1, S_q, S_k] bias."""
    import torch
    from otter_tpu_torch.ops.masks import alibi_slopes
    dev = "cuda"
    cases = []
    for d in (80, 96, 112):
        rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev,
                                         dtype=torch.bfloat16)
        s = 320
        pos = torch.arange(s, device=dev)
        ids = (pos[None, :] >= torch.tensor([0, 57], device=dev)[:, None]
               ).int()
        bias = (torch.arange(1 - s, 1, device=dev)[None, None, None, :]
                * alibi_slopes(4, device=dev)[None, :, None, None])
        cases.append((f"d{d}_causal", dict(
            q=rnd(2, 4, s, d), k=rnd(2, 4, s, d), v=rnd(2, 4, s, d),
            bias=bias, q_ids=ids, kv_ids=ids, causal=True,
            sm_scale=d ** -0.5)))
        cases.append((f"d{d}_cross", dict(
            q=rnd(2, 4, 200, d), k=rnd(2, 4, 333, d), v=rnd(2, 4, 333, d),
            bias=torch.randn(2, 1, 200, 333, generator=gen, device=dev),
            sm_scale=d ** -0.5)))
    return cases


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


def _sdpa_backward(kw, do):
    """SDPA's backward on the same inputs: time(forward + backward) -
    time(forward), with the mask as a float attn_mask (a finite fill, so
    rows that attend nothing average v as the port does); the same
    difference of device times."""
    import torch
    import torch.nn.functional as F
    mask = _sdpa_args(kw, fill=-1e30)
    leaves = [kw[n].detach().requires_grad_() for n in ("q", "k", "v")]
    scale = kw.get("sm_scale", kw["q"].shape[-1] ** -0.5)
    fwd = lambda: F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                 scale=scale)
    both = lambda: torch.autograd.grad(fwd(), leaves, do)
    return (time_ms(both, 10) - time_ms(fwd, 10),
            device_ms(both) - device_ms(fwd))


def _sdpa_fwd(kw, fill=float("-inf")):
    """One SDPA call that computes the same attention: with is_causal and
    no mask where the case has no bias and its ids mask nothing (SDPA's
    own flash kernel), else with an additive mask."""
    import torch
    import torch.nn.functional as F
    scale = kw.get("sm_scale", kw["q"].shape[-1] ** -0.5)
    ids = [kw.get(n) for n in ("q_ids", "kv_ids")]
    # "eq" ids that all hold one value allow every pair
    one_id = ids[0] is None or (
        kw.get("ids_mode", "eq") == "eq"
        and int(torch.cat([i.flatten() for i in ids]).unique().numel()) == 1)
    if kw.get("bias") is None and one_id:
        causal = bool(kw.get("causal"))
        return lambda: F.scaled_dot_product_attention(
            kw["q"], kw["k"], kw["v"], is_causal=causal, scale=scale)
    mask = _sdpa_args(kw, fill)
    return lambda: F.scaled_dot_product_attention(
        kw["q"], kw["k"], kw["v"], attn_mask=mask, scale=scale)


def _flash_kernels(gen, report, entries):
    """The flash forward and both backward kernels against their plain
    twins: the serving prefill shapes, OtterHD's full-HD prefill, the
    training shapes, and small cases at head dims 80, 96 and 112."""
    import torch
    from otter_tpu_torch.ops import flash_attention as fa

    # flash attention forward: four prefill configurations
    for case, kw, keep in _flash_cases(gen) + [_fuyu_prefill_case(gen)]:
        out = fa.flash_attention(**kw)
        ref = fa.flash_attention_plain(**kw)
        torch.cuda.synchronize()
        keep4 = None if keep is None else keep[:, None, :, None].expand_as(out)
        err, excess = max_err(out, ref, keep4)
        kern = lambda kw=kw: fa.flash_attention(**kw)
        r = report("flash_fwd", case, err, excess, time_ms(kern),
                   time_ms(lambda kw=kw: fa.flash_attention_plain(**kw), 5),
                   time_ms(_sdpa_fwd(kw)), *_flash_cost(kw),
                   device=(device_ms(kern), device_ms(_sdpa_fwd(kw))))
        if case == "mpt_prefill":
            entries["flash_fwd"] = r

    # flash attention backward: the training path's three attention sites
    # and a length that is not a multiple of the 64-row tile
    log("kernels: flash at the training shapes; forward tolerance as "
        "above; backward |err| <= 2e-2*max|plain| + 2e-2*|plain| (bf16 "
        "out, f32 inside); backward plain = the whole plain backward (dq, "
        "dk, dv); backward library = SDPA forward+backward - forward")
    for case, kw in ([(f"train {c}", kw) for c, kw in _flash_bwd_cases(gen)]
                     + _flash_head_dim_cases(gen)):
        args = [kw["q"], kw["k"], kw["v"], kw.get("bias"), kw.get("q_ids"),
                kw.get("kv_ids")]
        opts = {n: kw[n] for n in ("causal", "sm_scale", "ids_mode")
                if n in kw}
        out, lse = fa.flash_attention(*args, return_lse=True, **opts)
        # the forward at the training shapes too (row 1 of PERF.md's table)
        err, excess = max_err(out, fa.flash_attention_plain(*args, **opts))
        kern = lambda: fa.flash_attention(*args, **opts)
        report("flash_fwd", case, err, excess, time_ms(kern, 10),
               time_ms(lambda: fa.flash_attention_plain(*args, **opts), 3, 1),
               time_ms(_sdpa_fwd(kw, fill=-1e30), 10), *_flash_cost(kw),
               device=(device_ms(kern), device_ms(_sdpa_fwd(kw, fill=-1e30))))
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
        lib_ms, lib_dev = _sdpa_backward(kw, do)
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
                       lib_ms, *_flash_bwd_cost(kw, products, len(names)),
                       device=(device_ms(fn), lib_dev))
            if case == "train mpt":
                entries[kernel] = r
        del out, lse, do, di, dk, dv, dq, pq, pk, pv



def phase_kernels(gen, only: str = ""):
    """Every kernel against its plain version; `only` (for bring-up) checks
    a part alone: "fused" (phase `fusedkernels`) the fused decode layer's
    two, "head" (phase `headkernels`) `int8_matmul`, "flash" (phase
    `flashkernels`) the flash forward and backward, "decode" (phase
    `decodekernels`) `decode_attention`, "mlp" (phase `mlpkernels`)
    `int8_mlp` and `int8_attn_tail`, "int4" (phase `int4kernels`)
    `int4_mlp` and `int4_matmul`."""
    tol = "|err| <= 2e-2 + 2e-2*|plain| (bf16 in/out, f32 inside)"
    log(f"kernels: tolerance {tol}")
    entries = {}
    failed = []

    def report(kernel, case, err, excess, ms, plain_ms, lib_ms, nbytes,
               flops, device=None):
        """`device`: (kernel, library) device ms from `device_ms` (CUDA
        events around calls queued behind a spin kernel), where measured;
        the TFLOP/s and share of the bound are the device's."""
        b_ms, b_by = bound_ms(nbytes, flops)
        ok = excess <= 0 and math.isfinite(err)
        dev = ""
        if device is not None:
            lib_dev = ("none" if device[1] is None
                       else f"{device[1]:.4f} ms")
            dev = (f" | device: kernel {device[0]:.4f} ms "
                   f"({flops / device[0] / 1e9:.1f} TFLOP/s, "
                   f"{100 * b_ms / device[0]:.1f}% of the bound), library "
                   f"{lib_dev}")
        log(f"  {kernel}[{case}]: max_abs_err {err:.3e} "
            f"{'ok' if ok else f'FAIL (by {excess:.3e})'} | kernel "
            f"{ms:.4f} ms | plain "
            f"{plain_ms:.4f} ms | library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} | bound "
            f"{b_ms:.4f} ms ({b_by}){dev}")
        if not ok:
            failed.append(f"{kernel}[{case}]")
        r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=lib_ms)
        if device is not None:
            r.update(device_ms=device[0], library_device_ms=device[1])
        return r

    def done():
        if failed:
            raise RuntimeError(f"kernels disagree with their plain "
                               f"versions: {failed}")
        return entries

    if only:
        {"fused": _fused_layer_kernels, "head": _head_kernel,
         "flash": _flash_kernels, "decode": _decode_kernels,
         "mlp": _mlp_kernels, "int4": _int4_kernels}[only](
            gen, report, entries)
        return done()

    _flash_kernels(gen, report, entries)

    _mlp_kernels(gen, report, entries)
    _int4_kernels(gen, report, entries)
    _decode_kernels(gen, report, entries)
    _fused_layer_kernels(gen, report, entries, tail=False)
    _head_kernel(gen, report, entries)
    return done()


def _int4_kernels(gen, report, entries):
    """`int4_mlp` at the decoder MLP's widths (4096 -> 16384 -> 4096, gelu:
    0.5 byte a weight) at M = 1, 8 and 32 (32: the largest decode call), at
    the xattn FF's (the same widths) at M = 8 and at falcon7b's 4544 ->
    18176 -> 4544 at M = 8 (K % 128 != 0; 142 CTAs, beyond the 132 SMs),
    and `int4_matmul` at MPT-7B's qkv and out-proj widths (M = 1, 8, 32),
    against their plain versions, with device times and two calls compared
    bit for bit. Enough weight sets in turn that the timed reads come from
    device memory and not from the 50 MB L2 (67 MB a set at MPT's widths,
    41 MB at falcon7b's). No single PyTorch call computes `int4_mlp`;
    `int4_matmul`'s library call is `torch._weight_int4pack_mm` where the
    card's torch has a CUDA kernel for it (`_int4pack`: the weight
    converted once, outside the timed calls)."""
    import torch
    from otter_tpu_torch.ops import quant
    k_in = 4096
    cases = (("M=1", 4096, 16384, 1, 2), ("M=8", 4096, 16384, 8, 2),
             ("M=32", 4096, 16384, 32, 2),
             ("xattn ff M=8", 4096, 16384, 8, 2),
             ("falcon7b M=8", 4544, 18176, 8, 3))
    int4_sets = {}
    for case, k, hid, m, copies in cases:
        if (k, hid) not in int4_sets:
            int4_sets.clear()
            int4_sets[(k, hid)] = [
                quant.quantize_kernel_int4(0.02 * torch.randn(
                    k, hid, generator=gen, device="cuda"), 0)
                + quant.quantize_kernel_int4(0.02 * torch.randn(
                    hid, k, generator=gen, device="cuda"), 1)
                for _ in range(copies)]
        sets = int4_sets[(k, hid)]
        x = torch.randn(m, k, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        out = quant.int4_mlp(x, *sets[0])
        ref = quant.int4_mlp_plain(x, *sets[0])
        torch.cuda.synchronize()
        err, excess = max_err(out, ref)
        if not bool(torch.isfinite(out.float()).all()) or not _bits_repeat(
                lambda: quant.int4_mlp(x, *sets[0]), out):
            excess = float("inf")
        it = iter(range(10 ** 9))

        def call():
            return quant.int4_mlp(x, *sets[next(it) % copies])

        nbytes = k * hid + 4 * (hid + k) + 2 * 2 * m * k
        r = report("int4_mlp", case, err, excess, time_ms(call),
                   time_ms(lambda: quant.int4_mlp_plain(
                       x, *sets[next(it) % copies]), 5), None,
                   nbytes, 2.0 * m * 2 * k * hid,
                   device=(device_ms(call), None))
        # the main kernel, and the sum of its partial outputs (a dependent
        # launch: its span starts early, at the main kernel's phase 2)
        subs = _kernel_device_ms(call, 2)
        log("    its kernels, device ms a call (torch.profiler, 20 calls): "
            + ", ".join(f"{n} {t:.4f}" for n, t in subs.items()))
        r["sub_kernels_device_ms"] = subs
        if case == "M=8":
            entries["int4_mlp"] = r
    del int4_sets

    has_lib = _has_cuda_kernel("aten::_weight_int4pack_mm")
    for case, n_out, copies in (("qkv", 3 * k_in, 3), ("out_proj", k_in, 8)):
        sets = [quant.quantize_kernel_int4(0.02 * torch.randn(
            k_in, n_out, generator=gen, device="cuda"), 0)
            for _ in range(copies)]
        lib_sets = [_int4pack(wp, sc) for wp, sc in sets] if has_lib \
            else None
        for m in (1, 8, 32):
            x = torch.randn(m, k_in, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            out = quant.int4_matmul(x, *sets[0])
            ref = quant.int4_matmul_plain(x, *sets[0])
            torch.cuda.synchronize()
            err, excess = max_err(out, ref)
            if not bool(torch.isfinite(out.float()).all()) or not _bits_repeat(
                    lambda: quant.int4_matmul(x, *sets[0]), out):
                excess = float("inf")
            it = iter(range(10 ** 9))

            def call():
                return quant.int4_matmul(x, *sets[next(it) % copies])

            lib_ms = lib_dev = None
            if lib_sets is not None:
                def lib():
                    wpk, sz = lib_sets[next(it) % copies]
                    return torch._weight_int4pack_mm(x, wpk, 128, sz)

                try:
                    lib_err = max_err(torch._weight_int4pack_mm(
                        x, lib_sets[0][0], 128, lib_sets[0][1]), ref)[0]
                    lib_ms, lib_dev = time_ms(lib), device_ms(lib)
                    log(f"    library: group size 128, the column's scale "
                        f"rounded to bf16 in every group, zero points 0; "
                        f"max |err| against the plain version "
                        f"{lib_err:.3e}")
                except RuntimeError as e:   # a shape the op refuses
                    log(f"    library call refused: {e}")
            nbytes = k_in * n_out // 2 + 4 * n_out + 2 * m * (k_in + n_out)
            r = report("int4_matmul", f"{case} M={m}", err, excess,
                       time_ms(call),
                       time_ms(lambda: quant.int4_matmul_plain(
                           x, *sets[next(it) % copies]), 5), lib_ms,
                       nbytes, 2.0 * m * k_in * n_out,
                       device=(device_ms(call), lib_dev))
            subs = _kernel_device_ms(call, 2)
            log("    its kernels, device ms a call (torch.profiler, 20 "
                "calls): " + ", ".join(f"{n} {t:.4f}" for n, t in subs.items()))
            r["sub_kernels_device_ms"] = subs
            if (case, m) == ("qkv", 8):
                entries["int4_matmul"] = r
        del sets, lib_sets


def _int4pack(wp, scale):
    """`wp` (pack_axis 0, values in [-7, 7]) and its f32 per-column scale
    as `torch._weight_int4pack_mm` takes them: unsigned nibbles q = v + 8
    of W^T [N, K], two a byte along K (even k in the high nibble), tiled
    by `torch._convert_weight_to_int4pack`, and a [K / 128, N, 2] bf16
    table of (scale, zero point 0) for groups of 128 rows; the op
    computes x @ ((q - 8) * scale + 0)."""
    import torch
    from otter_tpu_torch.ops import quant
    q = (quant.unpack_int4(wp, 0).t().to(torch.int32) + 8)
    packed = (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8).contiguous()
    k, n = 2 * wp.shape[0], wp.shape[1]
    sz = torch.zeros(k // 128, n, 2, dtype=torch.bfloat16, device=wp.device)
    sz[:, :, 0] = scale.to(torch.bfloat16)
    return torch._convert_weight_to_int4pack(packed, 8), sz


def _decode_cases(gen):
    """(name, q, cache kind, starts, lengths, bias, stacked-cache shape) of
    the decode-attention cases: MPT's serving cache (b=8, 32 heads of 128,
    L=256; bf16, int8, int4), its long cache (L=2048; int8, int4) and
    OtterHD's full-HD decode (b=1, 64 heads of 64, int8, L=2432 with a span
    of 2372, 36 layers). A case of fewer layers than its model keeps enough
    of them to exceed the 50 MB L2 when each launch reads another layer."""
    import torch
    from otter_tpu_torch.ops.masks import alibi_slopes
    dev = "cuda"

    def alibi(h, L):
        return (torch.arange(L, device=dev)[None, None, :]
                * alibi_slopes(h, device=dev)[None, :, None])

    i32 = lambda x: torch.tensor(x, device=dev, dtype=torch.int32)
    mpt_starts = i32([0, 10, 37, 96, 0, 5, 64, 100])
    mpt_q = torch.randn(8, 32, 128, generator=gen, device=dev,
                        dtype=torch.bfloat16)
    short = i32([160, 150, 141, 129, 200, 133, 170, 190])
    long = i32([2048, 1900, 1500, 1029, 2000, 1333, 1700, 1990])
    cases = [(f"{c} cache", mpt_q, c, mpt_starts, short, alibi(32, 256),
              (8, 32, 32, 256, 128)) for c in ("bf16", "int8", "int4")]
    cases += [(f"{c} cache L=2048", mpt_q, c, mpt_starts, long,
               alibi(32, 2048), (8, 8, 32, 2048, 128))
              for c in ("int8", "int4")]
    # Persimmon is rotary: no bias; the cache holds the 2356-token prompt
    # and 16 new tokens, rounded up to a multiple of 128
    cases.append(("otterhd int8 b=1 L=2432",
                  torch.randn(1, 64, 64, generator=gen, device=dev,
                              dtype=torch.bfloat16),
                  "int8", i32([0]), i32([2372]), None, (1, 36, 64, 2432, 64)))
    return cases


def _decode_kernels(gen, report, entries):
    """`decode_attention` against its plain version at every case of
    `_decode_cases`; device times (`device_ms`) beside SDPA's over a bf16
    cache of the same shape, the library call for the bf16 cache (no single
    PyTorch call reads an int8 or int4 cache: for those SDPA's bf16 time is
    printed for information, and library_ms is none)."""
    import torch
    import torch.nn.functional as F
    from otter_tpu_torch.ops import decode_attention as da
    from otter_tpu_torch.ops import quant

    log("kernels: decode_attention (split over the cache); tolerance "
        "|err| <= 2e-2*min(1, max|plain| of the (batch, head) row) + "
        "2e-2*|plain|; each timed launch reads another layer; device = "
        "CUDA events around 10 calls behind a spin kernel")
    for case, q, cache, starts, lengths, bias, shape in _decode_cases(gen):
        b, nl, h, L, d = shape
        kw = dict(starts=starts, sm_scale=d ** -0.5)
        if cache == "int4":
            kv, ks, vs = quant.quantize_kv_int4(*(
                torch.randn(shape, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2)))
            k = v = kv
            kw.update(k_scale=ks, v_scale=vs, kv_bits=4)
        else:
            k, v = (torch.randn(shape, generator=gen, device="cuda",
                                dtype=torch.bfloat16) for _ in range(2))
            if cache == "int8":
                (k, ks), (v, vs) = quant.quantize_kv(k), quant.quantize_kv(v)
                kw.update(k_scale=ks, v_scale=vs)
        layer = nl // 2
        out = da.decode_attention(q, k, v, lengths, bias, layer=layer, **kw)
        again = da.decode_attention(q, k, v, lengths, bias, layer=layer, **kw)
        ref = da.decode_attention_plain(q, k, v, lengths, bias, layer=layer,
                                        **kw)
        torch.cuda.synchronize()
        err, excess = max_err(out, ref, per_row=True)
        if not torch.equal(out, again):
            log(f"  decode_attention[{case}]: two calls differ")
            excess = float("inf")
        it = iter(range(10 ** 9))
        kern = lambda: da.decode_attention(q, k, v, lengths, bias,
                                           layer=next(it) % nl, **kw)
        plain = lambda: da.decode_attention_plain(q, k, v, lengths, bias,
                                                  layer=next(it) % nl, **kw)
        # SDPA over a bf16 cache of this shape with the same span and bias
        kb = k if cache == "bf16" else torch.randn(
            shape, generator=gen, device="cuda", dtype=torch.bfloat16)
        vb = v if cache == "bf16" else kb
        pos = torch.arange(L, device="cuda")
        ok = (pos[None, :] >= starts[:, None]) & (pos[None, :] < lengths[:, None])
        m = (torch.zeros(b, h, L, device="cuda") if bias is None
             else bias.expand(b, h, L)).masked_fill(
            ~ok[:, None, :], float("-inf"))[:, :, None, :].to(q.dtype)
        lib = lambda: (lambda li: F.scaled_dot_product_attention(
            q[:, :, None], kb[:, li], vb[:, li], attn_mask=m,
            scale=d ** -0.5))(next(it) % nl)
        lib_ms, lib_dev = time_ms(lib), device_ms(lib)
        rows = int((lengths - starts).sum()) * h
        # k and v bytes a position, its two scales, the bias row, q and out
        kv_bytes = {"bf16": 2 * 2 * d, "int8": 2 * d, "int4": d}[cache]
        nbytes = (rows * kv_bytes + (2 * 4 * rows if cache != "bf16" else 0)
                  + (4 * h * L if bias is not None else 0) + 2 * 2 * b * h * d
                  + 2 * 4 * b)
        same = cache == "bf16"   # SDPA computes this function
        r = report("decode_attention", case, err, excess, time_ms(kern),
                   time_ms(plain, 5), lib_ms if same else None,
                   nbytes, 4.0 * rows * d,
                   device=(device_ms(kern), lib_dev if same else None))
        if not same:
            log(f"    (SDPA over a bf16 cache of this shape: wall {lib_ms:.4f}"
                f" ms, device {lib_dev:.4f} ms, for information)")
        if case == "int8 cache":
            entries["decode_attention"] = r
        if case == "int4 cache":
            entries["decode_attention_int4"] = r
        del k, v, kb, vb, kw


def _has_cuda_kernel(op: str) -> bool:
    """Whether the card's torch has a CUDA kernel for the aten `op` (a
    yardstick's library call; the port never calls one)."""
    import torch
    has = torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")
    log(f"  library: {op} has {'a' if has else 'no'} CUDA kernel in torch "
        f"{torch.__version__}")
    return has


def _head_kernel(gen, report, entries):
    """`int8_matmul` against its plain version at the two untied heads that
    reach it (K = 4096; N = 32002, LLaMA-2 with its two added tokens, whose
    rows are not 16-byte aligned, and N = 262144, Fuyu) and at a small odd
    shape (a view at shift 7), each with its device time and two calls
    compared bit for bit. The 131 MB head comes in two copies used in turn,
    so that the timed reads come from device memory and not from the 50 MB
    L2; the 1.07 GB head exceeds it alone. The library call is
    `torch._weight_int8pack_mm` (x @ W^T * scale with W int8 [N, K] and a
    bf16 scale) where the card's torch has a CUDA kernel for it: the weight
    is transposed once, outside the timed calls. Beside it, for
    information, the time of what the kernel replaces in the model:
    `Int8Dense`'s composed product (convert to bf16, cuBLAS, scale)."""
    import torch
    from otter_tpu_torch.ops import quant
    k_in = 4096

    def head(n_out):
        # quantized in column slices: an f32 copy of the 1.07 G weights and
        # its temporaries would take tens of GB
        wq = torch.empty(k_in, n_out, dtype=torch.int8, device="cuda")
        sc = torch.empty(n_out, dtype=torch.float32, device="cuda")
        for j in range(0, n_out, 32768):
            q, s1 = quant.quantize_kernel(0.02 * torch.randn(
                k_in, min(32768, n_out - j), generator=gen, device="cuda"))
            wq[:, j:j + q.shape[1]], sc[j:j + q.shape[1]] = q, s1
        return wq, sc

    def composed(x, wq, sc):
        return (x @ wq.to(torch.bfloat16)) * sc.to(torch.bfloat16)

    has_lib = _has_cuda_kernel("aten::_weight_int8pack_mm")

    for case, n_out, copies, ms_ in (("llama head N=32002", 32002, 2,
                                      (1, 8, 32)),
                                     ("fuyu head N=262144", 262144, 1,
                                      (1, 8)),
                                     ("odd N=130", 130, 1, (3,))):
        sets = [head(n_out) for _ in range(copies)]
        k_here = k_in
        if n_out == 130:   # a view into a wider weight: stride 141, shift 7
            k_here = 256
            wide, sc = sets[0]
            wide = torch.cat([wide[:k_here], wide[:k_here, :11]], dim=1)
            sets = [(wide[:, 7:137], sc)]
        lib_sets = [(w.t().contiguous(), sc.to(torch.bfloat16))
                    for w, sc in sets] if has_lib else None
        for m in ms_:
            x = torch.randn(m, k_here, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            out = quant.int8_matmul(x, *sets[0])
            ref = quant.int8_matmul_plain(x, *sets[0])
            torch.cuda.synchronize()
            err, excess = max_err(out, ref)
            if not bool(torch.isfinite(out.float()).all()) or not _bits_repeat(
                    lambda: quant.int8_matmul(x, *sets[0]), out):
                excess = float("inf")
            it = iter(range(10 ** 9))

            def call():
                return quant.int8_matmul(x, *sets[next(it) % copies])

            lib_ms = lib_dev = None
            if lib_sets is not None:
                def lib():
                    return torch._weight_int8pack_mm(
                        x, *lib_sets[next(it) % copies])

                try:
                    lib_ms, lib_dev = time_ms(lib), device_ms(lib)
                except RuntimeError as e:   # a shape the op refuses
                    log(f"    library call refused: {e}")
            nbytes = k_here * n_out + 4 * n_out + 2 * m * (k_here + n_out)
            r = report("int8_matmul", f"{case} M={m}", err, excess,
                       time_ms(call),
                       time_ms(lambda: quant.int8_matmul_plain(
                           x, *sets[next(it) % copies]), 3, 1), lib_ms,
                       nbytes, 2.0 * m * k_here * n_out,
                       device=(device_ms(call), lib_dev))
            composed_ms = time_ms(
                lambda: composed(x, *sets[next(it) % copies]), 5, 1)
            log(f"    Int8Dense's composed product on the same tensors: "
                f"{composed_ms:.4f} ms")
            if (n_out, m) == (32002, 8):
                entries["int8_matmul"] = r
        del sets


def _qk(gen, rows, cols):
    import torch
    from otter_tpu_torch.ops import quant
    return quant.quantize_kernel(0.02 * torch.randn(
        rows, cols, generator=gen, device="cuda"))


def _bits_repeat(fn, out) -> bool:
    import torch
    again = fn()
    torch.cuda.synchronize()
    same = torch.equal(out, again)
    if not same:
        log("  two calls differ: the sums' order is not fixed")
    return same


def _mlp_kernels(gen, report, entries):
    """`int8_mlp` alone, then `int8_attn_tail` alone (`_tail_kernels`),
    against their plain versions, with device times: the decoder MLP 4096
    -> 16384 -> 4096 (gelu) at M = 1, 8 and 32, OtterHD's (biases,
    sq_relu) at M = 1, falcon7b's 4544 -> 18176 -> 4544 at M = 8. A call
    reads 134-165 MB of weights, more than the 50 MB L2, so one weight set
    serves. No single PyTorch call computes it: library "none"."""
    import torch
    from otter_tpu_torch.ops import quant
    cases = (("M=1", 4096, 16384, 1, "gelu", False),
             ("M=8", 4096, 16384, 8, "gelu", False),
             ("M=32", 4096, 16384, 32, "gelu", False),
             ("otterhd M=1 biases sq_relu", 4096, 16384, 1, "sq_relu", True),
             ("falcon7b M=8", 4544, 18176, 8, "gelu", False))
    weights = {}
    for case, k, h, m, act, biases in cases:
        if (k, h) not in weights:
            weights.clear()
            weights[(k, h)] = _qk(gen, k, h) + _qk(gen, h, k)
        w1q, s1, w2q, s2 = weights[(k, h)]
        kw = dict(act=act)
        if biases:
            kw.update(b1=0.1 * torch.randn(h, generator=gen, device="cuda"),
                      b2=0.1 * torch.randn(k, generator=gen, device="cuda"))
        x = torch.randn(m, k, generator=gen, device="cuda",
                        dtype=torch.bfloat16)

        def call():
            return quant.int8_mlp(x, w1q, s1, w2q, s2, **kw)

        def plain():
            return quant.int8_mlp_plain(x, w1q, s1, w2q, s2, **kw)

        out, ref = call(), plain()
        torch.cuda.synchronize()
        err, excess = max_err(out, ref)
        if not _bits_repeat(call, out):
            excess = float("inf")
        nbytes = (2 * k * h + 4 * (h + k) * (2 if biases else 1)
                  + 2 * 2 * m * k)
        r = report("int8_mlp", case, err, excess, time_ms(call),
                   time_ms(plain, 5), None, nbytes, 2.0 * m * 2 * k * h,
                   device=(device_ms(call), None))
        if case == "M=8":
            entries["int8_mlp"] = r
    del weights
    _tail_kernels(gen, report, entries)


def _tail_kernels(gen, report, entries):
    """`int8_attn_tail` (out-proj + residual, norm_2, MLP + residual) against
    its plain version at MPT-7B's widths, M = 1, 8 and 32, two weight sets
    in turn (151 MB each), two calls compared bit for bit."""
    import torch
    from otter_tpu_torch.ops import quant
    d, hid = 4096, 16384
    tails = []
    for _ in range(2):
        (wo, so), (w1, s1), (w2, s2) = (_qk(gen, d, d), _qk(gen, d, hid),
                                        _qk(gen, hid, d))
        gain = 1 + 0.02 * torch.randn(d, generator=gen, device="cuda")
        tails.append((wo, so, gain, w1, s1, w2, s2))
    for m in (1, 8, 32):
        a, r = (torch.randn(m, d, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        out = quant.int8_attn_tail(a, r, *tails[0])
        ref, mlp = quant.int8_attn_tail_plain(a, r, *tails[0],
                                              return_mlp=True)
        torch.cuda.synchronize()
        # the function rounds its MLP output (|~50| at these widths) to
        # bf16 before the residual, which may cancel it: one bf16 step of
        # that output, 2^-7 |mlp|, is allowed beside the tolerance
        err, excess = max_err(out, ref, slack=2.0 ** -7 * mlp.float().abs())
        if not bool(torch.isfinite(out.float()).all()) or not _bits_repeat(
                lambda: quant.int8_attn_tail(a, r, *tails[0]), out):
            excess = float("inf")
        it = iter(range(10 ** 9))

        def call():
            return quant.int8_attn_tail(a, r, *tails[next(it) % 2])

        nbytes = (d * d + 2 * d * hid) + 4 * (3 * d + hid) + 2 * 3 * m * d
        res = report("int8_attn_tail", f"M={m}", err, excess, time_ms(call),
                     time_ms(lambda: quant.int8_attn_tail_plain(
                         a, r, *tails[next(it) % 2]), 5), None, nbytes,
                     2.0 * m * (d * d + 2 * d * hid),
                     device=(device_ms(call), None))
        if m == 8:
            entries["int8_attn_tail"] = res
    del tails


# the kernels one `decode_attn_megakernel` call launches: row norm, qkv
# product, attention, Wo product, sum of the partials
MEGAKERNEL_KERNELS = 5


def _fused_layer_kernels(gen, report, entries, tail: bool = True):
    """`int8_attn_tail` (with `tail`; `_tail_kernels`) and
    `decode_attn_megakernel` against their plain versions at MPT-7B's
    widths (D=4096, H=16384, 32 heads of 128): the megakernel at b = 1 and
    8, pos 0, 57 and 255 of a cache of 256 and pos 2047 of 2048, with two
    calls compared bit for bit, its device time and, at b=8 pos 255, the
    device time of each of its kernels (torch.profiler). Two weight sets in
    turn (and another cache layer each launch), so that the timed reads
    come from device memory and not from the 50 MB L2. No single PyTorch
    call computes either: library "none"."""
    import torch
    from otter_tpu_torch.ops import megakernel as mk
    from otter_tpu_torch.ops.masks import alibi_slopes
    d, h, dh = 4096, 32, 128

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    def gain():
        return 1 + 0.02 * torch.randn(d, generator=gen, device="cuda")

    def worst(outs, refs):
        pairs = [max_err(o, r) for o, r in zip(outs, refs)]
        finite = all(bool(torch.isfinite(o.float()).all()) for o in outs)
        return (max(e for e, _ in pairs),
                max(x for _, x in pairs) if finite else float("inf"))

    if tail:
        _tail_kernels(gen, report, entries)

    # the attention half: norm_1, qkv, cached attention, out-proj + residual
    wqos = []
    for _ in range(2):
        (wqkv, sqkv), (wo, so) = _qk(gen, d, 3 * d), _qk(gen, d, d)
        wqos.append((gain(), torch.cat([wqkv, wo], dim=1).contiguous(),
                     torch.cat([sqkv, so])))
        del wqkv, wo
    cases_256 = tuple((b, pos) for b in (8, 1) for pos in (0, 57, 255))
    for L, nl, cases in ((256, 4, cases_256), (2048, 2, ((8, 2047),
                                                          (1, 2047)))):
        bias = (torch.arange(L, device="cuda")[None, :]
                * alibi_slopes(h, device="cuda")[:, None]).float()
        kc, vc = rnd(8, nl, h, L, dh), rnd(8, nl, h, L, dh)
        for b, pos in cases:
            # rows at and past pos hold garbage the kernel must not read
            k, v = kc[:b].clone(), vc[:b].clone()
            k[:, :, :, pos:] = 1e4
            v[:, :, :, pos:] = 1e4
            x = rnd(b, d)
            layer = nl - 1

            def first():
                return mk.decode_attn_megakernel(x, k, v, pos, bias,
                                                 *wqos[0], layer=layer)

            outs = first()
            refs = mk.decode_attn_megakernel_plain(x, k, v, pos, bias,
                                                   *wqos[0], layer=layer)
            torch.cuda.synchronize()
            err, excess = worst(outs, refs)
            again = first()
            torch.cuda.synchronize()
            if not all(torch.equal(o, a) for o, a in zip(outs, again)):
                log("  two calls differ: the sums' order is not fixed")
                excess = float("inf")
            it = iter(range(10 ** 9))

            def call(fn=mk.decode_attn_megakernel):
                i = next(it)
                return fn(x, k, v, pos, bias, *wqos[i % 2], layer=i % nl)

            nbytes = (4 * d * d + 4 * 4 * d + 4 * d + 2 * 2 * b * h * pos * dh
                      + 4 * h * (pos + 1) + 2 * 4 * b * d)
            res = report("decode_attn_megakernel", f"b={b} L={L} pos={pos}",
                         err, excess, time_ms(call),
                         time_ms(lambda: call(
                             mk.decode_attn_megakernel_plain), 5), None,
                         nbytes, 2.0 * b * 4 * d * d + 4.0 * b * h * pos * dh,
                         device=(device_ms(call), None))
            if (b, L, pos) == (8, 256, 255):
                subs = _kernel_device_ms(call, MEGAKERNEL_KERNELS)
                log("    its kernels, device ms a call (torch.profiler, 20 "
                    "calls): " + ", ".join(f"{n} {t:.4f}"
                                           for n, t in subs.items()))
                res["sub_kernels_device_ms"] = subs
                entries["decode_attn_megakernel"] = res
            del k, v
        del kc, vc


def _kernel_device_ms(fn, per_call: int, iters: int = 20,
                      tries: int = 3) -> dict:
    """{"i. kernel name": device ms a call of fn} for the i-th of the
    `per_call` kernels that one call of fn launches, from torch.profiler's
    CUDA activity over `iters` calls (kernel durations as the card timed
    them). Kernels that overlap (a programmatic dependent launch waiting on
    its predecessor) each count their whole span.

    The profiler keeps only the activity it places inside its window, and
    CUPTI may lose a record: a profile that holds other than `per_call` x
    `iters` kernels is discarded and taken again, at most `tries` times in
    all."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # margins, so that no kernel lies at an edge of the window
            time.sleep(0.01)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
        kern = sorted((e for e in prof.profiler.kineto_results.events()
                       if e.device_type() == DeviceType.CUDA),
                      key=lambda e: e.start_ns())
        if len(kern) == per_call * iters:
            break
        log(f"    profile {attempt} of {tries} holds {len(kern)} kernels "
            f"in {iters} calls of {per_call}: discarded")
    else:
        raise RuntimeError(f"{len(kern)} kernels in {iters} calls of "
                           f"{per_call}, {tries} profiles")
    times = {}
    for i, e in enumerate(kern):
        # "void (anonymous namespace)::name<128>(args)" -> "name<128>"
        name = (e.name().replace("(anonymous namespace)::", "")
                .replace("otter::", "").replace("void ", "")
                .split("(")[0].strip())
        key = f"{i % per_call + 1}. {name}"
        times[key] = times.get(key, 0.0) + e.duration_ns() / 1e6 / iters
    return times


# ── model construction ──────────────────────────────────────────────

def build_model(cfg):
    """Full-width OtterVLM on the card with random weights from SEED,
    quantized tensor by tensor on the card."""
    from otter_tpu_torch.tools.random_weights import build_model as build
    return build(cfg, DEV, SEED)


def random_params(cfg):
    """{flax path: tensor} of `cfg`'s random bf16 weights, made on the card
    when read, each from its own seed."""
    from otter_tpu_torch.tools import random_weights
    return random_weights.RandomParams(cfg, DEV, seed=SEED)


def _depth_cut(cfg):
    """Every width kept; 4 decoder layers, 1 xattn block, CLIP 2,
    perceiver 1."""
    return cfg.replace(
        text=cfg.text.replace(num_hidden_layers=4),
        vision=cfg.vision.replace(num_hidden_layers=2),
        perceiver=cfg.perceiver.replace(depth=1))


def train_cfg(depth_cut: bool = False):
    """OTTER-MPT7B with bf16 weights (no quantization), as SFT trains it."""
    from otter_tpu_torch.config import otter_mpt7b
    cfg = otter_mpt7b()
    return _depth_cut(cfg) if depth_cut else cfg


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


def serving_cfg(depth_cut: bool = False, quant: str = "int8"):
    from otter_tpu_torch.config import otter_mpt7b
    cfg = otter_mpt7b()
    cfg = cfg.replace(text=cfg.text.replace(quant=quant,
                                            decode_kernel="auto"))
    return _depth_cut(cfg) if depth_cut else cfg


def llama_cfg(depth_cut: bool = False):
    """OTTER-LLaMA2-Chat-7B as the worker serves it with `--load-bit int8
    --cache-bit int8`."""
    from otter_tpu_torch.config import otter_llama2_chat7b
    cfg = otter_llama2_chat7b()
    cfg = cfg.replace(text=cfg.text.replace(quant="int8",
                                            decode_kernel="auto"))
    return _depth_cut(cfg) if depth_cut else cfg


def otterhd_cfg(depth_cut: bool = False):
    """OtterHD-8B (Fuyu) with int8 weights and the int8 embedding table."""
    from otter_tpu_torch.config import FuyuConfig
    cfg = FuyuConfig()
    text = cfg.text.replace(quant="int8", quant_embed=True,
                            decode_kernel="auto")
    if depth_cut:
        text = text.replace(num_hidden_layers=4)
    return cfg.replace(text=text)


def make_requests(cfg, batch: int, seed: int, full: bool = False):
    """Ragged 32-128-token prompts (`full`: all 128 tokens long), each
    starting with the media token, left-padded to 128, with one 224x224
    image each (numpy)."""
    import numpy as np
    from otter_tpu_torch.generation.engine import left_pad
    rng = np.random.default_rng(seed)
    p = 128
    lens = rng.integers(32, p + 1, batch)
    if full:
        lens[:] = p
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
    from otter_tpu_torch.ops import megakernel as mk
    from otter_tpu_torch.ops import quant
    saved = (fa.flash_attention_fwd, fa.flash_attention_bwd,
             quant.int8_mlp, quant.int4_mlp, quant.int4_matmul,
             da.decode_attention, mk.decode_attn_megakernel,
             quant.int8_attn_tail, quant.int8_matmul)
    fa.flash_attention_fwd = fa.flash_attention_plain
    fa.flash_attention_bwd = fa.flash_attention_bwd_plain
    quant.int8_mlp = quant.int8_mlp_plain
    quant.int4_mlp = quant.int4_mlp_plain
    quant.int4_matmul = quant.int4_matmul_plain
    da.decode_attention = da.decode_attention_plain
    mk.decode_attn_megakernel = mk.decode_attn_megakernel_plain
    quant.int8_attn_tail = quant.int8_attn_tail_plain
    quant.int8_matmul = quant.int8_matmul_plain
    try:
        yield
    finally:
        (fa.flash_attention_fwd, fa.flash_attention_bwd, quant.int8_mlp,
         quant.int4_mlp, quant.int4_matmul, da.decode_attention,
         mk.decode_attn_megakernel, quant.int8_attn_tail,
         quant.int8_matmul) = saved


# ── phase 4: kernel path against the plain path ─────────────────────

def first_step_logits(model, cfg, cache_dtype, vision_x, lang_x, attn):
    import torch
    from otter_tpu_torch.models.decoder import init_cache
    with torch.inference_mode():
        dev = model.device
        vx = torch.from_numpy(vision_x).to(dev)
        ids = torch.from_numpy(lang_x).to(dev)
        mask = torch.from_numpy(attn).to(dev)
        b, p = ids.shape
        cache = init_cache(cfg.text, b, 256, cache_dtype, dev)
        # positions count real tokens (rope models; ALiBi ignores them)
        real_len = mask.sum(-1)
        logits0, cache, lat = model(
            vx, ids, attention_mask=mask, cache=cache, head_last_only=True,
            positions=(mask.cumsum(-1) - 1).clamp_min(0))
        tok = torch.full((b, 1), cfg.text.vocab_size // 2, device=dev)
        kv_valid = torch.zeros((b, 256), dtype=torch.bool, device=dev)
        kv_valid[:, :p] = mask.bool()
        kv_valid[:, p] = True
        media = (ids == cfg.media_token_id).int().sum(-1)
        logits1, _, _ = model(None, tok, vis_latents=lat, cache=cache,
                              cache_pos=p, kv_valid=kv_valid,
                              positions=real_len[:, None],
                              media_counts=media)
        return logits0[:, -1].float(), logits1[:, -1].float()


def fuyu_first_step_logits(model, cfg, ids, patches, idx, mask):
    """The same for a FuyuVLM: the last prompt position's logits with the
    image patches merged, then one cached step."""
    import torch
    from otter_tpu_torch.models.fuyu import make_fuyu_cache
    with torch.inference_mode():
        dev = model.device
        ids, idx, mask = (torch.from_numpy(a).to(dev) for a in
                          (ids, idx, mask))
        patches = torch.from_numpy(patches).to(dev).to(model.dtype)
        b, s = ids.shape
        cache = make_fuyu_cache(cfg, b, 384, torch.int8, dev)
        logits0, cache = model(
            ids, image_patches=patches, image_patches_indices=idx,
            attention_mask=mask, cache=cache, head_last_only=True,
            positions=(mask.cumsum(-1) - 1).clamp_min(0))
        kv_valid = torch.zeros((b, 384), dtype=torch.bool, device=dev)
        kv_valid[:, :s] = mask.bool()
        kv_valid[:, s] = True
        tok = torch.full((b, 1), cfg.text.vocab_size // 2, device=dev)
        logits1, _ = model(tok, cache=cache, cache_pos=s, kv_valid=kv_valid,
                           positions=mask.sum(-1)[:, None])
        return logits0[:, -1].float(), logits1[:, -1].float()


def _hold_logits(tag: str, kern, plain):
    """Prefill and first-step logits, kernel path against plain path."""
    import torch
    for name, a, r in zip(("prefill", "decode step 1"), kern, plain):
        err = float((a - r).abs().max())
        scale = float(r.abs().max())
        ok = torch.isfinite(a).all() and err <= 5e-2 * scale
        log(f"parity[{tag}, {name}]: logits "
            f"max_abs_err {err:.4e} vs max|plain| {scale:.4e} "
            f"(tolerance 5e-2 * max|plain|) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{tag}: kernel path disagrees with the "
                               f"plain path at the {name} logits")


def phase_parity():
    import torch
    for quant, cache_dtype in (("int8", torch.int8), ("int4", "int4")):
        cfg = serving_cfg(depth_cut=True, quant=quant)
        model = build_model(cfg)
        req = make_requests(cfg, 8, SEED + 1)
        kern = first_step_logits(model, cfg, cache_dtype, *req)
        with plain_kernels():
            plain = first_step_logits(model, cfg, cache_dtype, *req)
        _hold_logits(f"{quant} weights and cache", kern, plain)
        del model

    # the rope models with untied int8 heads: the decode step's logits come
    # out of int8_matmul
    from otter_tpu_torch.ops import quant as quant_ops
    from otter_tpu_torch.tools.random_weights import fuyu_request
    cfg = llama_cfg(depth_cut=True)
    model = build_model(cfg)
    req = make_requests(cfg, 8, SEED + 3)
    before = quant_ops.int8_matmul.launches
    kern = first_step_logits(model, cfg, torch.int8, *req)
    with plain_kernels():
        plain = first_step_logits(model, cfg, torch.int8, *req)
    _hold_logits("llama2-chat-7b, int8 weights and cache", kern, plain)
    del model
    cfg = otterhd_cfg(depth_cut=True)
    model = build_model(cfg)
    req = fuyu_request(cfg, 448, 448, 16, SEED + 4, left_pad=8)
    kern = fuyu_first_step_logits(model, cfg, *req)
    with plain_kernels():
        plain = fuyu_first_step_logits(model, cfg, *req)
    _hold_logits("otterhd-8b, int8 weights, embedding and cache", kern, plain)
    del model
    if quant_ops.int8_matmul.launches != before + 2:
        raise RuntimeError("parity: the two untied heads did not go through "
                           "int8_matmul once each")

    # the fused decode routes, on full-length prompts (the megakernel
    # attends every cache row below the position: no left padding):
    # kernels against plain, and against the composed route of the same
    # weights (same seed), whose first cached step is the reference
    cfg = serving_cfg(depth_cut=True)
    req = make_requests(cfg, 8, SEED + 2, full=True)
    composed = {}
    for route, cache_dtype in (("megakernel", torch.bfloat16),
                               ("fused_tail", torch.int8)):
        if cache_dtype not in composed:
            model = build_model(cfg)
            composed[cache_dtype] = first_step_logits(model, cfg, cache_dtype,
                                                      *req)
            del model
        rcfg = cfg.replace(text=cfg.text.replace(**{route: True}))
        model = build_model(rcfg)
        kern = first_step_logits(model, rcfg, cache_dtype, *req)
        with plain_kernels():
            plain = first_step_logits(model, rcfg, cache_dtype, *req)
        for against, ref in (("plain", plain),
                             ("composed", composed[cache_dtype])):
            err = float((kern[1] - ref[1]).abs().max())
            scale = float(ref[1].abs().max())
            ok = torch.isfinite(kern[1]).all() and err <= 5e-2 * scale
            log(f"parity[{route}, decode step 1, kernels vs {against}]: "
                f"logits max_abs_err {err:.4e} vs max|{against}| "
                f"{scale:.4e} (tolerance 5e-2 * max|{against}|) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{route}: kernel path disagrees with the "
                                   f"{against} path at the first cached step")
        del model


# ── phase 5: serve requests at full width ───────────────────────────

# kernels each serving phase must launch (and no other), and for the llama
# phase the exact launches of one decode step and of one prefill
SERVE_PATHS = {
    "serve": {"flash_fwd", "int8_mlp", "decode_attention"},
    # no model routes a projection through int4_matmul (the JAX package
    # keeps them int8): it is held against its plain version in the kernels
    # phase only
    "serve4": {"flash_fwd", "int4_mlp", "decode_attention_int4"},
    "llama": {"flash_fwd", "int8_mlp", "decode_attention", "int8_matmul"},
}
LLAMA_STEP = {"int8_matmul": 1, "decode_attention": 32, "int8_mlp": 8}
# 24 CLIP + 6 perceiver + 32 decoder + 8 xattn attention calls
LLAMA_PREFILL = {"flash_fwd": 70}
# OTTER-MPT7B at int4: 32 decoder MLPs and 8 xattn FFs a step
SERVE4_STEP = {"int4_mlp": 40, "decode_attention_int4": 32}
# (prefill, decode step) launches that a b=8 request must make, by phase
EXACT_LAUNCHES = {"llama": (LLAMA_PREFILL, LLAMA_STEP),
                  "serve4": (LLAMA_PREFILL, SERVE4_STEP)}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _weight_bytes(model) -> int:
    return _nbytes(*model.parameters(), *model.buffers())


def _launches_of(fn) -> dict:
    """The kernels' launch counts over one call of `fn`, zeros left out."""
    from otter_tpu_torch.tools import bench_decode
    before = bench_decode.kernel_launches()
    fn()
    after = bench_decode.kernel_launches()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def phase_serve(smi: str, tag: str = "serve"):
    """Serve the requests on OTTER-MPT7B with int8 weights and cache (phase
    `serve`) or int4 weights and cache (phase `serve4`), or on
    OTTER-LLaMA2-Chat-7B with int8 weights and cache (phase `llama`)."""
    import numpy as np
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.tools import bench_decode

    int4 = tag == "serve4"
    quant_mode = "int4" if int4 else "int8"
    cfg = llama_cfg() if tag == "llama" else serving_cfg(quant=quant_mode)
    t0 = time.perf_counter()
    model = build_model(cfg)
    n_bytes = _weight_bytes(model)
    log(f"{tag}: {cfg.text.num_hidden_layers}-layer {cfg.text.arch} model, "
        f"{quant_mode} weights ({n_bytes / 1e9:.3f} GB on the card) and "
        f"{quant_mode} KV cache, built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    engine = OtterGenerator(model, cache_dtype="int4" if int4 else torch.int8)
    bench_decode.reset_kernel_launches()
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
            raise RuntimeError(f"{tag} b={b}: output shape {out.shape}")
        if not ((out >= 0) & (out < cfg.text.total_vocab)).all():
            raise RuntimeError(f"{tag} b={b}: token outside the vocabulary")
        if any(not np.array_equal(outs[0], o) for o in outs[1:]):
            raise RuntimeError(f"{tag} b={b}: greedy output differs between "
                               f"runs of the same request")
        if b == 1:
            # the streaming entry point yields what generate returned (up
            # to the end-of-chunk token, which it does not yield)
            streamed = list(engine.stream_generate(
                vision_x, lang_x, attn,
                gen=GenerationConfig(max_new_tokens=32)))
            want = out[0, p:].tolist()
            if cfg.eoc_token_id in want:
                want = want[:want.index(cfg.eoc_token_id)]
            if streamed != want:
                raise RuntimeError(f"{tag}: stream_generate gave {streamed}, "
                                   f"generate {want}")
            log(f"{tag} b=1: stream_generate yielded the {len(streamed)} "
                f"tokens generate returned")
        ttft = float(np.median(times[1]))
        decode_s = float(np.median(times[32])) - ttft
        tok_s = b * 31 / decode_s
        log(f"{tag} b={b}: prompts {attn.sum(1).tolist()} tokens + 1 image "
            f"each, 32 new tokens | TTFT {ttft * 1e3:.2f} ms | decode "
            f"{tok_s:.2f} tok/s ({decode_s / 31 * 1e3:.2f} ms/step) | "
            f"medians of {REPS}; TTFT runs "
            f"{[round(x * 1e3, 2) for x in times[1]]} ms, 32-token runs "
            f"{[round(x * 1e3, 2) for x in times[32]]} ms | {smi} | first "
            f"tokens {out[0, p:p + 8].tolist()}")
    if tag in EXACT_LAUNCHES:
        # what one prefill and one decode step launch, exactly (no eos, so
        # the 3-token request takes its two steps)
        req = make_requests(cfg, 8, SEED + 19)
        prefill = _launches_of(lambda: engine.generate(
            *req, gen=GenerationConfig(max_new_tokens=1)))
        three = _launches_of(lambda: engine.generate(
            *req, gen=GenerationConfig(max_new_tokens=3, eos_token_id=-1)))
        step = {k: (n - prefill.get(k, 0)) / 2 for k, n in three.items()
                if n != prefill.get(k, 0)}
        log(f"{tag}: a prefill launches {prefill}, a decode step {step}")
        want_prefill, want_step = EXACT_LAUNCHES[tag]
        if prefill != want_prefill or step != want_step:
            raise RuntimeError(
                f"{tag}: a prefill launched {prefill} (expected "
                f"{want_prefill}), a decode step {step} (expected "
                f"{want_step})")
    launches = bench_decode.kernel_launches()
    log(f"{tag}: kernel launches during the requests {launches}")
    path = SERVE_PATHS[tag]
    dead = sorted(k for k in path if launches[k] == 0)
    stray = sorted(k for k, n in launches.items() if n and k not in path)
    if dead or stray:
        raise RuntimeError(f"{tag}: never launched {dead}; launched off its "
                           f"path {stray}")
    return launches, engine


# ── phase 10: OtterHD-8B, one request at a time ─────────────────────

OTTERHD_STEP = {"int8_matmul": 1, "int8_mlp": 36, "decode_attention": 36}
OTTERHD_PREFILL = {"flash_fwd": 36}


def phase_otterhd(smi: str, profile: bool = False):
    import numpy as np
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.fuyu import fuyu_generate
    from otter_tpu_torch.tools import bench_decode
    from otter_tpu_torch.tools.random_weights import fuyu_request

    cfg = otterhd_cfg()
    t0 = time.perf_counter()
    model = build_model(cfg)
    n_bytes = _weight_bytes(model)
    lm = model.language_model
    table = _nbytes(lm.wte_q, lm.wte_s)
    plain_table = lm.wte_q.numel() * 2   # the same table in bf16
    log(f"otterhd: {cfg.text.num_hidden_layers}-layer persimmon model, int8 "
        f"weights, int8 embedding table and int8 KV cache: "
        f"{n_bytes / 1e9:.3f} GB on the card "
        f"({(n_bytes - table + plain_table) / 1e9:.3f} GB without "
        f"quant_embed: the table takes {table / 1e9:.3f} GB, "
        f"{plain_table / 1e9:.3f} in bf16), built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    def run(req, n_new):
        return list(fuyu_generate(
            model, *req, gen=GenerationConfig(max_new_tokens=n_new),
            cache_dtype=torch.int8))

    bench_decode.reset_kernel_launches()
    for height, width in ((448, 448), (1080, 1920)):
        req = fuyu_request(cfg, height, width, 16, SEED + 20)
        s = req[0].shape[1]
        run(req, 2)   # warm-up
        times = {1: [], 32: []}
        outs = []
        for _ in range(REPS):
            for n_new in (1, 32):
                t = time.perf_counter()
                out = run(req, n_new)
                times[n_new].append(time.perf_counter() - t)
            outs.append(out)
        if len(outs[0]) != 32 or not all(
                0 <= t < cfg.text.total_vocab for t in outs[0]):
            raise RuntimeError(f"otterhd {height}x{width}: tokens {outs[0]}")
        if any(o != outs[0] for o in outs[1:]):
            raise RuntimeError(f"otterhd {height}x{width}: greedy output "
                               f"differs between runs of the same request")
        prefill_s = float(np.median(times[1]))
        decode_s = float(np.median(times[32])) - prefill_s
        log(f"otterhd {height}x{width}: {s - 16} image tokens + 16 prompt "
            f"tokens, 32 new tokens | prefill (to the first token) "
            f"{prefill_s * 1e3:.2f} ms | decode {31 / decode_s:.2f} tok/s "
            f"({decode_s / 31 * 1e3:.2f} ms/step) | medians of {REPS}; "
            f"1-token runs {[round(x * 1e3, 2) for x in times[1]]} ms, "
            f"32-token runs {[round(x * 1e3, 2) for x in times[32]]} ms | "
            f"{smi} | first tokens {outs[0][:8]}")
        prefill = _launches_of(lambda: run(req, 1))
        three = _launches_of(lambda: run(req, 3))
        step = {k: (n - prefill.get(k, 0)) / 2 for k, n in three.items()
                if n != prefill.get(k, 0)}
        log(f"otterhd {height}x{width}: a prefill launches {prefill}, a "
            f"decode step {step}")
        if prefill != OTTERHD_PREFILL or step != OTTERHD_STEP:
            raise RuntimeError(
                f"otterhd: a prefill launched {prefill} (expected "
                f"{OTTERHD_PREFILL}), a decode step {step} (expected "
                f"{OTTERHD_STEP})")
    launches = bench_decode.kernel_launches()
    log(f"otterhd: kernel launches during the requests {launches}")
    if profile:
        for height, width in ((448, 448), (1080, 1920)):
            req = fuyu_request(cfg, height, width, 16, SEED + 20)
            phase_profile(lambda n_new: run(req, n_new),
                          f"otterhd {height}x{width}")
    return launches


# ── optional: where the time goes in one b=8 request ────────────────

def phase_profile(run, tag: str):
    """torch.profiler over one request served by `run(n_new)`: the prefill
    alone (1 new token), then the prefill + 31 decode steps; a decode
    step's device time and launches from the difference. Writes the kernel
    tables to OUT_DIR and prints the device-busy share and the top
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(OUT_DIR, exist_ok=True)
    seen = {}
    for n_new in (1, 32):
        run(n_new)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run(n_new)
            wall = time.perf_counter() - t
        seen[n_new] = _report_profile(
            prof, wall, f"profile {tag} new={n_new}",
            f"profile_{tag.replace(' ', '_').replace('=', '')}_new{n_new}"
            f".txt") + (wall,)
    (b0, n0, w0), (b1, n1, w1) = seen[1], seen[32]
    log(f"profile {tag}: a decode step takes {(b1 - b0) / 31 * 1e3:.3f} ms "
        f"of device kernels in {(n1 - n0) / 31:.1f} launches; "
        f"{(w1 - w0) / 31 * 1e3:.3f} ms of wall time under the profiler")


def _profile_engine(engine, tag: str):
    """`phase_profile` of a b=8 request through `OtterGenerator.generate`."""
    from otter_tpu_torch.config import GenerationConfig
    req = make_requests(engine.cfg, 8, SEED + 18)
    phase_profile(lambda n_new: engine.generate(
        *req, gen=GenerationConfig(max_new_tokens=n_new, eos_token_id=-1)),
        f"{tag} b=8")


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
    return busy, sum(e.count for e in kern)


# ── phase 8: the fused decode routes through the decode bench ───────

FUSED_RUNS = (
    ("composed", dict(cache_bit="bf16"),
     {"int8_mlp": 40, "decode_attention": 0, "decode_attn_megakernel": 0,
      "int8_attn_tail": 0}),
    ("megakernel", dict(megakernel=True, cache_bit="bf16"),
     {"int8_mlp": 40, "decode_attention": 0, "decode_attn_megakernel": 32,
      "int8_attn_tail": 0}),
    ("fused_tail", dict(fused_tail=True, cache_bit="int8",
                        decode_kernel="auto"),
     {"int8_mlp": 8, "decode_attention": 32, "decode_attn_megakernel": 0,
      "int8_attn_tail": 32}),
)


def phase_fused(smi: str, profile: bool = False):
    """`tools/bench_decode.run` at full width and depth, b=8: the composed
    decode layer, the megakernel route and the fused-tail route."""
    from otter_tpu_torch.tools import bench_decode

    bench_decode.reset_kernel_launches()
    results, failed = {}, []
    for name, kw, want in FUSED_RUNS:
        res = results[name] = bench_decode.run(batch=8, device=DEV,
                                               seed=SEED, **kw)
        got = res["launches_per_step"]
        log(f"fused[{name}]: {res['layers']}-layer OTTER-MPT7B int8, b=8, "
            f"prompt 128, cache {res['cache_len']} {res['cache_bit']} | "
            f"step {res['step_ms']:.3f} ms ({res['tokens_per_s']:.2f} tok/s), "
            f"estimates {[round(x, 3) for x in res['step_ms_estimates']]} "
            f"ms | device step {res['device_step_ms']:.3f} ms, estimates "
            f"{[round(x, 3) for x in res['device_step_ms_estimates']]} "
            f"({res['device_step_profiles']} profiles: two a third where "
            f"none lost a record) | reads {res['decode_step_bytes'] / 1e9:.3f} GB a step: "
            f"roofline {res['roofline_ms']:.3f} ms, share "
            f"{100 * res['roofline_share']:.2f}% of 3.35 TB/s | weights "
            f"{res['weight_bytes'] / 1e9:.3f} GB on the card | launches a "
            f"step {got} | first tokens {res['first_tokens']} | {smi}")
        if any(got[k] != n for k, n in want.items()):
            failed.append(f"{name}: launches a step {got}, expected {want}")
        if not res["tokens_equal"]:
            failed.append(f"{name}: greedy output differs between runs")
        if not res["tokens_valid"]:
            failed.append(f"{name}: output shape or a token outside the "
                          f"vocabulary")
        if not (math.isfinite(res["step_ms"]) and res["step_ms"] > 0):
            failed.append(f"{name}: step time {res['step_ms']}")
        if not (math.isfinite(res["device_step_ms"])
                and res["device_step_ms"] > 0):
            failed.append(f"{name}: device step {res['device_step_ms']} ms")
    launches = bench_decode.kernel_launches()
    extra = (results["megakernel"]["weight_bytes"]
             - results["composed"]["weight_bytes"])
    d = 4096
    want_extra = 32 * (4 * d * d + 4 * 4 * d)   # wqo_q + wqo_scale a layer
    log(f"fused: the megakernel's weights take {extra / 1e9:.4f} GB more on "
        f"the card than the composed route's (32 x [4096, 16384] int8 + "
        f"scales = {want_extra / 1e9:.4f} GB)")
    if extra != want_extra:
        failed.append(f"fused copy of Wqkv | Wo: {extra} bytes, expected "
                      f"{want_extra}")
    base = results["composed"]["step_ms"]
    log("fused: step time against the composed route of this call: "
        + ", ".join(f"{n} {results[n]['step_ms'] / base:.3f}x"
                    for n in ("megakernel", "fused_tail")))
    if failed:
        raise RuntimeError("fused phase failed: " + "; ".join(failed))
    if profile:
        _profile_fused()
    return launches


def _profile_layer_routes():
    """One full-width decoder layer (int8 weights, b=8, one new token at
    position 200 of a bf16 cache of 256) on the composed, megakernel and
    fused-tail routes, the same weights and cache for all three: device ms
    and kernel launches a call, from torch.profiler over 20 calls. What a
    fused route replaces is the composed layer less what the two share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from otter_tpu_torch.models.decoder import DecoderLayer, init_cache
    from otter_tpu_torch.ops import quant
    from otter_tpu_torch.ops.masks import alibi_slopes

    text = serving_cfg().text.replace(megakernel=True, decode_kernel=False)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 50)
    layer = DecoderLayer(text, torch.bfloat16, DEV)
    flat = {}
    for name, t in list(layer.named_buffers()) + list(layer.named_parameters()):
        if name.endswith("kernel_q"):
            q, sc = quant.quantize_kernel(0.02 * torch.randn(
                t.shape, generator=gen, device=DEV))
            flat[name], flat[name[:-len("kernel_q")] + "scale_q"] = q, sc
        elif name.endswith(".scale"):
            flat[name] = 1 + 0.02 * torch.randn(t.shape, generator=gen,
                                                device=DEV)
    fused = quant.add_fused_wqo(
        {"layers_0/" + k.replace(".", "/"): v for k, v in flat.items()})
    state = dict(layer.named_buffers())
    state.update(layer.named_parameters())
    with torch.no_grad():
        for k, v in fused.items():
            state[k[len("layers_0/"):].replace("/", ".")].copy_(v)
    b, L, pos, nl = 8, 256, 200, text.num_hidden_layers
    cache = init_cache(text.replace(num_hidden_layers=4), b, L,
                       torch.bfloat16, DEV)
    for t in cache.values():
        t.normal_(generator=gen)
    x = torch.randn(b, 1, text.hidden_size, generator=gen, device=DEV,
                    dtype=torch.bfloat16)
    bias = (torch.arange(L, device=DEV)[None, None, None, :]
            * alibi_slopes(text.num_attention_heads,
                           device=DEV)[None, :, None, None])
    kv_valid = (torch.arange(L, device=DEV) <= pos)[None].expand(b, L)
    outs = {}
    for route in ("composed", "megakernel", "fused_tail"):
        layer.cfg = text.replace(megakernel=route == "megakernel",
                                 fused_tail=route == "fused_tail")
        it = iter(range(10 ** 9))

        def call():
            with torch.inference_mode():
                return layer(x, layer=next(it) % 4, bias=bias, cache=cache,
                             cache_pos=pos, kv_valid=kv_valid)

        outs[route] = call()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(20):
                call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, n = _report_profile(
            prof, wall, f"profile layer[{route}] 20 calls",
            f"profile_layer_{route}.txt")
        err = float((outs[route].float() - outs["composed"].float())
                    .abs().max())
        log(f"profile layer[{route}]: {busy / 20 * 1e3:.4f} ms of device "
            f"kernels and {n / 20:.1f} launches a call ({nl} layers a step: "
            f"{busy / 20 * nl * 1e3:.2f} ms, {n / 20 * nl:.0f} launches); "
            f"max |out - composed| {err:.3e}")


def _profile_fused():
    """torch.profiler over b=8 requests of 16 and 48 new tokens on each
    fused run's model: device ms and kernel launches a decode step from
    the difference of the two."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from otter_tpu_torch.config import GenerationConfig, otter_mpt7b
    from otter_tpu_torch.generation.engine import OtterGenerator

    _profile_layer_routes()
    dtypes = {"bf16": torch.bfloat16, "int8": torch.int8}
    for name, kw, _ in FUSED_RUNS:
        cfg = otter_mpt7b()
        cfg = cfg.replace(text=cfg.text.replace(
            quant="int8", megakernel=kw.get("megakernel", False),
            fused_tail=kw.get("fused_tail", False),
            decode_kernel=kw.get("decode_kernel", cfg.text.decode_kernel)))
        engine = OtterGenerator(build_model(cfg),
                                cache_dtype=dtypes[kw["cache_bit"]])
        req = make_requests(cfg, 8, SEED + 19, full=True)[:2]
        seen = {}
        for n_new in (16, 48):
            gen_cfg = GenerationConfig(max_new_tokens=n_new, eos_token_id=-1)
            engine.generate(*req, gen=gen_cfg)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                engine.generate(*req, gen=gen_cfg)
                wall = time.perf_counter() - t
            seen[n_new] = _report_profile(
                prof, wall, f"profile fused[{name}] b=8 new={n_new}",
                f"profile_fused_{name}_new{n_new}.txt") + (wall,)
        (b0, n0, w0), (b1, n1, w1) = seen[16], seen[48]
        log(f"profile fused[{name}]: a decode step takes "
            f"{(b1 - b0) / 32 * 1e3:.3f} ms of device kernels in "
            f"{(n1 - n0) / 32:.1f} launches; {(w1 - w0) / 32 * 1e3:.3f} ms "
            f"of wall time under the profiler")
        del engine


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
    from random_params weights; the weights are left as they were."""
    import torch
    from otter_tpu_torch.models.convert import load_flax_params
    from otter_tpu_torch.models.otter import OtterVLM
    from otter_tpu_torch.train.step import TrainState, make_train_step
    model = OtterVLM(cfg, dtype=dtype, device=DEV, remat=True)
    load_flax_params(model, random_params(cfg))
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
    params = random_params(cfg)
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
    "decode_attention_int4": ("otter_tpu_torch/csrc/decode_attention.cu",
                              "otter_tpu/ops/decode_attention.py:280"),
    "int4_mlp": ("otter_tpu_torch/csrc/int4_mlp.cu",
                 "otter_tpu/ops/quant.py:616"),
    "int4_matmul": ("otter_tpu_torch/csrc/int4_mlp.cu",
                    "otter_tpu/ops/quant.py:773"),
    "flash_bwd_dkv": ("otter_tpu_torch/csrc/flash_bwd.cu",
                      "otter_tpu/ops/flash_attention.py:347"),
    "flash_bwd_dq": ("otter_tpu_torch/csrc/flash_bwd.cu",
                     "otter_tpu/ops/flash_attention.py:444"),
    "decode_attn_megakernel": ("otter_tpu_torch/csrc/megakernel.cu",
                               "otter_tpu/ops/megakernel.py:46"),
    "int8_attn_tail": ("otter_tpu_torch/csrc/int8_attn_tail.cu",
                       "otter_tpu/ops/quant.py:199"),
    "int8_matmul": ("otter_tpu_torch/csrc/int8_matmul.cu",
                    "otter_tpu/ops/quant.py:22"),
}
PHASES = "kernels,parity,serve,serve4,fused,llama,otterhd,trainparity,train"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=PHASES,
                    help=f"comma-separated subset of {PHASES}, plus profile "
                         "(after serve, serve4, llama, fused and train; not "
                         "run by default), fusedkernels, headkernels, "
                         "flashkernels, decodekernels, mlpkernels and "
                         "int4kernels "
                         "(parts of kernels, for bring-up). "
                         "Device and build always run.")
    ap.add_argument("--port-root", default=None,
                    help="import otter_tpu_torch from this checkout instead "
                         "(to run two versions of the port in one call)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    import torch
    smi = phase_device()
    if args.port_root is not None:
        sys.path.insert(0, os.path.abspath(args.port_root))
    import otter_tpu_torch  # (the checkout must hold the port)
    log(f"port: {os.path.dirname(os.path.abspath(otter_tpu_torch.__file__))}")
    walls = {}
    t = time.perf_counter()
    phase_build(check_sass=args.port_root is None)
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

    entries = {}
    if "kernels" in phases:
        entries = run("kernels", phase_kernels, gen)
    else:
        for name, only in (("fusedkernels", "fused"), ("headkernels", "head"),
                           ("flashkernels", "flash"),
                           ("decodekernels", "decode"),
                           ("mlpkernels", "mlp"), ("int4kernels", "int4")):
            if name in phases:
                entries.update(run(name, phase_kernels, gen, only))
    if "parity" in phases:
        run("parity", phase_parity)
    by_path = {}
    def serve(tag):
        launches, engine = phase_serve(smi, tag)
        if "profile" in phases:
            _profile_engine(engine, tag)
        return launches

    for tag in ("serve", "serve4"):
        if tag in phases:
            by_path[tag] = run(tag, serve, tag)
    if "fused" in phases:
        by_path["fused"] = run("fused", phase_fused, smi, "profile" in phases)
    if "llama" in phases:
        by_path["llama"] = run("llama", serve, "llama")
    if "otterhd" in phases:
        by_path["otterhd"] = run("otterhd", phase_otterhd, smi,
                                 "profile" in phases)
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
            bound_by=e.get("bound_by"), library_ms=e.get("library_ms"),
            **{k: e[k] for k in ("device_ms", "library_device_ms",
                                 "sub_kernels_device_ms") if k in e}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
