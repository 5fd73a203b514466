"""Steady-state decode throughput of OTTER-MPT7B with int8 weights
(counterpart of the JAX package's `bench.py`).

    python -m otter_tpu_torch.tools.bench_decode [--megakernel]
        [--fused-tail] [--cache-bit bf16|int8|int4] [--decode-kernel on|off|auto]
        [--batch 8] [--cache-len 0] [--device cuda]

prints one JSON line. The measurement: batch 8, a 128-token prompt whose
first token is the media token, one image a row, greedy decoding that never
stops early (`eos_token_id=-1`); two `generate` windows that differ only in
`max_new_tokens` (16 and 128, both a cache of 256), two warm-up calls, then
the median of 3 paired (long - short) / 112 estimates: the marginal cost of
a decode step, without the prefill and the vision encoder. `--cache-len N`
(N >= 1024) is the long-cache variant: windows of N - 248 and N - 128 new
tokens over a cache of N, `decode_kernel="auto"`, an int8 cache unless
`--cache-bit` says otherwise.

Beside the paired wall-clock estimates, the device's own: torch.profiler
(CUDA activity) over the steps that lie between the two windows (those
that make the long window longer: steps short .. long of one more
request, run by `generate`'s own decode loop), the kernels' durations
summed and divided by their number (`device_step_ms`), and the same over
each third of those steps (`device_step_ms_estimates`); None on the CPU.
Each profile leaves 50 ms idle at each edge of its window, and each third
is profiled again from its starting state (restored in place from a copy:
a captured step replays on its own tensors) until two profiles
hold the same number of kernel records (the profiler can lose records),
up to 5 times, before the bench raises; `device_step_profiles` counts the
profiles.
The host's share of a step moves the wall estimates by tens of percent
between runs on a machine shared with other work; the kernels' times do
not.

`--megakernel` routes each decoder layer's attention half through
`ops.megakernel.decode_attn_megakernel` (the weights gain the fused
`[Wqkv | Wo]` copy, `ops.quant.add_fused_wqo`); `--fused-tail` routes each
layer's tail through `ops.quant.int8_attn_tail`. On the card every route's
step is `OtterGenerator`'s captured CUDA graph (the megakernel's too: its
kernel reads the position from the device counter). The weights are random,
made on the device from a seed and quantized there (all-zero weights would
make every kernel's arithmetic vacuous).

Beside the step time the line carries the bytes a decode step must read
(every tensor of the language model once, the fused copy of Wqkv and Wo
counted once, plus the KV cache), that over the card's 3.35 TB/s as the
share of the memory roofline, and how many times a step launches each
hand-written kernel (from the wrappers' counters). It runs on the GPU
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from otter_tpu_torch.config import GenerationConfig, OtterConfig, otter_mpt7b
from otter_tpu_torch.device import resolve_device
from otter_tpu_torch.generation.engine import OtterGenerator, cache_bytes
from otter_tpu_torch.ops import decode_attention as da
from otter_tpu_torch.ops import flash_attention as fa
from otter_tpu_torch.ops import megakernel as mk
from otter_tpu_torch.ops import quant
from otter_tpu_torch.tools.random_weights import build_model

H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA H100 SXM data sheet
PROMPT = 128
_CACHE_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8, "int4": "int4"}


def _wrappers():
    return (fa.flash_attention, quant.int8_mlp, quant.int4_mlp,
            quant.int4_matmul, quant.int8_attn_tail, quant.int8_matmul,
            da.decode_attention, mk.decode_attn_megakernel)


def kernel_launches() -> Dict[str, int]:
    """The launch counters of the serving paths' kernel wrappers."""
    n_int4 = da.decode_attention.launches_int4
    return {"flash_fwd": fa.flash_attention.launches,
            "int8_mlp": quant.int8_mlp.launches,
            "int4_mlp": quant.int4_mlp.launches,
            "int4_matmul": quant.int4_matmul.launches,
            "decode_attention": da.decode_attention.launches - n_int4,
            "decode_attention_int4": n_int4,
            "decode_attn_megakernel": mk.decode_attn_megakernel.launches,
            "int8_attn_tail": quant.int8_attn_tail.launches,
            "int8_matmul": quant.int8_matmul.launches}


def reset_kernel_launches() -> None:
    for w in _wrappers():
        w.launches = 0
    da.decode_attention.launches_int4 = 0


def decode_step_bytes(model, batch: int, cache_len: int, cache_bit: str
                      ) -> int:
    """Bytes one decode step must read: every parameter and buffer of the
    language model once (the vision encoder and the perceiver run at
    prefill only), without the original Wqkv and out_proj kernels when the
    megakernel's fused copy is read in their place, plus the KV cache."""
    text = model.cfg.text
    fused = text.megakernel and text.quant == "int8"
    tensors = dict(model.lang_encoder.named_parameters())
    tensors.update(model.lang_encoder.named_buffers())
    weights = sum(
        t.numel() * t.element_size() for name, t in tensors.items()
        if not (fused and name.endswith((".attn.Wqkv.kernel_q",
                                         ".attn.out_proj.kernel_q"))))
    return weights + cache_bytes(text, batch, cache_len,
                                 _CACHE_DTYPES[cache_bit])


# Idle time the profiler's window holds before and after the profiled
# work: without it, profiles of the same few dozen decode steps on an H100
# held different numbers of kernel records, records lost in the trace.
_PROFILE_MARGIN_S = 0.05


def _kernel_ms(fn):
    """(device ms of what `fn()` runs on the card, the number of CUDA
    records in its trace): torch.profiler's CUDA activity, read straight
    from its events (no event tree is built), through `_busy_ms`. The
    window leaves `_PROFILE_MARGIN_S` clear at each edge."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()   # nothing earlier still runs in the window
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(_PROFILE_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(_PROFILE_MARGIN_S)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    return _busy_ms(events), len(events)


def _busy_ms(events) -> float:
    """The time in which at least one of `events` (CUDA records: start_ns,
    duration_ns) runs. Kernels on one stream run one after another, so this
    is their durations' sum, except where a programmatic dependent launch
    starts before its predecessor ends (the megakernel's): the overlap
    counts once."""
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events)
    busy, end = 0, None
    for lo, hi in spans:
        if end is None or lo >= end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy / 1e6


def _clone(v):
    """A copy of a decode state's tensors (and of the containers that hold
    them), to run the same steps again from it."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, SimpleNamespace):
        return SimpleNamespace(**{k: _clone(x) for k, x in vars(v).items()})
    if isinstance(v, dict):
        return {k: _clone(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_clone(x) for x in v)
    return v


@torch.inference_mode()
def _restore(st: SimpleNamespace, saved: SimpleNamespace) -> None:
    """`st` back to a `_clone` of it, in place: a captured step replays on
    the tensors it recorded, so the state keeps them."""
    for k, v in vars(saved).items():
        cur = getattr(st, k)
        if isinstance(v, torch.Tensor):
            cur.copy_(v)
        elif isinstance(v, dict):
            for name, t in v.items():
                cur[name].copy_(t)
        else:
            setattr(st, k, v)


def _device_step_ms(engine: OtterGenerator, vision_x, ids,
                    gen: GenerationConfig, first: int, parts: int = 3,
                    tries: int = 5):
    """Device ms a decode step over steps `first` .. `gen.max_new_tokens`
    of one request (those that the window of `gen.max_new_tokens` new
    tokens runs and one of `first` does not), through `generate`'s own
    prefill and decode loop, profiling only those steps: a profiled
    request of ~2000 steps records millions of kernel events. Returns (the
    mean over those steps, [the mean over each of `parts` consecutive runs
    of them], the number of profiles taken).

    The profiler can lose a record, and the records a step differ with the
    position (1420 against 1405 at b=8 on one route), so a run is held to
    itself: each is profiled again from the state it started from
    (`_restore`) until two profiles hold the same number of CUDA records, at
    most
    `tries` times in all, before this raises."""
    st = engine._prefill(vision_x, ids, None, gen, None)
    try:
        engine._decode(st, first)
        n = gen.max_new_tokens - first
        ends = [first + n * (i + 1) // parts for i in range(parts)]
        total, parts_ms, lo, profiles = 0.0, [], first, 0
        for hi in ends:
            start = _clone(st)
            seen = {}   # records -> ms of the first profile that held them
            ms, records = _kernel_ms(lambda: engine._decode(st, hi))
            while True:
                profiles += 1
                if records in seen:
                    break
                seen[records] = ms
                if len(seen) == tries:
                    raise RuntimeError(
                        f"decode steps {lo}..{hi}: no two of {tries} "
                        f"profiles hold the same number of kernel records "
                        f"({sorted(seen)}): records lost")
                _restore(st, start)
                ms, records = _kernel_ms(lambda: engine._decode(st, hi))
            total += seen[records]
            parts_ms.append(seen[records] / (hi - lo))
            lo = hi
    finally:
        engine._finish(st)
    return total / n, parts_ms, profiles


def run(megakernel: bool = False, fused_tail: bool = False,
        cache_bit: Optional[str] = None, decode_kernel=None, batch: int = 8,
        cache_len: int = 0, device=None, cfg: Optional[OtterConfig] = None,
        seed: int = 0, windows=None, reps: int = 3) -> dict:
    """Build the model and measure a decode step; returns the result as a
    dict (see the module docstring). `cfg` replaces full-width OTTER-MPT7B
    (the CPU test passes the tiny configuration), `windows` the two
    `max_new_tokens`, `reps` the number of paired estimates."""
    device = resolve_device(device)
    cfg = cfg or otter_mpt7b()
    long_cache = cache_len >= 1024
    if decode_kernel is None:
        decode_kernel = "auto" if long_cache else cfg.text.decode_kernel
    if cache_bit is None:
        cache_bit = "int8" if long_cache else "bf16"
    cfg = cfg.replace(text=cfg.text.replace(
        quant="int8", decode_kernel=decode_kernel, megakernel=megakernel,
        fused_tail=fused_tail))
    if windows is None:
        windows = ((cache_len - PROMPT - 120, cache_len - PROMPT)
                   if long_cache else (16, 128))
    new_short, new_long = windows
    used_cache = -(-(PROMPT + new_long) // 128) * 128   # as the engine rounds

    t0 = time.perf_counter()
    model = build_model(cfg, device, seed)
    build_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       list(model.parameters()) + list(model.buffers()))
    engine = OtterGenerator(model, cache_dtype=_CACHE_DTYPES[cache_bit])

    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    vision_x = rng.standard_normal((batch, 1, 1, 3, size, size)
                                   ).astype(np.float32)
    ids = rng.integers(5, min(50000, cfg.text.vocab_size - 8),
                       (batch, PROMPT)).astype(np.int64)
    ids[:, 0] = cfg.media_token_id

    def timed(n_new: int):
        gen = GenerationConfig(max_new_tokens=n_new, do_sample=False,
                               eos_token_id=-1)
        before = kernel_launches()
        t = time.perf_counter()
        out = engine.generate(vision_x, ids, gen=gen)   # ends on the host
        wall = time.perf_counter() - t
        after = kernel_launches()
        return wall, out, {k: after[k] - before[k] for k in after}

    timed(new_short)   # warm-up: builds and loads the kernels
    timed(new_long)
    on_gpu = device.type == "cuda"
    steps, outs, counts = [], [], None
    for _ in range(reps):
        t_short, _, n_short = timed(new_short)
        t_long, out, n_long = timed(new_long)
        steps.append((t_long - t_short) / (new_long - new_short))
        outs.append(out)
        counts = {k: (n_long[k] - n_short[k]) / (new_long - new_short)
                  for k in n_long}
    dev_step = dev_steps = dev_profiles = None
    if on_gpu:
        dev_step, dev_steps, dev_profiles = _device_step_ms(
            engine, vision_x, ids, GenerationConfig(
                max_new_tokens=new_long, do_sample=False, eos_token_id=-1),
            new_short)
    step_s = float(np.median(steps))
    nbytes = decode_step_bytes(model, batch, used_cache, cache_bit)
    return {
        "metric": f"otter_mpt7b_int8_decode_b{batch}_L{used_cache}_"
                  f"{cache_bit}cache"
                  + ("_megakernel" if megakernel else "")
                  + ("_fused_tail" if fused_tail else ""),
        "step_ms": step_s * 1e3,
        "tokens_per_s": batch / step_s,
        "step_ms_estimates": [s * 1e3 for s in steps],
        # the kernels' own time a step: not measured on the CPU
        "device_step_ms": dev_step,
        "device_step_ms_estimates": dev_steps,
        # profiles taken of the thirds (two each where none lost a record)
        "device_step_profiles": dev_profiles,
        "decode_step_bytes": nbytes,
        # a device's share of its roofline: not measured on the CPU
        "roofline_ms": nbytes / H100_BYTES_PER_S * 1e3 if on_gpu else None,
        "roofline_share": (nbytes / H100_BYTES_PER_S / step_s
                           if on_gpu else None),
        "launches_per_step": counts,
        "tokens_equal": all(np.array_equal(outs[0], o) for o in outs[1:]),
        "tokens_valid": bool(
            outs[0].shape == (batch, PROMPT + new_long)
            and ((outs[0] >= 0) & (outs[0] < cfg.text.total_vocab)).all()),
        "first_tokens": outs[0][0, PROMPT:PROMPT + 8].tolist(),
        "weight_bytes": weight_bytes,
        "build_s": build_s,
        "megakernel": megakernel, "fused_tail": fused_tail,
        "cache_bit": cache_bit, "decode_kernel": decode_kernel,
        "batch": batch, "cache_len": used_cache,
        "layers": cfg.text.num_hidden_layers,
        "device": (torch.cuda.get_device_name(device) if on_gpu else "cpu"),
    }


def card_name_and_power_limit() -> str:
    """`name, power.limit` of the first card, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--megakernel", action="store_true")
    ap.add_argument("--fused-tail", action="store_true")
    ap.add_argument("--cache-bit", choices=sorted(_CACHE_DTYPES))
    ap.add_argument("--decode-kernel", choices=["on", "off", "auto"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dk = {"on": True, "off": False, "auto": "auto", None: None}[
        args.decode_kernel]
    res = run(megakernel=args.megakernel, fused_tail=args.fused_tail,
              cache_bit=args.cache_bit, decode_kernel=dk, batch=args.batch,
              cache_len=args.cache_len, device=args.device, seed=args.seed)
    if res["device"] != "cpu":
        res["nvidia_smi"] = card_name_and_power_limit()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
