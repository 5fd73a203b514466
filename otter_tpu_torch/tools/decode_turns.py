"""The decode bench's step, measured in turns by two processes that share
one card, each importing `otter_tpu_torch` from its own checkout (a commit
and its parent, say), so that both meet the same host:

    python otter_tpu_torch/tools/decode_turns.py --tree A --turns DIR \\
        --role 0 [--pairs 12] [--megakernel] [--fused-tail] \\
        [--cache-bit bf16|int8|int4] [--profile]
    python otter_tpu_torch/tools/decode_turns.py --tree B --turns DIR \\
        --role 1 [the same options]

started together (run as a file: the package comes from `--tree`). Each
builds the decode bench's model and request (`bench_decode`: OTTER-MPT7B
at full width, int8 weights random from `--seed`; batch 8, a 128-token
prompt whose first token is the media token, one image a row, greedy
decoding that never stops early) with what its own checkout's
`OtterGenerator` does by default, warms up, then the two take turns in
the order 0 1 1 0 0 1 1 0 ..., `--pairs` turns each. A turn is one of the
bench's paired estimates: `generate` windows of 16 and 128 new tokens,
(t(128) - t(16)) / 112, on the wall clock and on the thread's CPU clock
(the host's own work). The process whose turn it is not polls a file
every 5 ms. With `--profile` each then counts, in its own turn, the CUDA
kernels of a step with torch.profiler over the same two windows. Each
writes its readings to DIR/role<R>.json; role 0 prints both and each
pair's difference (role 1 less role 0) as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SHORT, LONG = 16, 128
PROMPT = 128
POLL_S = 0.005


def _order(pairs: int):
    """Whose turn each turn is: 0 1, 1 0, 0 1, ..."""
    out = []
    for i in range(pairs):
        out += [0, 1] if i % 2 == 0 else [1, 0]
    return out


def _wait(path: str, want, deadline: float):
    """Poll `path` until `want(content)` holds; raises past `deadline`."""
    while True:
        try:
            with open(path) as f:
                text = f.read()
            if want(text):
                return text
        except FileNotFoundError:
            pass
        if time.monotonic() > deadline:
            raise TimeoutError(f"waited for {path} past the deadline")
        time.sleep(POLL_S)


def _write(path: str, text: str) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--turns", required=True)
    ap.add_argument("--role", type=int, choices=(0, 1), required=True)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--megakernel", action="store_true")
    ap.add_argument("--fused-tail", action="store_true")
    ap.add_argument("--cache-bit", choices=("bf16", "int8", "int4"),
                    default="bf16")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--wait-s", type=float, default=900.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch
    from otter_tpu_torch.config import GenerationConfig, otter_mpt7b
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.tools.random_weights import build_model
    package = os.path.dirname(sys.modules["otter_tpu_torch"].__file__)
    if package != os.path.join(os.path.abspath(args.tree), "otter_tpu_torch"):
        raise RuntimeError(f"otter_tpu_torch came from {package}, not from "
                           f"{args.tree}")

    deadline = time.monotonic() + args.wait_s
    os.makedirs(args.turns, exist_ok=True)
    turn_file = os.path.join(args.turns, "turn")
    cfg = otter_mpt7b()
    cfg = cfg.replace(text=cfg.text.replace(
        quant="int8", megakernel=args.megakernel,
        fused_tail=args.fused_tail))
    dev = torch.device("cuda")
    model = build_model(cfg, dev, args.seed)
    cache = {"bf16": torch.bfloat16, "int8": torch.int8,
             "int4": "int4"}[args.cache_bit]
    engine = OtterGenerator(model, cache_dtype=cache)
    rng = np.random.default_rng(args.seed)
    size = cfg.vision.image_size
    vision_x = rng.standard_normal((8, 1, 1, 3, size, size)
                                   ).astype(np.float32)
    ids = rng.integers(5, 50000, (8, PROMPT)).astype(np.int64)
    ids[:, 0] = cfg.media_token_id

    def window(n_new: int):
        gen = GenerationConfig(max_new_tokens=n_new, do_sample=False,
                               eos_token_id=-1)
        t, c = time.perf_counter(), time.thread_time()
        out = engine.generate(vision_x, ids, gen=gen)   # ends on the host
        return time.perf_counter() - t, time.thread_time() - c, out

    window(SHORT)
    window(LONG)
    _write(os.path.join(args.turns, f"ready{args.role}"), "1")
    order = _order(args.pairs) + ([0, 1] if args.profile else [])
    if args.role == 0:
        _wait(os.path.join(args.turns, "ready1"), bool, deadline)
        _write(turn_file, "0")
    wall, cpu, tokens, kernels = [], [], None, None
    for k, who in enumerate(order):
        if who != args.role:
            continue
        _wait(turn_file, lambda s, k=k: s.strip() == str(k), deadline)
        if k < 2 * args.pairs:
            ws, cs, _ = window(SHORT)
            wl, cl, out = window(LONG)
            wall.append((wl - ws) / (LONG - SHORT) * 1e3)
            cpu.append((cl - cs) / (LONG - SHORT) * 1e3)
            tokens = out[:, PROMPT:PROMPT + 8].tolist()
        else:
            from torch.profiler import ProfilerActivity, profile
            counts = []
            for n_new in (SHORT, LONG):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    window(n_new)
                counts.append(sum(1 for e in prof.events()
                                  if e.device_type.name == "CUDA"))
            kernels = (counts[1] - counts[0]) / (LONG - SHORT)
        _write(turn_file, str(k + 1))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    mine = {"tree": args.tree, "package": package, "wall_ms": wall,
            "cpu_ms": cpu, "kernels_a_step": kernels, "first_tokens": tokens,
            "nvidia_smi": smi}
    _write(os.path.join(args.turns, f"role{args.role}.json"),
           json.dumps(mine))
    if args.role == 0:
        other = json.loads(_wait(os.path.join(args.turns, "role1.json"),
                                 bool, deadline))
        d_wall = [b - a for a, b in zip(wall, other["wall_ms"])]
        d_cpu = [b - a for a, b in zip(cpu, other["cpu_ms"])]
        print(json.dumps({
            "role0": mine, "role1": other,
            "wall_ms_role1_less_role0": d_wall,
            "cpu_ms_role1_less_role0": d_cpu,
            "median_wall_diff_ms": float(np.median(d_wall)),
            "median_cpu_diff_ms": float(np.median(d_cpu)),
            "role1_slower_in": sum(d > 0 for d in d_wall),
            "tokens_equal": tokens == other["first_tokens"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
