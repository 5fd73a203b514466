"""Build and load the hand-written CUDA kernels in `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by nvcc
for Hopper (`sm_90a`) into its own shared library under `_build/` (listed
in `.gitignore`), keyed by a hash of the source and of the `csrc/*.cuh`
headers so an edited kernel is rebuilt. The libraries are loaded with ctypes: device pointers and the
CUDA stream go in as `c_void_p`, and every entry point returns
`cudaGetLastError()` after its launch, which `check` turns into an
exception. Nothing here runs at import time; the first wrapper call on a
CUDA tensor builds (if needed) and loads its library.

The serving worker calls the wrappers from several threads at once (one
executor thread a request), so a first use builds and loads under a lock,
and `count_launch` adds to the wrappers' launch counters under another:
ctypes releases the interpreter lock during a launch, and a bare `+= 1`
loses counts when threads interleave. A CUDA graph's capture launches
nothing: inside `recording_launches` the counts of this thread go to the
graph's record, and each replay adds the record (`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.RLock()   # one build or first load at a time
_count_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels in otter_tpu_torch/csrc")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # shared by several sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources that are not built yet, one nvcc process
    per source, all started together. Returns {name: nvcc output} for the
    sources compiled by this call (ptxas register/shared-memory report).
    Threads that ask for the same source at once build it once."""
    with _build_lock:
        return _build(names)


def _build(names: Iterable[str]) -> Dict[str, str]:
    BUILD_DIR.mkdir(exist_ok=True)
    procs: List[tuple] = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = {}
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use, with
    `signatures` {function: (argtypes, restype)} declared. Every source
    also exports `otter_error_string(int)`."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _build_lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            lib.otter_error_string.argtypes = [ctypes.c_int]
            lib.otter_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
    return lib


_recording = threading.local()


def count_launch(wrapper, int4: bool = False, times: int = 1) -> None:
    """`times` more launches on `wrapper`'s counter (`wrapper.launches`),
    and on `wrapper.launches_int4` when `int4` (decode_attention over an
    int4 cache); inside `recording_launches` on this thread, into its
    record instead."""
    rec = getattr(_recording, "rec", None)
    if rec is not None:
        rec[(wrapper, int4)] = rec.get((wrapper, int4), 0) + times
        return
    with _count_lock:
        wrapper.launches += times
        if int4:
            wrapper.launches_int4 += times


@contextlib.contextmanager
def recording_launches():
    """Yields a dict {(wrapper, int4): launches} that collects this
    thread's `count_launch` calls inside the block, which then move no
    counter: what a CUDA graph's capture records, and each replay adds
    with `add_launches`."""
    prev = getattr(_recording, "rec", None)
    _recording.rec = rec = {}
    try:
        yield rec
    finally:
        _recording.rec = prev


def add_launches(record) -> None:
    """A `recording_launches` record added to the counters (a replay)."""
    for (wrapper, int4), n in record.items():
        count_launch(wrapper, int4, n)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.otter_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


def all_sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))
