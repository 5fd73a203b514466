"""Build and load the hand-written CUDA kernels in `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by nvcc
for Hopper (`sm_90a`) into its own shared library under `_build/` (listed
in `.gitignore`), keyed by a hash of the source and of the `csrc/*.cuh`
headers so an edited kernel is rebuilt. The libraries are loaded with ctypes: device pointers and the
CUDA stream go in as `c_void_p`, and every entry point returns
`cudaGetLastError()` after its launch, which `check` turns into an
exception. Nothing here runs at import time; the first wrapper call on a
CUDA tensor builds (if needed) and loads its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


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
    sources compiled by this call (ptxas register/shared-memory report)."""
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


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.otter_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


def all_sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))
