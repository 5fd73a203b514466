"""ctypes bindings for the native C++ image preprocessing library
(counterpart of `otter_tpu/native/__init__.py`).

`preproc.cpp` decodes a batch of JPEG / PNG buffers (or their base64
text), resizes each with PIL's antialiased bicubic filter and normalizes
it to CHW float32, OpenMP-parallel across the batch. It is built with g++
at first use into `otter_tpu_torch/_build/` (listed in `.gitignore`),
keyed by a hash of the source and the flags, and linked against libjpeg,
libpng and zlib. The first build and load run under one file lock, so
processes that ask at once (test workers, data-loader threads) build it
once. There is no `-march=native`, and a file that does not load (one
copied from a host with other shared libraries) is built again here.

`available()` says whether the library built and loaded; when it did not,
`unavailable_reason()` says why (no compiler, no libjpeg / libpng
headers). The data pipelines' `native` choice goes through `resolve`:
"auto" takes PIL then, True raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "preproc.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-fopenmp"]
LIBS = ["-ljpeg", "-lpng", "-lz"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None      # why the library is unavailable


def _target() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libotter_preproc-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build "
                           "otter_tpu_torch/native/preproc.cpp")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp), *LIBS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for preproc.cpp:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def _build_and_open() -> ctypes.CDLL:
    BUILD_DIR.mkdir(exist_ok=True)
    out = _target()
    with open(BUILD_DIR / "libotter_preproc.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        built = not out.exists()
        if built:
            _compile(out)
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            if built:
                raise
            # a file built on another host (a copied checkout) whose
            # shared libraries this host lacks: build it here
            _compile(out)
            lib = ctypes.CDLL(str(out))
    lib.otter_preprocess_batch2.restype = ctypes.c_int
    lib.otter_preprocess_batch2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded on the first call (once: a failure
    is remembered, with its reason)."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _build_and_open()
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _error = f"{type(e).__name__}: {e}"
        return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """None where the library loads, else why it does not."""
    _load()
    return _error


def require() -> ctypes.CDLL:
    """The library, or a RuntimeError that says why it cannot be had."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native preprocessing unavailable: {_error}")
    return lib


def resolve(native) -> bool:
    """A data pipeline's `native` choice: "auto" uses the library where it
    builds and loads, True always (raises where it cannot be had, never
    giving way to PIL), False never."""
    if native == "auto":
        return available()
    if native:
        require()
        return True
    return False


def preprocess_batch(buffers: Sequence[bytes], size: int,
                     mean: Tuple[float, float, float],
                     std: Tuple[float, float, float],
                     is_base64: bool = False,
                     scaled_decode: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """buffers of encoded images (or base64 text) -> ([N,3,S,S] f32,
    status [N] int32 with 0=ok).

    scaled_decode lets libjpeg IDCT straight to the smallest M/8 scale
    still covering `size` (PIL's Image.draft equivalent): 2-4x fewer
    pixels decoded+resized on typical downscales, numerically a few LSBs
    off a full decode. Default False: bit-stable pixels for every caller
    (eval scores must not drift with a library default); the
    throughput-sensitive training pipelines (webdataset/mimicit collate)
    opt in explicitly."""
    lib = require()
    n = len(buffers)
    blob = b"".join(buffers)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(b) for b in buffers], out=offsets[1:])
    out = np.empty((n, 3, size, size), np.float32)
    status = np.zeros(n, np.int32)
    mean_arr = (ctypes.c_float * 3)(*mean)
    std_arr = (ctypes.c_float * 3)(*std)
    blob_buf = ctypes.create_string_buffer(blob, len(blob))
    lib.otter_preprocess_batch2(
        ctypes.cast(blob_buf, ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, int(is_base64), size, int(scaled_decode), mean_arr, std_arr,
        out.ctypes.data_as(ctypes.c_void_p),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out, status
