"""Exact weighted 1-D k-means, the default GANQ codebook init.

The port of ``ganq_tpu/ops/kmeans_exact.py`` over the port's own copy of the
C++ source (``ganq_tpu_torch/native/kmeans1d.cpp``): dynamic programming
over sorted split points in float64, so both packages produce bit-identical
codebooks from the same inputs. The library is built by ``g++`` at first use
into ``build/`` at the root of the checkout, under a file name that carries a
hash of the source, the flags and the host (``-march=native`` code must not
run on another machine's CPU), written through a temporary name and moved
into place with ``os.replace`` (several test workers may build at once). Rows
are solved on a host thread pool; the call releases the GIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

from .cuda_lib import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "native" / "kmeans1d.cpp"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def library_path() -> Path:
    key = " ".join([*GXX_FLAGS, platform.node(), platform.machine()])
    digest = hashlib.sha256(SOURCE.read_bytes() + key.encode()).hexdigest()[:12]
    return BUILD_DIR / f"libkmeans1d-{digest}.so"


def build() -> Path:
    """Compile the library unless it is already built; returns its path."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{res.stderr}")
    os.replace(tmp, target)
    return target


def load_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            dp = ctypes.POINTER(ctypes.c_double)
            lib.kmeans1d_rows.restype = None
            lib.kmeans1d_rows.argtypes = [dp, dp, ctypes.c_int32,
                                          ctypes.c_int32, ctypes.c_int32, dp]
            _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def kmeans_rows_exact(X: np.ndarray, weights: np.ndarray, k: int,
                      n_threads: Optional[int] = None) -> np.ndarray:
    """Per-row exact k-means with one column-weight vector shared by all rows
    (the GANQ codebook init). Returns [m, k] float64 ascending centroids."""
    lib = load_lib()
    X = np.ascontiguousarray(np.asarray(X, np.float64))
    w = np.ascontiguousarray(np.asarray(weights, np.float64).reshape(-1))
    m, n = X.shape
    out = np.zeros((m, k), np.float64)
    n_threads = n_threads or min(os.cpu_count() or 1, 16)
    chunk = max(1, -(-m // n_threads))

    def work(r0):
        r1 = min(r0 + chunk, m)
        lib.kmeans1d_rows(_ptr(X[r0:r1], ctypes.c_double),
                          _ptr(w, ctypes.c_double), r1 - r0, n, k,
                          _ptr(out[r0:r1], ctypes.c_double))

    with ThreadPoolExecutor(max_workers=n_threads) as ex:
        list(ex.map(work, range(0, m, chunk)))
    return out


__all__ = ["kmeans_rows_exact", "load_lib", "build", "library_path"]
