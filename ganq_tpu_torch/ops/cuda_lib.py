"""Build and load the hand-written CUDA kernels.

Each source ``ganq_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ``ctypes``. The build happens at first use, into ``build/`` at
the root of the checkout, under a file name that carries a hash of the
source and the shared headers, so an edited source is rebuilt and a stale
library is never loaded.

Nothing here runs at import: ``nvcc`` and ``ctypes`` are reached only when a
CUDA tensor arrives at a kernel wrapper (or when :func:`build_all` is called),
so the package imports cleanly on a machine without CUDA.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
KERNEL_SOURCES = ("lut_matmul", "flash_decode", "ganq_sstep", "uniform_matmul",
                  "w8_matmul", "w8a8_fused", "megastep_w8", "megastep4",
                  "megastep_lowbit", "megastep_lowbit_opt",
                  "megastep_lowbit_lm", "megastep_lowbit_lm_opt",
                  "megastep_lowbit_lora", "megastep_lowbit_lora_opt",
                  "megastep_lowbit_lora_lm", "megastep_lowbit_lora_lm_opt",
                  "megastep_lowbit_arch", "megastep_lowbit_arch_opt",
                  "megastep_lowbit_arch_lm", "megastep_lowbit_arch_lm_opt",
                  "megastep_lowbit_arch_lora", "megastep_lowbit_arch_lora_opt",
                  "megastep_lowbit_arch_lora_lm",
                  "megastep_lowbit_arch_lora_lm_opt", "megastep_lowbit_gemma",
                  "megastep_lowbit_w3w2", "megastep_lowbit_w3w2_ext",
                  "megastep_lowbit_walsh", "moe_expert")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[Tuple[str, str], object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source and of every
    shared header (``csrc/*.cuh``) a source may include."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (Popen, target) or None when the
    library is already built."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every kernel source at once (one nvcc per source, all started
    together) and wait for all of them. Returns each build's compiler
    output (register and shared-memory use from ``-Xptxas -v``); raises if
    any build fails."""
    started = {n: _start_build(n) for n in names}
    logs: Dict[str, str] = {}
    failed = []
    for name, job in started.items():
        if job is None:
            logs[name] = "(already built)"
            continue
        proc, tmp, target = job
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def function(name: str, symbol: str, argtypes):
    """C entry point ``symbol`` of kernel library ``name`` (built at first
    use), typed with ``argtypes`` and returning the launch's cudaError_t."""
    fn = _LIBS.get((name, symbol))
    if fn is None:
        import ctypes

        build_all([name])
        fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[(name, symbol)] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


__all__ = ["build_all", "function", "check", "library_path",
           "KERNEL_SOURCES", "BUILD_DIR"]
