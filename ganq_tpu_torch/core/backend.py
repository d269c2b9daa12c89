"""Device resolution and kernel-backend selection.

The port's counterpart of ``ganq_tpu/core/backend.py``. Two backends:

- ``"cuda"``: the hand-written Hopper kernels (``ops/lut_matmul.py``,
  ``ops/fused_attention.py``) for every quantized linear and decode attention.
  (The GANQ S-step picks its kernel from the device and
  ``QuantizeConfig.solver_backend``, ``quant/ganq.py``.)
- ``"reference"``: the plain PyTorch versions (dequantize + matmul, masked
  softmax attention) — the oracle, and the CPU path.

:func:`select_backend` picks ``"reference"`` on the CPU and ``"cuda"`` on a
CUDA device. On a CUDA device a model with a linear that no kernel of the
port serves yet raises, naming what would bring it; nothing falls back to the
plain path on the card unless the caller asks for ``backend="reference"``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

CUDA = "cuda"
REFERENCE = "reference"

# quantized kinds the "cuda" backend runs, with their bit widths
_CUDA_KERNELS = {"lut": (2, 3, 4)}


def resolve_device(device: Optional[str | torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; the CPU
    runs only when the caller asks for it, so a missing GPU raises instead of
    silently falling back."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matrix products in full float32 (no TF32) inside the block,
    whatever the caller's global setting; it is restored on exit."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision = prev


def _missing_kernel(kind: str, bits: int) -> str:
    if kind == "uniform":
        return "the uniform_matmul kernel comes with slice 3 of the port"
    if kind == "lut":
        return (f"the lut_matmul kernel takes 2, 3 or 4 bits, not {bits} "
                "(ROADMAP.md queue C)")
    return f"no slice of the port brings kind={kind} yet"


def select_backend(model: torch.nn.Module, device: torch.device,
                   preference: Optional[str] = None) -> str:
    """``preference`` if given, else ``"reference"`` on the CPU and
    ``"cuda"`` on a CUDA device. ``"cuda"`` raises unless the device is a
    CUDA device and every quantized linear of the model has a kernel."""
    from ..ops.qlinear import QLinear

    backend = preference or (REFERENCE if device.type == "cpu" else CUDA)
    if backend == REFERENCE:
        return backend
    if backend != CUDA:
        raise ValueError(f"unknown backend {backend!r}")
    if device.type != "cuda":
        raise ValueError("the cuda backend requires a CUDA device")
    for p in model.modules():
        if (isinstance(p, QLinear) and p.kind != "dense"
                and p.bits not in _CUDA_KERNELS.get(p.kind, ())):
            raise NotImplementedError(
                f"no CUDA kernel for kind={p.kind} bits={p.bits}: "
                f"{_missing_kernel(p.kind, p.bits)}; pass backend='reference' "
                "to run the plain PyTorch path on the card")
    return backend


__all__ = ["CUDA", "REFERENCE", "resolve_device", "select_backend",
           "full_f32_matmul"]
