"""Device resolution and kernel-backend selection.

The port's counterpart of ``ganq_tpu/core/backend.py``. Three backends:

- ``"cuda_a8"``: the int8-activation kernels for ``uniform`` and ``w8``
  linears (``ops/uniform_matmul.uniform_a8_matmul``,
  ``ops/w8_matmul.w8a8_matmul``), the counterpart of ``pallas_a8``; it takes
  models whose every quantized linear is ``w8`` or ``uniform`` at 4 or 8
  bits.
- ``"cuda"``: the full-precision hand-written Hopper kernels
  (``lut_matmul``, ``uniform_matmul``, ``w8_matmul``) for every quantized
  linear, and flash decode attention on both CUDA backends. (The GANQ
  S-step picks its kernel from the device and
  ``QuantizeConfig.solver_backend``, ``quant/ganq.py``.)
- ``"reference"``: the plain PyTorch versions (dequantize + matmul, masked
  softmax attention) — the oracle, and the CPU path.

:func:`select_backend` picks ``"reference"`` on the CPU (the JAX package's
TPU backends require a TPU) and, on a CUDA device, the first of
``AUTO_SELECT_BACKEND_ORDER`` that takes every quantized linear; a model with
a linear that no kernel of the port serves raises, naming what would bring
it. Nothing falls back to the plain path on the card unless the caller asks
for ``backend="reference"``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

CUDA_A8 = "cuda_a8"
CUDA = "cuda"
REFERENCE = "reference"

# quantized kinds each CUDA backend runs, with their bit widths
_KERNELS = {
    CUDA_A8: {"uniform": (4, 8), "w8": (8,)},
    CUDA: {"lut": (2, 3, 4, 8), "uniform": (2, 3, 4, 8), "w8": (8,)},
}
# priority on a CUDA device, mirroring the JAX package's
# AUTO_SELECT_BACKEND_ORDER (pallas_a8, then pallas)
AUTO_SELECT_BACKEND_ORDER = (CUDA_A8, CUDA)


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
    if kind == "lut":
        return f"the lut_matmul kernel takes 2, 3, 4 or 8 bits, not {bits}"
    return f"no slice of the port brings kind={kind} bits={bits} yet"


def _unserved(model: torch.nn.Module, backend: str):
    """The first quantized linear ``backend`` has no kernel for, or None."""
    from ..ops.qlinear import QLinear

    kernels = _KERNELS[backend]
    for p in model.modules():
        if (isinstance(p, QLinear) and p.kind != "dense"
                and p.bits not in kernels.get(p.kind, ())):
            return p
    return None


def select_backend(model: torch.nn.Module, device: torch.device,
                   preference: Optional[str] = None) -> str:
    """``preference`` if given, else ``"reference"`` on the CPU and the first
    CUDA backend of ``AUTO_SELECT_BACKEND_ORDER`` that runs every quantized
    linear of the model. A CUDA backend raises unless the device is a CUDA
    device and it has a kernel for every quantized linear."""
    if preference is None and device.type == "cpu":
        return REFERENCE
    if preference == REFERENCE:
        return preference
    if preference is not None and preference not in _KERNELS:
        raise ValueError(f"unknown backend {preference!r}")
    if device.type != "cuda":
        raise ValueError(f"the {preference} backend requires a CUDA device")
    for backend in (preference,) if preference else AUTO_SELECT_BACKEND_ORDER:
        p = _unserved(model, backend)
        if p is None:
            return backend
    raise NotImplementedError(
        f"no {backend} kernel for kind={p.kind} bits={p.bits}: "
        f"{_missing_kernel(p.kind, p.bits)}; pass backend='reference' to run "
        "the plain PyTorch path on the card")


__all__ = ["CUDA", "CUDA_A8", "REFERENCE", "AUTO_SELECT_BACKEND_ORDER",
           "resolve_device", "select_backend", "full_f32_matmul"]
