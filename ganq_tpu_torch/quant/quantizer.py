"""Uniform affine quantization parameter search.

The port of ``ganq_tpu/quant/quantizer.py`` (the reference's
``gptqmodel/quantization/quantizer.py:40-168``): per-row min/max affine
parameters with the symmetric mirror, the degenerate-range guard and the
optional ``mse`` grid-shrink search, evaluated as one batched grid. Weights
are quantized per output row over a slice of input columns: ``find_params``
takes ``x [rows, cols]`` and returns ``scale`` / ``zero`` of shape
``[rows, 1]``. Rounding is half to even (``torch.round``, as ``jnp.round``).

``find_params`` is jitted in the JAX package, where XLA compiles a division
by a constant (``maxq``, ``grid``) as a product with the constant's float32
reciprocal; the port computes that product, so a scale is the same float
and the codes of a row's extreme weights, which sit on rounding ties, come
out the same.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _times_reciprocal(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as compiled XLA computes it for a constant c."""
    return x * float(np.float32(1.0) / np.float32(c))


class UniformParams(NamedTuple):
    scale: torch.Tensor  # [rows, 1] float32
    zero: torch.Tensor   # [rows, 1] float32 (integer-valued zero point)
    maxq: int


def quantize_affine(x: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                    maxq: int) -> torch.Tensor:
    """Fake-quantize x with affine params: ``scale * (q - zero)``."""
    q = torch.clamp(torch.round(x / scale) + zero, 0, maxq)
    return scale * (q - zero)


def quantize_affine_idx(x: torch.Tensor, scale: torch.Tensor,
                        zero: torch.Tensor, maxq: int) -> torch.Tensor:
    """Integer codes in [0, maxq]."""
    return torch.clamp(torch.round(x / scale) + zero, 0, maxq).to(torch.int32)


def find_params(x: torch.Tensor, *, bits: int, sym: bool, mse: float = 0.0,
                grid: int = 100, maxshrink: float = 0.8) -> UniformParams:
    """Per-row affine params for a [rows, cols] weight slice: min/max
    clamped through 0, the symmetric mirror, a zero range widened to
    [-1, 1], and with ``mse > 0`` the grid search over shrink factors
    ``p = 1 - i / grid`` keeping the first best error where it beats the
    unshrunk one."""
    x = x.to(torch.float32)
    maxq = 2**bits - 1
    xmin = torch.clamp(torch.amin(x, dim=1), max=0.0)
    xmax = torch.clamp(torch.amax(x, dim=1), min=0.0)
    if sym:
        xmax = torch.maximum(torch.abs(xmin), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)

    scale = _times_reciprocal(xmax - xmin, maxq)
    if sym:
        zero = torch.full_like(scale, (maxq + 1) / 2)
    else:
        zero = torch.round(-xmin / scale)

    if mse > 0.0:
        steps = int(maxshrink * grid)
        ps = 1.0 - _times_reciprocal(torch.arange(
            steps, dtype=torch.float32, device=x.device), grid)  # [steps]
        xmin1 = ps[:, None] * xmin[None, :]                    # [steps, rows]
        xmax1 = ps[:, None] * xmax[None, :]
        scale1 = _times_reciprocal(xmax1 - xmin1, maxq)
        if sym:
            zero1 = zero[None, :].expand_as(scale1)
        else:
            zero1 = torch.round(-xmin1 / scale1)
        q = quantize_affine(x[None], scale1[:, :, None], zero1[:, :, None], maxq)
        err = torch.sum(torch.abs(q - x[None]) ** mse, dim=2)  # [steps, rows]
        best = torch.argmin(err, dim=0)                        # [rows]
        rows = torch.arange(x.shape[0], device=x.device)
        base = torch.sum(torch.abs(quantize_affine(
            x, scale[:, None], zero[:, None], maxq) - x) ** mse, dim=1)
        improved = err[best, rows] < base
        scale = torch.where(improved, scale1[best, rows], scale)
        zero = torch.where(improved, zero1[best, rows], zero)

    return UniformParams(scale[:, None], zero[:, None], maxq)


__all__ = ["UniformParams", "find_params", "quantize_affine",
           "quantize_affine_idx"]
