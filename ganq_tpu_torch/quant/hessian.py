"""Calibration Hessian accumulation.

The port of ``ganq_tpu/quant/hessian.py``. The reference accumulates
``H = 2/n * sum_t x_t x_t^T`` with a running average, where ``n`` counts
calibration *sequences*, not tokens; this keeps the raw float32 Gram sum and
divides once at :meth:`HessianAccumulator.finalize`.

The Gram sum is a plain float32 ``torch.matmul`` (the JAX package leaves it to
XLA, outside any Pallas kernel), run in full float32: :func:`full_f32_matmul`
turns TF32 off for its duration, whatever the caller's global setting.
"""

from __future__ import annotations

import torch

from ..core.backend import full_f32_matmul


class HessianAccumulator:
    """Accumulates the layer-wise proxy Hessian from activation batches.

    ``update(x)`` takes activations shaped ``[batch, seq, n]`` (or
    ``[tokens, n]``, counted as one sample); ``finalize()`` returns
    ``H = 2/nsamples * sum x x^T`` with nsamples counting sequences."""

    def __init__(self, columns: int, device="cuda"):
        self.columns = columns
        self.acc = torch.zeros((columns, columns), dtype=torch.float32,
                               device=device)
        self.nsamples = 0

    def update(self, x: torch.Tensor) -> None:
        nsamp = 1 if x.dim() == 2 else int(x.shape[0])
        x = x.reshape(-1, x.shape[-1]).to(torch.float32)
        with full_f32_matmul():
            self.acc += x.T @ x
        self.nsamples += nsamp

    def finalize(self) -> torch.Tensor:
        if self.nsamples == 0:
            raise ValueError("HessianAccumulator: no calibration batches seen")
        return (2.0 / self.nsamples) * self.acc


__all__ = ["HessianAccumulator"]
