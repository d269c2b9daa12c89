"""EoRA: eigenspace low-rank accuracy recovery for quantized linears.

The port of ``ganq_tpu/adapter/eora.py`` (the reference's
``gptqmodel/eora/eora.py:28-102``). From a module's activation covariance
``C = mean_t x x^T`` and its quantization error ``delta = W - Wq``:

    C = Q diag(L) Q^T          (negative eigenvalues clamped to the least
                                positive one, every one to at least 1e-12)
    S = Q diag(sqrt(L))        (the "scaling" matrix)
    U Sig V = svd(delta @ S)
    B = U_r sqrt(Sig_r)        [out, r]
    A = sqrt(Sig_r) V_r S^-1   [r, in]

so that ``delta ~= B @ A`` minimises the activation-weighted error. At
inference the linear adds ``(x @ A^T) @ B^T`` (:func:`apply_lora`).

All of it is float32 on the model's device: ``torch.linalg.eigh`` and
``svd``, and products in full float32 (TF32 off,
``core/backend.full_f32_matmul``), where the JAX package uses
``jnp.linalg`` and HIGHEST-precision dots. The factors are unique only up
to the signs of the singular vectors; ``B @ A`` is not.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, Tuple

import torch

from ..core.backend import full_f32_matmul


@contextlib.contextmanager
def _timed(timings: Optional[Dict[str, float]], key: str,
           device: torch.device):
    """Add the block's seconds to ``timings[key]`` (device synchronised
    around it) when ``timings`` is given."""
    if timings is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0


def compute_eora_full(delta: torch.Tensor, cov: torch.Tensor,
                      timings: Optional[Dict[str, float]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """(U, Sig, V^T, S^-1) of the eigen-scaled SVD; :func:`compute_eora`
    truncates them to a rank. ``timings``: see :func:`compute_eora`."""
    cov = cov.to(torch.float32)
    cov = 0.5 * (cov + cov.T)
    with _timed(timings, "eigh", cov.device):
        L, Q = torch.linalg.eigh(cov)
    pos_min = torch.min(torch.where(L > 0, L, torch.full_like(L, torch.inf)))
    L = torch.where(L < 0, pos_min, torch.clamp(L, min=1e-12))
    sqrtL = torch.sqrt(L)
    scaling = Q * sqrtL[None, :]                 # Q @ diag(sqrt(L))
    scaling_inv = (Q / sqrtL[None, :]).T         # diag(1/sqrt(L)) @ Q^T
    with full_f32_matmul():
        delta_scale = delta.to(torch.float32) @ scaling
    with _timed(timings, "svd", cov.device):
        U, S, Vt = torch.linalg.svd(delta_scale, full_matrices=False)
    return U, S, Vt, scaling_inv


def compute_eora(delta: torch.Tensor, cov: torch.Tensor, rank: int,
                 timings: Optional[Dict[str, float]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A [rank, in], B [out, rank]), float32, with ``delta ~= B @ A``.
    ``timings``, when given, sums the seconds of the ``eigh`` and the
    ``svd`` under those keys."""
    U, S, Vt, scaling_inv = compute_eora_full(delta, cov, timings)
    sqrtS = torch.sqrt(S[:rank])
    B = U[:, :rank] * sqrtS[None, :]
    with full_f32_matmul():
        A = (sqrtS[:, None] * Vt[:rank]) @ scaling_inv
    return A, B


def apply_lora(x: torch.Tensor, lora_a: torch.Tensor,
               lora_b: torch.Tensor) -> torch.Tensor:
    """The adapter's term ``(x @ A^T) @ B^T`` in x's type."""
    return (x @ lora_a.T.to(x.dtype)) @ lora_b.T.to(x.dtype)


__all__ = ["compute_eora", "compute_eora_full", "apply_lora"]
