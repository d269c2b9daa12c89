"""Shared solver preamble: dead columns, activation sorting, damping, Cholesky.

The port of ``ganq_tpu/quant/preamble.py``, the numerical pipeline of the
reference ``GPTQ.quantize`` preamble (``gptqmodel/quantization/gptq.py:259-320``):

1. dead input columns (``diag(H)==0``) repaired to 1 on the diagonal and the
   corresponding weight columns zeroed or set to the row mean;
2. optional activation sort: permute columns of W and H by ``diag(H)``;
3. ``Xxt`` snapshot (undamped H, post-perm);
4. GANQ L-factor: ``L = chol(H + diag(clamp(rowsum|H| - 2 diag(H))))`` — a
   diagonally-dominant, undamped factor (gptq.py:289-291);
5. damped inverse factor with auto-increment retry: ``H += p*mean(diag(H))*I``
   (cumulative across retries, matching the reference's in-place mutation),
   ``Hinv = upper-chol(H^-1)``, and the GPTQ-style L (``chol(H_damped)``).

All dense linear algebra runs in float32 on the weight's device. A failed
Cholesky is read from ``torch.linalg.cholesky_ex``'s ``info`` (the JAX
package reads it as NaNs in the factor); the retry loop is the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..core.config import QuantizeConfig


@dataclass
class Prepared:
    """Solver inputs after the preamble. All tensors float32, columns
    permuted."""

    W: torch.Tensor            # [m, n] dead-fixed, permuted weight
    Hinv: torch.Tensor         # [n, n] upper Cholesky factor of damped H^-1
    L: torch.Tensor            # [n, n] lower factor for the S-step (style-dependent)
    Xxt: torch.Tensor          # [n, n] undamped H (permuted)
    Xxt_damped: torch.Tensor   # [n, n] damped H (permuted)
    perm: Optional[torch.Tensor]     # [n] int64 or None
    invperm: Optional[torch.Tensor]  # [n] int64 or None
    damp_used: float
    dead: torch.Tensor         # [n] bool mask of dead columns (permuted order)


def repair_dead(W: torch.Tensor, H: torch.Tensor, dead_mode: str):
    """Dead (never-activated) input columns: set H's diagonal to 1 there and
    zero or mean-fill the weight columns (reference gptq.py:269-276)."""
    dead = torch.diagonal(H) == 0
    H = torch.where(torch.diag(dead), 1.0, H)
    if dead_mode == "zero":
        W = torch.where(dead[None, :], 0.0, W)
    else:  # "mean": row mean over live columns (reference gptq.py:274)
        n_live = torch.clamp(torch.sum(~dead), min=1)
        row_mean = torch.sum(torch.where(dead[None, :], 0.0, W), dim=1,
                             keepdim=True) / n_live
        W = torch.where(dead[None, :], row_mean, W)
    return W, H, dead


def _fix_and_sort(W, H, dead_mode: str, act_sort: str):
    W, H, dead = repair_dead(W, H, dead_mode)
    if act_sort == "none":
        return W, H, dead, None, None
    perm = torch.argsort(torch.diagonal(H), descending=(act_sort == "desc"),
                         stable=True)
    invperm = torch.argsort(perm)
    return W[:, perm], H[perm][:, perm], dead[perm], perm, invperm


def _cholesky(A: torch.Tensor, upper: bool = False
              ) -> Tuple[torch.Tensor, bool]:
    """(factor, ok): ``ok`` is false when the factorization failed."""
    L, info = torch.linalg.cholesky_ex(A, upper=upper)
    return L, int(info) == 0


def _ganq_L(H: torch.Tensor) -> torch.Tensor:
    offset = torch.clamp(torch.sum(torch.abs(H), dim=1) - 2.0 * torch.diagonal(H),
                         min=1e-8)
    L, ok = _cholesky(H + torch.diag(offset))
    if not ok:
        raise FloatingPointError("Cholesky of the GANQ L-factor failed")
    return L


def _damp_step(H: torch.Tensor, damp_percent: float):
    """One damping attempt: returns (H_damped, L, ok)."""
    damp = damp_percent * torch.mean(torch.diagonal(H))
    Hd = H + damp * torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    L, ok = _cholesky(Hd)
    return Hd, L, ok


def _hinv_upper(L: torch.Tensor) -> torch.Tensor:
    """Upper-triangular U with H^-1 = U^T U, given H = L L^T (reference
    gptq.py:306-308)."""
    Hinv_full = torch.cholesky_inverse(L)
    # symmetrize against fp drift before factorizing
    Hinv_full = 0.5 * (Hinv_full + Hinv_full.T)
    U, ok = _cholesky(Hinv_full, upper=True)
    if not ok or bool(torch.isnan(U).any()):
        raise FloatingPointError("Hinv factorization produced NaN.")
    return U


def prepare(W: torch.Tensor, H: torch.Tensor, qcfg: QuantizeConfig,
            max_damp_retries: int = 50) -> Prepared:
    """Run the full preamble. Raises if damping cannot stabilize the
    Cholesky."""
    W = W.to(torch.float32)
    H = H.to(torch.float32)
    W, H, dead, perm, invperm = _fix_and_sort(W, H, qcfg.dead,
                                              qcfg.resolved_act_sort())
    Xxt = H  # undamped snapshot (post-perm)
    L_ganq = _ganq_L(H) if qcfg.l_damp_style == "ganq" else None

    damp_percent = qcfg.damp_percent
    H_work = H
    L_damped = None
    for _ in range(max_damp_retries):
        if not (0 < damp_percent < 1):
            break
        H_work, L_try, ok = _damp_step(H_work, damp_percent)
        if ok:
            L_damped = L_try
            break
        if qcfg.damp_auto_increment <= 0:
            raise FloatingPointError(
                f"Cholesky failed at damp_percent={damp_percent:.5f} and "
                "damp_auto_increment is 0; increase damp or calibration size.")
        damp_percent += qcfg.damp_auto_increment
    if L_damped is None:
        raise FloatingPointError(
            f"Cholesky failed to stabilize (final damp_percent={damp_percent:.5f}).")

    return Prepared(
        W=W, Hinv=_hinv_upper(L_damped),
        L=L_ganq if qcfg.l_damp_style == "ganq" else L_damped,
        Xxt=Xxt, Xxt_damped=H_work, perm=perm, invperm=invperm,
        damp_used=float(damp_percent), dead=dead)


__all__ = ["Prepared", "prepare", "repair_dead"]
