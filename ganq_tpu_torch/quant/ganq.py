"""GANQ non-uniform LUT solver.

The port of ``ganq_tpu/quant/ganq.py``: Algorithm 1 of "GANQ: GPU-Adaptive
Layer-Wise LUT-Based Non-Uniform Quantization" with the semantics of the
reference implementation (``gptqmodel/quantization/ganq.py:397-646``):

- per-row 2^bits codebook ``T`` initialized by Hinv-weighted 1-D k-means
  (LeanQuant style; exact by default, ``ops/kmeans_exact.py``);
- K alternating iterations of
  * **S-step**: backward-substitution assignment over columns ``j=n-1..0``
    (``ops/ganq_solver.py``: the blocked CUDA kernel on the card by
    default, the per-column kernel with ``solver_backend="pallas"``, the
    plain per-column version on the CPU or with ``solver_backend="jax"``);
  * **T-step**: least-squares codebook refit ``T = WH S^T (S H S^T)^+`` via
    a batched symmetric-eigh pseudo-inverse of the per-row 2^bits-square
    normal matrix;
- best-(T, Q) tracking by the quadratic proxy loss ``tr(E H E^T)``.

The T-step's one-hot contraction runs in full float32 (TF32 off). The JAX
package splits H into three bf16 terms for its MXU passes, which by its own
docstring is loss-identical to float32; ``hessian_dtype="bfloat16"`` rounds H
to bf16 and then contracts in float32.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.backend import full_f32_matmul
from ..core.config import QuantizeConfig
from ..ops.ganq_solver import (s_step, s_step_blocked, s_step_blocked_kernel,
                               s_step_kernel)
from ..ops.kmeans import leanquant_weights, weighted_kmeans_1d
from .preamble import prepare


@dataclass
class GANQResult:
    Q: torch.Tensor          # [m, n] fake-quantized weight, original column order
    lut: torch.Tensor        # [m, 2^bits] per-row codebook (float32)
    idx: torch.Tensor        # [m, n] int32 codes into lut, original column order
    avg_loss: float
    quad_loss: float
    damp_used: float
    nsamples: int
    # constrained codebooks (codebook != "free"): the free codebook's quad
    # loss on the same assignments, the reported price of the constraint
    quad_loss_free: Optional[float] = None
    # no iteration improved the loss: one S-step against the initial codebook
    fallback: bool = False


def s_step_reference(W, L, T) -> np.ndarray:
    """Slow, obviously-correct S-step (numpy loop) for parity tests."""
    W = np.asarray(W, np.float32)
    L = np.asarray(L, np.float32)
    T = np.asarray(T, np.float32)
    m, n = W.shape
    Q = np.zeros((m, n), np.int32)
    r = np.zeros((m,), np.float32)
    for j in range(n - 1, -1, -1):
        eff = W[:, j] + r / L[j, j]
        Q[:, j] = np.argmin(np.abs(eff[:, None] - T), axis=1)
        Wq = np.take_along_axis(T, Q[:, j:], axis=1)
        r = (W[:, j:] - Wq) @ L[j:, (j - 1) % n]
    return Q


# --------------------------------------------------------------------- T-step
def _h_operand(H: torch.Tensor, fast) -> torch.Tensor:
    """The contraction operand for ``fast`` (see :func:`t_step`)."""
    if fast is True or fast == "bf16":
        return H.to(torch.bfloat16).to(torch.float32)
    return H


def _normal_ops(Qc: torch.Tensor, WHc: torch.Tensor, H: torch.Tensor, k: int):
    """Per-row normal-equation operands (SHST [rc, k, k], WHST [rc, k]) of
    the one-hot assignment S: SH = S H, SHST = SH S^T, WHST = WH S^T."""
    rc, n = Qc.shape
    S = (Qc[:, None, :] == torch.arange(k, device=Qc.device)[None, :, None]
         ).to(torch.float32)                                     # [rc, k, n]
    SH = (S.reshape(rc * k, n) @ H).reshape(rc, k, n)
    SHST = SH @ S.transpose(1, 2)                                # [rc, k, k]
    WHST = (S @ WHc[:, :, None].to(torch.float32))[..., 0]       # [rc, k]
    return 0.5 * (SHST + SHST.transpose(1, 2)), WHST


def _snap8(t: torch.Tensor) -> torch.Tensor:
    b = torch.clamp(torch.max(torch.abs(t), dim=1, keepdim=True).values,
                    min=1e-30) / 127.0
    return torch.clamp(torch.round(t / b), -127, 127) * b


def _quad_form(t: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """sum_r t_r A_r t_r."""
    return torch.sum((A @ t[:, :, None])[..., 0] * t)


def t_step(WH: torch.Tensor, H: torch.Tensor, Q: torch.Tensor, k: int,
           row_chunk: int = 256, rcond: float = 16 * 1.19e-7, fast=False,
           stats: bool = False, snap8: bool = False):
    """Codebook refit: T[i] = (WH S_i^T) (S_i H S_i^T)^+ per row.

    Min-norm pseudo-inverse via symmetric eigh with a gelsd-style relative
    cutoff; a codeword no column uses gets 0 (the reference's lstsq min-norm
    behaviour). ``fast``: ``True``/``"bf16"`` rounds H to bf16 before the
    contraction; anything else contracts H in float32. ``stats=True``
    returns ``(T, rel)`` with ``rel = sum_r(t_r A_r t_r - 2 t_r y_r)``, the
    quadratic loss minus the constant tr(W H W^T). ``snap8=True`` snaps t
    onto the per-row int8 grid inside the chunk (codebook="lut8")."""
    Hc = _h_operand(H, fast)
    ts, rel = [], torch.zeros((), dtype=torch.float32, device=Q.device)
    with full_f32_matmul():
        for Qc, WHc in zip(torch.split(Q, row_chunk), torch.split(WH, row_chunk)):
            A, y = _normal_ops(Qc, WHc, Hc, k)
            lam, V = torch.linalg.eigh(A)                  # ascending
            cutoff = rcond * torch.clamp(lam[:, -1:], min=0.0)
            keep = lam > cutoff
            inv = torch.where(keep, 1.0 / torch.where(keep, lam, 1.0), 0.0)
            # t = y V diag(inv) V^T
            t = ((y[:, None, :] @ V)[:, 0, :] * inv)[:, None, :] @ V.transpose(1, 2)
            t = t[:, 0, :]
            if snap8:
                t = _snap8(t)
            ts.append(t)
            if stats:
                rel = rel + _quad_form(t, A) - 2.0 * torch.sum(t * y)
    T = torch.cat(ts)
    return (T, rel) if stats else T


def t_step_affine(WH: torch.Tensor, H: torch.Tensor, Q: torch.Tensor, k: int,
                  row_chunk: int = 256, fast=False, sym: bool = False,
                  stats: bool = False):
    """Affine-constrained codebook refit ``T[r, s] = a_r + b_r (s - c)`` with
    ``c = 2^(bits-1)``: a per-row 2x2 normal system in the span {1, u} of
    the free codebook's normal equations (``sym=True`` pins a = 0).
    Degenerate rows fall back to b = 0 with a = the weighted mean."""
    Hc = _h_operand(H, fast)
    u = torch.arange(k, dtype=torch.float32, device=Q.device) - float(k // 2)
    eps = 1e-30
    ts, rel = [], torch.zeros((), dtype=torch.float32, device=Q.device)
    with full_f32_matmul():
        for Qc, WHc in zip(torch.split(Q, row_chunk), torch.split(WH, row_chunk)):
            A, y = _normal_ops(Qc, WHc, Hc, k)
            A1 = torch.sum(A, dim=2)                       # A @ 1
            Au = A @ u                                     # [rc, k]
            aa = torch.sum(A1, dim=1)                      # 1A1
            ab = torch.sum(Au, dim=1)                      # 1Au
            bb = Au @ u                                    # uAu
            y1 = torch.sum(y, dim=1)
            yu = y @ u
            if sym:
                b = yu / torch.clamp(bb, min=eps)
                a = torch.zeros_like(b)
            else:
                det = aa * bb - ab * ab
                ok = det > eps * torch.clamp(aa * bb, min=eps)
                safe = torch.where(ok, det, 1.0)
                a = torch.where(ok, (bb * y1 - ab * yu) / safe,
                                y1 / torch.clamp(aa, min=eps))
                b = torch.where(ok, (aa * yu - ab * y1) / safe, 0.0)
            ts.append(a[:, None] + b[:, None] * u[None, :])
            if stats:
                rel = rel + torch.sum(a * a * aa + 2.0 * a * b * ab + b * b * bb
                                      - 2.0 * (a * y1 + b * yu))
    T = torch.cat(ts)
    return (T, rel) if stats else T


def snap_lut8(T: torch.Tensor) -> torch.Tensor:
    """Snap a free codebook onto a per-row int8 grid: T ~= b * round(T/b)
    with b = rowmax|T|/127."""
    return _snap8(T)


def quad_loss(W: torch.Tensor, Wq: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """tr((W-Wq) H (W-Wq)^T) (reference quad_loss_2, ganq.py:392-395)."""
    E = W - Wq
    with full_f32_matmul():
        return torch.sum((E @ H) * E)


# ----------------------------------------------------------------------- main
def _select_s_step(qcfg: QuantizeConfig, device: torch.device) -> Callable:
    """The S-step for ``qcfg.solver_backend`` on ``device``: the plain
    per-column version on the CPU (what the JAX package runs there) and for
    ``"jax"``; on the card kernel 4 for ``"pallas"`` and kernel 3 for
    anything else ("auto"), at every shape."""
    backend = qcfg.solver_backend
    if device.type == "cpu" or backend == "jax":
        return s_step
    return s_step_kernel if backend == "pallas" else s_step_blocked_kernel


class _Phases:
    """Seconds per phase. On the card each mark records a CUDA event and
    the times are read once, in ``close``, so the solver loop gains no host
    sync; on the CPU a mark reads the host clock."""

    def __init__(self, out: Optional[Dict[str, float]], device: torch.device):
        self.out, self.device = out, device
        self.cuda = device.type == "cuda"
        self.marks = [("", self._now())] if out is not None else []

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def mark(self, phase: str) -> None:
        if self.out is not None:
            self.marks.append((phase, self._now()))

    def close(self) -> None:
        if self.out is None:
            return
        if self.cuda:
            self.marks[-1][1].synchronize()
        for (_, a), (phase, b) in zip(self.marks, self.marks[1:]):
            dt = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            self.out[phase] = self.out.get(phase, 0.0) + dt


def ganq_quantize(W: torch.Tensor, H: torch.Tensor, qcfg: QuantizeConfig,
                  nsamples: int, codebook_init_fn=None,
                  timings: Optional[Dict[str, float]] = None) -> GANQResult:
    """Full GANQ pipeline on one weight matrix, on W's device.

    ``codebook_init_fn(W_perm, hinv_diag) -> [m, 2^bits]`` may be injected.
    ``timings``, when given, accumulates seconds per phase (``prepare``,
    ``init``, ``s_step``, ``t_step``, ``final``)."""
    phases = _Phases(timings, W.device)
    prep = prepare(W, H, qcfg)
    m, n = prep.W.shape
    k = 2**qcfg.bits
    dev = prep.W.device
    phases.mark("prepare")

    hinv_diag = torch.diagonal(prep.Hinv)
    if codebook_init_fn is not None:
        T = torch.as_tensor(codebook_init_fn(prep.W, hinv_diag),
                            dtype=torch.float32, device=dev)
    elif qcfg.codebook_init == "kmeans_exact":
        from ..ops.kmeans_exact import kmeans_rows_exact
        wts = leanquant_weights(hinv_diag, qcfg.codebook_weight_exp)
        T = torch.from_numpy(kmeans_rows_exact(
            prep.W.cpu().numpy(), wts.cpu().numpy(), k)).to(dev, torch.float32)
    elif qcfg.codebook_init == "linear":
        base = torch.linspace(-1.0, 1.0, k, device=dev)
        T = base[None, :] * torch.max(prep.W, dim=1, keepdim=True).values
    elif qcfg.codebook_init == "normal":
        probs = torch.linspace(0.0, 1.0, k + 2, device=dev)[1:-1]
        quant = torch.erfinv(2 * probs - 1) * math.sqrt(2.0)
        T = quant[None, :] * torch.max(prep.W, dim=1, keepdim=True).values
    else:
        wts = leanquant_weights(hinv_diag, qcfg.codebook_weight_exp)
        T = weighted_kmeans_1d(prep.W, wts, k=k)

    Hd = prep.Xxt_damped
    with full_f32_matmul():
        WH = prep.W @ Hd                       # constant across iterations
    step = _select_s_step(qcfg, dev)
    fast_t = {"bfloat16": "bf16", "float32_strict": "strict"}.get(
        qcfg.hessian_dtype, False)
    codebook = qcfg.ganq_codebook

    def refit(Q):
        if codebook in ("affine", "affine_sym"):
            return t_step_affine(WH, Hd, Q, k, fast=fast_t,
                                 sym=codebook == "affine_sym", stats=True)
        return t_step(WH, Hd, Q, k, fast=fast_t, stats=True,
                      snap8=codebook == "lut8")

    if codebook in ("affine", "affine_sym"):
        # minmax grid init (see the JAX package's comment at this point)
        u = torch.arange(k, dtype=torch.float32, device=dev) - float(k // 2)
        wmin = torch.min(prep.W, dim=1, keepdim=True).values
        wmax = torch.max(prep.W, dim=1, keepdim=True).values
        if codebook == "affine_sym":
            b = torch.maximum(-wmin / float(k // 2), wmax / float(k // 2 - 1))
            T = b * u[None, :]
        else:
            b = (wmax - wmin) / float(k - 1)
            T = wmin + b * (u[None, :] + float(k // 2))
    elif codebook == "lut8":
        T = snap_lut8(T)
    phases.mark("init")

    # best-(T, Q) tracking stays on the device: no host sync in the loop
    best_rel = torch.tensor(float("inf"), device=dev)
    bT = bQ = found = None
    T_init = T
    for _ in range(qcfg.ganq_iterations):
        Q, _werr = step(prep.W, prep.L, T)
        phases.mark("s_step")
        T, rel = refit(Q)
        phases.mark("t_step")
        better = torch.isfinite(rel) & (rel < best_rel)
        best_rel = torch.where(better, rel, best_rel)
        if bT is None:
            bT, bQ, found = T, Q, better
            continue
        bT = torch.where(better, T, bT)
        bQ = torch.where(better, Q, bQ)
        found = found | better

    fallback = bQ is None or not bool(found)
    if not fallback:
        T, Q = bT, bQ
    else:  # no iteration improved (K=0 or NaN): one pass on the initial codebook
        T = T_init
        Q, _ = step(prep.W, prep.L, T)
    Wq = torch.take_along_dim(T, Q.to(torch.int64), dim=1)
    dist = float(quad_loss(prep.W, Wq, Hd))

    quad_free = None
    if codebook != "free":
        T_free = t_step(WH, Hd, Q, k, fast=fast_t)
        quad_free = float(quad_loss(
            prep.W, torch.take_along_dim(T_free, Q.to(torch.int64), dim=1), Hd))

    d = torch.diagonal(prep.Hinv)
    avg_loss = float(torch.sum((prep.W - Wq) ** 2 / d[None, :] ** 2 / 2.0)) / nsamples

    if prep.invperm is not None:
        Wq = Wq[:, prep.invperm]
        Q = Q[:, prep.invperm]
    phases.mark("final")
    phases.close()
    return GANQResult(Q=Wq, lut=T, idx=Q.to(torch.int32), avg_loss=avg_loss,
                      quad_loss=dist, damp_used=prep.damp_used,
                      nsamples=nsamples, quad_loss_free=quad_free,
                      fallback=fallback)


__all__ = ["GANQResult", "ganq_quantize", "s_step", "s_step_blocked",
           "s_step_reference", "t_step", "t_step_affine", "snap_lut8",
           "quad_loss"]
