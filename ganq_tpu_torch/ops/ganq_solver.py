"""GANQ S-step: the two hand-written CUDA kernels and their plain versions.

The port of ``ganq_tpu/ops/ganq_solver.py``. Both kernels compute the same
function (``csrc/ganq_sstep.cu`` states it): W [m, n] f32, L [n, n]
lower-triangular f32 and one codebook T [m, V] f32 per row (V = 2^bits, 4 to
256) give the codes Q [m, n] int32 and the errors Werr [m, n] f32 of the
backward walk over the columns.

- :func:`s_step_blocked_kernel` (kernel 3, replaces ``s_step_blocked_pallas``):
  128-column blocks right to left, a K-split trailing product per block
  (partial sums added in split order) plus an in-block walk. Its plain
  version is :func:`s_step_blocked`, in the same block order.
- :func:`s_step_kernel` (kernel 4, replaces ``s_step_pallas``): the
  per-column walk in one launch, each 16-column block's residuals one
  3xTF32 product over the committed columns. Its plain version is the
  per-column :func:`s_step`.

The wrappers run the plain version only for CPU tensors; for a CUDA tensor
they launch the kernel (any m, any n, V = 4 .. 256) or raise. ``.launches``
counts the wrapper's kernel calls: one per S-step, although the blocked
kernel enqueues a product and a walk per column block on the stream.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core.backend import full_f32_matmul
from . import cuda_lib

BLOCK = 128


def s_step(W: torch.Tensor, L: torch.Tensor, T: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain per-column S-step (the port of ``quant/ganq.s_step``): columns
    j = n-1 .. 0, each residual ``r = Werr @ L[:, j-1]`` against the whole
    error matrix (columns < j are still zero). Returns (Q int32, Werr)."""
    m, n = W.shape
    Werr = torch.zeros_like(W)
    Q = torch.zeros((m, n), dtype=torch.int32, device=W.device)
    r = torch.zeros((m,), dtype=W.dtype, device=W.device)
    with full_f32_matmul():
        for j in range(n - 1, -1, -1):
            eff = W[:, j] + r / L[j, j]
            idx = torch.argmin(torch.abs(eff[:, None] - T), dim=1)
            Werr[:, j] = W[:, j] - torch.take_along_dim(T, idx[:, None], dim=1)[:, 0]
            Q[:, j] = idx.to(torch.int32)
            r = Werr @ L[:, (j - 1) % n]
    return Q, Werr


def s_step_blocked(W: torch.Tensor, L: torch.Tensor, T: torch.Tensor,
                   blk: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain blocked S-step (the port of ``quant/ganq.s_step_blocked``, with
    a ragged last block where n is not a multiple of ``blk``): per block
    [b0, b1), right to left, the trailing residual ``Werr[:, b1:] @
    L[b1:, b0:b1]`` and an in-block correction ``acc`` updated after every
    column. The same block order as kernel 3. Returns (Q int32, Werr)."""
    m, n = W.shape
    Werr = torch.zeros_like(W)
    Q = torch.zeros((m, n), dtype=torch.int32, device=W.device)
    with full_f32_matmul():
        for b0 in range(((n - 1) // blk) * blk, -1, -blk):
            b1 = min(b0 + blk, n)
            rext = Werr[:, b1:] @ L[b1:, b0:b1]
            acc = torch.zeros_like(rext)
            for t in range(b1 - b0 - 1, -1, -1):
                j = b0 + t
                eff = W[:, j] + (rext[:, t] + acc[:, t]) / L[j, j]
                idx = torch.argmin(torch.abs(eff[:, None] - T), dim=1)
                werr = W[:, j] - torch.take_along_dim(T, idx[:, None], dim=1)[:, 0]
                Werr[:, j] = werr
                Q[:, j] = idx.to(torch.int32)
                acc[:, :t] += werr[:, None] * L[j, b0:j][None, :]
    return Q, Werr


def _check(W: torch.Tensor, L: torch.Tensor, T: torch.Tensor, what: str):
    m, n = W.shape if W.dim() == 2 else (None, None)
    if (W.dim() != 2 or L.shape != (n, n) or T.dim() != 2
            or T.shape[0] != m):
        raise ValueError(f"{what}: W must be [m, n], L [n, n] and T [m, V]; "
                         f"got {tuple(W.shape)}, {tuple(L.shape)}, "
                         f"{tuple(T.shape)}")
    V = T.shape[1]
    if V not in (4, 8, 16, 32, 64, 128, 256):
        raise ValueError(f"{what}: codebook width must be 2^bits for bits "
                         f"2-8, got {V}")
    for t in (W, L, T):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: W, L and T must be float32")
        if t.device != W.device:
            raise ValueError(f"{what}: tensors on different devices")
    return m, n, V


def s_step_blocked_kernel(W: torch.Tensor, L: torch.Tensor, T: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3: the blocked S-step. (Q [m, n] int32, Werr [m, n] f32)."""
    if W.device.type == "cpu":
        return s_step_blocked(W, L, T)
    m, n, V = _check(W, L, T, "s_step_blocked kernel")
    W, T = W.contiguous(), T.contiguous()
    Lt = L.T.contiguous()       # a view of the column-major Cholesky factor
    Werr = torch.empty_like(W)
    Q = torch.empty((m, n), dtype=torch.int32, device=W.device)
    size = cuda_lib.function("ganq_sstep", "ganq_sstep_blocked_scratch",
                             [ctypes.c_int] * 2)(m, n)
    scratch = torch.empty((size,), dtype=torch.float32, device=W.device)
    fn = cuda_lib.function("ganq_sstep", "ganq_sstep_blocked",
                           [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
    status = fn(W.data_ptr(), Lt.data_ptr(), T.data_ptr(), Werr.data_ptr(),
                Q.data_ptr(), scratch.data_ptr(), m, n, V,
                torch.cuda.current_stream(W.device).cuda_stream)
    cuda_lib.check(status, "s_step_blocked kernel")
    s_step_blocked_kernel.launches += 1
    return Q, Werr


def s_step_kernel(W: torch.Tensor, L: torch.Tensor, T: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 4: the per-column S-step. (Q [m, n] int32, Werr [m, n] f32)."""
    if W.device.type == "cpu":
        return s_step(W, L, T)
    m, n, V = _check(W, L, T, "s_step kernel")
    W, T = W.contiguous(), T.contiguous()
    Lt = L.T.contiguous()       # a view of the column-major Cholesky factor
    Werr = torch.empty_like(W)
    Q = torch.empty((m, n), dtype=torch.int32, device=W.device)
    fn = cuda_lib.function("ganq_sstep", "ganq_sstep_columns",
                           [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
    status = fn(W.data_ptr(), Lt.data_ptr(), T.data_ptr(), Werr.data_ptr(),
                Q.data_ptr(), m, n, V,
                torch.cuda.current_stream(W.device).cuda_stream)
    cuda_lib.check(status, "s_step kernel")
    s_step_kernel.launches += 1
    return Q, Werr


s_step_blocked_kernel.launches = 0
s_step_kernel.launches = 0

__all__ = ["s_step", "s_step_blocked", "s_step_blocked_kernel",
           "s_step_kernel", "BLOCK"]
