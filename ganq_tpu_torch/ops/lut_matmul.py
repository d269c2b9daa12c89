"""LUT-dequant matrix product: ``y = x @ lut-dequant(W)^T``.

The port of ``ganq_tpu/ops/lut_matmul.py``. ``W[m, k] = lut[m, codes[m, k]]``
with one 2^bits-entry codebook per output row and the codes planar-packed in
int32 words (``ops/packing.py``), possibly padded past K.

:func:`lut_matmul` launches the hand-written CUDA kernel
(``csrc/lut_matmul.cu``) for a CUDA tensor and runs the plain version,
:func:`lut_matmul_reference`, only for a CPU tensor. On CUDA it takes every
shape the serving path gives it (bits 2/3/4, any M, padded K, any number of
rows) or raises; there is no silent fallback.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .packing import pack_factor, unpack_int_rows

_X_TYPES = (torch.bfloat16, torch.float32)


def lut_matmul_reference(x: torch.Tensor, lut: torch.Tensor,
                         idx_packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain PyTorch version: unpack + gather + matmul. The codebook is
    widened to float32 for the gather and the weight is rounded to x's type,
    as in the JAX oracle."""
    K = x.shape[-1]
    idx = unpack_int_rows(idx_packed, bits, K).to(torch.int64)
    w = torch.take_along_dim(lut.to(torch.float32), idx, dim=1)
    return x @ w.T.to(x.dtype)


def _check(x, lut, idx_packed, bits):
    if bits not in (2, 3, 4):
        raise ValueError(f"lut_matmul kernel: bits must be 2, 3 or 4, got {bits}")
    if x.dtype not in _X_TYPES:
        raise TypeError(f"lut_matmul kernel: x must be bf16 or f32, got {x.dtype}")
    if idx_packed.dtype != torch.int32:
        raise TypeError("lut_matmul kernel: idx_packed must be int32")
    M = lut.shape[0]
    if lut.dim() != 2 or lut.shape[1] != 2**bits:
        raise ValueError(f"lut_matmul kernel: lut must be [M, {2**bits}], "
                         f"got {tuple(lut.shape)}")
    if idx_packed.dim() != 2 or idx_packed.shape[0] != M:
        raise ValueError("lut_matmul kernel: idx_packed must be [M, width]")
    if idx_packed.shape[1] * pack_factor(bits) < x.shape[-1]:
        raise ValueError("lut_matmul kernel: packed width covers fewer than K "
                         "columns")
    for t in (x, lut, idx_packed):
        if t.device != x.device:
            raise ValueError("lut_matmul kernel: tensors on different devices")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary (the kernel's
    vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def lut_matmul(x: torch.Tensor, lut: torch.Tensor, idx_packed: torch.Tensor,
               bits: int = 4) -> torch.Tensor:
    """x [..., K] @ lut-dequant(W)[M, K]^T -> [..., M] in x's type, summed in
    float32. The codebook is taken in x's type (an f32 codebook is rounded
    for bf16 x; a bf16 codebook is exact in either)."""
    if x.device.type == "cpu":
        return lut_matmul_reference(x, lut, idx_packed, bits)
    _check(x, lut, idx_packed, bits)
    K = x.shape[-1]
    M, width = lut.shape[0], idx_packed.shape[1]
    x2 = x.reshape(-1, K)
    if width * pack_factor(bits) != K:     # padding columns must add zero
        x2 = torch.nn.functional.pad(x2, (0, width * pack_factor(bits) - K))
    if lut.dtype not in (torch.bfloat16, x.dtype):
        lut = lut.to(x.dtype)
    x2, lut, idx = (_aligned(t) for t in (x2, lut, idx_packed))
    B = x2.shape[0]
    out = torch.empty((B, M), dtype=x.dtype, device=x.device)
    if B:
        fn = cuda_lib.function(
            "lut_matmul", "ganq_lut_matmul",
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        status = fn(x2.data_ptr(), lut.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), B, M, width, bits,
                    int(x.dtype == torch.bfloat16),
                    int(lut.dtype == torch.bfloat16),
                    torch.cuda.current_stream(x.device).cuda_stream)
        cuda_lib.check(status, "lut_matmul")
        lut_matmul.launches += 1
    return out.reshape(*x.shape[:-1], M)


lut_matmul.launches = 0

__all__ = ["lut_matmul", "lut_matmul_reference"]
