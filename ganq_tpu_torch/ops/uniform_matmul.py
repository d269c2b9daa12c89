"""Uniform (scale / zero-point) dequant matrix products, full precision and
W{2,3,4,8}A8.

The port of ``ganq_tpu/ops/uniform_matmul.py``. ``W[m, k] = s[m, g(k)] *
(q[m, k] - z[m, g(k)])`` with planar-packed codes (``ops/packing.py``),
per-group float32 scales and zeros and a column -> group map ``g_idx``
(sequential, ``k // gs``, when None).

- :func:`uniform_matmul` (kernel 5, replaces the Pallas ``uniform_matmul``):
  launches ``csrc/uniform_matmul.cu`` for a CUDA tensor, at every shape and
  every ``g_idx``; its plain version is :func:`uniform_matmul_reference`.
- :func:`uniform_a8_matmul` (kernel 6, replaces ``uniform_a8_matmul``):
  per-token int8 activations against the codes, exact int32 dots per group.
  Where the JAX package's gate refuses a shape (a ``g_idx``, groups
  not a multiple of 128 columns, ...), the JAX function returns the
  full-precision product, and so does this one: through kernel 5 on the
  card, through its plain version on the CPU. Its own plain version is
  :func:`uniform_a8_reference`.

The wrappers take the plain versions only for CPU tensors; for a CUDA tensor
they launch their kernel or raise. ``.launches`` counts kernel calls.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import cuda_lib
from .packing import pack_factor, unpack_int_rows

_X_TYPES = (torch.bfloat16, torch.float32)


def _pick_tile(dim: int, candidates) -> int:
    for c in candidates:
        if dim % c == 0:
            return c
    return dim


def group_map(g_idx: Optional[torch.Tensor], K: int, n_groups: int,
              device) -> torch.Tensor:
    """The column -> group map: ``g_idx``, or the sequential ``k // gs``
    (gs = ceil(K / n_groups)) when it is None."""
    if g_idx is not None:
        return g_idx.to(torch.int64)
    gs = -(-K // max(n_groups, 1))
    return torch.arange(K, device=device) // gs


def dequantize_uniform(qweight, scales, zeros, g_idx, bits,
                       K) -> torch.Tensor:
    """The float32 weight [M, K], ``scale * (q - zero)``; ``zeros`` None is
    the symmetric centre 2^(bits-1)."""
    gi = group_map(g_idx, K, scales.shape[1], scales.device)
    q = unpack_int_rows(qweight, bits, K).to(torch.float32)
    z = (zeros.to(torch.float32)[:, gi] if zeros is not None
         else float(1 << (bits - 1)))
    return scales.to(torch.float32)[:, gi] * (q - z)


def uniform_matmul_reference(x: torch.Tensor, qweight: torch.Tensor,
                             scales: torch.Tensor,
                             zeros: Optional[torch.Tensor],
                             g_idx: Optional[torch.Tensor],
                             bits: int) -> torch.Tensor:
    """Plain version of kernel 5: dequantize in float32, round the weight to
    x's type, matmul."""
    w = dequantize_uniform(qweight, scales, zeros, g_idx, bits, x.shape[-1])
    return x @ w.T.to(x.dtype)


# fl(1/127): jitted JAX compiles ``max|x| / 127.0`` into a product with it
INV127 = float(np.float32(1.0) / np.float32(127.0))


def row_scale(amax: torch.Tensor) -> torch.Tensor:
    """A token row's int8 scale from its float32 max|x|: ``max(max|x| *
    fl(1/127), 1e-12)``, the float32 product into which XLA compiles the
    JAX package's ``max(max|x| / 127.0, 1e-12)`` (it differs from the IEEE
    quotient in the last bit on some rows)."""
    return torch.clamp(amax * torch.full_like(amax, INV127), min=1e-12)


def quantize_rows(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8 activations of x2 [B, K]: (x8 as float32 integers,
    sx [B, 1]) with sx from :func:`row_scale` and ``x8 = clamp(round(x /
    sx), -127, 127)``, an IEEE quotient with ties to even (``jnp.round``
    divides by a traced value). The rule of every int8-activation point of
    the port (``csrc/a8_quant.cuh`` on the card)."""
    xf = x2.to(torch.float32)
    sx = row_scale(torch.amax(torch.abs(xf), dim=1, keepdim=True))
    return torch.clamp(torch.round(xf / sx), -127, 127), sx


def uniform_a8_reference(x: torch.Tensor, qweight: torch.Tensor,
                         scales: torch.Tensor, zeros: Optional[torch.Tensor],
                         g_idx: Optional[torch.Tensor],
                         bits: int) -> torch.Tensor:
    """Plain version of kernel 6, the JAX oracle's arithmetic: quantized
    activations times the float32 dequantized weight, times sx."""
    K = x.shape[-1]
    x8, sx = quantize_rows(x.reshape(-1, K))
    w = dequantize_uniform(qweight, scales, zeros, g_idx, bits, K)
    y = (x8 @ w.T) * sx
    return y.reshape(*x.shape[:-1], -1).to(x.dtype)


def _check(x, qweight, scales, zeros, bits, what):
    if bits not in (2, 3, 4, 8):
        raise ValueError(f"{what} kernel: bits must be 2, 3, 4 or 8, got {bits}")
    if x.dtype not in _X_TYPES:
        raise TypeError(f"{what} kernel: x must be bf16 or f32, got {x.dtype}")
    if qweight.dtype != torch.int32:
        raise TypeError(f"{what} kernel: qweight must be int32")
    M, K = qweight.shape[0], x.shape[-1]
    if qweight.dim() != 2 or qweight.shape[1] * pack_factor(bits) != K:
        raise ValueError(f"{what} kernel: qweight must be [M, K / packfactor]")
    if scales.dim() != 2 or scales.shape[0] != M or scales.shape[1] < 1:
        raise ValueError(f"{what} kernel: scales must be [M, groups]")
    if zeros is not None and zeros.shape != scales.shape:
        raise ValueError(f"{what} kernel: zeros must match scales")
    for t in (qweight, scales) + ((zeros,) if zeros is not None else ()):
        if t.device != x.device:
            raise ValueError(f"{what} kernel: tensors on different devices")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# elements of scratch by (sizing symbol, shape)
_SCRATCH: dict = {}


def _scratch(lib: str, symbol: str, dtype: torch.dtype, x: torch.Tensor,
             *shape: int):
    """The scratch a kernel of library ``lib`` needs at this shape (the
    partial sums of a product whose K it splits over blocks, ...), in
    elements of ``dtype`` as ``symbol`` sizes it once a shape, or None."""
    n = _SCRATCH.get((symbol,) + shape)
    if n is None:
        fn = cuda_lib.function(lib, symbol, [ctypes.c_int] * len(shape))
        n = _SCRATCH[(symbol,) + shape] = fn(*shape)
    return torch.empty(n, dtype=dtype, device=x.device) if n else None


def uniform_matmul(x: torch.Tensor, qweight: torch.Tensor,
                   scales: torch.Tensor, zeros: Optional[torch.Tensor],
                   g_idx: Optional[torch.Tensor], bits: int = 4) -> torch.Tensor:
    """x [..., K] @ dequant(W)[M, K]^T -> [..., M] in x's type, summed in
    float32, the weight rounded to x's type."""
    if x.device.type == "cpu":
        return uniform_matmul_reference(x, qweight, scales, zeros, g_idx, bits)
    _check(x, qweight, scales, zeros, bits, "uniform_matmul")
    K = x.shape[-1]
    M, width = qweight.shape
    G = scales.shape[1]
    if g_idx is not None and (g_idx.shape != (K,) or g_idx.device != x.device):
        raise ValueError("uniform_matmul kernel: g_idx must be [K] on x's device")
    x2 = _aligned(x.reshape(-1, K))
    qw = _aligned(qweight)
    sc = scales.to(torch.float32).contiguous()
    zp = zeros.to(torch.float32).contiguous() if zeros is not None else None
    gi = g_idx.to(torch.int32).contiguous() if g_idx is not None else None
    B = x2.shape[0]
    out = torch.empty((B, M), dtype=x.dtype, device=x.device)
    if B and M:
        x_bf16 = int(x.dtype == torch.bfloat16)
        part = _scratch("uniform_matmul", "ganq_uniform_matmul_scratch",
                        torch.float32, x, B, M, width, bits, x_bf16)
        fn = cuda_lib.function(
            "uniform_matmul", "ganq_uniform_matmul",
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        status = fn(x2.data_ptr(), qw.data_ptr(), sc.data_ptr(),
                    zp.data_ptr() if zp is not None else None,
                    gi.data_ptr() if gi is not None else None,
                    out.data_ptr(),
                    part.data_ptr() if part is not None else None, B, M,
                    width, G, -(-K // G), bits, x_bf16, _stream(x))
        cuda_lib.check(status, "uniform_matmul")
        uniform_matmul.launches += 1
    return out.reshape(*x.shape[:-1], M)


uniform_matmul.launches = 0


def a8_eligible(K: int, M: int, n_groups: int, g_idx, bits: int) -> bool:
    """The JAX package's capability gate of its W{b}A8 kernel, copied
    (``ganq_tpu/ops/uniform_matmul.py:283-300``). A ``g_idx`` that is given
    counts as permuted, as in the JAX package's jitted serving path, where
    it cannot be inspected; ``uniform_linear`` omits a sequential one, so no
    device value is read here."""
    gs = K // n_groups if n_groups else K
    pf = pack_factor(bits)
    width = K // pf
    block_m = 256 if K >= 8192 else 512
    tm = _pick_tile(M, (block_m, 512, 256, 128, 64, 32, 16, 8))
    return (bits in (2, 3, 4, 8) and K % pf == 0
            and K % max(n_groups, 1) == 0
            and g_idx is None
            and M % tm == 0
            and (width % 128 == 0 or M <= 8)
            and (gs % 128 == 0 or n_groups <= 1)
            and (width % gs == 0 or gs % width == 0))


def uniform_a8_matmul(x: torch.Tensor, qweight: torch.Tensor,
                      scales: torch.Tensor, zeros: Optional[torch.Tensor],
                      g_idx: Optional[torch.Tensor],
                      bits: int = 4) -> torch.Tensor:
    """W{bits}A8-dynamic x [..., K] @ W^T -> [..., M] in x's type. Shapes
    the gate refuses get the full-precision product, as in the JAX
    package (kernel 5 on the card)."""
    K, M = x.shape[-1], qweight.shape[0]
    if not a8_eligible(K, M, scales.shape[1], g_idx, bits):
        return uniform_matmul(x, qweight, scales, zeros, g_idx, bits)
    if x.device.type == "cpu":
        return uniform_a8_reference(x, qweight, scales, zeros, g_idx, bits)
    _check(x, qweight, scales, zeros, bits, "uniform_a8_matmul")
    width = qweight.shape[1]
    G = scales.shape[1]
    sc = scales.to(torch.float32).contiguous()
    zp = zeros.to(torch.float32).contiguous() if zeros is not None else None
    x2 = _aligned(x.reshape(-1, K))
    qw = _aligned(qweight)
    B = x2.shape[0]
    out = torch.empty((B, M), dtype=x.dtype, device=x.device)
    if B and M:
        x8 = torch.empty((B, K), dtype=torch.int8, device=x.device)
        sx = torch.empty((B,), dtype=torch.float32, device=x.device)
        sumx = torch.empty((B, G), dtype=torch.int32, device=x.device)
        part = _scratch("uniform_matmul", "ganq_uniform_a8_matmul_scratch",
                        torch.float32, x, B, M, width, bits)
        fn = cuda_lib.function(
            "uniform_matmul", "ganq_uniform_a8_matmul",
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        status = fn(x2.data_ptr(), qw.data_ptr(), sc.data_ptr(),
                    zp.data_ptr() if zp is not None else None,
                    x8.data_ptr(), sx.data_ptr(),
                    sumx.data_ptr(), out.data_ptr(),
                    part.data_ptr() if part is not None else None, B, M,
                    width, G, bits, int(x.dtype == torch.bfloat16),
                    _stream(x))
        cuda_lib.check(status, "uniform_a8_matmul")
        uniform_a8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], M)


uniform_a8_matmul.launches = 0

__all__ = ["uniform_matmul", "uniform_matmul_reference", "uniform_a8_matmul",
           "uniform_a8_reference", "quantize_rows", "row_scale", "INV127",
           "a8_eligible", "dequantize_uniform", "group_map"]
