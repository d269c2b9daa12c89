"""int8-recoded weight matrix products: the ``w8`` serving kind.

The port of ``ganq_tpu/ops/w8_matmul.py``. A ``lut`` (or ``uniform``) linear
recoded at load time onto a per-row int8 grid, ``w8[m, k] = round(w[m, k] /
s[m])`` with ``s = max|row| / 127``; the weight [M, K'] keeps the pack-time
padding (K' >= K) and x is zero-padded to match.

- :func:`w8_matmul` (kernel 7, replaces the Pallas ``w8_matmul``):
  ``x @ rnd_x(w8 * s)^T``; launches ``csrc/w8_matmul.cu`` for a CUDA tensor
  at every shape with K' >= K. Its plain version is
  :func:`w8_matmul_reference`.
- :func:`w8a8_matmul` (kernel 8, replaces ``w8a8_matmul``): per-token int8
  activations, exact int32 dots, ``(acc * sx) * s``. Where the JAX package's
  gate refuses a shape, the JAX function returns the full-precision product,
  and so does this one: through kernel 7 on the card, through its plain
  version on the CPU. Its own plain version is :func:`w8a8_reference`.

The wrappers take the plain versions only for CPU tensors; for a CUDA tensor
they launch their kernel or raise. ``.launches`` counts kernel calls.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_lib
from .packing import pack_factor, unpack_int_rows
from .uniform_matmul import (_X_TYPES, _aligned, _pick_tile, _stream,
                             quantize_rows)


def recode_lut_to_int8(lut: torch.Tensor, idx_packed: torch.Tensor, bits: int,
                       in_features: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lut [M, 2^bits], packed codes) -> (w8 int8 [M, K'], scale f32
    [M, 1]); K' keeps the pack-time padding (``in_features`` is unused, as
    in the JAX package: x is zero-padded to K')."""
    Kp = idx_packed.shape[1] * pack_factor(bits)
    idx = unpack_int_rows(idx_packed, bits, Kp).to(torch.int64)
    lutf = lut.to(torch.float32)
    w = torch.take_along_dim(lutf, idx, dim=1)
    amax = torch.amax(torch.abs(lutf), dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    w8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w8, scale


def w8_matmul_reference(x: torch.Tensor, w8: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 7 (the JAX fallback's formula): the float32
    weight rounded to x's type, matmul over the first K columns."""
    K = x.shape[-1]
    w = w8.to(torch.float32) * scale.to(torch.float32)
    return x @ w[:, :K].T.to(x.dtype)


def w8a8_reference(x: torch.Tensor, w8: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 8: x zero-padded to K', per-token int8
    activations, the integer dot (exact in float64), ``(acc * sx) * s``."""
    M, Kp = w8.shape
    x8, sx = quantize_rows(_padded_rows(x, Kp))
    acc = (x8.to(torch.float64) @ w8.to(torch.float64).T).to(torch.float32)
    y = (acc * sx) * scale.to(torch.float32).reshape(1, M)
    return y.reshape(*x.shape[:-1], M).to(x.dtype)


def _check(x, w8, scale, what):
    if x.dtype not in _X_TYPES:
        raise TypeError(f"{what} kernel: x must be bf16 or f32, got {x.dtype}")
    if w8.dtype != torch.int8 or w8.dim() != 2:
        raise TypeError(f"{what} kernel: w8 must be an int8 matrix")
    M, Kp = w8.shape
    if Kp < x.shape[-1]:
        raise ValueError(f"{what} kernel: w8 has {Kp} columns, x {x.shape[-1]}")
    if scale.numel() != M:
        raise ValueError(f"{what} kernel: scale must hold one value per row")
    for t in (w8, scale):
        if t.device != x.device:
            raise ValueError(f"{what} kernel: tensors on different devices")


def _padded_rows(x: torch.Tensor, Kp: int) -> torch.Tensor:
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    if Kp != K:
        x2 = torch.nn.functional.pad(x2, (0, Kp - K))
    return _aligned(x2)


def w8_matmul(x: torch.Tensor, w8: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ (w8 * scale)[M, K']^T -> [..., M] in x's type."""
    if x.device.type == "cpu":
        return w8_matmul_reference(x, w8, scale)
    _check(x, w8, scale, "w8_matmul")
    M, Kp = w8.shape
    x2 = _padded_rows(x, Kp)
    wq = _aligned(w8)
    sc = scale.to(torch.float32).contiguous()
    B = x2.shape[0]
    out = torch.empty((B, M), dtype=x.dtype, device=x.device)
    if B and M:
        fn = cuda_lib.function(
            "w8_matmul", "ganq_w8_matmul",
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        status = fn(x2.data_ptr(), wq.data_ptr(), sc.data_ptr(),
                    out.data_ptr(), B, M, Kp, int(x.dtype == torch.bfloat16),
                    _stream(x))
        cuda_lib.check(status, "w8_matmul")
        w8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], M)


w8_matmul.launches = 0


def w8a8_eligible(K: int, M: int, Kp: int) -> bool:
    """The JAX package's gate of its W8A8 kernel, copied literally
    (``ganq_tpu/ops/w8_matmul.py:135-136``)."""
    tm = _pick_tile(M, (512, 512, 256, 128, 64, 32))
    return not (M % tm or Kp < K or (Kp % 128 and M > 8))


def w8a8_matmul(x: torch.Tensor, w8: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """W8A8-dynamic x [..., K] -> [..., M] in x's type. Shapes the gate
    refuses get the full-precision product, as in the JAX package (kernel 7
    on the card)."""
    M, Kp = w8.shape
    if not w8a8_eligible(x.shape[-1], M, Kp):
        return w8_matmul(x, w8, scale)
    if x.device.type == "cpu":
        return w8a8_reference(x, w8, scale)
    _check(x, w8, scale, "w8a8_matmul")
    x2 = _padded_rows(x, Kp)
    wq = _aligned(w8)
    sc = scale.to(torch.float32).contiguous()
    B = x2.shape[0]
    out = torch.empty((B, M), dtype=x.dtype, device=x.device)
    if B and M:
        x8 = torch.empty((B, Kp), dtype=torch.int8, device=x.device)
        sx = torch.empty((B,), dtype=torch.float32, device=x.device)
        fn = cuda_lib.function(
            "w8_matmul", "ganq_w8a8_matmul",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        status = fn(x2.data_ptr(), wq.data_ptr(), sc.data_ptr(), x8.data_ptr(),
                    sx.data_ptr(), out.data_ptr(), B, M, Kp,
                    int(x.dtype == torch.bfloat16), _stream(x))
        cuda_lib.check(status, "w8a8_matmul")
        w8a8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], M)


w8a8_matmul.launches = 0

__all__ = ["w8_matmul", "w8_matmul_reference", "w8a8_matmul", "w8a8_reference",
           "recode_lut_to_int8", "w8a8_eligible"]
