"""Quantized-linear container and the apply dispatcher.

The port of ``ganq_tpu/ops/qlinear.py`` for the kinds this slice serves:

- ``dense``: float weight [out, in] (+ bias).
- ``lut``: per-row codebook ``lut [out, 2^bits]`` (bf16) + planar-packed
  codes ``idx_packed [out, in'/packfactor]`` (int32), ``in'`` padded to a
  multiple of ``128 * packfactor`` when larger — the GANQ artifact.
- ``uniform``: packed codes + per-group scale/zero (+ g_idx); served by the
  reference backend until its kernel lands.

A :class:`QLinear` is an ``nn.Module`` whose arrays are buffers, so
``.to(device)`` moves it and its buffer names are the checkpoint's tensor
suffixes.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .packing import pack_factor, pack_int_rows, unpack_int_rows

# token-row count at which quantized matmuls switch from the decode-shaped
# LUT kernel to the dequantize-once GEMM (ganq_tpu/ops/qlinear.py:41)
_PREFILL_GEMM_ROWS = 1024


class QLinear(nn.Module):
    """A linear layer's parameters: ``kind``/``bits``/``in_features`` plus
    its arrays as buffers."""

    def __init__(self, kind: str, arrays: Dict[str, torch.Tensor],
                 bits: int = 16, in_features: int = 0):
        super().__init__()
        self.kind = kind
        self.bits = bits
        self.in_features = in_features
        for name, value in arrays.items():
            self.register_buffer(name, value)

    def __getitem__(self, k: str) -> torch.Tensor:
        return self._buffers[k]

    def __contains__(self, k: str) -> bool:
        return self._buffers.get(k) is not None

    def extra_repr(self) -> str:
        shapes = {k: tuple(v.shape) for k, v in self._buffers.items()}
        return f"{self.kind}, bits={self.bits}, {shapes}"


# ----------------------------------------------------------------- constructors
def dense_linear(weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> QLinear:
    arrays = {"weight": weight}
    if bias is not None:
        arrays["bias"] = bias
    return QLinear("dense", arrays, in_features=weight.shape[1])


def lut_linear(lut: torch.Tensor, idx: torch.Tensor, bits: int,
               bias: Optional[torch.Tensor] = None) -> QLinear:
    """Build a packed LUT linear from a codebook [out, 2^bits] and codes
    [out, in]. The codebook is sorted per row and the codes remapped, so the
    artifact is canonical; columns are zero-padded up to a multiple of
    ``128 * packfactor`` when K is larger than that."""
    order = torch.argsort(lut, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)      # old code -> new code
    lut_sorted = torch.take_along_dim(lut, order, dim=1)
    idx_new = torch.take_along_dim(rank, idx.to(torch.int64), dim=1)
    align = 128 * pack_factor(bits)
    K = idx_new.shape[1]
    Kp = -(-K // align) * align if K > align else K
    if Kp != K:
        idx_new = nn.functional.pad(idx_new, (0, Kp - K))
    arrays = {"lut": lut_sorted.to(torch.bfloat16),
              "idx_packed": pack_int_rows(idx_new, bits)}
    if bias is not None:
        arrays["bias"] = bias
    return QLinear("lut", arrays, bits=bits, in_features=K)


def uniform_g_idx(p: QLinear) -> torch.Tensor:
    """The column -> group map of a uniform linear (the sequential map when
    the artifact omits it)."""
    if "g_idx" in p:
        return p["g_idx"].to(torch.int64)
    gs = -(-p.in_features // max(p["scales"].shape[1], 1))
    return torch.arange(p.in_features, device=p["scales"].device) // gs


def uniform_zeros(p: QLinear) -> torch.Tensor:
    """The zero points of a uniform linear (the symmetric center when the
    artifact omits them)."""
    if "zeros" in p:
        return p["zeros"]
    return torch.full_like(p["scales"], float(1 << (p.bits - 1)))


# ----------------------------------------------------------- reference dequant
def dequantize_weight(p: QLinear) -> torch.Tensor:
    """Materialize the float32 weight [out, in] — the oracle every kernel
    must match."""
    if p.kind == "dense":
        return p["weight"]
    if p.kind == "lut":
        idx = unpack_int_rows(p["idx_packed"], p.bits, p.in_features)
        return torch.take_along_dim(p["lut"].to(torch.float32),
                                    idx.to(torch.int64), dim=-1)
    if p.kind == "uniform":
        qidx = unpack_int_rows(p["qweight"], p.bits, p.in_features)
        gi = uniform_g_idx(p)
        scale = p["scales"].to(torch.float32)[:, gi]
        zero = uniform_zeros(p).to(torch.float32)[:, gi]
        return scale * (qidx.to(torch.float32) - zero)
    raise ValueError(f"unknown qlinear kind: {p.kind}")


def apply(p: QLinear, x: torch.Tensor, backend: str = "reference") -> torch.Tensor:
    """y = x @ W^T + b for any linear kind. x: [..., in] -> [..., out]."""
    rows = x.numel() // x.shape[-1]
    if p.kind == "dense":
        y = x @ p["weight"].T.to(x.dtype)
    elif backend == "reference":
        y = x @ dequantize_weight(p).T.to(x.dtype)
    elif backend != "cuda":
        raise ValueError(f"unknown backend: {backend}")
    elif rows >= _PREFILL_GEMM_ROWS:
        # prefill-shaped: compute bound, so dequantize once to bf16 and run a
        # dense GEMM (the fused kernel is decode-shaped). The bf16 weight
        # exists for one linear at a time.
        w = dequantize_weight(p).to(torch.bfloat16)
        y = x.to(torch.bfloat16) @ w.T
    elif p.kind == "lut":
        from .lut_matmul import lut_matmul
        y = lut_matmul(x, p["lut"], p["idx_packed"], p.bits)
    else:
        raise NotImplementedError(
            f"no CUDA kernel for kind={p.kind} yet (uniform_matmul is port "
            "slice 3); use the reference backend")
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


__all__ = ["QLinear", "dense_linear", "lut_linear", "dequantize_weight",
           "apply", "uniform_g_idx", "uniform_zeros"]
