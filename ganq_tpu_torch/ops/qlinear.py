"""Quantized-linear container and the apply dispatcher.

The port of ``ganq_tpu/ops/qlinear.py``. Kinds:

- ``dense``: float weight [out, in] (+ bias).
- ``lut``: per-row codebook ``lut [out, 2^bits]`` (bf16) + planar-packed
  codes ``idx_packed [out, in'/packfactor]`` (int32), ``in'`` padded to a
  multiple of ``128 * packfactor`` when larger — the GANQ artifact.
- ``uniform``: packed codes ``qweight`` + per-group ``scales`` (+ ``zeros``,
  omitted when every zero point is the symmetric centre 2^(bits-1); +
  ``g_idx``, omitted when it is the sequential ``k // group_size``) — the
  GPTQ artifact and the target of the ``optimize()`` recodes.
- ``w8``: per-row int8 weight ``w8 [out, in']`` + ``scale [out, 1]``.

A :class:`QLinear` is an ``nn.Module`` whose arrays are buffers, so
``.to(device)`` moves it and its buffer names are the checkpoint's tensor
suffixes. The recodes (``recode_w8``, ``w8_to_uniform8``,
``recode_uniform8``, ``recode_uniform4``, ``certify_uniform``) build new
linears from old ones, as ``GanqModel.optimize`` and the engine use them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .packing import pack_factor, pack_int_rows, unpack_int_rows
from .uniform_matmul import dequantize_uniform, group_map

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


def uniform_linear(qidx: torch.Tensor, scale: torch.Tensor,
                   zero: torch.Tensor, g_idx: Optional[torch.Tensor], bits: int,
                   bias: Optional[torch.Tensor] = None) -> QLinear:
    """Packed uniform linear from codes [out, in], scale/zero [out, groups]
    and g_idx [in]. Zeros that all equal the symmetric centre 2^(bits-1) are
    omitted, and so is a g_idx equal to ``k // group_size``: the a8 gate and
    the prefill branch read those omissions, as in the JAX package."""
    arrays = {"qweight": pack_int_rows(qidx, bits),
              "scales": scale.to(torch.float32)}
    if not bool(torch.all(zero == float(1 << (bits - 1)))):
        arrays["zeros"] = zero.to(torch.float32)
    if g_idx is not None:
        K = qidx.shape[1]
        gs = -(-K // max(scale.shape[1], 1))
        seq = torch.arange(K, device=g_idx.device) // gs
        if not torch.equal(g_idx.to(torch.int64), seq):
            arrays["g_idx"] = g_idx.to(torch.int32)
    if bias is not None:
        arrays["bias"] = bias
    return QLinear("uniform", arrays, bits=bits, in_features=qidx.shape[1])


def uniform_g_idx(p: QLinear) -> torch.Tensor:
    """The column -> group map of a uniform linear (the sequential map when
    the artifact omits it)."""
    return group_map(p["g_idx"] if "g_idx" in p else None, p.in_features,
                     p["scales"].shape[1], p["scales"].device)


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
        return dequantize_uniform(p["qweight"], p["scales"],
                                  p["zeros"] if "zeros" in p else None,
                                  p["g_idx"] if "g_idx" in p else None,
                                  p.bits, p.in_features)
    if p.kind == "w8":
        w = p["w8"].to(torch.float32) * p["scale"].to(torch.float32)
        return w[:, :p.in_features]
    raise ValueError(f"unknown qlinear kind: {p.kind}")


def _prefill_weight(p: QLinear) -> torch.Tensor:
    """The bf16 weight of the dequantize-once prefill GEMM. Symmetric uniform
    artifacts with sequential groups take the JAX package's bf16-native
    form, codes -> int8 -> bf16 times bf16 scales, which rounds differently
    from the float32 dequantization rounded to bf16."""
    if (p.kind == "uniform" and "zeros" not in p and "g_idx" not in p
            and p.in_features % p["scales"].shape[-1] == 0):
        codes = unpack_int_rows(p["qweight"], p.bits, p.in_features)
        c8 = (codes - (1 << (p.bits - 1))).to(torch.int8).to(torch.bfloat16)
        gs = p.in_features // p["scales"].shape[-1]
        sc = torch.repeat_interleave(p["scales"].to(torch.bfloat16), gs, dim=-1)
        return c8 * sc
    return dequantize_weight(p).to(torch.bfloat16)


def apply(p: QLinear, x: torch.Tensor, backend: str = "reference") -> torch.Tensor:
    """y = x @ W^T + b for any linear kind. x: [..., in] -> [..., out].

    ``"cuda"`` runs each kind's full-precision kernel (``lut_matmul``,
    ``uniform_matmul``, ``w8_matmul``); ``"cuda_a8"`` the int8-activation
    kernels for ``uniform`` and ``w8`` (``uniform_a8_matmul``,
    ``w8a8_matmul``), the counterpart of the JAX package's ``pallas_a8``.
    From 1024 token rows both dequantize once to bf16 and run a GEMM. An
    EoRA adapter adds its rank-r term ``(x @ A^T) @ B^T`` on every backend,
    after the product and before the bias (``adapter/eora.apply_lora``: a
    plain matmul pair, as the JAX package leaves it to XLA)."""
    rows = x.numel() // x.shape[-1]
    if p.kind == "dense":
        y = x @ p["weight"].T.to(x.dtype)
    elif backend == "reference":
        y = x @ dequantize_weight(p).T.to(x.dtype)
    elif backend not in ("cuda", "cuda_a8"):
        raise ValueError(f"unknown backend: {backend}")
    elif rows >= _PREFILL_GEMM_ROWS:
        # prefill-shaped: compute bound, so dequantize once to bf16 and run a
        # dense GEMM (the fused kernels are decode-shaped). The bf16 weight
        # exists for one linear at a time.
        y = x.to(torch.bfloat16) @ _prefill_weight(p).T
    elif p.kind == "lut":
        from .lut_matmul import lut_matmul
        y = lut_matmul(x, p["lut"], p["idx_packed"], p.bits)
    elif p.kind == "w8":
        from . import w8_matmul as w8m
        kernel = w8m.w8a8_matmul if backend == "cuda_a8" else w8m.w8_matmul
        y = kernel(x, p["w8"], p["scale"])
    elif p.kind == "uniform":
        from . import uniform_matmul as um
        kernel = (um.uniform_a8_matmul if backend == "cuda_a8"
                  else um.uniform_matmul)
        y = kernel(x, p["qweight"], p["scales"],
                   p["zeros"] if "zeros" in p else None,
                   p["g_idx"] if "g_idx" in p else None, p.bits)
    else:
        raise ValueError(f"unknown qlinear kind: {p.kind}")
    if "lora_a" in p:
        from ..adapter.eora import apply_lora
        y = y + apply_lora(x, p["lora_a"], p["lora_b"])
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


# -------------------------------------------------------------------- recodes
def _carry_bias(p: QLinear, arrays: Dict[str, torch.Tensor]):
    """A recode's arrays plus the bias and the EoRA adapter of ``p`` (the
    JAX package's ``for extra in ("bias", "lora_a", "lora_b")``; its
    ``recode_w8`` carries the bias only, ``ROADMAP.md`` queue C)."""
    for extra in ("bias", "lora_a", "lora_b"):
        if extra in p:
            arrays[extra] = p[extra]
    return arrays


def recode_w8(p: QLinear) -> QLinear:
    """``lut`` or ``uniform`` linear -> per-row int8 ``w8`` linear (error at
    most max|row| / 254); other kinds pass through unchanged."""
    if p.kind == "lut":
        from .w8_matmul import recode_lut_to_int8
        w8, scale = recode_lut_to_int8(p["lut"], p["idx_packed"], p.bits,
                                       p.in_features)
    elif p.kind == "uniform":
        w = dequantize_weight(p)
        amax = torch.amax(torch.abs(w), dim=1, keepdim=True)
        scale = torch.clamp(amax, min=1e-12) / 127.0
        w8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    else:
        return p
    return QLinear("w8", _carry_bias(p, {"w8": w8, "scale": scale}), bits=8,
                   in_features=p.in_features)


def w8_to_uniform8(p: QLinear) -> QLinear:
    """``w8`` linear -> ``uniform`` 8-bit linear, losslessly: code = w8 +
    128 (the zero point 2^7 is the per-row grid's centre) and the row scale
    repeated over 128-column groups. Other kinds, and widths that are no
    multiple of 128, pass through unchanged."""
    if p.kind != "w8":
        return p
    n = p.in_features
    if n % 128 or n % pack_factor(8):
        return p
    codes = p["w8"][:, :n].to(torch.int32) + 128
    scale = p["scale"].to(torch.float32)
    scales = scale.expand(scale.shape[0], n // 128).contiguous()
    return QLinear("uniform", _carry_bias(p, {
        "qweight": pack_int_rows(codes, 8), "scales": scales}), bits=8,
        in_features=n)


def recode_uniform8(p: QLinear) -> QLinear:
    """``lut`` linear -> ``uniform`` 8-bit linear with per-128-column max-abs
    scales (error at most max|group| / 254). Widths that are no multiple of
    128 take :func:`recode_w8`'s artifact converted losslessly. Other kinds
    pass through unchanged."""
    if p.kind != "lut":
        return p
    n = p.in_features
    if n % 128 or n % pack_factor(8):
        return w8_to_uniform8(recode_w8(p))
    w = dequantize_weight(p)
    gw = w.reshape(w.shape[0], n // 128, 128)
    scale = torch.clamp(torch.amax(torch.abs(gw), dim=-1), min=1e-12) / 127.0
    codes = torch.clamp(torch.round(gw / scale[..., None]), -127, 127) + 128
    codes = codes.reshape(w.shape[0], n).to(torch.int32)
    return QLinear("uniform", _carry_bias(p, {
        "qweight": pack_int_rows(codes, 8),
        "scales": scale.to(torch.float32)}), bits=8, in_features=n)


def recode_uniform4(p: QLinear) -> QLinear:
    """3-bit ``lut`` linear -> ``uniform`` 4-bit linear: the 8 codebook values
    snap onto the row's 16-level affine grid (error at most max-min / 30)
    while the codes keep the solver's assignments. Other kinds and bits,
    odd widths and lane-padded artifacts pass through unchanged."""
    if p.kind != "lut" or p.bits != 3:
        return p
    n = p.in_features
    if n % 128 or n % pack_factor(4):
        return p
    if p["idx_packed"].shape[-1] * pack_factor(3) != n:
        return p                     # lane-padded artifact (lut_linear)
    lut = p["lut"].to(torch.float32)                  # [R, 8]
    tmin = torch.amin(lut, dim=-1)
    tmax = torch.amax(lut, dim=-1)
    s = torch.clamp((tmax - tmin) / 15.0, min=1e-12)
    zero = -tmin / s                                  # v = s * (q - zero)
    q16 = torch.clamp(torch.round((lut - tmin[:, None]) / s[:, None]), 0, 15)
    idx = unpack_int_rows(p["idx_packed"], 3, n).to(torch.int64)
    codes = torch.take_along_dim(q16.to(torch.int32), idx, dim=1)
    G = n // 128
    return QLinear("uniform", _carry_bias(p, {
        "qweight": pack_int_rows(codes, 4),
        "scales": s[:, None].expand(-1, G).contiguous(),
        "zeros": zero[:, None].expand(-1, G).contiguous()}), bits=4,
        in_features=n)


def concat_rows(linears) -> QLinear:
    """Fuse linears that share an input (q/k/v, gate/up) by concatenating
    their output rows: every row-wise array (weight, codebooks, packed
    codes, scales, zeros, bias) is independent per output row. ``g_idx``
    is shared and must agree. EoRA adapters fuse block-diagonally, as in
    the JAX package: A' stacks the A rows [sum r, in] and B' =
    blockdiag(B_i) [sum out, sum r], so ``(x @ A'^T) @ B'^T`` is each
    linear's own term; a mix of adapted and plain linears raises
    ValueError. Linears of mixed kind or bits, or whose other arrays
    differ (``zeros`` present in some only), raise ValueError: there the
    JAX package's ``concat_rows`` drops the later linears' ``zeros`` or
    raises, and the port serves them unfused (``ROADMAP.md`` queue C)."""
    first = linears[0]
    if len({(p.kind, p.bits) for p in linears}) != 1:
        raise ValueError("cannot fuse linears of mixed kind/bits")
    has_lora = ["lora_a" in p for p in linears]
    if any(has_lora) and not all(has_lora):
        raise ValueError("cannot fuse a mix of adapted and plain linears")
    keys = sorted(k for k, v in first._buffers.items() if v is not None)
    if any(sorted(k for k, v in p._buffers.items() if v is not None) != keys
           for p in linears[1:]):
        raise ValueError("cannot fuse linears with different arrays")
    arrays = {}
    for k in keys:
        if k == "g_idx":
            if any(not torch.equal(first[k], p[k]) for p in linears[1:]):
                raise ValueError("cannot fuse linears with divergent g_idx")
            arrays[k] = first[k]
        elif k == "lora_b":
            arrays[k] = torch.block_diag(*(p[k] for p in linears))
        else:
            arrays[k] = torch.cat([p[k] for p in linears], dim=0)
    return QLinear(first.kind, arrays, first.bits, first.in_features)


def certify_uniform(p: QLinear, tol_rel: float = 2.0 ** -7
                    ) -> Optional[QLinear]:
    """``lut`` linear whose per-row codebook lies on an affine grid ->
    ``uniform`` linear; None when a row does not.

    A host-side numpy copy of the JAX package's function: each row is fit by
    least squares, first with the zero point pinned to the symmetric centre
    (then the result omits ``zeros``), else freely; the fit's residual must
    stay within ``tol_rel`` of the row's range. Per-row scale and zero are
    repeated over 128-column groups (one group per row for other widths).
    The packed codes pass through untouched; lane-padded artifacts are not
    certified (their pad codes would dequantize to -scale * zero)."""
    if p.kind != "lut" or p.bits < 2:
        return None
    lut = p["lut"].to(torch.float32).cpu().numpy()    # [m, k], sorted
    k = lut.shape[-1]
    if k != 1 << p.bits:
        return None
    center = float(1 << (p.bits - 1))
    u = np.arange(k, dtype=np.float32) - center            # sym basis
    uc = np.arange(k, dtype=np.float32) - (k - 1) / 2.0    # centred (sum 0)
    span = np.maximum(lut[:, -1] - lut[:, 0], np.max(np.abs(lut), axis=1))
    tol = tol_rel * np.maximum(span, 1e-30)
    # sym-constrained fit: value = b * (s - center)
    b_sym = (lut @ u) / float(u @ u)
    resid_sym = np.max(np.abs(lut - b_sym[:, None] * u[None, :]), axis=1)
    sym = bool(np.all(resid_sym <= tol))
    if sym:
        a = -0.5 * b_sym                         # in the centred basis
        b = b_sym
    else:
        # free affine fit in the centred basis: value = a + b * uc (the row
        # mean is the exact intercept since sum(uc) == 0)
        a = np.mean(lut, axis=1)
        b = ((lut - a[:, None]) @ uc) / float(uc @ uc)
        resid = np.max(np.abs(lut - a[:, None] - b[:, None] * uc[None, :]),
                       axis=1)
        if not np.all(resid <= tol):
            return None
    # constant rows (b ~ 0) are representable only at value 0 (scale 0)
    flat = np.abs(b) <= 1e-30
    if np.any(flat & (np.abs(a) > tol)):
        return None
    b = np.where(flat, 1e-30, b)
    n = p.in_features
    if p["idx_packed"].shape[-1] != n // pack_factor(p.bits):
        return None                              # lane-padded artifact
    G = n // 128 if n % 128 == 0 else 1
    dev = p["idx_packed"].device
    scale = np.broadcast_to(np.float32(b).reshape(-1, 1), (lut.shape[0], G))
    arrays = {"qweight": p["idx_packed"],
              "scales": torch.from_numpy(np.array(scale)).to(dev)}
    if not sym:
        # value(s) = a + b * (s - (k - 1) / 2) = b * (s - zero)
        zero = np.broadcast_to(
            np.float32((k - 1) / 2.0 - a / b).reshape(-1, 1), (lut.shape[0], G))
        arrays["zeros"] = torch.from_numpy(np.array(zero)).to(dev)
    return QLinear("uniform", _carry_bias(p, arrays), bits=p.bits,
                   in_features=n)


__all__ = ["QLinear", "dense_linear", "lut_linear", "uniform_linear",
           "dequantize_weight", "apply", "uniform_g_idx", "uniform_zeros",
           "recode_w8", "w8_to_uniform8", "recode_uniform8", "recode_uniform4",
           "certify_uniform", "concat_rows"]
