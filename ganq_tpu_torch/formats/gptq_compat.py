"""GPTQ-ecosystem checkpoint layout conversion.

The port of ``ganq_tpu/formats/gptq_compat.py``, bit-exact with it. The
legacy AutoGPTQ layout (``gptqmodel/nn_modules/qlinear/__init__.py:492-572``):

- ``qweight``: int32 [in_features * bits / 32, out_features], codes packed
  along the input dimension, little-endian within each word;
- ``qzeros``: int32 [n_groups, out_features * bits / 32], zero points packed
  along the output dimension, stored minus one in ``FORMAT.GPTQ`` (v1) and
  as they are in ``FORMAT.GPTQ_V2``;
- ``scales``: fp16 [n_groups, out_features];
- ``g_idx``: int32 [in_features].

The runtime layout packs codes per output row ([out, in/packfactor],
``ops/packing.py``); these converters translate both ways, in numpy, for 2,
4 and 8 bits (the 3-bit interleave is not supported, as in the JAX
package).
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple

import numpy as np


def _check_bits(bits: int) -> None:
    if bits not in (2, 4, 8):
        raise ValueError(f"GPTQ compat layout supports 2/4/8 bits, got {bits}")


def pack_gptq(qidx: np.ndarray, scales: np.ndarray, zeros: np.ndarray,
              g_idx: np.ndarray, bits: int, v1: bool = True
              ) -> Dict[str, np.ndarray]:
    """Solver outputs -> GPTQ tensors. qidx: [out, in] int codes;
    scales/zeros: [out, n_groups]; g_idx: [in]."""
    _check_bits(bits)
    pf = 32 // bits
    out_f, in_f = qidx.shape
    if in_f % pf:
        raise ValueError(f"in_features {in_f} not divisible by pack factor {pf}")
    codes = qidx.astype(np.uint32).T                     # [in, out]
    shifts = (np.arange(pf, dtype=np.uint32) * bits)[None, :, None]
    qweight = (codes.reshape(in_f // pf, pf, out_f) << shifts).sum(
        axis=1, dtype=np.uint32).astype(np.int32)        # [in/pf, out]

    z = np.round(zeros).astype(np.uint32).T              # [n_groups, out]
    if v1:
        if np.any(z == 0):
            # v1 stores zero - 1, so a zero point of 0 wraps to 2^bits - 1
            warnings.warn("zero-point 0 present: GPTQ v1 storage wraps it; "
                          "save with format='gptq_v2' for exactness")
        z = (z - 1) & ((1 << bits) - 1)
    n_groups = z.shape[0]
    if out_f % pf:
        raise ValueError(f"out_features {out_f} not divisible by pack factor {pf}")
    shifts_o = (np.arange(pf, dtype=np.uint32) * bits)[None, None, :]
    qzeros = (z.reshape(n_groups, out_f // pf, pf) << shifts_o).sum(
        axis=2, dtype=np.uint32).astype(np.int32)        # [n_groups, out/pf]
    return {
        "qweight": np.ascontiguousarray(qweight),
        "qzeros": np.ascontiguousarray(qzeros),
        "scales": np.ascontiguousarray(scales.T.astype(np.float16)),
        "g_idx": np.ascontiguousarray(g_idx.astype(np.int32)),
    }


def unpack_gptq(tensors: Dict[str, np.ndarray], bits: int, v1: bool = True
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """GPTQ tensors -> (qidx [out, in], scales [out, G], zeros [out, G],
    g_idx [in])."""
    _check_bits(bits)
    pf = 32 // bits
    mask = np.uint32((1 << bits) - 1)
    qweight = tensors["qweight"].astype(np.uint32)       # [in/pf, out]
    shifts = (np.arange(pf, dtype=np.uint32) * bits)[None, :, None]
    codes = (qweight[:, None, :] >> shifts) & mask       # [in/pf, pf, out]
    qidx = codes.reshape(-1, qweight.shape[1]).T.astype(np.int32)

    qzeros = tensors["qzeros"].astype(np.uint32)         # [G, out/pf]
    shifts_o = (np.arange(pf, dtype=np.uint32) * bits)[None, None, :]
    z = ((qzeros[:, :, None] >> shifts_o) & mask).reshape(qzeros.shape[0], -1)
    if v1:
        z = (z + 1) & mask
    zeros = z.T.astype(np.float32)                       # [out, G]
    scales = tensors["scales"].astype(np.float32).T      # [out, G]
    g_idx = tensors["g_idx"].astype(np.int32)
    return qidx, scales, zeros, g_idx


__all__ = ["pack_gptq", "unpack_gptq"]
