"""Bit-packing of integer codes into int32 words, planar layout.

Bit-exact with ``ganq_tpu/ops/packing.py``: bit-slot ``p`` of word ``w``
holds the code of column ``p * (n / packfactor) + w``, so one plane is one
shift and mask over the packed block and covers a contiguous column range.
3-bit codes take one nibble each (packfactor 8). Words are stored as int32;
a word whose top bit is set is the negative int32 with the same bits.
"""

from __future__ import annotations

import torch


def _bits_per_slot(bits: int) -> int:
    return 4 if bits == 3 else bits


def pack_factor(bits: int) -> int:
    return 32 // _bits_per_slot(bits)


def pack_int_rows(idx: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack [..., n] integer codes (0..2^bits-1) into [..., n/packfactor]
    int32 words, planar layout."""
    slot = _bits_per_slot(bits)
    pf = 32 // slot
    n = idx.shape[-1]
    if n % pf != 0:
        raise ValueError(f"packing requires n % {pf} == 0, got n={n}")
    width = n // pf
    x = idx.to(torch.int64).reshape(*idx.shape[:-1], pf, width)
    shifts = (torch.arange(pf, dtype=torch.int64, device=idx.device)
              * slot)[:, None]
    packed = torch.sum(x << shifts, dim=-2)        # disjoint bits: sum == or
    # uint32 -> int32 with the same bits
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)


def unpack_plane(packed: torch.Tensor, bits: int, plane: int) -> torch.Tensor:
    """Plane ``plane`` -> [..., width] int32 codes, columns
    [plane*width, (plane+1)*width). The arithmetic shift of a negative word
    only fills bits above those the mask keeps."""
    slot = _bits_per_slot(bits)
    return (packed >> (slot * plane)) & (2**slot - 1) & (2**bits - 1)


def unpack_int_rows(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_int_rows` -> [..., n] int32 codes."""
    planes = [unpack_plane(packed, bits, p) for p in range(pack_factor(bits))]
    return torch.cat(planes, dim=-1)[..., :n]


__all__ = ["pack_int_rows", "unpack_int_rows", "unpack_plane", "pack_factor"]
