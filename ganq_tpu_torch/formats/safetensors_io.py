"""Reader and writer for the safetensors file format, on torch tensors.

The port reads and writes the format itself rather than through the
``safetensors`` package: an 8-byte little-endian header length, a JSON
header mapping each tensor name to its dtype, shape and byte range, then the
raw little-endian bytes of every tensor, back to back.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import torch

_CODES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _CODES.items()}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of one file, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    buf = torch.frombuffer(data, dtype=torch.uint8) if data else None
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _CODES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: unsupported dtype {info['dtype']} "
                             f"for {name}")
        begin, end = info["data_offsets"]
        raw = buf[begin:end].clone() if end > begin else torch.empty(0, dtype=torch.uint8)
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write tensors to one file. Tensors are laid out by element size, largest
    first, so every tensor starts at an offset aligned to its element size."""
    items = sorted(((k, v.detach().contiguous().cpu()) for k, v in tensors.items()),
                   key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: Dict[str, object] = {}
    offset = 0
    for name, t in items:
        if t.dtype not in _NAMES:
            raise ValueError(f"cannot store {name} of dtype {t.dtype}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    hb = json.dumps(header, separators=(",", ":")).encode()
    hb += b" " * (-len(hb) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for _, t in items:
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))


__all__ = ["load_file", "save_file"]
