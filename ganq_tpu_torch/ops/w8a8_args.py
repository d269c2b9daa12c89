"""The argument block of the fused decode kernels (kernels 9-14).

``csrc/w8a8_fused.cuh`` declares the same struct, ``W8A8Args``; each C entry
point (``ganq_fused_mlp``, ``ganq_fused_qkv_rope``, ``ganq_attn_half``,
``ganq_megastep_w8``, ``ganq_megastep4``, ``ganq_megastep_lowbit``) takes a
pointer to one; the group-scaled kernels 13 and 14 read the fields after
``x_bf16`` and after ``part`` too (kernel 14 alone the zero-point
corrections and act-order column orders at the end). Field order and types must
match the header's. Pointers are tensors' ``data_ptr()`` (0 for an unused
field); the kernels read and write them on the caller's stream, so every
tensor named here must stay alive until the launch has been enqueued, which
the wrappers guarantee by holding them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import cuda_lib

_INTS = ("B", "H", "Kx", "q_dim", "kv_dim", "d", "rd", "interleaved", "qkv_ld",
         "o_rows", "I", "ti", "down_ld", "T", "Tb", "L", "fold_norm", "act",
         "x_bf16", "gs", "bits", "tq", "gtp", "cos_ld", "kmajor")
_FLOATS = ("eps", "rms_offset", "scale")
_STRIDES = ("cache_sb", "cache_sg", "cache_st", "cache_sl")
_POINTERS = ("x", "attn_norm", "mlp_norm", "qkv_w8", "qkv_scale", "qkv_bias",
             "cos_half", "sin_half", "k_cache", "v_cache", "pos", "o_t_w8",
             "o_t_scale", "gateup_w8", "gateup_scale", "down_w8",
             "down_scale", "y", "qkv_out", "kn", "vn", "x8", "sx", "xs",
             "act_a", "amax", "a8", "attn", "attn_amax", "o32", "part",
             "qkv_pk", "o_pk", "gu_pk", "dn_pk", "qkv_gs", "o_gs", "gu_gs",
             "dn_gs", "partf", "qkv_sz", "o_sz", "gu_sz", "dn_sz", "ap_q",
             "ap_g", "ap_o")

ACT_CODES = {"silu": 0, "gelu_tanh": 1, "gelu": 2}


class W8A8Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in _INTS]
                + [(n, ctypes.c_float) for n in _FLOATS]
                + [(n, ctypes.c_longlong) for n in _STRIDES]
                + [(n, ctypes.c_void_p) for n in _POINTERS])


def launch(library: str, symbol: str, what: str,
           tensors: Dict[str, Optional[torch.Tensor]], device: torch.device,
           **scalars) -> None:
    """Fill a :class:`W8A8Args` from ``tensors`` (by field name) and
    ``scalars`` and call ``symbol`` of ``csrc/<library>.cu`` on the current
    stream; raises on a non-zero cudaError_t."""
    args = W8A8Args()
    for name, value in scalars.items():
        setattr(args, name, value)
    for name, t in tensors.items():
        if t is not None:
            if t.device != device:
                raise ValueError(f"{what}: {name} is on {t.device}, not "
                                 f"{device}")
            setattr(args, name, t.data_ptr())
    fn = cuda_lib.function(library, symbol, [ctypes.POINTER(W8A8Args),
                                             ctypes.c_void_p])
    stream = torch.cuda.current_stream(device).cuda_stream
    cuda_lib.check(fn(ctypes.byref(args), stream), what)


__all__ = ["W8A8Args", "launch", "ACT_CODES"]
