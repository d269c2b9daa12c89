"""Fused W8A8 MLP: norm, gate/up, activation, down and residual (kernel 9).

The port of ``ganq_tpu/ops/fused_mlp.py``. For token rows x [B, H] (B <= 64):

    h  = rmsnorm(x) (optional)           x8, sx = int8 rows of h
    g  = (x8 . gate * sx) * gs           u = (x8 . up * sx) * us
    a  = act(g) * u                      quantized per tile of ti columns:
    out = sum over tiles, in tile order, of (a8_t . down_t) * sa_t
    y  = out * ds (+ x when the norm is folded in)

The tile width changes the numbers (each tile has its own activation
scale): :func:`fused_mlp_tile` is the JAX package's rule, copied. Where the
JAX function's ``ok`` test fails it computes the MLP in full precision
outside its kernel, and so does this one (:func:`fused_mlp_fallback`).

:func:`fused_mlp_w8a8` launches ``csrc/w8a8_fused.cu`` (``ganq_fused_mlp``)
for CUDA tensors and runs :func:`fused_mlp_plain`, its plain version, only
for CPU tensors. ``.launches`` counts kernel calls.
"""

from __future__ import annotations

from typing import Optional

import torch

from .fused_attention import _f32, _int_dot, rms_rows
from .uniform_matmul import _aligned, quantize_rows
from .w8a8_args import ACT_CODES

# the JAX kernel's VMEM budget for its three streamed weight tiles
_TILE_BUDGET = 13 * 2**20


def fused_mlp_tile(I: int, Hp: int, block_i: int = 1024) -> int:
    """The activation tile width of kernel 9 (``fused_mlp.py:106-115``):
    from ``block_i``, halve while it does not divide I, then while it is
    above 256 and 6 * ti * Hp bytes exceed 13 MiB. At H = 3072, I = 8192
    that is 512; at H = 2048, 1024."""
    ti = block_i
    while I % ti:
        ti //= 2
    while ti > 256 and 6 * ti * Hp > _TILE_BUDGET:
        ti //= 2
    return ti


def fused_mlp_ok(B: int, H: int, gateup_w8: torch.Tensor,
                 down_w8: torch.Tensor, ti: int, fold_norm: bool) -> bool:
    """The JAX function's test for running its kernel
    (``fused_mlp.py:119-120``)."""
    I2, Hp = gateup_w8.shape
    Hd, Ip = down_w8.shape
    return (Hd == H and Hp >= H and Ip >= I2 // 2 and ti >= 256
            and ti % 128 == 0 and Hp % 128 == 0
            and (not fold_norm or Hp == H) and B <= 64)


def activation(g: torch.Tensor, act: str) -> torch.Tensor:
    """The fused kernels' activations: "silu", "gelu_tanh" and "gelu"."""
    if act == "silu":
        return torch.nn.functional.silu(g)
    if act == "gelu_tanh":
        return torch.nn.functional.gelu(g, approximate="tanh")
    return torch.nn.functional.gelu(g)


def mlp_tiles(x8: torch.Tensor, sx: torch.Tensor, gateup_w8: torch.Tensor,
              gateup_scale: torch.Tensor, down_w8: torch.Tensor, ti: int,
              act: str, down_k_major: bool = False) -> torch.Tensor:
    """The W8A8 MLP body shared by kernels 9 and 12: the float32 sum over
    activation tiles, in tile order, of ``(a8_t . down_t) * sa_t``, where
    ``a = act(g) * u`` and each tile's a is quantized by its own per-row
    scale. ``down_w8`` is [H, I'] (kernel 9) or K-major [I, H] (the
    megapack's ``down_t``)."""
    I = gateup_w8.shape[0] // 2
    gs = gateup_scale.to(torch.float32).reshape(1, -1)
    acc = torch.zeros((x8.shape[0], down_w8.shape[1] if down_k_major
                       else down_w8.shape[0]), dtype=torch.float32,
                      device=x8.device)
    for t0 in range(0, I, ti):
        g = (_int_dot(x8, gateup_w8[t0:t0 + ti]) * sx) * gs[:, t0:t0 + ti]
        u = (_int_dot(x8, gateup_w8[I + t0:I + t0 + ti]) * sx) \
            * gs[:, I + t0:I + t0 + ti]
        a8, sa = quantize_rows(activation(g, act) * u)
        dn = (down_w8[t0:t0 + ti].T if down_k_major
              else down_w8[:, t0:t0 + ti])
        acc = acc + _int_dot(a8, dn) * sa
    return acc


def fused_mlp_plain(x: torch.Tensor, gateup_w8: torch.Tensor,
                    gateup_scale: torch.Tensor, down_w8: torch.Tensor,
                    down_scale: torch.Tensor, act: str = "silu",
                    block_i: int = 1024, norm_w: Optional[torch.Tensor] = None,
                    eps: float = 1e-5, rms_offset: float = 0.0) -> torch.Tensor:
    """Plain version of kernel 9 (the shapes its ``ok`` test admits), with
    the kernel's arithmetic. x [..., H] -> [..., H] in x's type."""
    H = x.shape[-1]
    I2, Hp = gateup_w8.shape
    x2 = x.reshape(-1, H)
    h = x2.to(torch.float32)
    if norm_w is not None:
        h = rms_rows(h, norm_w, eps, rms_offset)
    if Hp != H:
        h = torch.nn.functional.pad(h, (0, Hp - H))
    x8, sx = quantize_rows(h)
    ti = fused_mlp_tile(I2 // 2, Hp, block_i)
    out = mlp_tiles(x8, sx, gateup_w8, gateup_scale, down_w8, ti, act)
    out = out * down_scale.to(torch.float32).reshape(1, -1)
    if norm_w is not None:
        out = out + x2.to(torch.float32)
    return out.to(x.dtype).reshape(x.shape)


def fused_mlp_fallback(x: torch.Tensor, gateup_w8: torch.Tensor,
                       gateup_scale: torch.Tensor, down_w8: torch.Tensor,
                       down_scale: torch.Tensor, act: str = "silu",
                       block_i: int = 1024,
                       norm_w: Optional[torch.Tensor] = None,
                       eps: float = 1e-5,
                       rms_offset: float = 0.0) -> torch.Tensor:
    """The JAX function's route for shapes its kernel refuses
    (``fused_mlp.py:121-132``): the norm and residual outside, then the MLP
    in full precision (float32 dequantized weights; the activation "silu"
    or else "gelu", never "gelu_tanh", as there)."""
    H = x.shape[-1]
    x2 = x.reshape(-1, H)
    if norm_w is not None:
        var = torch.mean(x2.to(torch.float32) ** 2, dim=1, keepdim=True)
        h = x2 * torch.rsqrt(var + eps) * (norm_w.to(x2.dtype) + rms_offset)
        y = fused_mlp_w8a8(h, gateup_w8, gateup_scale, down_w8, down_scale,
                           act=act, block_i=block_i)
        return (x + y.reshape(x.shape)).to(x.dtype)
    I = gateup_w8.shape[0] // 2
    gw = gateup_w8.to(torch.float32) * gateup_scale.to(torch.float32)
    xf = x2.to(torch.float32)
    g = xf @ gw[:I, :H].T
    u = xf @ gw[I:, :H].T
    a = activation(g, "silu" if act == "silu" else "gelu") * u
    dw = down_w8[:, :I].to(torch.float32) * down_scale.to(torch.float32)
    y = a @ dw.T
    return y.to(x.dtype).reshape(x.shape)


def fused_mlp_w8a8(x: torch.Tensor, gateup_w8: torch.Tensor,
                   gateup_scale: torch.Tensor, down_w8: torch.Tensor,
                   down_scale: torch.Tensor, act: str = "silu",
                   block_i: int = 1024, norm_w: Optional[torch.Tensor] = None,
                   eps: float = 1e-5, rms_offset: float = 0.0) -> torch.Tensor:
    """Kernel 9: x [..., H] -> [..., H] in x's type. gateup: int8 [2I, Hp]
    (gate rows, then up rows) + scale [2I, 1]; down: int8 [H, Ip] + scale
    [H, 1] (padded columns unread). With ``norm_w`` the rmsnorm and the
    residual are folded in."""
    H = x.shape[-1]
    B = x.numel() // H
    I2, Hp = gateup_w8.shape
    ti = fused_mlp_tile(I2 // 2, Hp, block_i)
    fold = norm_w is not None
    if not fused_mlp_ok(B, H, gateup_w8, down_w8, ti, fold):
        return fused_mlp_fallback(x, gateup_w8, gateup_scale, down_w8,
                                  down_scale, act, block_i, norm_w, eps,
                                  rms_offset)
    if x.device.type == "cpu":
        return fused_mlp_plain(x, gateup_w8, gateup_scale, down_w8,
                               down_scale, act, block_i, norm_w, eps,
                               rms_offset)
    from .w8a8_args import launch

    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("fused_mlp_w8a8 kernel: x must be bf16 or float32")
    if gateup_w8.dtype != torch.int8 or down_w8.dtype != torch.int8:
        raise TypeError("fused_mlp_w8a8 kernel: int8 weights")
    I = I2 // 2
    Ip = down_w8.shape[1]
    if Ip % 16:
        raise ValueError("fused_mlp_w8a8 kernel: down rows must be 16-byte "
                         "multiples")
    dev = x.device
    x2 = x.reshape(B, H)
    if Hp != H:
        x2 = torch.nn.functional.pad(x2, (0, Hp - H))
    x2 = _aligned(x2)
    ng = I // ti
    y = torch.empty((B, H), dtype=x.dtype, device=dev)
    launch("w8a8_fused", "ganq_fused_mlp", "fused_mlp_w8a8", dict(
        x=x2, attn_norm=_f32(norm_w), gateup_w8=_aligned(gateup_w8),
        gateup_scale=_f32(gateup_scale), down_w8=_aligned(down_w8),
        down_scale=_f32(down_scale), y=y,
        x8=torch.empty((B, Hp), dtype=torch.int8, device=dev),
        sx=torch.empty((B,), dtype=torch.float32, device=dev),
        act_a=torch.empty((B, I), dtype=torch.float32, device=dev),
        amax=torch.empty((B, ng), dtype=torch.int32, device=dev),
        a8=torch.empty((B, I), dtype=torch.int8, device=dev)), dev,
        B=B, H=H, Kx=Hp, I=I, ti=ti, down_ld=Ip, L=1, fold_norm=int(fold),
        act=ACT_CODES[act], x_bf16=int(x.dtype == torch.bfloat16), eps=eps,
        rms_offset=rms_offset)
    fused_mlp_w8a8.launches += 1
    return y.reshape(x.shape)


fused_mlp_w8a8.launches = 0

__all__ = ["fused_mlp_w8a8", "fused_mlp_plain", "fused_mlp_fallback",
           "fused_mlp_tile", "fused_mlp_ok", "mlp_tiles", "activation"]
