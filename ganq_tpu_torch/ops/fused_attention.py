"""Fused attention decode kernels: norm + qkv + rope, and flash decode.

The port of ``ganq_tpu/ops/fused_attention.py``:

- :func:`fused_qkv_rope_w8a8` (kernel 10, replaces the Pallas
  ``fused_qkv_rope_w8a8``): rmsnorm, per-row int8 activations, the int8
  qkv product ``(acc * sx) * s``, bias, and rope on the q and k sections,
  out in bf16. Rope's partner lane is read rounded to bf16, as the TPU
  kernel's sign-permutation product reads it:
  ``y * cos + (bf16(y) @ R) * sin``. Its plain version is
  :func:`fused_qkv_rope_plain`; ``rope_tile_operands``,
  ``expand_rope_tables`` and ``qkv_fusable_tile`` are the JAX package's
  helpers, copied.
- :func:`flash_decode_attention` (kernel 2): one query token per sequence
  over the KV cache (``csrc/flash_decode.cu``), plain version
  :func:`flash_decode_reference`; :func:`flash_decode_split_reference`
  rounds where the kernel rounds, to hold the kernel to about one bf16 ulp
  on the card.

The wrappers take the plain versions only for CPU tensors; for a CUDA tensor
they launch their kernel or raise. ``.launches`` counts kernel calls.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_lib

# ------------------------------------------------------------------ rope prep
def rope_tile_operands(tile: int, head_dim: int, rotary_dim: int,
                       interleaved: bool):
    """Operands of rope on a [B, tile] row tile of ``tile // head_dim`` whole
    heads (copied from the JAX package): ``R [tile, tile]``, the
    block-diagonal rotate-half (or interleaved-pair) sign permutation with
    zero columns outside the rotary span, and lane maps (cos_map, sin_map
    [tile]) naming the rope-table entry each lane multiplies (-1: identity
    lane, cos 1 and sin 0)."""
    nh = tile // head_dim
    R = np.zeros((tile, tile), np.float32)
    cos_map = np.full((tile,), -1, np.int64)
    sin_map = np.full((tile,), -1, np.int64)
    half = rotary_dim // 2
    for h in range(nh):
        base = h * head_dim
        for j in range(rotary_dim):
            if interleaved:
                partner = base + (j + 1 if j % 2 == 0 else j - 1)
                cos_map[base + j] = sin_map[base + j] = j // 2
                R[partner, base + j] = -1.0 if j % 2 == 0 else 1.0
            elif j < half:
                cos_map[base + j] = sin_map[base + j] = j
                R[base + j + half, base + j] = -1.0
            else:
                cos_map[base + j] = sin_map[base + j] = j - half
                R[base + j - half, base + j] = 1.0
    return R, cos_map, sin_map


def expand_rope_tables(cos_half: torch.Tensor, sin_half: torch.Tensor,
                       cos_map: np.ndarray, sin_map: np.ndarray
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-lane cos/sin rows [1, tile] (float32) from the half tables
    [rotary_dim // 2] and the lane maps (identity lanes: cos 1, sin 0)."""
    dev = cos_half.device
    cm = torch.as_tensor(np.where(cos_map < 0, 0, cos_map), device=dev)
    sm = torch.as_tensor(np.where(sin_map < 0, 0, sin_map), device=dev)
    cos_l = torch.where(torch.as_tensor(cos_map < 0, device=dev), 1.0,
                        cos_half.to(torch.float32)[cm])
    sin_l = torch.where(torch.as_tensor(sin_map < 0, device=dev), 0.0,
                        sin_half.to(torch.float32)[sm])
    return cos_l[None, :], sin_l[None, :]


def qkv_fusable_tile(q_dim: int, kv_dim: int, head_dim: int) -> Optional[int]:
    """The JAX package's row tile of its fused qkv kernels: the first of
    512, 256, 1024, 128, 2048 that divides both the q and kv sections and
    holds whole heads, or None (then no fused qkv kernel runs)."""
    for cand in (512, 256, 1024, 128, 2048):
        if q_dim % cand == 0 and kv_dim % cand == 0 and cand % head_dim == 0:
            return cand
    return None


def rope_rows(y: torch.Tensor, cos_half: Optional[torch.Tensor],
              sin_half: Optional[torch.Tensor], q_dim: int, kv_dim: int,
              head_dim: int, rotary_dim: int, interleaved: bool
              ) -> torch.Tensor:
    """Rope on the q and k sections of y [B, Dqkv] (float32) as the fused
    kernels apply it: ``y * cos + (bf16(y) @ R) * sin`` per head, R from
    :func:`rope_tile_operands` (each output lane reads one partner lane,
    rounded to bf16, times +-1); the v section is left as it is."""
    if not rotary_dim:
        return y
    R, cmap, smap = rope_tile_operands(head_dim, head_dim, rotary_dim,
                                       interleaved)
    partner = torch.as_tensor(np.abs(R).argmax(axis=0), device=y.device)
    sign = torch.as_tensor(R.sum(axis=0), device=y.device)
    cos_l, sin_l = expand_rope_tables(cos_half, sin_half, cmap, smap)
    n = q_dim + kv_dim
    sec = y[:, :n].reshape(y.shape[0], n // head_dim, head_dim)
    rot = sec.to(torch.bfloat16).to(torch.float32)[..., partner] * sign
    roped = sec * cos_l + rot * sin_l
    return torch.cat([roped.reshape(y.shape[0], n), y[:, n:]], dim=1)


def _int_dot(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """x8 [B, K] (integers) @ w8[:, :K]^T as the exact int32 sum, returned
    in float32 (the sum is exact in float64; its float32 rounding is the
    kernels' int -> float conversion)."""
    K = x8.shape[-1]
    return (x8.to(torch.float64) @ w8[:, :K].to(torch.float64).T
            ).to(torch.float32)


def rms_rows(x: torch.Tensor, weight: torch.Tensor, eps: float,
             rms_offset: float = 0.0) -> torch.Tensor:
    """The fused kernels' rmsnorm of token rows, kept in float32:
    ``x * rsqrt(mean(x^2) + eps) * (w + offset)``."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * (weight.to(torch.float32)
                                          + rms_offset)


def fused_qkv_rope_plain(x: torch.Tensor, norm_w: Optional[torch.Tensor],
                         qkv_w8: torch.Tensor, qkv_scale: torch.Tensor,
                         bias: Optional[torch.Tensor],
                         cos_half: Optional[torch.Tensor],
                         sin_half: Optional[torch.Tensor], q_dim: int,
                         kv_dim: int, head_dim: int, rotary_dim: int = 0,
                         interleaved: bool = False, eps: float = 1e-5,
                         rms_offset: float = 0.0,
                         fold_norm: bool = True) -> torch.Tensor:
    """Plain version of kernel 10, with the kernel's arithmetic: x [B, H] ->
    qkv [B, q_dim + 2 kv_dim] bf16. The JAX oracle
    (``fused_qkv_rope_reference``) rotates the float32 y instead of its bf16
    rounding, which moves an output by at most one bf16 ulp."""
    from .uniform_matmul import quantize_rows

    H = x.shape[-1]
    xf = x.to(torch.float32)
    if fold_norm:
        xf = rms_rows(xf, norm_w if norm_w is not None
                      else torch.ones(H, device=x.device), eps, rms_offset)
    x8, sx = quantize_rows(xf)
    y = (_int_dot(x8, qkv_w8) * sx) * qkv_scale.to(torch.float32).reshape(1, -1)
    if bias is not None:
        y = y + bias.to(torch.float32).reshape(1, -1)
    y = rope_rows(y, cos_half, sin_half, q_dim, kv_dim, head_dim, rotary_dim,
                  interleaved)
    return y.to(torch.bfloat16)


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.to(torch.float32).contiguous()


def fused_qkv_rope_w8a8(x: torch.Tensor, norm_w: Optional[torch.Tensor],
                        qkv_w8: torch.Tensor, qkv_scale: torch.Tensor,
                        bias: Optional[torch.Tensor],
                        cos_half: Optional[torch.Tensor],
                        sin_half: Optional[torch.Tensor], q_dim: int,
                        kv_dim: int, head_dim: int, rotary_dim: int = 0,
                        interleaved: bool = False, eps: float = 1e-5,
                        rms_offset: float = 0.0,
                        fold_norm: bool = True) -> torch.Tensor:
    """Kernel 10: x [B, H] -> qkv [B, q_dim + 2 kv_dim] bf16 with rope on the
    q and k sections; ``cos_half``/``sin_half`` [rotary_dim // 2] are the
    rope tables at the decode position. qkv_w8 [Dqkv, H'] int8 (H' >= H,
    pack padding unread), qkv_scale [Dqkv, 1] float32."""
    Dqkv = qkv_w8.shape[0]
    if Dqkv != q_dim + 2 * kv_dim:
        raise ValueError("fused_qkv_rope: qkv rows != q_dim + 2 kv_dim")
    if qkv_fusable_tile(q_dim, kv_dim, head_dim) is None:
        raise ValueError(f"no 128-aligned head tile for q_dim={q_dim} "
                         f"kv_dim={kv_dim} head_dim={head_dim}")
    if x.device.type == "cpu":
        return fused_qkv_rope_plain(x, norm_w, qkv_w8, qkv_scale, bias,
                                    cos_half, sin_half, q_dim, kv_dim,
                                    head_dim, rotary_dim, interleaved, eps,
                                    rms_offset, fold_norm)
    from .w8a8_args import launch
    from .uniform_matmul import _aligned

    B, H = x.shape
    _check_fused_shapes("fused_qkv_rope", x, qkv_w8, head_dim, rotary_dim)
    dev = x.device
    xc = _aligned(x)
    out = torch.empty((B, Dqkv), dtype=torch.bfloat16, device=dev)
    x8 = torch.empty((B, H), dtype=torch.int8, device=dev)
    sx = torch.empty((B,), dtype=torch.float32, device=dev)
    launch("w8a8_fused", "ganq_fused_qkv_rope", "fused_qkv_rope_w8a8", dict(
        x=xc, attn_norm=_f32(norm_w) if fold_norm else None,
        qkv_w8=_aligned(qkv_w8), qkv_scale=_f32(qkv_scale),
        qkv_bias=_f32(bias), cos_half=_f32(cos_half),
        sin_half=_f32(sin_half), qkv_out=out, x8=x8, sx=sx), dev,
        B=B, H=H, Kx=H, q_dim=q_dim, kv_dim=kv_dim, d=head_dim,
        rd=rotary_dim or 0, interleaved=int(interleaved),
        qkv_ld=qkv_w8.shape[1], L=1, fold_norm=int(fold_norm),
        x_bf16=int(x.dtype == torch.bfloat16), eps=eps,
        rms_offset=rms_offset)
    fused_qkv_rope_w8a8.launches += 1
    return out


fused_qkv_rope_w8a8.launches = 0


def _check_fused_shapes(what: str, x: torch.Tensor, qkv_w8: torch.Tensor,
                        head_dim: int, rotary_dim: int) -> None:
    """What the fused CUDA kernels take: x bf16 or float32, int8 weights
    whose rows are 16-byte multiples, a hidden width of 16-byte multiples and
    an even rotary span."""
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 2:
        raise TypeError(f"{what} kernel: x must be a bf16 or float32 matrix")
    if qkv_w8.dtype != torch.int8 or qkv_w8.shape[1] % 16 or x.shape[1] % 16:
        raise ValueError(f"{what} kernel: int8 rows and the hidden width "
                         "must be multiples of 16")
    if qkv_w8.shape[1] < x.shape[1] or (rotary_dim or 0) % 2 \
            or (rotary_dim or 0) > head_dim or head_dim % 2:
        raise ValueError(f"{what} kernel: bad widths (weight "
                         f"{tuple(qkv_w8.shape)}, x {tuple(x.shape)}, "
                         f"rotary_dim {rotary_dim})")


_SPLIT_KEYS = 128      # keys per block of the kernel (csrc/flash_decode.cu)
_TILE_KEYS = 64        # keys per tile of a block
_NEG_BIG = -1e30       # the kernel's masked score


def flash_decode_reference(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos, scale: float
                           ) -> torch.Tensor:
    """Masked full-softmax version in float32: q [B, Hq, d], k/v_cache
    [B, T, Hkv, d], keys t <= pos -> [B, Hq, d] bf16."""
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    qpk = q.shape[1] // Hkv
    kk = torch.repeat_interleave(k_cache.float(), qpk, dim=2)   # [B,T,Hq,d]
    vv = torch.repeat_interleave(v_cache.float(), qpk, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), kk) * scale
    mask = torch.arange(T, device=q.device)[None, None, :] <= pos
    s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bthd->bhd", p, vv).to(torch.bfloat16)


def flash_decode_split_reference(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, pos, scale: float
                                 ) -> torch.Tensor:
    """Plain version with the CUDA kernel's rounding points, against which
    the kernel is held to about one bf16 ulp: keys in spans of 128 and tiles
    of 64; within a span a running max after each tile, p = exp(s - max)
    rounded to bf16 before p . v and the sum l of the unrounded p; the spans
    rescaled to the common max; acc / l rounded to bf16. Shapes as
    :func:`flash_decode_reference`."""
    B, T, Hkv, d = k_cache.shape
    Hq = q.shape[1]
    qpk = Hq // Hkv
    nsplit = -(-T // _SPLIT_KEYS)
    tiles = _SPLIT_KEYS // _TILE_KEYS
    pad = nsplit * _SPLIT_KEYS - T
    kk = torch.repeat_interleave(k_cache.float(), qpk, dim=2)   # [B,T,Hq,d]
    vv = torch.repeat_interleave(v_cache.float(), qpk, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.to(torch.bfloat16).float(), kk) * scale
    valid = torch.arange(T, device=q.device) <= pos
    s = F.pad(torch.where(valid, s, _NEG_BIG), (0, pad), value=_NEG_BIG)
    s = s.view(B, Hq, nsplit, tiles, _TILE_KEYS)
    valid = F.pad(valid, (0, pad), value=False).view(nsplit, tiles, _TILE_KEYS)
    vv = F.pad(vv, (0, 0, 0, 0, 0, pad)).view(B, nsplit, tiles, _TILE_KEYS,
                                               Hq, d)
    m = torch.cummax(s.amax(-1), dim=-1).values      # running max per tile
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    pv = torch.einsum("bhnit,bnithd->bhnid", p.to(torch.bfloat16).float(), vv)
    w = torch.exp(m - m[..., -1:])                   # tile -> span max
    acc = (pv * w[..., None]).sum(3)                 # [B, Hq, nsplit, d]
    l = (p.sum(-1) * w).sum(-1)                      # [B, Hq, nsplit]
    m_span = m[..., -1]
    ws = torch.exp(m_span - m_span.amax(-1, keepdim=True))
    out = (acc * ws[..., None]).sum(2) / torch.clamp(
        (l * ws).sum(-1), min=1e-30)[..., None]
    return out.to(torch.bfloat16)


def flash_decode_split_bound(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, pos: int, scale: float,
                             got: torch.Tensor, split: torch.Tensor
                             ) -> torch.Tensor:
    """Per-element bound [B, Hq, d] on |got - split| for a kernel that rounds
    where :func:`flash_decode_split_reference` does and differs from it only
    in float32 order: one bf16 ulp of the output; one p of the row flipped to
    its next bf16 value (2^-7 of p, at most 2^-7 * max_t p_t |v_t|) where a
    score differs in its last float32 bit; 3e-5 * sum_t p_t |v_t| for
    float32 sums. ``pos`` is a host int."""
    qpk = q.shape[1] // k_cache.shape[2]
    kk = k_cache[:, :pos + 1].float().repeat_interleave(qpk, dim=2)
    vv = v_cache[:, :pos + 1].float().repeat_interleave(qpk, dim=2).abs()
    p = torch.softmax(torch.einsum("bhd,bthd->bht", q.float(), kk) * scale,
                      dim=-1)
    pv_max = (p.permute(0, 2, 1)[..., None] * vv).amax(dim=1)
    pv_sum = torch.einsum("bht,bthd->bhd", p, vv)
    big = torch.maximum(got.float().abs(), split.float().abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return ulp + 2**-7 * pv_max + 3e-5 * pv_sum


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos, scale: float
                           ) -> torch.Tensor:
    """Single-token GQA attention: q [B, Hq, d] (read as bf16), k/v_cache
    [B, T, Hkv, d] bf16 already holding the current token at ``pos``;
    attends keys t <= pos. ``pos`` is a host int or a 0-d int tensor on the
    device (read by the kernel, no host sync). Returns [B, Hq, d] bf16."""
    if q.device.type == "cpu":
        return flash_decode_reference(q, k_cache, v_cache, pos, scale)
    B, Hq, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("flash_decode: k/v caches must be [B, T, Hkv, d]")
    _, T, Hkv, dk = k_cache.shape
    if k_cache.shape[0] != B or dk != d or Hq % Hkv:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not match "
                         f"cache {tuple(k_cache.shape)}")
    qpk = Hq // Hkv
    if d % 8 or d > 128 or qpk > 32:
        raise ValueError(f"flash_decode kernel: needs head_dim % 8 == 0, "
                         f"head_dim <= 128 and at most 32 query heads a kv "
                         f"head, got head_dim={d}, qpk={qpk}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"flash_decode kernel: {name} must be contiguous "
                             "bf16")
        if t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"flash_decode kernel: {name} must be 16-byte "
                             "aligned on q's device")
    qb = q.to(torch.bfloat16).contiguous()
    if qb.data_ptr() % 16:                 # the kernel copies q in 16 bytes
        qb = qb.clone()
    if isinstance(pos, torch.Tensor):
        pos_t = pos.to(device=q.device, dtype=torch.int32).reshape(1)
    else:
        pos_t = torch.full((1,), int(pos), dtype=torch.int32, device=q.device)
    out = torch.empty((B, Hq, d), dtype=torch.bfloat16, device=q.device)
    # one block per span of _SPLIT_KEYS keys; spans' partial softmax state
    nsplit = -(-T // _SPLIT_KEYS)
    part_acc = torch.empty(B * Hq * nsplit * d, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(B * Hq * nsplit * 2, dtype=torch.float32,
                          device=q.device)
    fn = cuda_lib.function(
        "flash_decode", "ganq_flash_decode",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p])
    status = fn(qb.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                pos_t.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
                part_ml.data_ptr(), _arrival_counts(q.device, B * Hkv),
                B, T, Hkv, qpk, d, nsplit, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(status, "flash_decode")
    flash_decode_attention.launches += 1
    return out


_COUNTS = {}


def _arrival_counts(device: torch.device, n: int) -> int:
    """The address of at least ``n`` int32 arrival counters for kernel 2's
    combine on ``device``: zero when made, and the kernel sets each back to
    zero when it is done with it, so calls that do not overlap on the device
    (the port's: one stream at a time) share them."""
    buf = _COUNTS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTS[device] = buf
    return buf.data_ptr()


flash_decode_attention.launches = 0

__all__ = ["flash_decode_attention", "flash_decode_reference",
           "flash_decode_split_reference", "flash_decode_split_bound",
           "fused_qkv_rope_w8a8", "fused_qkv_rope_plain", "rope_tile_operands",
           "expand_rope_tables", "qkv_fusable_tile", "rope_rows", "rms_rows"]
