"""Flash decode attention: one query token per sequence over the KV cache.

The port of ``flash_decode_attention`` / ``flash_decode_reference`` from
``ganq_tpu/ops/fused_attention.py`` (``fused_qkv_rope_w8a8`` comes with the
optimize() kernels in a later slice).

:func:`flash_decode_attention` launches the hand-written CUDA kernel
(``csrc/flash_decode.cu``) for CUDA tensors and runs the plain version,
:func:`flash_decode_reference`, only for CPU tensors.
:func:`flash_decode_split_reference` is a plain version that rounds where
the kernel rounds, to hold the kernel to about one bf16 ulp on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_lib

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
    if d % 8 or d > 128 or qpk * d > 4096:
        raise ValueError(f"flash_decode kernel: needs head_dim % 8 == 0, "
                         f"head_dim <= 128 and qpk*head_dim <= 4096, got "
                         f"head_dim={d}, qpk={qpk}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"flash_decode kernel: {name} must be contiguous "
                             "bf16")
        if t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"flash_decode kernel: {name} must be 16-byte "
                             "aligned on q's device")
    qb = q.to(torch.bfloat16).contiguous()
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
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p])
    status = fn(qb.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                pos_t.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
                part_ml.data_ptr(), B, T, Hkv, qpk, d, nsplit, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(status, "flash_decode")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0

__all__ = ["flash_decode_attention", "flash_decode_reference",
           "flash_decode_split_reference", "flash_decode_split_bound"]
