"""The attention half of a W8A8 decode layer in one call (kernel 11).

The port of ``ganq_tpu/ops/fused_layer.py``: rmsnorm, int8 activations, the
fused int8 qkv product, bias and rope (kernel 10's work), flash GQA attention
over the cache history below ``pos`` with the current token's k/v folded in
last, the per-row int8 quantization of the attention output (one scale per
batch row across all heads, starting from 1e-12, the max taken before the
division by 127), the int8 o product against the transposed o weight
``o_t_w8 [Dq, H]`` and the residual. Batch rows <= 8.

The flash walk has the TPU kernel's rounding points (:func:`flash_rows`):
keys in blocks of Tb (256, halved until it divides the cache length), a
running max updated once per block, p = exp(s - m) rounded to bf16 before
p . v and summed unrounded into l, masked scores -1e30, blocks at or past
``pos`` neither read nor computed, the current token folded in last.

:func:`attn_half_decode_w8a8` launches ``csrc/w8a8_fused.cu``
(``ganq_attn_half``) for CUDA tensors and runs :func:`attn_half_plain`, its
plain version, only for CPU tensors. ``.launches`` counts kernel calls.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .fused_attention import (_check_fused_shapes, _f32, _int_dot,
                              fused_qkv_rope_plain, qkv_fusable_tile)
from .uniform_matmul import _aligned

_NEG_BIG = -1e30


def flash_block(T: int, block_t: int = 256) -> int:
    """The flash walk's key block of kernels 11 and 12: ``block_t``, at most
    T, halved until it divides T."""
    Tb = min(block_t, T)
    while T % Tb:
        Tb //= 2
    return Tb


def flash_rows(q: torch.Tensor, k_hist: torch.Tensor, v_hist: torch.Tensor,
               k_cur: torch.Tensor, v_cur: torch.Tensor, pos,
               scale: float, Tb: int) -> torch.Tensor:
    """Flash GQA attention of one query token per row with the TPU kernels'
    rounding points. q [B, Hq, d] bf16; k/v_hist [B, Hkv, T, d] (history
    below ``pos``, an int or one length per row; later keys are never read,
    and blocks past a row's history leave it as it is); k/v_cur [B, Hkv, d]
    bf16, the current token, folded in last. Returns acc / l, float32
    [B, Hq, d]."""
    B, Hq, d = q.shape
    Hkv = k_hist.shape[1]
    qpk = Hq // Hkv
    qf = q.to(torch.bfloat16).to(torch.float32).reshape(B, Hkv, qpk, d)
    m = torch.full((B, Hkv, qpk), _NEG_BIG, device=q.device)
    l = torch.zeros((B, Hkv, qpk), device=q.device)
    acc = torch.zeros((B, Hkv, qpk, d), device=q.device)

    def fold(s, v):                         # s [B, Hkv, qpk, n], v [B, Hkv, n, d]
        nonlocal m, l, acc
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bgqt,bgtd->bgqd",
                          p.to(torch.bfloat16).to(torch.float32), v)
        acc = acc * alpha[..., None] + pv
        m = m_new

    rows = [int(p) for p in torch.as_tensor(pos).reshape(-1)]
    lens = torch.tensor(rows, device=q.device).reshape(-1, 1, 1, 1)
    for t0 in range(0, max(rows), Tb):
        kb = k_hist[:, :, t0:t0 + Tb].to(torch.float32)
        vb = v_hist[:, :, t0:t0 + Tb].to(torch.float32)
        s = torch.einsum("bgqd,bgtd->bgqt", qf, kb) * scale
        valid = torch.arange(t0, t0 + kb.shape[2], device=q.device) < lens
        fold(torch.where(valid, s, _NEG_BIG), vb)
    kc = k_cur.to(torch.bfloat16).to(torch.float32)
    s_c = (qf * kc[:, :, None, :]).sum(-1, keepdim=True) * scale
    fold(s_c, v_cur.to(torch.bfloat16).to(torch.float32)[:, :, None, :])
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Hq, d)


def attn_out_int8(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention output's int8 rows: a [B, Dq] float32 -> (a8 as float32
    integers, sa [B, 1]) with ``sa = max(1e-12, max|a|) / 127`` (one scale
    per batch row across all heads)."""
    amax = torch.clamp(torch.amax(torch.abs(a), dim=1, keepdim=True), min=1e-12)
    sa = amax / torch.full_like(amax, 127.0)
    return torch.clamp(torch.round(a / sa), -127, 127), sa


def attn_half_plain(x: torch.Tensor, norm_w: Optional[torch.Tensor],
                    qkv_w8: torch.Tensor, qkv_scale: torch.Tensor,
                    qkv_bias: Optional[torch.Tensor], o_w8t: torch.Tensor,
                    o_scale_row: torch.Tensor,
                    cos_half: Optional[torch.Tensor],
                    sin_half: Optional[torch.Tensor], k_cache: torch.Tensor,
                    v_cache: torch.Tensor, pos, *, q_dim: int, kv_dim: int,
                    head_dim: int, rotary_dim: int = 0,
                    interleaved: bool = False, eps: float = 1e-5,
                    rms_offset: float = 0.0, scale: float = 1.0,
                    fold_norm: bool = True, block_t: int = 256):
    """Plain version of kernel 11, with the kernel's arithmetic. Shapes as
    :func:`attn_half_decode_w8a8`."""
    B, H = x.shape
    d = head_dim
    Hq, Hkv = q_dim // d, kv_dim // d
    qkv = fused_qkv_rope_plain(x, norm_w, qkv_w8, qkv_scale, qkv_bias,
                               cos_half, sin_half, q_dim, kv_dim, d,
                               rotary_dim, interleaved, eps, rms_offset,
                               fold_norm)
    q = qkv[:, :q_dim].reshape(B, Hq, d)
    kn = qkv[:, q_dim:q_dim + kv_dim].reshape(B, Hkv, d)
    vn = qkv[:, q_dim + kv_dim:].reshape(B, Hkv, d)
    T = k_cache.shape[1]
    a = flash_rows(q, k_cache.transpose(1, 2), v_cache.transpose(1, 2), kn,
                   vn, int(pos), scale, flash_block(T, block_t))
    a8, sa = attn_out_int8(a.reshape(B, q_dim))
    o = (_int_dot(a8, o_w8t[:q_dim].T) * sa) * o_scale_row.to(
        torch.float32).reshape(1, -1)
    y = (x.to(torch.float32) + o).to(x.dtype)
    return y, kn, vn


def attn_half_fusable(cfg, lp) -> bool:
    """The JAX package's gate of kernel 11 (``fused_layer.py:365``) for the
    port's llama layers: a fused ``w8`` qkv and the transposed o weight, no
    bias on o, head_dim 128 and a 128-multiple hidden width, and a qkv row
    tile (the architecture conditions of the JAX gate hold for every llama
    layer the port builds)."""
    attn = lp.attn
    qkv = attn["qkv"] if "qkv" in attn else None
    if qkv is None or getattr(lp, "o_t_w8", None) is None or qkv.kind != "w8":
        return False
    if "bias" in attn["o"]:
        return False
    if cfg.head_dim != 128 or cfg.hidden_size % 128:
        return False
    kvd = (qkv["w8"].shape[0] - cfg.q_dim) // 2
    return qkv_fusable_tile(cfg.q_dim, kvd, cfg.head_dim) is not None


def attn_half_decode_w8a8(x: torch.Tensor, norm_w: Optional[torch.Tensor],
                          qkv_w8: torch.Tensor, qkv_scale: torch.Tensor,
                          qkv_bias: Optional[torch.Tensor],
                          o_w8t: torch.Tensor, o_scale_row: torch.Tensor,
                          cos_half: Optional[torch.Tensor],
                          sin_half: Optional[torch.Tensor],
                          k_cache: torch.Tensor, v_cache: torch.Tensor, pos, *,
                          q_dim: int, kv_dim: int, head_dim: int,
                          rotary_dim: int = 0, interleaved: bool = False,
                          eps: float = 1e-5, rms_offset: float = 0.0,
                          scale: float = 1.0, fold_norm: bool = True,
                          block_t: int = 256):
    """Kernel 11, one decode step's attention half for one layer. x [B, H]
    (B <= 8); qkv_w8 [Dqkv, H'] int8 + scale [Dqkv, 1]; o_w8t [Dq', H] int8
    (the o weight transposed) + o_scale_row [1, H]; k/v_cache [B, T, Hkv, d]
    bf16 holding the history below ``pos`` (a host int or a 0-d device
    tensor, read by the kernel). Returns (y [B, H] with the residual, k_new
    [B, Hkv, d], v_new [B, Hkv, d]) bf16 k/v."""
    B, H = x.shape
    if B > 8:
        raise ValueError("attn_half_decode_w8a8: B <= 8; larger batches use "
                         "the per-linear path")
    if x.device.type == "cpu":
        return attn_half_plain(x, norm_w, qkv_w8, qkv_scale, qkv_bias, o_w8t,
                               o_scale_row, cos_half, sin_half, k_cache,
                               v_cache, pos, q_dim=q_dim, kv_dim=kv_dim,
                               head_dim=head_dim, rotary_dim=rotary_dim,
                               interleaved=interleaved, eps=eps,
                               rms_offset=rms_offset, scale=scale,
                               fold_norm=fold_norm, block_t=block_t)
    from .w8a8_args import launch

    d = head_dim
    Hkv = kv_dim // d
    _check_fused_shapes("attn_half_decode", x, qkv_w8, d, rotary_dim)
    if d != 128 or q_dim % d or kv_dim % d or (q_dim // d) % Hkv:
        raise ValueError("attn_half_decode kernel: head_dim 128 and whole "
                         "GQA groups")
    _, T, Hc, dc = k_cache.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B or Hc != Hkv
            or dc != d or k_cache.dtype != torch.bfloat16
            or not k_cache.is_contiguous() or not v_cache.is_contiguous()):
        raise ValueError("attn_half_decode kernel: contiguous bf16 caches "
                         "[B, T, Hkv, d]")
    if o_w8t.dtype != torch.int8 or o_w8t.shape[1] != H or o_w8t.shape[0] < q_dim:
        raise ValueError("attn_half_decode kernel: o_w8t [Dq, H] int8")
    dev = x.device
    pos_t = (pos.to(device=dev, dtype=torch.int32).reshape(1)
             if isinstance(pos, torch.Tensor)
             else torch.full((1,), int(pos), dtype=torch.int32, device=dev))
    Dqkv = q_dim + 2 * kv_dim
    y = torch.empty((B, H), dtype=x.dtype, device=dev)
    kn = torch.empty((B, kv_dim), dtype=torch.bfloat16, device=dev)
    vn = torch.empty((B, kv_dim), dtype=torch.bfloat16, device=dev)
    launch("w8a8_fused", "ganq_attn_half", "attn_half_decode_w8a8", dict(
        x=_aligned(x), attn_norm=_f32(norm_w) if fold_norm else None,
        qkv_w8=_aligned(qkv_w8), qkv_scale=_f32(qkv_scale),
        qkv_bias=_f32(qkv_bias), cos_half=_f32(cos_half),
        sin_half=_f32(sin_half), k_cache=k_cache, v_cache=v_cache, pos=pos_t,
        o_t_w8=_aligned(o_w8t), o_t_scale=_f32(o_scale_row), y=y, kn=kn,
        vn=vn,
        qkv_out=torch.empty((B, Dqkv), dtype=torch.bfloat16, device=dev),
        x8=torch.empty((B, H), dtype=torch.int8, device=dev),
        sx=torch.empty((B,), dtype=torch.float32, device=dev),
        attn=torch.empty((B, q_dim), dtype=torch.float32, device=dev),
        attn_amax=torch.empty((B * Hkv,), dtype=torch.float32, device=dev),
        o32=torch.empty((B, H), dtype=torch.int32, device=dev)), dev,
        B=B, H=H, Kx=H, q_dim=q_dim, kv_dim=kv_dim, d=d, rd=rotary_dim or 0,
        interleaved=int(interleaved), qkv_ld=qkv_w8.shape[1],
        o_rows=o_w8t.shape[0], T=T, Tb=flash_block(T, block_t), L=1,
        fold_norm=int(fold_norm), x_bf16=int(x.dtype == torch.bfloat16),
        eps=eps, rms_offset=rms_offset, scale=scale,
        cache_sb=T * Hkv * d, cache_sg=d, cache_st=Hkv * d, cache_sl=0)
    attn_half_decode_w8a8.launches += 1
    return y, kn.reshape(B, Hkv, d), vn.reshape(B, Hkv, d)


attn_half_decode_w8a8.launches = 0

__all__ = ["attn_half_decode_w8a8", "attn_half_plain", "attn_half_fusable",
           "flash_rows", "flash_block", "attn_out_int8"]
