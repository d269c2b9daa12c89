"""Whole decode step over all layers in one launch, W8A8 (kernel 12).

The port of ``ganq_tpu/ops/megastep.py``. One call runs every layer of a
homogeneous llama-family ``w8`` model for one decode token: per layer the
attention norm and int8 activations, the fused qkv product with bias and
rope, flash GQA attention over the cache history below ``pos`` with the
current token folded in last, the int8 o product and residual, the MLP norm
and int8 activations, gate/up, activation, per-tile int8 activations and the
down product summed in tile order. The residual stays float32 across all
layers and is rounded to x's type only after the last one, as in the TPU
kernel (its JAX oracle ``megastep_reference`` rounds to bf16 after every
layer instead). The MLP tile is 1024 halved until it divides I
(:func:`megastep_tile`), not kernel 9's rule.

Operands come from :func:`megapack`, stacked with a leading layer axis:
``down_t [L, I, H]`` is K-major and ``o_t_w8 [L, Dq, H]`` transposed, as
the JAX package packs them. The cache is in the megastep layout
``[L, B * Hkv, T, d]``.

:func:`megastep_decode_w8a8` launches ``csrc/megastep_w8.cu``
(``ganq_megastep_w8``, one cooperative launch) for CUDA tensors and runs
:func:`megastep_plain`, its plain version, only for CPU tensors.
``.launches`` counts kernel calls.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from .fused_attention import (_f32, _int_dot, fused_qkv_rope_plain,
                              qkv_fusable_tile, rms_rows)
from .fused_layer import attn_out_int8, flash_block, flash_rows
from .fused_mlp import mlp_tiles
from .uniform_matmul import _aligned, quantize_rows
from .w8a8_args import ACT_CODES


def megastep_tile(I: int, block_i: int = 1024) -> int:
    """The MLP activation tile of kernel 12 (``megastep.py:287-290``):
    ``block_i`` halved until it divides I."""
    ti = block_i
    while I % ti:
        ti //= 2
    return ti


def megapack(cfg, sp) -> Dict[str, torch.Tensor]:
    """The megastep's stacked operands from a stacked model (fused ``qkv``
    and ``gateup`` ``w8`` linears and the transposed o, as
    ``serve/stacked.stack_layers`` builds them): the JAX package's keys,
    shapes and types."""
    layers = list(sp.layers)
    L = len(layers)
    H = cfg.hidden_size

    def stack(f):
        return torch.stack([f(lp) for lp in layers])

    qkv0 = layers[0].attn["qkv"]
    Dqkv = qkv0["w8"].shape[0]
    I = layers[0].mlp["gateup"]["w8"].shape[0] // 2
    dev = qkv0["w8"].device

    def bias(lp):
        qkv = lp.attn["qkv"]
        return (qkv["bias"].to(torch.float32) if "bias" in qkv
                else torch.zeros(Dqkv, device=dev))

    return {
        "attn_norm": stack(lambda lp: lp.input_norm.weight.to(
            torch.float32).reshape(1, H)),
        "mlp_norm": stack(lambda lp: lp.post_norm.weight.to(
            torch.float32).reshape(1, H)),
        "qkv_w8": stack(lambda lp: lp.attn["qkv"]["w8"]),
        "qkv_scale": stack(lambda lp: lp.attn["qkv"]["scale"].to(
            torch.float32).reshape(Dqkv, 1)),
        "qkv_bias": stack(lambda lp: bias(lp).reshape(1, Dqkv)),
        "o_t_w8": stack(lambda lp: lp.o_t_w8),
        "o_t_scale": stack(lambda lp: lp.o_t_scale.to(
            torch.float32).reshape(1, H)),
        "gateup_w8": stack(lambda lp: lp.mlp["gateup"]["w8"][:, :H]),
        "gateup_scale": stack(lambda lp: lp.mlp["gateup"]["scale"].to(
            torch.float32).reshape(2 * I, 1)),
        # down K-major: [H, Ip] -> [I, H]
        "down_t": stack(lambda lp: lp.mlp["down"]["w8"][:, :I].T.contiguous()),
        "down_scale": stack(lambda lp: lp.mlp["down"]["scale"].to(
            torch.float32).reshape(1, H)),
    }


def megastep_fusable(cfg, sp) -> bool:
    """The JAX gate of kernel 12 (``megastep.py:442``) on the port's stacked
    model: fused ``w8`` qkv, gateup and down with the transposed o, no EoRA
    adapter on them, no bias on gateup or down, head_dim 128, a
    128-multiple hidden width, no qk-norm, gateup unpadded, and a qkv row
    tile, and none of gemma's sandwich norms, attention softcap, sliding
    windows or dual rope. The JAX gate's other architecture conditions
    (rope, pre-norm rmsnorm, gated MLP, no MoE, ...) hold for every model
    the port builds."""
    if sp is None or not len(sp.layers):
        return False
    lp = sp.layers[0]
    qkv = lp.attn["qkv"] if "qkv" in lp.attn else None
    gu = lp.mlp["gateup"] if "gateup" in lp.mlp else None
    dn = lp.mlp["down"] if "down" in lp.mlp else None
    if qkv is None or gu is None or dn is None \
            or getattr(lp, "o_t_w8", None) is None:
        return False
    if any(m.kind != "w8" for m in (qkv, gu, dn)):
        return False
    if any("lora_a" in m for m in (qkv, gu, dn)):
        return False
    if "bias" in dn or "bias" in gu:
        return False
    if cfg.head_dim != 128 or cfg.hidden_size % 128 or cfg.qk_norm:
        return False
    if (cfg.sandwich_norm or cfg.attn_softcap is not None
            or cfg.sliding_window is not None
            or cfg.rope_local_theta is not None):
        return False
    if gu["w8"].shape[1] != cfg.hidden_size:
        return False
    kvd = (qkv["w8"].shape[0] - cfg.q_dim) // 2
    return qkv_fusable_tile(cfg.q_dim, kvd, cfg.head_dim) is not None


def megastep_plain(x: torch.Tensor, mp: Dict[str, torch.Tensor],
                   k_cache: torch.Tensor, v_cache: torch.Tensor, pos,
                   cos_half: Optional[torch.Tensor],
                   sin_half: Optional[torch.Tensor], *, q_dim: int,
                   kv_dim: int, head_dim: int, rotary_dim: int = 0,
                   interleaved: bool = False, eps: float = 1e-5,
                   rms_offset: float = 0.0, scale: float = 1.0,
                   act: str = "silu", block_t: int = 256,
                   block_i: int = 1024):
    """Plain version of kernel 12, with the kernel's arithmetic (the float32
    residual across layers). Shapes as :func:`megastep_decode_w8a8`."""
    B, H = x.shape
    L = mp["qkv_w8"].shape[0]
    d = head_dim
    Hq, Hkv = q_dim // d, kv_dim // d
    T = k_cache.shape[2]
    I = mp["down_t"].shape[1]
    ti = megastep_tile(I, block_i)
    Tb = flash_block(T, block_t)
    pos = int(pos)
    xs = x.to(torch.float32)
    kns, vns = [], []
    for li in range(L):
        qkv = fused_qkv_rope_plain(
            xs, mp["attn_norm"][li, 0], mp["qkv_w8"][li], mp["qkv_scale"][li],
            mp["qkv_bias"][li, 0], cos_half, sin_half, q_dim, kv_dim, d,
            rotary_dim, interleaved, eps, rms_offset, True)
        kn = qkv[:, q_dim:q_dim + kv_dim]
        vn = qkv[:, q_dim + kv_dim:]
        kns.append(kn)
        vns.append(vn)
        a = flash_rows(qkv[:, :q_dim].reshape(B, Hq, d),
                       k_cache[li].reshape(B, Hkv, T, d),
                       v_cache[li].reshape(B, Hkv, T, d),
                       kn.reshape(B, Hkv, d), vn.reshape(B, Hkv, d), pos,
                       scale, Tb)
        a8, sa = attn_out_int8(a.reshape(B, q_dim))
        xs = xs + (_int_dot(a8, mp["o_t_w8"][li][:q_dim].T) * sa) \
            * mp["o_t_scale"][li]
        x8, sx = quantize_rows(rms_rows(xs, mp["mlp_norm"][li, 0], eps,
                                        rms_offset))
        ma = mlp_tiles(x8, sx, mp["gateup_w8"][li], mp["gateup_scale"][li],
                       mp["down_t"][li], ti, act, down_k_major=True)
        xs = xs + ma * mp["down_scale"][li]
    return xs.to(x.dtype), torch.stack(kns), torch.stack(vns)


def megastep_decode_w8a8(x: torch.Tensor, mp: Dict[str, torch.Tensor],
                         k_cache: torch.Tensor, v_cache: torch.Tensor, pos,
                         cos_half: Optional[torch.Tensor],
                         sin_half: Optional[torch.Tensor], *, q_dim: int,
                         kv_dim: int, head_dim: int, rotary_dim: int = 0,
                         interleaved: bool = False, eps: float = 1e-5,
                         rms_offset: float = 0.0, scale: float = 1.0,
                         act: str = "silu", block_t: int = 256,
                         block_i: int = 1024):
    """Kernel 12, one decode step over all layers. x [B, H] (B <= 8, the
    embedded current token); ``mp`` from :func:`megapack`; k/v_cache
    [L, B * Hkv, T, d] bf16 (history below ``pos``, a host int or a 0-d
    device tensor); cos/sin_half [rotary_dim // 2] at ``pos``. Returns
    (y [B, H], the hidden state before the final norm, in x's type; k_new
    and v_new [L, B, kv_dim] bf16)."""
    B, H = x.shape
    if B > 8:
        raise ValueError("megastep_decode_w8a8: B <= 8")
    if x.device.type == "cpu":
        return megastep_plain(x, mp, k_cache, v_cache, pos, cos_half,
                              sin_half, q_dim=q_dim, kv_dim=kv_dim,
                              head_dim=head_dim, rotary_dim=rotary_dim,
                              interleaved=interleaved, eps=eps,
                              rms_offset=rms_offset, scale=scale, act=act,
                              block_t=block_t, block_i=block_i)
    from .w8a8_args import launch

    L, Dqkv, qkv_ld = mp["qkv_w8"].shape
    d = head_dim
    Hkv = kv_dim // d
    I = mp["down_t"].shape[1]
    T = k_cache.shape[2]
    if (x.dtype not in (torch.bfloat16, torch.float32) or d != 128
            or Dqkv != q_dim + 2 * kv_dim or (q_dim // d) % Hkv
            or H % 16 or qkv_ld % 16 or (rotary_dim or 0) % 2):
        raise ValueError("megastep kernel: bf16/f32 x, head_dim 128, whole "
                         "GQA groups and 16-byte rows")
    if (k_cache.shape != (L, B * Hkv, T, d) or v_cache.shape != k_cache.shape
            or k_cache.dtype != torch.bfloat16
            or not k_cache.is_contiguous() or not v_cache.is_contiguous()):
        raise ValueError("megastep kernel: contiguous bf16 caches "
                         "[L, B * Hkv, T, d]")
    for k in ("qkv_w8", "o_t_w8", "gateup_w8", "down_t"):
        if mp[k].dtype != torch.int8 or not mp[k].is_contiguous():
            raise ValueError(f"megastep kernel: {k} must be contiguous int8")
    dev = x.device
    ti = megastep_tile(I, block_i)
    ng = I // ti
    pos_t = (pos.to(device=dev, dtype=torch.int32).reshape(1)
             if isinstance(pos, torch.Tensor)
             else torch.full((1,), int(pos), dtype=torch.int32, device=dev))
    y = torch.empty((B, H), dtype=x.dtype, device=dev)
    kn = torch.empty((L, B, kv_dim), dtype=torch.bfloat16, device=dev)
    vn = torch.empty((L, B, kv_dim), dtype=torch.bfloat16, device=dev)

    scratch = functools.partial(torch.empty, device=dev)
    launch("megastep_w8", "ganq_megastep_w8", "megastep_decode_w8a8", dict(
        x=_aligned(x), attn_norm=mp["attn_norm"], mlp_norm=mp["mlp_norm"],
        qkv_w8=mp["qkv_w8"], qkv_scale=mp["qkv_scale"],
        qkv_bias=mp["qkv_bias"], cos_half=_f32(cos_half),
        sin_half=_f32(sin_half), k_cache=k_cache, v_cache=v_cache, pos=pos_t,
        o_t_w8=mp["o_t_w8"], o_t_scale=mp["o_t_scale"],
        gateup_w8=mp["gateup_w8"], gateup_scale=mp["gateup_scale"],
        down_w8=mp["down_t"], down_scale=mp["down_scale"], y=y, kn=kn, vn=vn,
        qkv_out=scratch((B, Dqkv), dtype=torch.bfloat16),
        x8=scratch((B, H), dtype=torch.int8),
        sx=scratch((B,), dtype=torch.float32),
        xs=scratch((B, H), dtype=torch.float32),
        act_a=scratch((B, I), dtype=torch.float32),
        amax=scratch((B, ng), dtype=torch.int32),
        attn=scratch((B, q_dim), dtype=torch.float32),
        attn_amax=scratch((B * Hkv,), dtype=torch.float32),
        o32=scratch((B, H), dtype=torch.int32),
        part=scratch((ng, B, H), dtype=torch.int32)), dev,
        B=B, H=H, Kx=H, q_dim=q_dim, kv_dim=kv_dim, d=d,
        rd=rotary_dim or 0, interleaved=int(interleaved), qkv_ld=qkv_ld,
        o_rows=mp["o_t_w8"].shape[1], I=I, ti=ti, down_ld=H, T=T,
        Tb=flash_block(T, block_t), L=L, fold_norm=1, act=ACT_CODES[act],
        x_bf16=int(x.dtype == torch.bfloat16), eps=eps,
        rms_offset=rms_offset, scale=scale, cache_sb=Hkv * T * d,
        cache_sg=T * d, cache_st=d, cache_sl=B * Hkv * T * d)
    megastep_decode_w8a8.launches += 1
    return y, kn, vn


megastep_decode_w8a8.launches = 0

__all__ = ["megastep_decode_w8a8", "megastep_plain", "megapack",
           "megastep_fusable", "megastep_tile"]
