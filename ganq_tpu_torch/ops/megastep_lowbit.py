"""Whole decode step over all layers in one launch, plane-packed uniform
weights or 3-bit codebooks (kernel 14), and the gates of its variants.

The port of ``ganq_tpu/ops/megastep_lowbit.py``. ``ganq_tpu`` serves
homogeneous uniform W4/W3/W2/W8 models ("w4p", "w3", "w2", "w8p") and true
8-entry 3-bit codebooks ("wl8", the Walsh plane expansion) at decode batch
<= 64 through ``megastep_lowbit_decode``; so does the port, with zero
points and act-order (uniform variants), EoRA adapters, qwen3's per-head
qk-norm, o/gate-up/down biases and gemma's sandwich norms, sliding windows,
attention softcap and dual rope (every variant):
:func:`megapack_lowbit` packs the JAX package's planes (keys, shapes and
bytes), zero-point corrections and adapter factors, :func:`megapack_walsh`
a ``lut`` model's 3 stored bit planes and its float32 Walsh coefficient
rows (:func:`walsh_coef`), :func:`actorder_transform` bakes act-order
artifacts into a pack-only copy and gives the column orders of the
activations, and :func:`megastep_lowbit_decode` launches the kernel
(:func:`kernel_library` names its source: ``csrc/megastep_lowbit.cu``,
``ganq_megastep_lowbit``, one cooperative launch, for "w4p"/"w8p" packs
without optional operands; with zero points or act-order
``csrc/megastep_lowbit_opt.cu``, with the lm fold
``csrc/megastep_lowbit_lm.cu`` and ``megastep_lowbit_lm_opt.cu``, with
EoRA adapters ``csrc/megastep_lowbit_lora*.cu``, with the qk-norm rows or
biases ``csrc/megastep_lowbit_arch*.cu``, with gemma's operands
``csrc/megastep_lowbit_gemma.cu``; "w3"/"w2" ``csrc/megastep_lowbit_w3w2.cu``
and, with any optional operand, ``megastep_lowbit_w3w2_ext.cu``; "wl8"
``csrc/megastep_lowbit_walsh.cu``) for CUDA tensors and runs
:func:`megastep_lowbit_plain` only for CPU tensors; ``.launches`` counts
kernel calls. With ``lm`` (:func:`mega_lm_operands`) the step also folds
the final norm and a ``w8`` lm_head in (the trailing-unembed fold,
:func:`lm_fold_plain`) and returns the logits.

The arithmetic of the uniform variants is kernel 13's
(``ops/megastep4.grouped_step_plain``): each product sums, over its groups
in order, the group's bf16 scale times the exact int32 dot of the int8
activations with the centred codes ``q - 2^(bits-1)`` (plus, with zero
points, the group's correction ``sz`` times its activation sum,
``megastep_lowbit.py:479-494``). "wl8" replaces the group walk by the
Walsh walk (``megastep_lowbit.py:441-477``, :func:`walsh_linear`): the
activation sum ``S`` and the 7 monomial dots ``z_j = x8 . m_j(q)``, exact
integers over the walk's whole column range (a qkv or gate/up tile: H
columns; o: q_dim; a down tile: ti), then ``c0 S + c1 z1 + ... + c7 z7``
in float32 in that order with the row's coefficients. Two things differ
from kernel 13: rope reads its partner lane in float32 (the TPU kernel
rotates by lane rolls, ``_rope_rot``), and the MLP tile comes from
:func:`_mlp_plan` (4096 for w4p and 2048 for w8p at Llama-3.2-3B widths).
The flash block Tb follows the JAX wrapper's plan, which may halve it where
the TPU's VMEM estimate is exceeded (:func:`megastep_lowbit_plan`).

The gates (:func:`megastep_lowbit_fusable`, :func:`megastep_walsh_fusable`)
and the plans and tile rules they read are copies, so that
``serve/stacked.mega_enabled`` routes a request exactly as the JAX package
does.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch

from .megastep4 import (_codes, _dn_layout, _gu_layout, _scales_t,
                        _uniform_mats, common_pack_ops, grouped_step_plain,
                        out_rows)
from .fused_attention import rms_rows
from .packing import pack_factor, pack_int_rows, unpack_int_rows
from .uniform_matmul import quantize_rows

# field plans: per plane, (row_block, src_shift, width) high bits -> low
# (megastep_lowbit.py:69)
_PLAN = {
    4: (((0, 0, 4), (1, 0, 4)),),
    3: (((0, 0, 3), (1, 0, 3), (2, 1, 2)),
        ((2, 0, 1), (3, 0, 3), (4, 0, 3), (5, 2, 1)),
        ((5, 0, 2), (6, 0, 3), (7, 0, 3))),
    2: (((0, 0, 2), (1, 0, 2), (2, 0, 2), (3, 0, 2)),),
    8: (((0, 0, 8),),),
}


def _plan_meta(bits: int):
    """(metas, coef, nd, g_r) of a plan (``megastep_lowbit.py:126``): per
    plane the fields (row, shift, width, bitpos), the per-row-block
    coefficient of the sign offsets, the derived-matrix count, and the rows
    per plane group."""
    plan = _PLAN[bits]
    metas = []
    nd = 0
    for segs in plan:
        pos = 8
        fields = []
        for (row, shift, w) in segs:
            pos -= w
            fields.append((row, shift, w, pos))
        assert pos == 0, "plan fields must fill the byte"
        metas.append(tuple(fields))
        nd += len(segs)
    g_r = max(r for segs in plan for (r, _, _) in segs) + 1
    coef = [-(1 << (bits - 1))] * g_r
    for segs in plan:
        row0, shift0, w0 = segs[0]
        coef[row0] += 1 << (shift0 + w0 - 1)
    return tuple(metas), tuple(coef), nd, g_r


def _walsh_csz(H: int, q_dim: int, ti: int) -> int:
    for c in (512, 256, 128):
        if H % c == 0 and q_dim % c == 0 and ti % c == 0:
            return c
    return 0


def _qkv_tile_lb(Dqkv: int, d: int, g_r: int) -> Optional[int]:
    for cand in (4096, 3072, 2560, 2048, 1280, 1024, 512):
        if (Dqkv % cand == 0 and cand % d == 0
                and (cand // g_r) % 128 == 0):
            return cand
    return None


def _mlp_tile_lb(I: int, g_r: int) -> Optional[int]:
    ti = 2048
    while ti >= 128 and (I % ti or (ti // g_r) % 128):
        ti //= 2
    return ti if ti >= 128 else None


def _mlp_plan(I: int, bits: int, H: int, cap: int = 48 * 1024 * 1024) -> tuple:
    """(ti, ptg) of the plane kernel's MLP walk (``megastep_lowbit.py:305``)."""
    metas, _, _, g_r = _plan_meta(bits)
    npl = len(metas)
    unit = 6 * npl * H // g_r
    best = None
    for ti0 in range(256, min(I, 4096) + 1, 128):
        if I % ti0 or (ti0 // g_r) % 128:
            continue
        ng = I // ti0
        ptg = 0
        for c in range(ng, 0, -1):
            if ng % c == 0 and c * ti0 * unit <= cap:
                ptg = c
                break
        if not ptg:
            continue
        key = (ptg * ti0, ti0)
        if best is None or key > best[0]:
            best = (key, ti0, ptg)
    if best is None:
        return _mlp_tile_lb(I, g_r), 1
    return best[1], best[2]


def _arch_fusable_common(cfg, sp) -> bool:
    """The architecture surface of the plane kernels
    (``megastep_lowbit.py:1905``) for the port's llama-family and gemma
    models: head_dim 128, a qk-norm only per head (True or "head") with q
    and k norm weights of width head_dim, and sandwich norms only where the
    layers carry both weights (gemma's softcap, windows and dual rope ride
    the kernel; the remaining conditions hold for every model the port
    builds)."""
    if cfg.head_dim != 128:
        return False
    if cfg.sandwich_norm and sp.layers[0].post_attn_norm is None:
        return False
    if cfg.qk_norm:
        if cfg.qk_norm not in (True, "head"):
            return False
        lp = sp.layers[0]
        if lp.q_norm is None or lp.k_norm is None:
            return False
        if (lp.q_norm.shape[-1] != cfg.head_dim
                or lp.k_norm.shape[-1] != cfg.head_dim):
            return False
    return True


def _fused(sp):
    if sp is None or not len(sp.layers):
        return None
    lp = sp.layers[0]
    got = tuple(g[n] if n in g else None for g, n in (
        (lp.attn, "qkv"), (lp.attn, "o"), (lp.mlp, "gateup"),
        (lp.mlp, "down")))
    return None if any(m is None for m in got) else got


def megastep_walsh_fusable(cfg, sp) -> bool:
    """The JAX gate of the Walsh LUT variant ("wl8",
    ``megastep_lowbit.py:1824``): all four projections 3-bit ``lut`` with
    8-entry codebooks and exact-width packs, EoRA adapters on all four or on
    none, lane-aligned field blocks and tiles."""
    mats = _fused(sp)
    if mats is None:
        return False
    qkv, o, gu, dn = mats
    if any(m.kind != "lut" or m.bits != 3 for m in mats):
        return False
    if any(m["lut"].shape[-1] != 8 for m in mats):
        return False
    if sum("lora_a" in m for m in mats) not in (0, 4):
        return False
    for m in mats:
        if m["idx_packed"].shape[-1] * pack_factor(3) != m.in_features:
            return False
    if not _arch_fusable_common(cfg, sp):
        return False
    H = cfg.hidden_size
    if H % 8 or (H // 8) % 128:
        return False
    Dqkv = qkv["lut"].shape[0]
    kvd = (Dqkv - cfg.q_dim) // 2
    if cfg.q_dim + 2 * kvd != Dqkv or kvd % cfg.head_dim:
        return False
    I = gu["lut"].shape[0] // 2
    ti = _mlp_plan(I, 3, H)[0]
    if ti is None or _qkv_tile_lb(Dqkv, cfg.head_dim, 8) is None:
        return False
    return _walsh_csz(H, cfg.q_dim, ti) != 0


def megastep_lowbit_fusable(cfg, sp, bits: int) -> bool:
    """The JAX gate of the plane variants (``megastep_lowbit.py:1946``):
    all four projections ``uniform`` at ``bits``, EoRA adapters on all four
    or on none, act-order only at power-of-two widths, zeros laid out as
    the scales, one 128-multiple group size, lane-aligned field blocks and
    tiles."""
    if bits not in _PLAN:
        return False
    _, _, _, g_r = _plan_meta(bits)
    mats = _fused(sp)
    if mats is None:
        return False
    qkv, o, gu, dn = mats
    if any(m.kind != "uniform" or m.bits != bits for m in mats):
        return False
    # EoRA adapters: all four projections, or none (a partial set is
    # served per layer)
    if sum("lora_a" in m for m in mats) not in (0, 4):
        return False

    def _pow2(v):
        return v & (v - 1) == 0

    if ("g_idx" in qkv or "g_idx" in gu) and not _pow2(cfg.hidden_size):
        return False
    if "g_idx" in o and not _pow2(cfg.q_dim):
        return False
    gss = set()
    for m in mats:
        if "zeros" in m and m["zeros"].shape != m["scales"].shape:
            return False
        gs = m.in_features // m["scales"].shape[-1]
        if gs % 128 or m.in_features % gs:
            return False
        gss.add(gs)
    if len(gss) != 1:
        return False
    if cfg.hidden_size % (g_r * 128):
        return False
    if not _arch_fusable_common(cfg, sp):
        return False
    Dqkv = qkv["scales"].shape[0]
    kvd = (Dqkv - cfg.q_dim) // 2
    if cfg.q_dim + 2 * kvd != Dqkv or kvd % cfg.head_dim:
        return False
    I = gu["scales"].shape[0] // 2
    if _mlp_plan(I, bits, cfg.hidden_size)[0] is None:
        return False
    return _qkv_tile_lb(Dqkv, cfg.head_dim, g_r) is not None


# ------------------------------------------------------------------- packs
def _plane_pack(codes: torch.Tensor, tile: int, bits: int) -> torch.Tensor:
    """[R, K] codes -> [NP * R / g_r, K] int8 plane bytes, tile-major (the
    JAX package's ``_plane_pack``): tile t's planes at rows
    [t * NP * tile / g_r, ...), plane p's field f holding the tile's row
    block [f * tile / g_r, (f + 1) * tile / g_r); each plane's top field
    stored XOR its sign bit."""
    plan = _PLAN[bits]
    g_r = max(r for segs in plan for (r, _, _) in segs) + 1
    R, K = codes.shape
    tF = tile // g_r
    c = codes.to(torch.int32).reshape(R // tile, g_r, tF, K)
    planes = []
    for segs in plan:
        byte = None
        for j, (row, shift, w) in enumerate(segs):
            v = (c[:, row] >> shift) & ((1 << w) - 1)
            if j == 0:
                v = v ^ (1 << (w - 1))
            byte = v if byte is None else (byte << w) | v
        planes.append(byte)
    out = torch.stack(planes, dim=1).reshape(R // tile * len(plan) * tF, K)
    return ((out + 128) % 256 - 128).to(torch.int8)


def _sz_t(m, bits: int) -> torch.Tensor:
    """[G, R] float32 zero-point corrections ``scale * (2^(bits-1) -
    zero)`` of a uniform linear (zeros where it has none)."""
    s = m["scales"].to(torch.float32)
    if "zeros" not in m:
        return torch.zeros_like(s).T.contiguous()
    return (s * (float(1 << (bits - 1)) - m["zeros"].to(torch.float32))
            ).T.contiguous()


@torch.no_grad()
def megapack_lowbit(cfg, sp, bits: int = 3) -> Dict[str, torch.Tensor]:
    """Kernel 14's operands from a stacked model of uniform ``bits``-bit
    fused linears (``serve/stacked.stack_layers``), byte-equal to the JAX
    package's ``megapack_lowbit``: plane bytes ``qkv_pk``, ``o_pk``,
    ``gu_pk`` (gate tiles, then up tiles), ``dn_pk``, bf16 scales with the
    groups leading (``gu_s`` and ``dn_s`` tile-major), the qkv bias and the
    norms; qwen3's ``qk_nm`` and the o/gate-up/down biases
    (:func:`_arch_pack_ops`); where any projection has zero points, the float32 corrections
    ``qkv_sz``, ``o_sz``, ``gu_sz`` and ``dn_sz`` in the scales' layouts;
    gemma's sandwich norms ``pa_norm`` and ``pm_norm`` [L, 1, H] float32;
    where all four carry EoRA adapters, their factors rounded to bf16
    (``megastep_lowbit.py:1746-1763``): ``la_q`` [L, rq, H], ``lb_q`` [L,
    Dqkv, rq], ``la_o`` [L, ro, q_dim], ``lb_o`` [L, H, ro], ``la_g`` [L,
    rg, H], ``lb_g`` [L, 2I, rg] with its rows tile-major like ``gu_s``
    (gate tile, then up tile), ``la_d`` [L, rd, I] and ``lb_d`` [L, H, rd].
    Bits 8, 4, 3 and 2 (``_PLAN``: 3-bit planes hold 8 row blocks of a tile
    in 3 bytes, rows 2 and 5 split across two of them; 2-bit planes 4 row
    blocks in a byte); packs one layer at a time. Act-order artifacts go
    through :func:`actorder_transform` first (ValueError here)."""
    if bits not in _PLAN:
        raise ValueError(f"megapack_lowbit: no plane plan for {bits} bits")
    lp0 = sp.layers[0]
    if any("g_idx" in m for m in (lp0.attn["qkv"], lp0.attn["o"],
                                  lp0.mlp["gateup"], lp0.mlp["down"])):
        raise ValueError("megapack_lowbit: act-order artifacts must go "
                         "through actorder_transform (serve.stacked.prepack)")
    mats = _uniform_mats(sp, bits, zeros=True)
    H = cfg.hidden_size
    _, _, _, g_r = _plan_meta(bits)
    Dqkv = mats[0][0]["scales"].shape[0]
    I = mats[0][2]["scales"].shape[0] // 2
    gs = mats[0][3].in_features // mats[0][3]["scales"].shape[1]
    tq = _qkv_tile_lb(Dqkv, cfg.head_dim, g_r)
    ti = _mlp_plan(I, bits, H)[0]
    zp = any("zeros" in m for m in mats[0])
    keys = ["qkv_pk", "qkv_s", "o_pk", "o_s", "gu_pk", "gu_s", "dn_pk",
            "dn_s"]
    if zp:
        keys += ["qkv_sz", "o_sz", "gu_sz", "dn_sz"]
    out = {k: [] for k in keys}
    for qkv, o, gu, dn in mats:
        gcodes = _codes(gu)
        out["qkv_pk"].append(_plane_pack(_codes(qkv), tq, bits))
        out["qkv_s"].append(_scales_t(qkv))
        out["o_pk"].append(_plane_pack(_codes(o), H, bits))
        out["o_s"].append(_scales_t(o))
        out["gu_pk"].append(torch.cat([_plane_pack(gcodes[:I], ti, bits),
                                       _plane_pack(gcodes[I:], ti, bits)]))
        out["gu_s"].append(_gu_layout(_scales_t(gu), I, ti))
        out["dn_pk"].append(_plane_pack(_codes(dn), H, bits))
        out["dn_s"].append(_dn_layout(_scales_t(dn), I, ti, gs))
        if zp:
            out["qkv_sz"].append(_sz_t(qkv, bits))
            out["o_sz"].append(_sz_t(o, bits))
            out["gu_sz"].append(_gu_layout(_sz_t(gu, bits), I, ti))
            out["dn_sz"].append(_dn_layout(_sz_t(dn, bits), I, ti, gs))
    mp = {k: torch.stack(v) for k, v in out.items()}
    mp.update(_shared_pack_ops(cfg, sp, mats, I, ti))
    return mp


def _shared_pack_ops(cfg, sp, mats, I: int, ti: int) -> Dict[str, torch.Tensor]:
    """The operands every kernel-14 pack shares (``_common_pack_ops``,
    ``megastep_lowbit.py:1686-1764``): norms and the qkv bias, the
    architecture operands (:func:`_arch_pack_ops`) and, where all four
    projections carry EoRA adapters, their factors rounded to bf16, gate/up's
    ``lb_g`` rows tile-major like ``gu_s``."""
    mp = common_pack_ops(sp, mats)
    mp.update(_arch_pack_ops(cfg, sp, mats, I, ti))
    if all("lora_a" in m for m in mats[0]):
        out = {k: [] for k in _LORA_KEYS}
        for qkv, o, gu, dn in mats:
            lbg = gu["lora_b"]
            lbg = torch.cat([lbg[a * I + t * ti:a * I + (t + 1) * ti]
                             for t in range(I // ti) for a in (0, 1)])
            for name, m, lb in (("q", qkv, qkv["lora_b"]), ("o", o, o["lora_b"]),
                                ("g", gu, lbg), ("d", dn, dn["lora_b"])):
                out[f"la_{name}"].append(m["lora_a"].to(torch.bfloat16))
                out[f"lb_{name}"].append(lb.to(torch.bfloat16))
        mp.update({k: torch.stack(v) for k, v in out.items()})
    return mp


def _arch_pack_ops(cfg, sp, mats, I: int, ti: int) -> Dict[str, torch.Tensor]:
    """The architecture operands of ``ganq_tpu``'s ``_common_pack_ops``
    (``megastep_lowbit.py:1698-1745``): for a sandwich-norm model (gemma2/3)
    ``pa_norm`` and ``pm_norm`` [L, 1, H] float32, the post-attention and
    post-feedforward norm weights; for a per-head qk-norm model
    ``qk_nm`` [L, 2, Dqkv] float32, the lane-expanded weight row (q heads
    ``q_norm``, k heads ``k_norm``, v lanes 1) over the apply-mask row (1 on
    q and k lanes, 0 on v); where o, gate/up or down has a bias, ``o_bias``
    [L, 1, H], ``gu_bias`` [L, 1, 2I] tile-major like ``gu_s`` (gate tile,
    then up tile) and ``dn_bias`` [L, 1, H] float32, zeros for a projection
    without one."""
    out = {}
    L = len(mats)
    Dqkv = out_rows(mats[0][0])
    H = out_rows(mats[0][1])
    dev = sp.layers[0].input_norm.weight.device
    d = cfg.head_dim
    lp0 = sp.layers[0]
    if lp0.q_norm is not None and cfg.qk_norm in (True, "head"):
        kvd = (Dqkv - cfg.q_dim) // 2
        rows = []
        for lp in sp.layers:
            w = torch.cat([lp.q_norm.to(torch.float32).repeat(cfg.q_dim // d),
                           lp.k_norm.to(torch.float32).repeat(kvd // d),
                           torch.ones(kvd, device=dev)])
            m = torch.cat([torch.ones(cfg.q_dim + kvd, device=dev),
                           torch.zeros(kvd, device=dev)])
            rows.append(torch.stack([w, m]))
        out["qk_nm"] = torch.stack(rows)
    if cfg.sandwich_norm and lp0.post_attn_norm is not None:
        for key, name in (("pa_norm", "post_attn_norm"),
                          ("pm_norm", "post_mlp_norm")):
            out[key] = torch.stack([getattr(lp, name).weight.to(
                torch.float32) for lp in sp.layers]).reshape(L, 1, H)
    if any("bias" in m for mm in mats for m in mm[1:]):
        def bias(m, width):
            return (m["bias"].to(torch.float32) if "bias" in m
                    else torch.zeros(width, device=dev))

        def gu_tiles(b):
            return torch.cat([b[a * I + t * ti:a * I + (t + 1) * ti]
                              for t in range(I // ti) for a in (0, 1)])

        out["o_bias"] = torch.stack([bias(m[1], H) for m in mats]).reshape(
            L, 1, H)
        out["gu_bias"] = torch.stack([gu_tiles(bias(m[2], 2 * I))
                                      for m in mats]).reshape(L, 1, 2 * I)
        out["dn_bias"] = torch.stack([bias(m[3], H) for m in mats]).reshape(
            L, 1, H)
    return out


# ------------------------------------------------------ the Walsh planes
# Any function on 3 bits is a sum of 8 XOR monomials (``megastep_lowbit.py:
# 184-200``): T[r, q] = c0[r] + sum_S c_S[r] * (XOR of q's bits in S), so
# x . T[r, q_r] = c0[r] * sum(x) + sum_S c_S[r] * (x . m_S(q_r)).
_MONO = ((0,), (1,), (2,), (0, 1), (0, 2), (1, 2), (0, 1, 2))


def _walsh_basis_inv() -> np.ndarray:
    """Inverse of M[c, S] (column 0 = 1, then the XOR monomials of code c):
    exact coefficient recovery c = Minv @ T for any 8-entry codebook (the
    port's own copy of ``megastep_lowbit.py:203``)."""
    M = np.zeros((8, 8), np.float64)
    M[:, 0] = 1.0
    for j, S in enumerate(_MONO):
        for c in range(8):
            v = 0
            for b in S:
                v ^= (c >> b) & 1
            M[c, 1 + j] = v
    return np.linalg.inv(M)


def walsh_coef(lut: torch.Tensor) -> torch.Tensor:
    """[..., m, 8] codebooks -> [..., 8, m] float32 coefficient rows (c0
    first, then the 7 monomials; ``megastep_lowbit.py:217``): the Walsh
    transform of the table, each row's float32 products (exact: the inverse
    holds 0, 1 and +-1/4) summed over the 8 entries in order, which gives
    ``ganq_tpu``'s float32 einsum bit for bit."""
    minv = torch.as_tensor(_walsh_basis_inv().astype(np.float32),
                           device=lut.device)
    t = lut.to(torch.float32)
    acc = torch.zeros((*t.shape[:-1], 8), dtype=torch.float32,
                      device=lut.device)
    for k in range(8):
        acc = acc + t[..., k:k + 1] * minv[:, k]
    return acc.transpose(-1, -2).contiguous()


def _walsh_plane_pack(codes: torch.Tensor, tile: int) -> torch.Tensor:
    """[R, K] 3-bit codes -> [3 R / 8, K] int8 bit planes, tile-major
    (``megastep_lowbit.py:225``): tile t's 3 planes at rows [t * 3 * tile /
    8, ...); plane p's byte holds bit p of the tile's 8 row blocks, row
    block r at byte bit 7 - r, unflipped."""
    R, K = codes.shape
    tF = tile // 8
    c = codes.to(torch.int32).reshape(R // tile, 8, tF, K)
    planes = []
    for p in range(3):
        byte = None
        for r in range(8):
            v = (c[:, r] >> p) & 1
            byte = v if byte is None else (byte << 1) | v
        planes.append(byte)
    out = torch.stack(planes, dim=1).reshape(R // tile * 3 * tF, K)
    return ((out + 128) % 256 - 128).to(torch.int8)


def _walsh_codes(pk: torch.Tensor, tile: int) -> torch.Tensor:
    """The 3-bit codes [R, K] (int32) of :func:`_walsh_plane_pack`'s
    planes."""
    b = pk.to(torch.int32) & 255
    P, K = b.shape
    tF = tile // 8
    b = b.reshape(P // (3 * tF), 3, tF, K)
    rows = [sum(((b[:, p] >> (7 - r)) & 1) << p for p in range(3))
            for r in range(8)]
    return torch.stack(rows, dim=1).reshape(P // 3 * 8, K)


def walsh_linear(x8: torch.Tensor, codes: torch.Tensor,
                 cf: torch.Tensor) -> torch.Tensor:
    """The Walsh walk of one product (``walsh_y``, ``megastep_lowbit.py:
    441-477``): x8 [B, K] (integers), 3-bit codes [R, K], coefficient rows
    cf [8, R] float32 -> [B, R] float32 ``c0 S + c1 z1 + ... + c7 z7``, in
    that order, S the activation sum and z_j the dot with monomial j's bits
    (``_MONO``), exact integers over all K columns (float64 here: every
    partial sum stays below 2^53)."""
    x = x8.to(torch.float64)
    c = codes.to(torch.int32)
    cf = cf.to(torch.float32)
    y = cf[0] * x.sum(dim=1, keepdim=True).to(torch.float32)
    for j, mono in enumerate(_MONO):
        m = 0
        for b in mono:
            m = m ^ ((c >> b) & 1)
        z = (x @ m.to(torch.float64).T).to(torch.float32)
        y = y + cf[1 + j] * z
    return y


def _lut3_mats(sp):
    """The four fused linears of every layer, checked to be the 3-bit
    8-entry ``lut`` artifacts of "wl8" (g_idx and zero points do not exist
    on them)."""
    out = []
    for lp in sp.layers:
        mats = (lp.attn["qkv"], lp.attn["o"], lp.mlp["gateup"], lp.mlp["down"])
        if any(m.kind != "lut" or m.bits != 3 or m["lut"].shape[-1] != 8
               for m in mats):
            raise ValueError("megapack_walsh: every linear must be a 3-bit "
                             "8-entry lut")
        out.append(mats)
    return out


@torch.no_grad()
def megapack_walsh(cfg, sp) -> Dict[str, torch.Tensor]:
    """The "wl8" operands of kernel 14 from a stacked model of 3-bit
    8-entry ``lut`` fused linears (``megastep_lowbit.py:1767``): the 3
    stored bit planes of each projection (:func:`_walsh_plane_pack`,
    exactly 3 bits a weight: ``qkv_pk``, ``o_pk``, ``gu_pk`` gate tiles then
    up tiles, ``dn_pk``) and the float32 Walsh coefficient rows in the
    scales' slots, ``qkv_s`` [L, 8, Dqkv], ``o_s`` [L, 8, H], ``gu_s`` [L, 8,
    2I] tile-major (gate tile, then up tile) and ``dn_s`` [L, 8, H], plus
    the operands every pack shares (:func:`_shared_pack_ops`). Packs one
    layer at a time."""
    mats = _lut3_mats(sp)
    H = cfg.hidden_size
    Dqkv = out_rows(mats[0][0])
    I = out_rows(mats[0][2]) // 2
    tq = _qkv_tile_lb(Dqkv, cfg.head_dim, 8)
    ti = _mlp_plan(I, 3, H)[0]
    out = {k: [] for k in ("qkv_pk", "qkv_s", "o_pk", "o_s", "gu_pk", "gu_s",
                           "dn_pk", "dn_s")}

    def codes(m):
        return unpack_int_rows(m["idx_packed"], 3, m.in_features)

    for qkv, o, gu, dn in mats:
        gcodes = codes(gu)
        out["qkv_pk"].append(_walsh_plane_pack(codes(qkv), tq))
        out["qkv_s"].append(walsh_coef(qkv["lut"]))
        out["o_pk"].append(_walsh_plane_pack(codes(o), H))
        out["o_s"].append(walsh_coef(o["lut"]))
        out["gu_pk"].append(torch.cat([_walsh_plane_pack(gcodes[:I], ti),
                                       _walsh_plane_pack(gcodes[I:], ti)]))
        out["gu_s"].append(_gu_layout(walsh_coef(gu["lut"]), I, ti))
        out["dn_pk"].append(_walsh_plane_pack(codes(dn), H))
        out["dn_s"].append(walsh_coef(dn["lut"]))
    mp = {k: torch.stack(v) for k, v in out.items()}
    mp.update(_shared_pack_ops(cfg, sp, mats, I, ti))
    return mp


# kernel 14's qk-norm and bias operands (the ARCH instantiations)
_ARCH_KEYS = ("qk_nm", "o_bias", "gu_bias", "dn_bias")

# gemma's sandwich norms (the GEMMA instantiation)
_SAND_KEYS = ("pa_norm", "pm_norm")

# kernel 14's EoRA operands (A and B of q, o, gate/up and down)
_LORA_KEYS = ("la_q", "lb_q", "la_o", "lb_o", "la_g", "lb_g", "la_d", "lb_d")


def _gidx_perm(g_idx_l, gs: int) -> Optional[np.ndarray]:
    """Stable group-contiguous column order of one layer's g_idx, or None
    where it is already sequential (``megastep_lowbit.py:1451``). Raises
    ValueError on unbalanced groups (every group must hold gs columns)."""
    gi = np.asarray(g_idx_l, np.int64)
    n = gi.shape[0]
    if np.array_equal(gi, np.arange(n) // gs):
        return None
    counts = np.bincount(gi, minlength=n // gs)
    if counts.shape[0] != n // gs or not np.all(counts == gs):
        raise ValueError("act-order g_idx with unbalanced groups")
    return np.argsort(gi, kind="stable").astype(np.int32)


@torch.no_grad()
def actorder_transform(cfg, sp, bits: int):
    """Bake act-order (``g_idx``) artifacts into a pack-only copy
    (``megastep_lowbit.py:1465``). Returns ``(tsp, aps)``: a stacked model
    whose qkv/o/gate-up/down columns are sorted group-contiguous (g_idx
    dropped), and the column orders the kernel reads its activations
    through: ``ap_q`` and ``ap_g`` [L, H], ``ap_o`` [L, q_dim] int32 (the
    identity for a projection without g_idx; ``aps`` is empty where
    qkv, o and gate/up have none). Down's order is baked into the pack: the
    gate/up output rows (codes, scales, zeros and bias) are permuted to
    match, so no activation of down is permuted at run time. EoRA adapters
    follow: each ``lora_a``'s columns take its projection's column order
    (the kernel forms ``x @ A^T`` from the permuted activation) and
    gate/up's ``lora_b`` rows take down's order, both halves. Where the
    JAX package routes activations through Beneš lane masks
    (``ops/lane_perm.py``), a gather through the indices gives the same
    values. The ORIGINAL ``sp`` keeps serving prefill (its artifacts keep
    g_idx). Raises ValueError on unbalanced groups."""
    from ..models.transformer import Layer, Model, sandwich_norms
    from .qlinear import QLinear

    names = (("attn", "qkv"), ("attn", "o"), ("mlp", "gateup"),
             ("mlp", "down"))
    if not any("g_idx" in getattr(lp, g)[n] for lp in sp.layers
               for g, n in names):
        return sp, {}

    def perm_of(m):
        if "g_idx" not in m:
            return None
        return _gidx_perm(m["g_idx"].cpu().numpy(),
                          m.in_features // m["scales"].shape[1])

    perms = [{n: perm_of(getattr(lp, g)[n]) for g, n in names}
             for lp in sp.layers]

    def rewrite(m, col, row=None):
        arrays = {k: v for k, v in m._buffers.items()
                  if v is not None and k != "g_idx"}
        dev = m["qweight"].device
        if col is not None:
            cp = torch.as_tensor(col, device=dev).long()
            codes = unpack_int_rows(m["qweight"], m.bits, m.in_features)
            arrays["qweight"] = pack_int_rows(codes[:, cp], m.bits)
            if "lora_a" in arrays:
                arrays["lora_a"] = arrays["lora_a"][:, cp]
        if row is not None:
            I = m["scales"].shape[0] // 2
            rp = torch.as_tensor(row, device=dev).long()
            full = torch.cat([rp, rp + I])
            for k in ("qweight", "scales", "zeros", "bias", "lora_b"):
                if k in arrays:
                    arrays[k] = arrays[k][full]
        return QLinear(m.kind, arrays, m.bits, m.in_features)

    layers = []
    for lp, p in zip(sp.layers, perms):
        attn = dict(lp.attn.items())
        mlp = dict(lp.mlp.items())
        attn["qkv"] = rewrite(attn["qkv"], p["qkv"])
        attn["o"] = rewrite(attn["o"], p["o"])
        mlp["gateup"] = rewrite(mlp["gateup"], p["gateup"], p["down"])
        mlp["down"] = rewrite(mlp["down"], p["down"])
        layers.append(Layer(lp.input_norm.weight, lp.post_norm.weight, attn,
                            mlp, **sandwich_norms(lp)))
    tsp = Model(sp.embed_tokens.weight, sp.final_norm.weight, layers,
                sp.lm_head)
    aps = {}
    if any(p[n] is not None for p in perms for n in ("qkv", "o", "gateup")):
        dev = sp.layers[0].attn["qkv"]["qweight"].device

        def orders(name, n):
            return torch.stack([torch.as_tensor(
                p[name] if p[name] is not None else np.arange(n, dtype=np.int32),
                device=dev) for p in perms])

        aps = {"ap_q": orders("qkv", cfg.hidden_size),
               "ap_g": orders("gateup", cfg.hidden_size),
               "ap_o": orders("o", cfg.q_dim)}
    return tsp, aps


# -------------------------------------------------------------------- plan
def megastep_lowbit_plan(B: int, H: int, q_dim: int, kv_dim: int,
                         head_dim: int, T: int, Dqkv: int, I: int, bits: int,
                         gs: int, block_t: int = 128,
                         qkv_cap_mb: int = 12, zp: bool = False,
                         aperm: bool = False,
                         lora: Optional[tuple] = None,
                         tv: int = 0, qkn: bool = False,
                         biases: bool = False,
                         sand: bool = False,
                         walsh: bool = False) -> Dict[str, int]:
    """The JAX wrapper's run-time plan (``megastep_lowbit.py:966-1087``):
    the qkv tile ``tq``, the MLP tile ``ti`` (baked into the pack), the
    tiles per grid step ``ptq``/``ptg`` and the flash block ``Tb``:
    ``block_t`` at most T, halved until it divides T, then halved again (or
    ptg, then ptq, cut) while the TPU's VMEM estimate exceeds its budget.
    The estimate counts the optional operands: zero points ``zp``,
    act-order ``aperm`` (the JAX package's Beneš masks, 2 log2(n) - 1
    stages), the EoRA ranks ``lora`` (rq, ro, rg, rd), the fold's
    vocabulary tile ``tv``, the qk-norm rows ``qkn``, the o/gate-up/down
    ``biases`` and gemma's sandwich norms ``sand``. With ``walsh`` ("wl8",
    bits 3) the estimate counts the 8 coefficient rows in the scales' place
    and ``gs`` is ignored (``megastep_lowbit.py:974-984``). Tb and ti set
    rounding points."""
    metas, _, _, g_r = _plan_meta(bits)
    npl = len(metas)
    d = head_dim
    Hq, Hkv = q_dim // d, kv_dim // d
    tq = _qkv_tile_lb(Dqkv, d, g_r)
    NQ = Dqkv // tq
    Tb = min(block_t, T)
    while T % Tb:
        Tb //= 2
    ti, ptg = _mlp_plan(I, bits, H)
    NG = I // ti
    if walsh:
        gtp8 = Gp = Gq = 8
    else:
        gtp8 = -(-(ti // gs) // 8) * 8
        Gp, Gq = H // gs, q_dim // gs
    Bp = -(-B // 8) * 8

    def _per_step(n_tiles, tile_bytes, cap):
        for c in range(n_tiles, 0, -1):
            if n_tiles % c == 0 and c * tile_bytes <= cap:
                return c
        return 1

    pq0 = npl * tq // g_r
    ptq = _per_step(NQ, pq0 * H, qkv_cap_mb * 1024 * 1024)
    po = npl * H // g_r
    BGp_ = -(-B * Hkv // 8) * 8

    def _vmem_est(ptq_, ptg_, Tb_):
        pq_ = ptq_ * pq0
        pi_ = ptg_ * (npl * ti // g_r)
        est = 2 * pq_ * H
        est += 2 * 2 * Gp * ptq_ * tq
        est += 2 * 4 * 2 * ptq_ * B * tq
        est += 2 * 2 * 2 * (B * Hkv) * Tb_ * d
        est += 2 * po * q_dim
        est += 2 * 2 * Gq * H
        est += 2 * 2 * pi_ * H
        est += 2 * 2 * Gp * ptg_ * 2 * ti
        est += 2 * po * ptg_ * ti
        est += 2 * 2 * ptg_ * gtp8 * H
        est += 2 * 4 * (2 * H + ptq_ * tq)
        if zp:
            est += 2 * 4 * (Gp * ptq_ * tq + Gq * H
                            + Gp * ptg_ * 2 * ti + ptg_ * gtp8 * H)
        if aperm:
            est += 2 * 2 * (2 * _benes_stages(H) * H
                            + _benes_stages(q_dim) * q_dim)
        if lora:
            rq_, ro_, rg_, rd_ = lora
            est += 2 * 2 * (rq_ * H + ptq_ * tq * rq_ + ro_ * q_dim
                            + H * ro_ + rg_ * H + ptg_ * 2 * ti * rg_
                            + rd_ * ptg_ * ti + H * rd_)
            est += 4 * B * (rq_ + rg_ + rd_)
        if qkn:
            est += 2 * 4 * 2 * ptq_ * tq
        if sand:
            est += 2 * 4 * 2 * H
        if biases:
            est += 2 * 4 * (2 * H + ptg_ * 2 * ti)
        if tv:
            est += 2 * (tv * H + 4 * 8 * tv) + 4 * H + 2 * 4 * B * tv
        est += 2 * B * H + 2 * 2 * 2 * B * kv_dim + 4 * BGp_ * 128
        est += 2 * B * H
        est += (4 * B * H + B * H + 4 * Bp * 128
                + 2 * (Hq + 2 * Hkv) * Bp * d + 4 * Hq * Bp * d
                + 2 * 4 * Hq * Bp * 128 + Bp * max(q_dim, ti) + 4 * B * H)
        if aperm or lora:
            est += 4 * Bp * q_dim
        return est

    def _down(c, n):
        for c2 in range(c - 1, 0, -1):
            if n % c2 == 0:
                return c2
        return 1

    budget = 108 * 1024 * 1024
    while _vmem_est(ptq, ptg, Tb) > budget:
        if Tb > 16:
            Tb //= 2
        elif ptg > 1:
            ptg = _down(ptg, NG)
        elif ptq > 1:
            ptq = _down(ptq, NQ)
        else:
            break
    return {"tq": tq, "ti": ti, "ptq": ptq, "ptg": ptg, "Tb": Tb}


def _benes_stages(n: int) -> int:
    """Stages of the JAX package's Beneš lane network on n lanes."""
    return 2 * int(math.log2(n)) - 1


def _lora_ranks(mp) -> Optional[tuple]:
    """(rq, ro, rg, rd) of a pack's EoRA operands, or None."""
    if "la_q" not in mp:
        return None
    return tuple(mp[f"la_{n}"].shape[1] for n in ("q", "o", "g", "d"))


def _group_size(mp, H: int, walsh: int) -> int:
    """The group size of a uniform pack; 128 for a Walsh pack, whose walks
    take no groups (the kernel's checks read it)."""
    return 128 if walsh else H // mp["qkv_s"].shape[1]


def _plan_of(x, mp, k_cache, q_dim, kv_dim, head_dim, bits, block_t,
             qkv_cap_mb, lm=None, walsh: int = 0):
    metas, _, _, g_r = _plan_meta(bits)
    H = x.shape[1]
    return megastep_lowbit_plan(
        x.shape[0], H, q_dim, kv_dim, head_dim, k_cache.shape[2],
        mp["qkv_pk"].shape[1] * g_r // len(metas), mp["gu_s"].shape[2] // 2,
        bits, _group_size(mp, H, walsh), block_t, qkv_cap_mb,
        zp="qkv_sz" in mp, aperm="ap_q" in mp, lora=_lora_ranks(mp),
        tv=lm["scale"].shape[-1] if lm is not None else 0,
        qkn="qk_nm" in mp, biases="o_bias" in mp, sand="pa_norm" in mp,
        walsh=bool(walsh))


# --------------------------------------------------------------- the step
def _plane_codes(pk: torch.Tensor, tile: int, bits: int) -> torch.Tensor:
    """Centred codes ``q - 2^(bits-1)`` [R, K] (int32) of
    :func:`_plane_pack`'s planes: an 8-bit plane byte read signed is the
    centred code; a sub-byte plane's fields follow ``_PLAN``, the top field
    of each plane stored XOR its sign bit and a split row joined as ``hi <<
    shift | lo``."""
    if bits == 8:
        return pk.to(torch.int32)
    plan = _PLAN[bits]
    g_r = max(r for segs in plan for (r, _, _) in segs) + 1
    P, K = pk.shape
    tF = tile // g_r
    b = (pk.to(torch.int32) & 255).reshape(P // (len(plan) * tF), len(plan),
                                           tF, K)
    rows = [0] * g_r
    for p, segs in enumerate(plan):
        pos = 8
        for j, (row, shift, w) in enumerate(segs):
            pos -= w
            v = (b[:, p] >> pos) & ((1 << w) - 1)
            if j == 0:
                v = v ^ (1 << (w - 1))
            rows[row] = rows[row] + (v << shift)
    q = torch.stack(rows, dim=1).reshape(P // len(plan) * g_r, K)
    return q - (1 << (bits - 1))


def _layer_ops_lb(mp: Dict[str, torch.Tensor], bits: int, tq: int, ti: int,
                  gs: int, walsh: int = 0):
    """Layer l's decoded operands of a :func:`megapack_lowbit` pack, or
    with ``walsh`` of a :func:`megapack_walsh` pack (then the products'
    codes are the 3-bit codes, their scales the [8, R] coefficient rows and
    ``walsh`` is set)."""
    H = mp["o_s"].shape[2]
    I = mp["gu_s"].shape[2] // 2
    NG = I // ti
    gtp = mp["dn_s"].shape[1] // NG
    Pi = mp["gu_pk"].shape[1] // 2

    def gate_up(key, l):
        g = mp[key][l].reshape(-1, NG, 2, ti)
        return g[:, :, 0].reshape(-1, I), g[:, :, 1].reshape(-1, I)

    def down(key, l):
        return mp[key][l].reshape(NG, gtp, H)[:, :ti // gs].reshape(I // gs,
                                                                    H)

    zp = "qkv_sz" in mp

    def arch(l):
        out = {}
        if "qk_nm" in mp:
            out["qk_nm"] = mp["qk_nm"][l]
        if "o_bias" in mp:
            gb, ub = gate_up("gu_bias", l)
            out.update(o_bias=mp["o_bias"][l, 0], gate_bias=gb[0],
                       up_bias=ub[0], dn_bias=mp["dn_bias"][l, 0])
        out.update({k: mp[k][l, 0] for k in _SAND_KEYS if k in mp})
        return out

    def lora(l):
        if "la_q" not in mp:
            return {}
        rg = mp["lb_g"].shape[2]
        lbg = mp["lb_g"][l].reshape(NG, 2, ti, rg)
        return {"la_q": mp["la_q"][l], "lb_q": mp["lb_q"][l],
                "la_o": mp["la_o"][l], "lb_o": mp["lb_o"][l],
                "la_g": mp["la_g"][l], "lb_gate": lbg[:, 0].reshape(I, rg),
                "lb_up": lbg[:, 1].reshape(I, rg), "la_d": mp["la_d"][l],
                "lb_d": mp["lb_d"][l]}

    if walsh:
        def codes(pk, tile):
            return _walsh_codes(pk, tile)
    else:
        def codes(pk, tile):
            return _plane_codes(pk, tile, bits)

    def ops(l):
        gpk = mp["gu_pk"][l]
        gs_, us_ = gate_up("gu_s", l)
        gz, uz = gate_up("gu_sz", l) if zp else (None, None)
        return {**lora(l),
            "qkv": (codes(mp["qkv_pk"][l], tq), mp["qkv_s"][l],
                    mp["qkv_sz"][l] if zp else None),
            "o": (codes(mp["o_pk"][l], H), mp["o_s"][l],
                  mp["o_sz"][l] if zp else None),
            "gate": (codes(gpk[:Pi], ti), gs_, gz),
            "up": (codes(gpk[Pi:], ti), us_, uz),
            "down": (codes(mp["dn_pk"][l], H),
                     mp["dn_s"][l] if walsh else down("dn_s", l),
                     down("dn_sz", l) if zp else None),
            "walsh": bool(walsh),
            "bias": mp["qkv_bias"][l, 0], "attn_norm": mp["attn_norm"][l, 0],
            "mlp_norm": mp["mlp_norm"][l, 0], **arch(l),
            **{k: mp[k][l].long() for k in ("ap_q", "ap_g", "ap_o")
               if k in mp}}
    return ops


def megastep_lowbit_plain(x: torch.Tensor, mp: Dict[str, torch.Tensor],
                          k_cache: torch.Tensor, v_cache: torch.Tensor, pos,
                          cos_half: Optional[torch.Tensor],
                          sin_half: Optional[torch.Tensor], *, q_dim: int,
                          kv_dim: int, head_dim: int, rotary_dim: int = 0,
                          interleaved: bool = False, eps: float = 1e-5,
                          rms_offset: float = 0.0, scale: float = 1.0,
                          act: str = "silu", block_t: int = 128,
                          bits: int = 4, lm=None, qkv_cap_mb: int = 12,
                          softcap: float = 0.0, windows=None, rope_sel=None,
                          walsh: int = 0):
    """Plain version of kernel 14 ("w4p", "w3", "w2", "w8p" by ``bits``,
    "wl8" with ``walsh=7``; with the lm fold where ``lm`` is given, gemma's
    softcap, windows and dual rope where they are), with the kernel's
    arithmetic. Shapes and results as :func:`megastep_lowbit_decode`."""
    plan = _plan_of(x, mp, k_cache, q_dim, kv_dim, head_dim, bits, block_t,
                    qkv_cap_mb, lm, walsh)
    gs = _group_size(mp, x.shape[1], walsh)
    xs, kn, vn = grouped_step_plain(
        x, _layer_ops_lb(mp, bits, plan["tq"], plan["ti"], gs, walsh),
        mp["qkv_pk"].shape[0], k_cache, v_cache, pos, cos_half, sin_half,
        q_dim=q_dim, kv_dim=kv_dim, head_dim=head_dim, rotary_dim=rotary_dim,
        interleaved=interleaved, eps=eps, rms_offset=rms_offset, scale=scale,
        act=act, Tb=plan["Tb"], ti=plan["ti"], gs=gs, partner_bf16=False,
        windows=windows, softcap=softcap, rope_sel=rope_sel)
    if lm is None:
        return xs.to(x.dtype), kn, vn
    return xs.to(x.dtype), kn, vn, lm_fold_plain(xs, lm, eps, rms_offset)


def lm_fold_plain(xs: torch.Tensor, lm: Dict[str, torch.Tensor], eps: float,
                  rms_offset: float = 0.0) -> torch.Tensor:
    """The trailing-unembed fold of kernel 14 (``megastep_lowbit.py:
    893-914``): the final rmsnorm of the float32 residual ``xs`` [B, H],
    its int8 rows (``quantize_rows``: sx = max|x| * fl(1/127), codes an
    IEEE quotient with ties to even), the exact integer dot with the int8
    lm_head rows, and ``(dv * sx) * scale`` in float32: logits [B, V].
    ``lm`` from :func:`mega_lm_operands`."""
    x8, sx = quantize_rows(rms_rows(xs, lm["norm"], eps, rms_offset))
    return lm_vocab_plain(x8, sx, lm)


def lm_vocab_plain(x8: torch.Tensor, sx: torch.Tensor,
                   lm: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The fold's vocab phase: int8 rows x8 [B, H] (any integer type) with
    scales sx [B] or [B, 1] -> ``(float(x8 . w8) * sx) * scale`` [B, V]
    float32. The integer products stay below 2^53, so their float64 sum is
    exact in any order, and rounds to float32 as the int32 dot does."""
    dv = x8.to(torch.float64) @ lm["w8"].to(torch.float64).T
    return (dv.to(torch.float32) * sx.reshape(-1, 1).to(torch.float32)
            * lm["scale"].reshape(1, -1))


def mega_lm_operands(cfg, sp, max_tile_bytes: int = 4 * 1024 * 1024
                     ) -> Optional[Dict[str, torch.Tensor]]:
    """Operands of the trailing-unembed fold (``lm=`` of
    :func:`megastep_lowbit_decode`; ``megastep_lowbit.py:1870-1902``), or
    None where the model's unembed cannot fold: the lm_head is not ``w8``,
    has a bias or no per-row scale, the model has no final rmsnorm or has a
    ``project_out``, or no vocabulary tile ``tv`` in 4096 .. 128 divides V
    within ``max_tile_bytes``. ``{"w8": [V, H] int8, "scale": [NV, tv]
    float32, "norm": [H] float32}``; the TPU's 8-sublane copy of the scales
    is not needed here. logit_scale and softcap stay with the caller."""
    from .qlinear import QLinear

    lm = sp.lm_head
    if not isinstance(lm, QLinear) or lm.kind != "w8" or "bias" in lm:
        return None
    w8 = lm["w8"]
    V, H = w8.shape
    if lm["scale"].numel() != V:
        return None
    if (not getattr(cfg, "final_layer_norm", True)
            or getattr(cfg, "norm", "rmsnorm") != "rmsnorm"
            or getattr(sp, "project_out", None) is not None):
        return None
    tv = next((c for c in (4096, 2048, 1024, 512, 256, 128)
               if V % c == 0 and c * H <= max_tile_bytes), None)
    if tv is None:
        return None
    return {"w8": w8,
            "scale": lm["scale"].to(torch.float32).reshape(V // tv, tv),
            "norm": sp.final_norm.weight.to(torch.float32).reshape(H)}


def pos_vector(pos, B: int, device) -> torch.Tensor:
    """Per-slot positions [B] int32 on ``device`` from a host int, a 0-d or
    a [B] tensor."""
    p = torch.as_tensor(pos, device=device).to(torch.int32).reshape(-1)
    return p.expand(B).contiguous()


def rope_rows_for(cos_half, sin_half, B: int, rotary_dim: int, device):
    """cos/sin [B, rotary_dim / 2] float32 (a [half] table serves every
    slot), or (None, None) without rope."""
    if not rotary_dim:
        return None, None
    half = rotary_dim // 2
    return tuple(t.to(device=device, dtype=torch.float32).reshape(-1, half)
                 .expand(B, half).contiguous() for t in (cos_half, sin_half))


def launch_grouped(library: str, symbol: str, what: str, x: torch.Tensor,
                   mp: Dict[str, torch.Tensor], keys: Dict[str, str],
                   k_cache: torch.Tensor, v_cache: torch.Tensor, pos,
                   cos_half, sin_half, *, bits: int, kmajor: bool, tq: int,
                   ti: int, gs: int, Tb: int, q_dim: int, kv_dim: int,
                   head_dim: int, rotary_dim: int, interleaved: bool,
                   eps: float, rms_offset: float, scale: float, act: str,
                   lm: Optional[Dict[str, torch.Tensor]] = None,
                   fold_rows: Optional[dict] = None, softcap: float = 0.0,
                   windows=None, rope_sel=None, walsh: int = 0):
    """Check the operands of a whole-step kernel 13 or 14 call and launch it
    (``csrc/<library>.cu``). ``keys`` names the pack's code operands; with
    ``walsh`` (kernel 14's "wl8") the scales' slots hold float32
    coefficient rows [L, 8, R] (:func:`megapack_walsh`). The
    kernel reads x and writes y in float32; y is returned in x's type. With
    kernel 14's ``lm`` (:func:`mega_lm_operands`) the kernel folds the
    unembed in and the logits come fourth; ``fold_rows``, a dict, then
    receives the fold's int8 rows ``x8`` [B, H] and scales ``sx`` [B] (the
    kernel's scratch), so that a check can hold its vocab phase bit for
    bit. The EoRA factors (kernel 14's ``la_*``/``lb_*``) come for all four
    projections or none; the kernel gets float32 scratch ``xa_*`` [B, r]
    for their A products. Gemma's operands (kernel 14): the sandwich norms
    ``pa_norm``/``pm_norm`` of the pack (with float32 scratch ``sand`` [B,
    H] for the o and down outputs they norm), ``windows`` and ``rope_sel``
    [L] int32 (then cos/sin_half [2, B, rotary_dim / 2]) and ``softcap``."""
    from .w8a8_args import ACT_CODES, launch

    B, H = x.shape
    d = head_dim
    Hkv = kv_dim // d
    metas, _, _, g_r = _plan_meta(bits)
    qkv_pk, o_pk, gu_pk, dn_pk = (mp[keys[k]] for k in ("qkv", "o", "gu",
                                                        "dn"))
    L = qkv_pk.shape[0]
    Dqkv = qkv_pk.shape[1] * g_r // len(metas)
    I = mp["gu_s"].shape[2] // 2
    T = k_cache.shape[2]
    rd = rotary_dim or 0
    if (d != 128 or Dqkv != q_dim + 2 * kv_dim or (q_dim // d) % Hkv
            or q_dim // d // Hkv > 8 or H % (128 * g_r) or gs % 128
            or H % gs or q_dim % gs or ti % gs or I % ti or Tb > 128
            or T % Tb or rd % 2 or rd > d or act not in ACT_CODES):
        raise ValueError(f"{what}: head_dim 128, at most 8 query heads per kv "
                         "head, 128-multiple groups and tiles, flash blocks "
                         "of at most 128 keys")
    if (k_cache.shape != (L, B * Hkv, T, d) or v_cache.shape != k_cache.shape
            or k_cache.dtype != torch.bfloat16
            or v_cache.dtype != torch.bfloat16
            or not k_cache.is_contiguous() or not v_cache.is_contiguous()):
        raise ValueError(f"{what}: contiguous bf16 caches [L, B * Hkv, T, d]")
    for name, t in ((keys["qkv"], qkv_pk), (keys["o"], o_pk),
                    (keys["gu"], gu_pk), (keys["dn"], dn_pk)):
        if t.dtype != torch.int8 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous int8")
    sdt = torch.float32 if walsh else torch.bfloat16
    for name in ("qkv_s", "o_s", "gu_s", "dn_s"):
        if mp[name].dtype != sdt or not mp[name].is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {sdt}")
    if walsh and (bits != 3 or tuple(mp["dn_s"].shape) != (L, 8, H)
                  or any(k in mp for k in ("qkv_sz", "ap_q"))):
        raise ValueError(f"{what}: the Walsh planes are 3-bit, with [L, 8, "
                         "R] coefficient rows, no zero points and no "
                         "act-order")
    extra = {}
    for name, field, dtype, shape in (
            ("qkv_sz", "qkv_sz", torch.float32, mp["qkv_s"].shape),
            ("o_sz", "o_sz", torch.float32, mp["o_s"].shape),
            ("gu_sz", "gu_sz", torch.float32, mp["gu_s"].shape),
            ("dn_sz", "dn_sz", torch.float32, mp["dn_s"].shape),
            ("ap_q", "ap_q", torch.int32, (L, H)),
            ("ap_g", "ap_g", torch.int32, (L, H)),
            ("ap_o", "ap_o", torch.int32, (L, q_dim))):
        t = mp.get(name)
        if t is None:
            continue
        if (kmajor or t.dtype != dtype or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous {dtype} "
                             f"{tuple(shape)} (kernel 14)")
        extra[field] = t
    if ("qkv_sz" in extra) != ("dn_sz" in extra) or (
            "ap_q" in extra) != ("ap_o" in extra):
        raise ValueError(f"{what}: zero points and act-order orders come "
                         "for all four projections")
    dev = x.device
    ranks = {}
    if any(k in mp for k in _LORA_KEYS):
        ranks = dict(zip(("r_q", "r_o", "r_g", "r_d"), _lora_ranks(mp)))
        shapes = {"la_q": (L, ranks["r_q"], H), "lb_q": (L, Dqkv, ranks["r_q"]),
                  "la_o": (L, ranks["r_o"], q_dim), "lb_o": (L, H, ranks["r_o"]),
                  "la_g": (L, ranks["r_g"], H), "lb_g": (L, 2 * I, ranks["r_g"]),
                  "la_d": (L, ranks["r_d"], I), "lb_d": (L, H, ranks["r_d"])}
        for name, shape in shapes.items():
            t = mp.get(name)
            if (kmajor or t is None or t.dtype != torch.bfloat16
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(f"{what}: the EoRA operands come for all "
                                 f"four projections; {name} must be "
                                 f"contiguous bf16 {shape} (kernel 14)")
            extra[name] = t
        for n in ("q", "o", "g", "d"):
            extra[f"xa_{n}"] = torch.empty((B, ranks[f"r_{n}"]),
                                           dtype=torch.float32, device=dev)
    arch = {k: mp[k] for k in _ARCH_KEYS if k in mp}
    if arch:
        if ("o_bias" in arch) != ("dn_bias" in arch) or (
                "o_bias" in arch) != ("gu_bias" in arch):
            raise ValueError(f"{what}: o_bias, gu_bias and dn_bias come "
                             "together")
        for name, shape in (("qk_nm", (L, 2, Dqkv)), ("o_bias", (L, 1, H)),
                            ("gu_bias", (L, 1, 2 * I)),
                            ("dn_bias", (L, 1, H))):
            t = arch.get(name)
            if t is not None and (kmajor or t.dtype != torch.float32
                                  or tuple(t.shape) != shape
                                  or not t.is_contiguous()):
                raise ValueError(f"{what}: {name} must be contiguous float32 "
                                 f"{shape} (kernel 14)")
        extra.update(arch)
        if "qk_nm" in arch:     # the pre-rope qkv rows the norm pass reads
            extra["qkv_f"] = torch.empty((B, Dqkv), dtype=torch.float32,
                                         device=dev)
    V = 0
    if lm is not None:
        V = lm["w8"].shape[0]
        if (kmajor or lm["w8"].dtype != torch.int8
                or tuple(lm["w8"].shape) != (V, H) or V % 128
                or not lm["w8"].is_contiguous()
                or lm["scale"].dtype != torch.float32
                or lm["scale"].numel() != V
                or lm["norm"].dtype != torch.float32
                or lm["norm"].numel() != H):
            raise ValueError(f"{what}: lm must be w8 [V, H] int8 (V a "
                             "multiple of 128), float32 scale [V] and "
                             "norm [H] (kernel 14)")
        extra.update(lm_w8=lm["w8"],
                     lm_scale=lm["scale"].reshape(V).contiguous(),
                     lm_norm=lm["norm"].reshape(H).contiguous(),
                     logits=torch.empty((B, V), dtype=torch.float32,
                                        device=dev))
    sand = {k: mp[k] for k in _SAND_KEYS if k in mp}
    if sand:
        if len(sand) != 2 or any(
                kmajor or t.dtype != torch.float32
                or tuple(t.shape) != (L, 1, H) or not t.is_contiguous()
                for t in sand.values()):
            raise ValueError(f"{what}: pa_norm and pm_norm come together, "
                             f"contiguous float32 {(L, 1, H)} (kernel 14)")
        extra.update(sand, sand=torch.empty((B, H), dtype=torch.float32,
                                            device=dev))
    for name, t in (("windows", windows), ("rope_sel", rope_sel)):
        if t is None:
            continue
        t = torch.as_tensor(t, device=dev).to(torch.int32).reshape(-1)
        if kmajor or t.numel() != L:
            raise ValueError(f"{what}: {name} must be [L] (kernel 14)")
        extra[name] = t.contiguous()
    if rope_sel is not None and rd:
        half = rd // 2
        cos_t, sin_t = (t.to(device=dev, dtype=torch.float32)
                        .reshape(2, -1, half).expand(2, B, half).contiguous()
                        for t in (cos_half, sin_half))
    else:
        cos_t, sin_t = rope_rows_for(cos_half, sin_half, B, rd, dev)
    if softcap and kmajor:
        raise ValueError(f"{what}: the softcap is kernel 14's")
    ng = I // ti
    y = torch.empty((B, H), dtype=torch.float32, device=dev)
    kn = torch.empty((L, B, kv_dim), dtype=torch.bfloat16, device=dev)
    vn = torch.empty((L, B, kv_dim), dtype=torch.bfloat16, device=dev)
    scratch = functools.partial(torch.empty, device=dev)
    x8 = scratch((B, H), dtype=torch.int8)
    sx = scratch((B,), dtype=torch.float32)
    # flags of the attention items, then arrival counters of the (row, kv
    # head) units and the token rows
    flags = _attention_flags(dev, B * Hkv * (T // Tb + 1) + B)
    launch(library, symbol, what, dict(
        x=x.to(torch.float32).contiguous(), attn_norm=mp["attn_norm"],
        mlp_norm=mp["mlp_norm"], qkv_bias=mp["qkv_bias"], cos_half=cos_t,
        sin_half=sin_t, k_cache=k_cache, v_cache=v_cache,
        pos=pos_vector(pos, B, dev), qkv_pk=qkv_pk, o_pk=o_pk, gu_pk=gu_pk,
        dn_pk=dn_pk, qkv_gs=mp["qkv_s"], o_gs=mp["o_s"], gu_gs=mp["gu_s"],
        dn_gs=mp["dn_s"], y=y, kn=kn, vn=vn,
        qkv_out=scratch((B, Dqkv), dtype=torch.bfloat16),
        x8=x8, sx=sx, xs=scratch((B, H), dtype=torch.float32),
        act_a=scratch((B, I), dtype=torch.float32),
        amax=scratch((B, ng), dtype=torch.int32),
        a8=scratch((B, max(q_dim, I)), dtype=torch.int8),
        attn=scratch((B, q_dim), dtype=torch.float32),
        attn_amax=scratch((B * Hkv,), dtype=torch.float32),
        att_part=scratch((B * Hkv, T // Tb, q_dim // kv_dim * (d + 2)),
                         dtype=torch.float32),
        att_flag=flags[:B * Hkv * (T // Tb)],
        att_count=flags[B * Hkv * (T // Tb):],
        partf=(scratch((max(q_dim, I) // gs, B, H), dtype=torch.float32)
               if kmajor else None), **extra), dev,
        B=B, H=H, q_dim=q_dim, kv_dim=kv_dim, d=d, rd=rd,
        interleaved=int(interleaved), I=I, ti=ti, T=T, Tb=Tb, L=L,
        act=ACT_CODES[act], eps=eps, rms_offset=rms_offset, scale=scale,
        cache_sb=Hkv * T * d, cache_sg=T * d, cache_st=d,
        cache_sl=B * Hkv * T * d, gs=gs, bits=bits, tq=tq,
        gtp=8 if walsh else mp["dn_s"].shape[1] // ng, cos_ld=rd // 2,
        kmajor=int(kmajor),
        V=V, softcap=float(softcap or 0.0), **ranks)
    if lm is None:
        return y.to(x.dtype), kn, vn
    if fold_rows is not None:
        fold_rows.update(x8=x8, sx=sx)
    return y.to(x.dtype), kn, vn, extra["logits"]


_FLAGS: Dict[torch.device, torch.Tensor] = {}


def _attention_flags(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 flags and arrival counters of kernels 13 and
    14 (the attention items' flags, then the counters of the attention
    units and the token rows) on ``device``: zero when made,
    and the kernel sets each back to zero when its phase is done with it,
    so calls that do not overlap on the device (the port's: one stream at a
    time) share them."""
    buf = _FLAGS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _FLAGS[device] = buf
    return buf


def gemma_call(mp: Dict[str, torch.Tensor], softcap=0.0, windows=None,
               rope_sel=None) -> bool:
    """Whether a kernel 14 call carries any of gemma's operands: sandwich
    norms in the pack, a softcap, windows or a rope selector."""
    return (any(k in mp for k in _SAND_KEYS) or bool(softcap)
            or windows is not None or rope_sel is not None)


def kernel_library(mp: Dict[str, torch.Tensor], fold: bool,
                   gemma: bool = False, bits: int = 4, walsh: int = 0) -> str:
    """The kernel-14 source a pack's call runs. "wl8" (``walsh``) the Walsh
    instantiation (``csrc/megastep_lowbit_walsh.cu``, every optional
    operand a runtime flag); "w3"/"w2" (``bits`` 3 or 2)
    ``csrc/megastep_lowbit_w3w2.cu``, or with any optional operand
    ``megastep_lowbit_w3w2_ext.cu`` (each a runtime flag). "w4p"/"w8p": a
    call with gemma's operands (:func:`gemma_call`) the GEMMA instantiation
    (``csrc/megastep_lowbit_gemma.cu``, which takes every other optional
    operand too, each nullable); otherwise packs with qwen3's qk-norm or
    o/gate-up/down biases the ARCH instantiations
    (``csrc/megastep_lowbit_arch*.cu``), with EoRA adapters the ones with
    the rank-r epilogue (``_lora``), steps with the fold theirs (``_lm``),
    packs with zero points or act-order the ones that read them (``_opt``);
    each optional operand is compiled into its own instantiations, so that
    the kernels without it keep their code."""
    if walsh:
        return "megastep_lowbit_walsh"
    extended = (gemma or fold or "la_q" in mp or "qkv_sz" in mp
                or "ap_q" in mp or any(k in mp for k in _ARCH_KEYS))
    if bits in (3, 2):
        return "megastep_lowbit_w3w2" + ("_ext" if extended else "")
    if gemma:
        return "megastep_lowbit_gemma"
    return ("megastep_lowbit"
            + ("_arch" if any(k in mp for k in _ARCH_KEYS) else "")
            + ("_lora" if "la_q" in mp else "") + ("_lm" if fold else "")
            + ("_opt" if "qkv_sz" in mp or "ap_q" in mp else ""))


def megastep_lowbit_decode(x: torch.Tensor, mp: Dict[str, torch.Tensor],
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           pos, cos_half: Optional[torch.Tensor],
                           sin_half: Optional[torch.Tensor], *, q_dim: int,
                           kv_dim: int, head_dim: int, rotary_dim: int = 0,
                           interleaved: bool = False, eps: float = 1e-5,
                           rms_offset: float = 0.0, scale: float = 1.0,
                           act: str = "silu", block_t: int = 128,
                           bits: int = 3, softcap: float = 0.0, windows=None,
                           rope_sel=None, lm=None, walsh: int = 0,
                           qkv_cap_mb: int = 12,
                           fold_rows: Optional[dict] = None):
    """Kernel 14, one decode step over all layers ("w4p", "w3", "w2",
    "w8p" at ``bits`` 4, 3, 2, 8; "wl8" at ``bits=3, walsh=7``). x [B, H]
    (B <= 64, the embedded current token); ``mp`` from
    :func:`megapack_lowbit` (from :func:`megapack_walsh` for "wl8"), with
    the zero-point corrections
    ``*_sz``, the act-order orders ``ap_*`` (:func:`actorder_transform`),
    the EoRA factors ``la_*``/``lb_*``, qwen3's ``qk_nm``, the
    o/gate-up/down biases and gemma's sandwich norms ``pa_norm``/``pm_norm``
    where the model has them; k/v_cache [L, B * Hkv, T, d] bf16 (slot b's
    history below ``pos[b]``; ``pos`` a host int, a 0-d or a [B] int
    tensor); cos/sin_half [rotary_dim / 2] or [B, rotary_dim / 2] at each
    slot's position, or with ``rope_sel`` [L] (gemma3's dual rope: 1 picks
    the second table) both tables, [2, B, rotary_dim / 2]; ``windows`` [L]
    each layer's sliding window (T for a full layer); ``softcap`` gemma2's
    attention softcap. Returns (y [B, H], the hidden state before the final
    norm, in x's type; k_new and v_new [L, B, kv_dim] bf16), and with
    ``lm`` (:func:`mega_lm_operands`: the trailing-unembed fold) the
    float32 logits [B, V] fourth. ``fold_rows``: see :func:`launch_grouped`
    (the card only). The other arguments are the JAX wrapper's; ``walsh``
    takes 7 (the exact 8-entry codebook) or 0."""
    B, H = x.shape
    if B > 64:
        raise ValueError("megastep_lowbit_decode: B <= 64")
    if walsh not in (0, 7) or (walsh and bits != 3):
        raise ValueError("megastep_lowbit_decode: walsh=7 at bits=3 (the "
                         "exact 8-entry codebooks) or walsh=0")
    if x.device.type == "cpu":
        return megastep_lowbit_plain(x, mp, k_cache, v_cache, pos, cos_half,
                                     sin_half, q_dim=q_dim, kv_dim=kv_dim,
                                     head_dim=head_dim, rotary_dim=rotary_dim,
                                     interleaved=interleaved, eps=eps,
                                     rms_offset=rms_offset, scale=scale,
                                     act=act, block_t=block_t, bits=bits,
                                     lm=lm, qkv_cap_mb=qkv_cap_mb,
                                     softcap=softcap, windows=windows,
                                     rope_sel=rope_sel, walsh=walsh)
    plan = _plan_of(x, mp, k_cache, q_dim, kv_dim, head_dim, bits, block_t,
                    qkv_cap_mb, lm, walsh)
    lib = kernel_library(mp, lm is not None,
                         gemma_call(mp, softcap, windows, rope_sel), bits,
                         walsh)
    out = launch_grouped(
        lib, f"ganq_{lib}", "megastep_lowbit_decode",
        x, mp, {"qkv": "qkv_pk", "o": "o_pk", "gu": "gu_pk", "dn": "dn_pk"},
        k_cache, v_cache, pos, cos_half, sin_half, bits=bits, kmajor=False,
        tq=plan["tq"], ti=plan["ti"], gs=_group_size(mp, H, walsh),
        Tb=plan["Tb"], q_dim=q_dim, kv_dim=kv_dim, head_dim=head_dim,
        rotary_dim=rotary_dim, interleaved=interleaved, eps=eps,
        rms_offset=rms_offset, scale=scale, act=act, lm=lm,
        fold_rows=fold_rows, softcap=softcap, windows=windows,
        rope_sel=rope_sel, walsh=walsh)
    megastep_lowbit_decode.launches += 1
    by = megastep_lowbit_decode.by_source
    by[lib] = by.get(lib, 0) + 1
    return out


megastep_lowbit_decode.launches = 0
# launches by kernel source (``kernel_library``), beside the total
megastep_lowbit_decode.by_source = {}

__all__ = ["megastep_lowbit_decode", "megastep_lowbit_plain",
           "lm_fold_plain", "lm_vocab_plain", "mega_lm_operands",
           "megapack_lowbit", "megapack_walsh", "walsh_coef", "walsh_linear",
           "megastep_lowbit_plan",
           "megastep_lowbit_fusable", "megastep_walsh_fusable", "_PLAN",
           "_plan_meta", "_mlp_plan"]
