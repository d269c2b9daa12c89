"""Whole decode step over all layers in one launch, plane-packed uniform
weights (kernel 14), and the gates of its variants.

The port of ``ganq_tpu/ops/megastep_lowbit.py``. ``ganq_tpu`` serves
homogeneous uniform W4/W3/W2/W8 models ("w4p", "w3", "w2", "w8p") and true
8-entry 3-bit codebooks ("wl8", the Walsh plane expansion) at decode batch
<= 64 through ``megastep_lowbit_decode``. The port has the "w4p" and "w8p"
variants, with zero points and act-order: :func:`megapack_lowbit` packs the
JAX package's planes (keys, shapes and bytes) and zero-point corrections,
:func:`actorder_transform` bakes act-order artifacts into a pack-only copy
and gives the column orders of the activations, and
:func:`megastep_lowbit_decode` launches ``csrc/megastep_lowbit.cu``
(``ganq_megastep_lowbit``, one cooperative launch; packs with zero points or
act-order ``csrc/megastep_lowbit_opt.cu``) for CUDA tensors and runs
:func:`megastep_lowbit_plain` only for CPU tensors; ``.launches``
counts kernel calls. It raises NotImplementedError naming the feature for
every operand of a later sub-slice: w3/w2, the Walsh LUTs, EoRA, biases,
qk-norm, sandwich norms, windows, softcap and the trailing-unembed lm fold.

The arithmetic is kernel 13's (``ops/megastep4.grouped_step_plain``): each
product sums, over its groups in order, the group's bf16 scale times the
exact int32 dot of the int8 activations with the centred codes ``q -
2^(bits-1)`` (plus, with zero points, the group's correction ``sz`` times
its activation sum, ``megastep_lowbit.py:479-494``). Two things differ from kernel 13: rope reads its partner lane
in float32 (the TPU kernel rotates by lane rolls, ``_rope_rot``), and the
MLP tile comes from :func:`_mlp_plan` (4096 for w4p and 2048 for w8p at
Llama-3.2-3B widths). The flash block Tb follows the JAX wrapper's plan,
which may halve it where the TPU's VMEM estimate is exceeded
(:func:`megastep_lowbit_plan`).

The gates (:func:`megastep_lowbit_fusable`, :func:`megastep_walsh_fusable`)
and the plans and tile rules they read are copies, so that
``serve/stacked.mega_enabled`` routes a request exactly as the JAX package
does.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from .megastep4 import (_codes, _dn_layout, _gu_layout, _scales_t,
                        _uniform_mats, common_pack_ops, grouped_step_plain,
                        nibble_rows)
from .packing import pack_factor, pack_int_rows, unpack_int_rows

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


def _arch_fusable_common(cfg) -> bool:
    """The architecture surface of the plane kernels
    (``megastep_lowbit.py:1905``) for the port's llama models: head_dim 128
    (the remaining conditions hold for every llama model the port builds)."""
    return cfg.head_dim == 128


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
    8-entry codebooks and exact-width packs, lane-aligned field blocks and
    tiles."""
    mats = _fused(sp)
    if mats is None:
        return False
    qkv, o, gu, dn = mats
    if any(m.kind != "lut" or m.bits != 3 for m in mats):
        return False
    if any(m["lut"].shape[-1] != 8 for m in mats):
        return False
    for m in mats:
        if m["idx_packed"].shape[-1] * pack_factor(3) != m.in_features:
            return False
    if not _arch_fusable_common(cfg):
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
    all four projections ``uniform`` at ``bits``, act-order only at
    power-of-two widths, zeros laid out as the scales, one 128-multiple
    group size, lane-aligned field blocks and tiles."""
    if bits not in _PLAN:
        return False
    _, _, _, g_r = _plan_meta(bits)
    mats = _fused(sp)
    if mats is None:
        return False
    qkv, o, gu, dn = mats
    if any(m.kind != "uniform" or m.bits != bits for m in mats):
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
    if not _arch_fusable_common(cfg):
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
    norms; where any projection has zero points, the float32 corrections
    ``qkv_sz``, ``o_sz``, ``gu_sz`` and ``dn_sz`` in the scales' layouts.
    Bits 4 and 8; packs one layer at a time. Act-order artifacts go through
    :func:`actorder_transform` first (ValueError here)."""
    if bits not in (4, 8):
        raise NotImplementedError(
            f"megapack_lowbit: {bits}-bit planes (w3/w2) are a later slice of "
            "the port (ROADMAP.md queue B)")
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
    mp.update(common_pack_ops(sp, mats))
    return mp


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
    match, so no activation of down is permuted at run time. Where the
    JAX package routes activations through Beneš lane masks
    (``ops/lane_perm.py``), a gather through the indices gives the same
    values. The ORIGINAL ``sp`` keeps serving prefill (its artifacts keep
    g_idx). Raises ValueError on unbalanced groups."""
    from ..models.transformer import Layer, Model
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
            codes = unpack_int_rows(m["qweight"], m.bits, m.in_features)
            arrays["qweight"] = pack_int_rows(
                codes[:, torch.as_tensor(col, device=dev).long()], m.bits)
        if row is not None:
            I = m["scales"].shape[0] // 2
            rp = torch.as_tensor(row, device=dev).long()
            full = torch.cat([rp, rp + I])
            for k in ("qweight", "scales", "zeros", "bias"):
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
                            mlp))
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
                         qkv_cap_mb: int = 12) -> Dict[str, int]:
    """The JAX wrapper's run-time plan (``megastep_lowbit.py:966-1087``) for
    a model without optional operands: the qkv tile ``tq``, the MLP tile
    ``ti`` (baked into the pack), the tiles per grid step ``ptq``/``ptg``
    and the flash block ``Tb``: ``block_t`` at most T, halved until it
    divides T, then halved again (or ptg, then ptq, cut) while the TPU's
    VMEM estimate exceeds its budget. Tb and ti set rounding points."""
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
        est += 2 * B * H + 2 * 2 * 2 * B * kv_dim + 4 * BGp_ * 128
        est += 2 * B * H
        est += (4 * B * H + B * H + 4 * Bp * 128
                + 2 * (Hq + 2 * Hkv) * Bp * d + 4 * Hq * Bp * d
                + 2 * 4 * Hq * Bp * 128 + Bp * max(q_dim, ti) + 4 * B * H)
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


def _plan_of(x, mp, k_cache, q_dim, kv_dim, head_dim, bits, block_t,
             qkv_cap_mb):
    _, _, _, g_r = _plan_meta(bits)
    H = x.shape[1]
    return megastep_lowbit_plan(
        x.shape[0], H, q_dim, kv_dim, head_dim, k_cache.shape[2],
        mp["qkv_pk"].shape[1] * g_r, mp["gu_s"].shape[2] // 2, bits,
        H // mp["qkv_s"].shape[1], block_t, qkv_cap_mb)


# --------------------------------------------------------------- the step
def _plane_codes(pk: torch.Tensor, tile: int, bits: int) -> torch.Tensor:
    """Centred codes ``q - 2^(bits-1)`` [R, K] of 4- or 8-bit planes: an
    8-bit plane byte read signed is the centred code; a 4-bit plane holds
    the tile's first row block in its high nibble."""
    if bits == 8:
        return pk.to(torch.int32)
    return nibble_rows(pk, tile, True)


def _layer_ops_lb(mp: Dict[str, torch.Tensor], bits: int, tq: int, ti: int,
                  gs: int):
    """Layer l's decoded operands of a :func:`megapack_lowbit` pack."""
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

    def ops(l):
        gpk = mp["gu_pk"][l]
        gs_, us_ = gate_up("gu_s", l)
        gz, uz = gate_up("gu_sz", l) if zp else (None, None)
        return {
            "qkv": (_plane_codes(mp["qkv_pk"][l], tq, bits), mp["qkv_s"][l],
                    mp["qkv_sz"][l] if zp else None),
            "o": (_plane_codes(mp["o_pk"][l], H, bits), mp["o_s"][l],
                  mp["o_sz"][l] if zp else None),
            "gate": (_plane_codes(gpk[:Pi], ti, bits), gs_, gz),
            "up": (_plane_codes(gpk[Pi:], ti, bits), us_, uz),
            "down": (_plane_codes(mp["dn_pk"][l], H, bits), down("dn_s", l),
                     down("dn_sz", l) if zp else None),
            "bias": mp["qkv_bias"][l, 0], "attn_norm": mp["attn_norm"][l, 0],
            "mlp_norm": mp["mlp_norm"][l, 0],
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
                          bits: int = 4, qkv_cap_mb: int = 12):
    """Plain version of kernel 14 ("w4p", "w8p"), with the kernel's
    arithmetic. Shapes as :func:`megastep_lowbit_decode`."""
    plan = _plan_of(x, mp, k_cache, q_dim, kv_dim, head_dim, bits, block_t,
                    qkv_cap_mb)
    gs = x.shape[1] // mp["qkv_s"].shape[1]
    return grouped_step_plain(
        x, _layer_ops_lb(mp, bits, plan["tq"], plan["ti"], gs),
        mp["qkv_pk"].shape[0], k_cache, v_cache, pos, cos_half, sin_half,
        q_dim=q_dim, kv_dim=kv_dim, head_dim=head_dim, rotary_dim=rotary_dim,
        interleaved=interleaved, eps=eps, rms_offset=rms_offset, scale=scale,
        act=act, Tb=plan["Tb"], ti=plan["ti"], gs=gs, partner_bf16=False)


# operands of kernel 14's later sub-slices and what each serves
_LATER_OPERANDS = {"la_q": "EoRA adapters", "qk_nm": "qk-norm",
                   "pa_norm": "sandwich norms",
                   "o_bias": "o/gate-up/down biases"}


def _later_feature(mp, bits: int, softcap=0.0, windows=None,
                   rope_sel=None, lm=None, walsh: int = 0) -> Optional[str]:
    """The first feature of a kernel 14 call that a later slice of the port
    brings, or None."""
    if walsh:
        return "the Walsh LUT planes (wl8)"
    if bits not in (4, 8):
        return f"{bits}-bit planes (w3/w2)"
    for key, what in _LATER_OPERANDS.items():
        if key in mp:
            return what
    if windows is not None:
        return "sliding windows"
    if softcap:
        return "the attention softcap"
    if rope_sel is not None:
        return "dual rope tables"
    if lm is not None:
        return "the trailing-unembed lm fold"
    return None


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
                   eps: float, rms_offset: float, scale: float, act: str):
    """Check the operands of a whole-step kernel 13 or 14 call and launch it
    (``csrc/<library>.cu``). ``keys`` names the pack's code operands. The
    kernel reads x and writes y in float32; y is returned in x's type."""
    from .w8a8_args import ACT_CODES, launch

    B, H = x.shape
    d = head_dim
    Hkv = kv_dim // d
    F = 2 if bits == 4 else 1
    qkv_pk, o_pk, gu_pk, dn_pk = (mp[keys[k]] for k in ("qkv", "o", "gu",
                                                        "dn"))
    L = qkv_pk.shape[0]
    Dqkv = qkv_pk.shape[1] * F
    I = mp["gu_s"].shape[2] // 2
    T = k_cache.shape[2]
    rd = rotary_dim or 0
    if (d != 128 or Dqkv != q_dim + 2 * kv_dim or (q_dim // d) % Hkv
            or q_dim // d // Hkv > 8 or H % (128 * F) or gs % 128
            or H % gs or q_dim % gs or ti % gs or I % ti or Tb > 256
            or T % Tb or rd % 2 or rd > d or act not in ACT_CODES):
        raise ValueError(f"{what}: head_dim 128, at most 8 query heads per kv "
                         "head, 128-multiple groups and tiles")
    if (k_cache.shape != (L, B * Hkv, T, d) or v_cache.shape != k_cache.shape
            or k_cache.dtype != torch.bfloat16
            or v_cache.dtype != torch.bfloat16
            or not k_cache.is_contiguous() or not v_cache.is_contiguous()):
        raise ValueError(f"{what}: contiguous bf16 caches [L, B * Hkv, T, d]")
    for name, t in ((keys["qkv"], qkv_pk), (keys["o"], o_pk),
                    (keys["gu"], gu_pk), (keys["dn"], dn_pk)):
        if t.dtype != torch.int8 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous int8")
    for name in ("qkv_s", "o_s", "gu_s", "dn_s"):
        if mp[name].dtype != torch.bfloat16 or not mp[name].is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous bf16")
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
    ng = I // ti
    cos_t, sin_t = rope_rows_for(cos_half, sin_half, B, rd, dev)
    y = torch.empty((B, H), dtype=torch.float32, device=dev)
    kn = torch.empty((L, B, kv_dim), dtype=torch.bfloat16, device=dev)
    vn = torch.empty((L, B, kv_dim), dtype=torch.bfloat16, device=dev)
    scratch = functools.partial(torch.empty, device=dev)
    launch(library, symbol, what, dict(
        x=x.to(torch.float32).contiguous(), attn_norm=mp["attn_norm"],
        mlp_norm=mp["mlp_norm"], qkv_bias=mp["qkv_bias"], cos_half=cos_t,
        sin_half=sin_t, k_cache=k_cache, v_cache=v_cache,
        pos=pos_vector(pos, B, dev), qkv_pk=qkv_pk, o_pk=o_pk, gu_pk=gu_pk,
        dn_pk=dn_pk, qkv_gs=mp["qkv_s"], o_gs=mp["o_s"], gu_gs=mp["gu_s"],
        dn_gs=mp["dn_s"], y=y, kn=kn, vn=vn,
        qkv_out=scratch((B, Dqkv), dtype=torch.bfloat16),
        x8=scratch((B, H), dtype=torch.int8),
        sx=scratch((B,), dtype=torch.float32),
        xs=scratch((B, H), dtype=torch.float32),
        act_a=scratch((B, I), dtype=torch.float32),
        amax=scratch((B, ng), dtype=torch.int32),
        a8=scratch((B, max(q_dim, I)), dtype=torch.int8),
        attn=scratch((B, q_dim), dtype=torch.float32),
        attn_amax=scratch((B * Hkv,), dtype=torch.float32),
        partf=(scratch((max(q_dim, I) // gs, B, H), dtype=torch.float32)
               if kmajor else None), **extra), dev,
        B=B, H=H, q_dim=q_dim, kv_dim=kv_dim, d=d, rd=rd,
        interleaved=int(interleaved), I=I, ti=ti, T=T, Tb=Tb, L=L,
        act=ACT_CODES[act], eps=eps, rms_offset=rms_offset, scale=scale,
        cache_sb=Hkv * T * d, cache_sg=T * d, cache_st=d,
        cache_sl=B * Hkv * T * d, gs=gs, bits=bits, tq=tq,
        gtp=mp["dn_s"].shape[1] // ng, cos_ld=rd // 2, kmajor=int(kmajor))
    return y.to(x.dtype), kn, vn


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
                           qkv_cap_mb: int = 12):
    """Kernel 14, one decode step over all layers ("w4p" at ``bits=4``,
    "w8p" at ``bits=8``). x [B, H] (B <= 64, the embedded current token);
    ``mp`` from :func:`megapack_lowbit`, with the zero-point corrections
    ``*_sz`` and the act-order orders ``ap_*`` (:func:`actorder_transform`)
    where the model has them; k/v_cache [L, B * Hkv, T, d] bf16 (slot b's
    history below ``pos[b]``; ``pos`` a host int, a 0-d or a [B] int
    tensor); cos/sin_half [rotary_dim / 2] or [B, rotary_dim / 2] at each
    slot's position. Returns (y [B, H], the hidden state before the final
    norm, in x's type; k_new and v_new [L, B, kv_dim] bf16). The other
    arguments are the JAX wrapper's; each of them, and every other optional
    operand of ``mp``, raises NotImplementedError naming its feature."""
    B, H = x.shape
    if B > 64:
        raise ValueError("megastep_lowbit_decode: B <= 64")
    later = _later_feature(mp, bits, softcap, windows, rope_sel, lm, walsh)
    if later:
        raise NotImplementedError(
            f"megastep_lowbit_decode: {later} comes with a later slice of the "
            "port (ROADMAP.md queue B)")
    if x.device.type == "cpu":
        return megastep_lowbit_plain(x, mp, k_cache, v_cache, pos, cos_half,
                                     sin_half, q_dim=q_dim, kv_dim=kv_dim,
                                     head_dim=head_dim, rotary_dim=rotary_dim,
                                     interleaved=interleaved, eps=eps,
                                     rms_offset=rms_offset, scale=scale,
                                     act=act, block_t=block_t, bits=bits,
                                     qkv_cap_mb=qkv_cap_mb)
    plan = _plan_of(x, mp, k_cache, q_dim, kv_dim, head_dim, bits, block_t,
                    qkv_cap_mb)
    # packs with zero points or act-order run the kernel's other
    # instantiation (csrc/megastep_lowbit_opt.cu)
    lib = ("megastep_lowbit_opt" if "qkv_sz" in mp or "ap_q" in mp
           else "megastep_lowbit")
    y, kn, vn = launch_grouped(
        lib, f"ganq_{lib}", "megastep_lowbit_decode",
        x, mp, {"qkv": "qkv_pk", "o": "o_pk", "gu": "gu_pk", "dn": "dn_pk"},
        k_cache, v_cache, pos, cos_half, sin_half, bits=bits, kmajor=False,
        tq=plan["tq"], ti=plan["ti"], gs=H // mp["qkv_s"].shape[1],
        Tb=plan["Tb"], q_dim=q_dim, kv_dim=kv_dim, head_dim=head_dim,
        rotary_dim=rotary_dim, interleaved=interleaved, eps=eps,
        rms_offset=rms_offset, scale=scale, act=act)
    megastep_lowbit_decode.launches += 1
    return y, kn, vn


megastep_lowbit_decode.launches = 0

__all__ = ["megastep_lowbit_decode", "megastep_lowbit_plain",
           "megapack_lowbit", "megastep_lowbit_plan",
           "megastep_lowbit_fusable", "megastep_walsh_fusable", "_PLAN",
           "_plan_meta", "_mlp_plan"]
