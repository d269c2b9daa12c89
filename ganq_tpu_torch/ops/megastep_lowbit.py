"""Gates of the plane-packed whole-step kernels (kernel 14, not ported).

``ganq_tpu/ops/megastep_lowbit.py`` serves homogeneous uniform W4/W3/W2/W8
models ("w4p", "w3", "w2", "w8p") and true 8-entry 3-bit codebooks ("wl8",
the Walsh plane expansion) at decode batch <= 64 through
``megastep_lowbit_decode``, which the port has not yet ported (``ROADMAP.md``
queue B). The port keeps its own copies of the gates
(:func:`megastep_lowbit_fusable`, :func:`megastep_walsh_fusable`) and of the
plans and tile rules they read, so that ``serve/stacked.mega_enabled``
routes a request exactly as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

from .packing import pack_factor

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


__all__ = ["megastep_lowbit_fusable", "megastep_walsh_fusable", "_PLAN",
           "_plan_meta", "_mlp_plan"]
