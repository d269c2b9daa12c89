"""Gate of the pair-nibble W4A8 whole-step kernel (kernel 13, not ported).

``ganq_tpu/ops/megastep4.py`` serves homogeneous symmetric uniform 4-bit
models at decode batch <= 8 through ``megastep4_decode``, which the port has
not yet ported (``ROADMAP.md`` queue B). The port keeps its own copy of the
gate, :func:`megastep4_fusable`, so that ``serve/stacked.mega_enabled``
routes a request exactly as the JAX package does and the engine can name the
kernel it lacks.
"""

from __future__ import annotations

from typing import Optional


def _qkv_tile4(Dqkv: int, d: int) -> Optional[int]:
    """Largest row tile t | Dqkv with t % d == 0 and (t/2) % 128 == 0."""
    for cand in (2560, 2048, 1280, 1024, 512, 256):
        if Dqkv % cand == 0 and cand % d == 0 and (cand // 2) % 128 == 0:
            return cand
    return None


def megastep4_fusable(cfg, sp) -> bool:
    """The JAX gate (``megastep4.py:642``) on the port's stacked model:
    qkv, o, gateup and down all ``uniform`` 4-bit, sequential symmetric
    groups of one 128-multiple size, no bias on o, gateup or down,
    head_dim 128, a hidden width that is a multiple of 256, and a qkv tile.
    The JAX gate's architecture conditions hold for every llama model the
    port builds."""
    if sp is None or not len(sp.layers):
        return False
    lp = sp.layers[0]
    qkv = lp.attn["qkv"] if "qkv" in lp.attn else None
    o = lp.attn["o"] if "o" in lp.attn else None
    gu = lp.mlp["gateup"] if "gateup" in lp.mlp else None
    dn = lp.mlp["down"] if "down" in lp.mlp else None
    if qkv is None or o is None or gu is None or dn is None:
        return False
    mats = (qkv, o, gu, dn)
    if any(m.kind != "uniform" or m.bits != 4 for m in mats):
        return False
    if any("g_idx" in m for m in mats):
        return False
    if any("bias" in m for m in (o, gu, dn)):
        return False
    gss = set()
    for m in mats:
        if "zeros" in m:
            return False
        gs = m.in_features // m["scales"].shape[-1]
        if gs % 128 or m.in_features % gs:
            return False
        gss.add(gs)
    if len(gss) != 1:
        return False
    if cfg.head_dim != 128 or cfg.hidden_size % 256:
        return False
    Dqkv = qkv["scales"].shape[0]
    kvd = (Dqkv - cfg.q_dim) // 2
    if cfg.q_dim + 2 * kvd != Dqkv or kvd % cfg.head_dim:
        return False
    return _qkv_tile4(Dqkv, cfg.head_dim) is not None


__all__ = ["megastep4_fusable"]
