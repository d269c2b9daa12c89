"""Whole decode step over all layers in one launch, symmetric W4A8 with
pair-nibble bytes (kernel 13).

The port of ``ganq_tpu/ops/megastep4.py``. One call runs every layer of a
homogeneous llama-family model whose four fused projections are symmetric
uniform 4-bit linears with one 128-multiple group size: per layer the
attention norm and int8 activations, the qkv product with bias and rope,
flash GQA attention over each slot's cache history, the o product and
residual, the MLP norm and int8 activations, gate/up, the activation, int8
activations per MLP tile and the down product, the tiles summed in order.
Every product is group-scaled: per group of ``gs`` columns the exact int32
dot ``z = x8 . (q - 8)`` times the group's bf16 scale, summed over the
groups in order in float32, then times the row's activation scale. The
residual stays float32 across the layers and is rounded to x's type after
the last one.

Operands come from :func:`megapack4` (the JAX package's keys, shapes and
byte layout): the qkv and gate/up codes pair rows ``(r, r + tile / 2)`` of
each row tile into one byte (``((q_hi ^ 8) << 4) | q_lo``, the low nibble
the tile's first half), o and down are K-major and pair columns
``(c, c + H / 2)``. Rope reads its partner lane rounded to bf16, as the TPU
kernel's sign-permutation product does.

:func:`megastep4_decode` launches ``csrc/megastep4.cu`` (``ganq_megastep4``,
one cooperative launch) for CUDA tensors and runs :func:`megastep4_plain`
only for CPU tensors. ``.launches`` counts kernel calls. The plain version
decodes the packs back into codes and shares its arithmetic with kernel 14's
(:func:`grouped_step_plain`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.backend import full_f32_matmul
from .fused_attention import rms_rows, rope_tile_operands
from .fused_layer import attn_out_int8, flash_rows
from .fused_mlp import activation
from .packing import unpack_int_rows
from .uniform_matmul import quantize_rows


def _qkv_tile4(Dqkv: int, d: int) -> Optional[int]:
    """Largest row tile t | Dqkv with t % d == 0 and (t/2) % 128 == 0."""
    for cand in (2560, 2048, 1280, 1024, 512, 256):
        if Dqkv % cand == 0 and cand % d == 0 and (cand // 2) % 128 == 0:
            return cand
    return None


def _mlp_tile4(I: int) -> int:
    """The MLP tile of kernel 13 (``megastep4.py:551``), baked into the
    pack: 2048 halved until it divides I with a 128-multiple half."""
    ti = 2048
    while I % ti or (ti // 2) % 128:
        ti //= 2
    return ti


def _to_int8(byte: torch.Tensor) -> torch.Tensor:
    return ((byte.to(torch.int32) + 128) % 256 - 128).to(torch.int8)


def _pair_rows(codes: torch.Tensor, tile: int) -> torch.Tensor:
    """[R, K] codes -> [R/2, K] bytes pairing rows (r, r + tile/2) of each
    row tile; the high nibble (the tile's second half) stored XOR 8."""
    R, K = codes.shape
    c = codes.to(torch.int32).reshape(R // tile, 2, tile // 2, K)
    lo = c[:, 0].reshape(R // 2, K)
    hi = c[:, 1].reshape(R // 2, K)
    return _to_int8(((hi ^ 8) << 4) | lo)


def _pair_cols(codes_t: torch.Tensor) -> torch.Tensor:
    """[K, N] codes -> [K, N/2] bytes pairing columns (c, c + N/2)."""
    N = codes_t.shape[1]
    c = codes_t.to(torch.int32)
    return _to_int8(((c[:, N // 2:] ^ 8) << 4) | c[:, :N // 2])


def _uniform_mats(sp, bits: int, zeros: bool = False):
    """The four fused linears of every layer, checked to be the uniform
    ``bits``-bit artifacts the whole-step kernels take: symmetric without
    o/gate-up/down biases, or, where ``zeros`` (kernel 14), with zero
    points, EoRA adapters and those biases."""
    later = ("g_idx",) if zeros else ("zeros", "g_idx", "lora_a")
    out = []
    for lp in sp.layers:
        mats = (lp.attn["qkv"], lp.attn["o"], lp.mlp["gateup"], lp.mlp["down"])
        for m in mats:
            if m.kind != "uniform" or m.bits != bits:
                raise ValueError(f"megapack: every linear must be uniform "
                                 f"{bits}-bit")
            for feature in later:
                if feature in m:
                    raise NotImplementedError(
                        f"megapack4: {feature!r} artifacts (asym zero points, "
                        "act-order, EoRA) are kernel 14's, not kernel 13's "
                        "(as in ganq_tpu: megapack_lowbit takes them)")
        if not zeros and any("bias" in m for m in mats[1:]):
            raise ValueError("megapack4: kernel 13 takes no o/gate-up/down "
                             "biases")
        out.append(mats)
    return out


def _codes(m) -> torch.Tensor:
    return unpack_int_rows(m["qweight"], m.bits, m.in_features)


def _scales_t(m) -> torch.Tensor:
    """[R, G] float32 scales -> [G, R] bf16 (the packs' scale layout)."""
    return m["scales"].to(torch.bfloat16).T.contiguous()


def _gu_layout(gsc: torch.Tensor, I: int, ti: int) -> torch.Tensor:
    """[G, 2I] -> tile-major columns (gate tile, then up tile)."""
    blocks = []
    for t in range(I // ti):
        blocks.append(gsc[:, t * ti:(t + 1) * ti])
        blocks.append(gsc[:, I + t * ti:I + (t + 1) * ti])
    return torch.cat(blocks, dim=1)


def _dn_layout(dsc: torch.Tensor, I: int, ti: int, gs: int) -> torch.Tensor:
    """[Gi, H] -> tile-major rows, each tile's groups padded to a multiple
    of 8 rows."""
    gti = ti // gs
    gtp = -(-gti // 8) * 8
    H = dsc.shape[1]
    d = dsc.reshape(I // ti, gti, H)
    if gtp != gti:
        d = torch.cat([d, d.new_zeros((I // ti, gtp - gti, H))], dim=1)
    return d.reshape(I // ti * gtp, H)


def out_rows(m) -> int:
    """Output rows of a uniform (``scales``) or ``lut`` linear."""
    return (m["scales"] if "scales" in m else m["lut"]).shape[0]


def common_pack_ops(sp, mats) -> Dict[str, torch.Tensor]:
    """Norms and the qkv bias, stacked (``megastep_lowbit.py:1686``, the
    operands every pack flavour shares on a llama model)."""
    L = len(mats)
    H = sp.layers[0].input_norm.weight.shape[0]
    Dqkv = out_rows(mats[0][0])
    dev = sp.layers[0].input_norm.weight.device

    def bias(qkv):
        return (qkv["bias"].to(torch.float32) if "bias" in qkv
                else torch.zeros(Dqkv, device=dev))

    return {
        "qkv_bias": torch.stack([bias(m[0]) for m in mats]).reshape(
            L, 1, Dqkv),
        "attn_norm": torch.stack([lp.input_norm.weight.to(torch.float32)
                                  for lp in sp.layers]).reshape(L, 1, H),
        "mlp_norm": torch.stack([lp.post_norm.weight.to(torch.float32)
                                 for lp in sp.layers]).reshape(L, 1, H),
    }


@torch.no_grad()
def megapack4(cfg, sp) -> Dict[str, torch.Tensor]:
    """Kernel 13's operands from a stacked model of uniform 4-bit fused
    linears (``serve/stacked.stack_layers``), byte-equal to the JAX
    package's ``megapack4``. Packs one layer at a time."""
    mats = _uniform_mats(sp, 4)
    H = cfg.hidden_size
    Dqkv = mats[0][0]["scales"].shape[0]
    I = mats[0][2]["scales"].shape[0] // 2
    gs = mats[0][3].in_features // mats[0][3]["scales"].shape[1]
    tq = _qkv_tile4(Dqkv, cfg.head_dim)
    ti = _mlp_tile4(I)
    out = {k: [] for k in ("qkv_p4", "qkv_s", "o_p4", "o_s", "gu_p4", "gu_s",
                           "dn_p4", "dn_s")}
    for qkv, o, gu, dn in mats:
        gcodes = _codes(gu)
        out["qkv_p4"].append(_pair_rows(_codes(qkv), tq))
        out["qkv_s"].append(_scales_t(qkv))
        out["o_p4"].append(_pair_cols(_codes(o).T))
        out["o_s"].append(_scales_t(o))
        out["gu_p4"].append(torch.cat([_pair_rows(gcodes[:I], ti),
                                       _pair_rows(gcodes[I:], ti)]))
        out["gu_s"].append(_gu_layout(_scales_t(gu), I, ti))
        out["dn_p4"].append(_pair_cols(_codes(dn).T))
        out["dn_s"].append(_dn_layout(_scales_t(dn), I, ti, gs))
    mp = {k: torch.stack(v) for k, v in out.items()}
    mp.update(common_pack_ops(sp, mats))
    return mp


def megastep4_fusable(cfg, sp) -> bool:
    """The JAX gate (``megastep4.py:642``) on the port's stacked model:
    qkv, o, gateup and down all ``uniform`` 4-bit, sequential symmetric
    groups of one 128-multiple size, no bias on o, gateup or down,
    head_dim 128, a hidden width that is a multiple of 256, no qk-norm,
    none of gemma's sandwich norms, attention softcap, sliding windows or
    dual rope, and a qkv tile. The JAX gate's other architecture conditions
    hold for every model the port builds."""
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
    if any("g_idx" in m or "lora_a" in m for m in mats):
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
    if cfg.head_dim != 128 or cfg.hidden_size % 256 or cfg.qk_norm:
        return False
    if (cfg.sandwich_norm or cfg.attn_softcap is not None
            or cfg.sliding_window is not None
            or cfg.rope_local_theta is not None):
        return False
    Dqkv = qkv["scales"].shape[0]
    kvd = (Dqkv - cfg.q_dim) // 2
    if cfg.q_dim + 2 * kvd != Dqkv or kvd % cfg.head_dim:
        return False
    return _qkv_tile4(Dqkv, cfg.head_dim) is not None


# ------------------------------------------------------------ plain versions
def nibble_rows(pk: torch.Tensor, tile: int, hi_first: bool) -> torch.Tensor:
    """Centred codes ``q - 8`` [R, K] (int32) of pair-nibble rows [R/2, K]:
    each byte holds rows (i, i + tile/2) of its row tile, the high nibble
    stored XOR 8 (kernel 14's planes keep the tile's first half in the high
    nibble, kernel 13's in the low one)."""
    b = pk.to(torch.int32)
    hi = (((b >> 4) & 15) ^ 8) - 8
    lo = (b & 15) - 8
    first, second = (hi, lo) if hi_first else (lo, hi)
    P, K = b.shape
    t2 = tile // 2
    return torch.stack([first.reshape(P // t2, t2, K),
                        second.reshape(P // t2, t2, K)], dim=1).reshape(
                            2 * P, K)


def nibble_cols(pk_t: torch.Tensor) -> torch.Tensor:
    """Centred codes [N, K] of K-major pair-column bytes [K, N/2]."""
    b = pk_t.to(torch.int32)
    return torch.cat([(b & 15) - 8, (((b >> 4) & 15) ^ 8) - 8], dim=1).T


def group_linear(x8: torch.Tensor, codes: torch.Tensor,
                 scales: torch.Tensor, gs: int,
                 sz: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole-step kernels' group-scaled product: x8 [B, K] (integers)
    and centred codes [R, K] -> [B, R] float32, the sum over the K / gs
    groups in order of ``s[g] * z_g`` with ``z_g`` the exact int32 group
    dot (float64 here, exact) and ``scales`` [G, R] bf16 or float32. With
    zero-point corrections ``sz`` [G, R] float32 each group adds
    ``s[g] * z_g + sz[g] * S_g``, ``S_g`` the group's activation sum."""
    B, K = x8.shape
    R = codes.shape[0]
    G = K // gs
    xg = x8.to(torch.float64).reshape(B, G, gs)
    z = torch.einsum("bgk,rgk->brg", xg,
                     codes.to(torch.float64).reshape(R, G, gs)
                     ).to(torch.float32)
    s = scales.to(torch.float32)
    if sz is not None:
        S = xg.sum(dim=2).to(torch.float32)
    y = torch.zeros((B, R), dtype=torch.float32, device=x8.device)
    for g in range(G):
        p = s[g] * z[:, :, g]
        if sz is not None:
            p = p + sz[g] * S[:, g:g + 1]
        y = y + p
    return y


def rope_rows_per_slot(y: torch.Tensor, cos_b: torch.Tensor,
                       sin_b: torch.Tensor, n_roped: int, head_dim: int,
                       rotary_dim: int, interleaved: bool,
                       partner_bf16: bool) -> torch.Tensor:
    """Rope on the first ``n_roped`` columns of y [B, Dqkv] with per-row
    tables cos/sin_b [B, rotary_dim / 2]: ``y * cos + rot * sin`` per head,
    where ``rot`` is the partner lane times +-1, read rounded to bf16 (kernel
    13, the sign-permutation product) or in float32 (kernel 14, lane
    rolls)."""
    if not rotary_dim:
        return y
    R, cmap, smap = rope_tile_operands(head_dim, head_dim, rotary_dim,
                                       interleaved)
    dev = y.device
    partner = torch.as_tensor(np.abs(R).argmax(axis=0), device=dev)
    sign = torch.as_tensor(R.sum(axis=0), dtype=torch.float32, device=dev)
    lane = torch.as_tensor(cmap >= 0, device=dev)
    idx = torch.as_tensor(np.where(cmap < 0, 0, cmap), device=dev)
    cos_l = torch.where(lane, cos_b.to(torch.float32)[:, idx], 1.0)[:, None]
    sin_l = torch.where(lane, sin_b.to(torch.float32)[:, idx], 0.0)[:, None]
    B = y.shape[0]
    sec = y[:, :n_roped].reshape(B, n_roped // head_dim, head_dim)
    src = sec.to(torch.bfloat16).to(torch.float32) if partner_bf16 else sec
    roped = sec * cos_l + (src[..., partner] * sign) * sin_l
    return torch.cat([roped.reshape(B, n_roped), y[:, n_roped:]], dim=1)


def qk_norm_rows(y: torch.Tensor, qk_nm: torch.Tensor, head_dim: int,
                 eps: float, rms_offset: float) -> torch.Tensor:
    """Kernel 14's per-head RMS of the float32 qkv rows y [B, Dqkv]
    (``megastep_lowbit.py:592-601``): each head's mean square over
    head_dim, then ``y * (rsqrt(msq + eps) * (w + rms_offset))`` on the
    lanes whose mask (``qk_nm[1]``) is set, y elsewhere; ``qk_nm`` [2, Dqkv]
    is the lane-expanded weight row over the mask row."""
    B, D = y.shape
    yh = y.reshape(B, D // head_dim, head_dim)
    msq = (yh * yh).sum(dim=-1, keepdim=True) * (1.0 / head_dim)
    w = qk_nm[0].reshape(D // head_dim, head_dim)
    m = qk_nm[1].reshape(D // head_dim, head_dim)
    f = torch.where(m != 0.0, torch.rsqrt(msq + eps) * (w + rms_offset), 1.0)
    return (yh * f).reshape(B, D)


def grouped_step_plain(x: torch.Tensor, layer_ops: Callable[[int], dict],
                       L: int, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       pos, cos_half: Optional[torch.Tensor],
                       sin_half: Optional[torch.Tensor], *, q_dim: int,
                       kv_dim: int, head_dim: int, rotary_dim: int,
                       interleaved: bool, eps: float, rms_offset: float,
                       scale: float, act: str, Tb: int, ti: int, gs: int,
                       partner_bf16: bool, windows=None, softcap: float = 0.0,
                       rope_sel=None):
    """The arithmetic kernels 13 and 14 share, on decoded operands.
    ``layer_ops(l)`` gives layer l's centred codes, [G, R] scales and
    zero-point corrections (``qkv``, ``o``, ``gate``, ``up``, ``down``:
    (codes, scales, sz or None)), its qkv ``bias``, its two norm weights
    and, for act-order packs, the column orders ``ap_q``/``ap_g``/``ap_o``
    (or None) through which the qkv, gate/up and o products read their
    activations, and for packs with EoRA adapters (kernel 14) their bf16
    factors ``la_q``/``lb_q``, ``la_o``/``lb_o``, ``la_g`` with ``lb_gate``
    and ``lb_up``, ``la_d``/``lb_d`` (in the pack's column orders), whose
    rank-r terms are float32 products at the TPU kernel's points
    (``megastep_lowbit.py:511-512, 587-591, 756-758, 772-774, 827-831,
    844-846, 876-877``): q's on the normed activation before its int8
    rows, added after the qkv bias and before rope; o's on the float
    attention output; gate/up's at the MLP norm, added before the
    activation; down's ``x @ A^T`` summed over the MLP tiles in tile order
    from each tile's float activation, and both o's and down's added to
    the product before the residual. Kernel 14's architecture operands
    come last at the same points (``megastep_lowbit.py:592-601, 759-760,
    833-836, 878-879``): ``qk_nm`` (:func:`qk_norm_rows`) after q's EoRA
    term and before rope; ``o_bias``, ``gate_bias``/``up_bias`` and
    ``dn_bias`` each after its product's EoRA term. Gemma's operands
    (``megastep_lowbit.py:670-672, 764-769, 883, 1094-1153, 1313-1322``):
    the sandwich norms ``pa_norm`` / ``pm_norm`` are RMS norms of the o and
    down outputs, after their bias and before the residual add; ``windows``
    [L] (a layer's window, T on full layers) masks each slot's keys at or
    before ``pos - window``; ``softcap`` caps the scaled scores;
    ``rope_sel`` [L] picks layer l's rope table from cos/sin_half [2, B,
    rotary_dim / 2] (0 the global, 1 the local). ``pos`` [B] holds each
    slot's history length; cos/sin_half are otherwise [rotary_dim / 2] or
    [B, rotary_dim / 2]. Where ``layer_ops(l)["walsh"]`` is set (kernel
    14's "wl8") each product is the Walsh walk of its codes and [8, R]
    coefficient rows (``megastep_lowbit.walsh_linear``; down's rows serve
    every MLP tile) in place of the group walk. Returns (y, the float32
    residual after the last layer; k_new, v_new [L, B, kv_dim] bf16)."""
    B, H = x.shape
    d = head_dim
    Hq, Hkv = q_dim // d, kv_dim // d
    T = k_cache.shape[2]
    pos_l = [int(p) for p in torch.as_tensor(pos).reshape(-1).expand(B)]
    if rotary_dim:
        n_tab = 1 if rope_sel is None else 2

        def tables(t):
            return t.to(torch.float32).reshape(n_tab, -1, rotary_dim // 2
                                               ).expand(n_tab, B, -1)

        cos_tabs, sin_tabs = tables(cos_half), tables(sin_half)
        sel = ([0] * L if rope_sel is None
               else [int(r) for r in torch.as_tensor(rope_sel).reshape(-1)])
    wins = (None if windows is None
            else [int(w) for w in torch.as_tensor(windows).reshape(-1)])
    xs = x.to(torch.float32)
    kns, vns = [], []
    def perm(v, order):
        return v if order is None else v[:, order]

    def rank_r(v, w):
        with full_f32_matmul():
            return v @ w.to(torch.float32).T

    for li in range(L):
        op = layer_ops(li)
        lora = "la_q" in op
        walsh = op.get("walsh", False)
        if walsh:
            from .megastep_lowbit import walsh_linear

            def linear(v, c, s, z):
                return walsh_linear(v, c, s)
        else:
            def linear(v, c, s, z):
                return group_linear(v, c, s, gs, z)
        xf = rms_rows(xs, op["attn_norm"], eps, rms_offset)
        x8, sx = quantize_rows(xf)
        c, s, z = op["qkv"]
        y = linear(perm(x8, op.get("ap_q")), c, s, z) * sx + op["bias"]
        if lora:
            y = y + rank_r(rank_r(perm(xf, op.get("ap_q")), op["la_q"]),
                           op["lb_q"])
        if "qk_nm" in op:
            y = qk_norm_rows(y, op["qk_nm"], d, eps, rms_offset)
        if rotary_dim:
            y = rope_rows_per_slot(y, cos_tabs[sel[li]], sin_tabs[sel[li]],
                                   q_dim + kv_dim, d, rotary_dim,
                                   interleaved, partner_bf16)
        qkv = y.to(torch.bfloat16)
        kn, vn = qkv[:, q_dim:q_dim + kv_dim], qkv[:, q_dim + kv_dim:]
        kns.append(kn)
        vns.append(vn)
        a = flash_rows(qkv[:, :q_dim].reshape(B, Hq, d),
                       k_cache[li].reshape(B, Hkv, T, d),
                       v_cache[li].reshape(B, Hkv, T, d),
                       kn.reshape(B, Hkv, d), vn.reshape(B, Hkv, d), pos_l,
                       scale, Tb, None if wins is None else wins[li], softcap)
        a8, sa = attn_out_int8(a.reshape(B, q_dim))
        c, s, z = op["o"]
        upd = linear(perm(a8, op.get("ap_o")), c, s, z) * sa
        if lora:
            af = perm(a.reshape(B, q_dim).to(torch.float32), op.get("ap_o"))
            upd = upd + rank_r(rank_r(af, op["la_o"]), op["lb_o"])
        if "o_bias" in op:
            upd = upd + op["o_bias"]
        if "pa_norm" in op:
            upd = rms_rows(upd, op["pa_norm"], eps, rms_offset)
        xs = xs + upd
        xf = perm(rms_rows(xs, op["mlp_norm"], eps, rms_offset),
                  op.get("ap_g"))
        x8, sx = quantize_rows(xf)
        if lora:
            xa_g = rank_r(xf, op["la_g"])
            xa_d = torch.zeros((B, op["la_d"].shape[0]), dtype=torch.float32,
                               device=x.device)
        dn_codes, dn_s, dn_sz = op["down"]
        I = dn_codes.shape[1]
        gti = ti // gs
        ma = torch.zeros((B, H), dtype=torch.float32, device=x.device)
        def tile(sel, rows):
            return None if sel is None else sel[rows]

        for t in range(I // ti):
            cols = slice(t * ti, (t + 1) * ti)
            gu = [linear(x8, c[cols], s[:, cols],
                         tile(z, (slice(None), cols))) * sx
                  for c, s, z in (op["gate"], op["up"])]
            if lora:
                gu = [g + rank_r(xa_g, op[k][cols])
                      for g, k in zip(gu, ("lb_gate", "lb_up"))]
            if "gate_bias" in op:
                gu = [g + op[k][cols] for g, k in zip(gu, ("gate_bias",
                                                           "up_bias"))]
            at = activation(gu[0], act) * gu[1]
            a8m, sam = quantize_rows(at)
            if lora:
                xa_d = xa_d + rank_r(at, op["la_d"][:, cols])
            grp = slice(t * gti, (t + 1) * gti)
            ma = ma + linear(a8m, dn_codes[:, cols],
                             dn_s if walsh else dn_s[grp],
                             tile(dn_sz, grp)) * sam
        if lora:
            ma = ma + rank_r(xa_d, op["lb_d"])
        if "dn_bias" in op:
            ma = ma + op["dn_bias"]
        if "pm_norm" in op:
            ma = rms_rows(ma, op["pm_norm"], eps, rms_offset)
        xs = xs + ma
    return xs, torch.stack(kns), torch.stack(vns)


def _layer_ops4(mp: Dict[str, torch.Tensor], ti: int, tq: int, gs: int):
    """Layer l's decoded operands of a :func:`megapack4` pack."""
    I = mp["gu_p4"].shape[1]
    NG = I // ti
    gtp = mp["dn_s"].shape[1] // NG

    def ops(l):
        gcodes = mp["gu_p4"][l]
        gsc = mp["gu_s"][l].reshape(-1, NG, 2, ti)
        return {
            "qkv": (nibble_rows(mp["qkv_p4"][l], tq, False), mp["qkv_s"][l],
                    None),
            "o": (nibble_cols(mp["o_p4"][l]), mp["o_s"][l], None),
            "gate": (nibble_rows(gcodes[:I // 2], ti, False),
                     gsc[:, :, 0].reshape(-1, I), None),
            "up": (nibble_rows(gcodes[I // 2:], ti, False),
                   gsc[:, :, 1].reshape(-1, I), None),
            "down": (nibble_cols(mp["dn_p4"][l]),
                     mp["dn_s"][l].reshape(NG, gtp, -1)[:, :ti // gs]
                     .reshape(I // gs, -1), None),
            "bias": mp["qkv_bias"][l, 0], "attn_norm": mp["attn_norm"][l, 0],
            "mlp_norm": mp["mlp_norm"][l, 0]}
    return ops


def _plan4(x, mp, k_cache, head_dim, block_t):
    """(tq, ti, gs, Tb) of a kernel 13 call, as ``megastep4.py:378-388``."""
    H = x.shape[1]
    Dqkv = mp["qkv_p4"].shape[1] * 2
    T = k_cache.shape[2]
    Tb = min(block_t, T)
    while T % Tb:
        Tb //= 2
    return (_qkv_tile4(Dqkv, head_dim), _mlp_tile4(mp["gu_p4"].shape[1]),
            H // mp["qkv_s"].shape[1], Tb)


def megastep4_plain(x: torch.Tensor, mp: Dict[str, torch.Tensor],
                    k_cache: torch.Tensor, v_cache: torch.Tensor, pos,
                    cos_half: Optional[torch.Tensor],
                    sin_half: Optional[torch.Tensor], *, q_dim: int,
                    kv_dim: int, head_dim: int, rotary_dim: int = 0,
                    interleaved: bool = False, eps: float = 1e-5,
                    rms_offset: float = 0.0, scale: float = 1.0,
                    act: str = "silu", block_t: int = 128):
    """Plain version of kernel 13, with the kernel's arithmetic. Shapes as
    :func:`megastep4_decode`."""
    tq, ti, gs, Tb = _plan4(x, mp, k_cache, head_dim, block_t)
    y, kn, vn = grouped_step_plain(
        x, _layer_ops4(mp, ti, tq, gs), mp["qkv_p4"].shape[0], k_cache,
        v_cache, pos, cos_half, sin_half, q_dim=q_dim, kv_dim=kv_dim,
        head_dim=head_dim, rotary_dim=rotary_dim, interleaved=interleaved,
        eps=eps, rms_offset=rms_offset, scale=scale, act=act, Tb=Tb, ti=ti,
        gs=gs, partner_bf16=True)
    return y.to(x.dtype), kn, vn


def megastep4_decode(x: torch.Tensor, mp: Dict[str, torch.Tensor],
                     k_cache: torch.Tensor, v_cache: torch.Tensor, pos,
                     cos_half: Optional[torch.Tensor],
                     sin_half: Optional[torch.Tensor], *, q_dim: int,
                     kv_dim: int, head_dim: int, rotary_dim: int = 0,
                     interleaved: bool = False, eps: float = 1e-5,
                     rms_offset: float = 0.0, scale: float = 1.0,
                     act: str = "silu", block_t: int = 128):
    """Kernel 13, one decode step over all layers. x [B, H] (B <= 8, the
    embedded current token); ``mp`` from :func:`megapack4`; k/v_cache
    [L, B * Hkv, T, d] bf16 (slot b's history below ``pos[b]``; ``pos`` a
    host int, a 0-d or a [B] int tensor); cos/sin_half [rotary_dim / 2] or
    [B, rotary_dim / 2] at each slot's position. Returns (y [B, H], the
    hidden state before the final norm, in x's type; k_new and v_new
    [L, B, kv_dim] bf16)."""
    B, H = x.shape
    if B > 8:
        raise ValueError("megastep4_decode: B <= 8")
    if x.device.type == "cpu":
        return megastep4_plain(x, mp, k_cache, v_cache, pos, cos_half,
                               sin_half, q_dim=q_dim, kv_dim=kv_dim,
                               head_dim=head_dim, rotary_dim=rotary_dim,
                               interleaved=interleaved, eps=eps,
                               rms_offset=rms_offset, scale=scale, act=act,
                               block_t=block_t)
    from .megastep_lowbit import launch_grouped

    tq, ti, gs, Tb = _plan4(x, mp, k_cache, head_dim, block_t)
    y, kn, vn = launch_grouped(
        "megastep4", "ganq_megastep4", "megastep4_decode", x, mp,
        {"qkv": "qkv_p4", "o": "o_p4", "gu": "gu_p4", "dn": "dn_p4"},
        k_cache, v_cache, pos, cos_half, sin_half, bits=4, kmajor=True,
        tq=tq, ti=ti, gs=gs, Tb=Tb, q_dim=q_dim, kv_dim=kv_dim,
        head_dim=head_dim, rotary_dim=rotary_dim, interleaved=interleaved,
        eps=eps, rms_offset=rms_offset, scale=scale, act=act)
    megastep4_decode.launches += 1
    return y, kn, vn


megastep4_decode.launches = 0

__all__ = ["megastep4_decode", "megastep4_plain", "megapack4",
           "megastep4_fusable", "grouped_step_plain", "group_linear"]
