"""One MoE layer's routed-expert MLP for decode-shaped rows (kernel 15).

The port of ``ganq_tpu/ops/moe_expert.py``. After ``optimize()`` a MoE
layer whose experts are uniform 4- or 8-bit linears carries a plane-packed
copy of its experts (:func:`moe_megapack`, the JAX package's keys, shapes
and bytes), and ``models/transformer._moe_combine`` sends every decode step
of at most 32 token rows on ``"cuda_a8"`` through :func:`moe_expert_decode`:
S = min(E, rows * top_k) expert slots (the top-S experts by routed mass,
``slot_ids`` on the device) and per-slot routing weights ``wts`` [B, S]
give

    y = sum over slots s, MLP tiles t (in that order) of
        wts[:, s] * sa_t * (a8_t . down_e[:, tile t]),
    a = act(sx * x8 . gate_e) * (sx * x8 . up_e),  a8_t, sa_t = int8(a_t)

with the megasteps' activation-quantization points: x to int8 per row, the
activation to int8 per row over each MLP tile of ``ti`` columns (from
``megastep_lowbit._mlp_plan``: 2048 at 8 bits and 3584 at 4 bits for
Mixtral-8x7B's widths), and every product group-scaled (per group of ``gs``
columns the exact int32 dot of the centred codes, times the bf16 scale,
summed over the groups in order in float32). Slots beyond the routed
experts carry zero weight; their weights are read all the same.

:func:`moe_expert_decode` launches ``csrc/moe_expert.cu``
(``ganq_moe_expert``) for CUDA tensors and runs :func:`moe_expert_plain`
only for CPU tensors; ``.launches`` counts kernel calls. The gate
:func:`moe_mega_fusable` is the JAX package's.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .megastep4 import _dn_layout, _gu_layout, _scales_t, group_linear
from .megastep_lowbit import _mlp_plan, _plan_meta, _plane_codes, _plane_pack
from .fused_mlp import activation
from .packing import unpack_int_rows
from .uniform_matmul import quantize_rows


def moe_mega_fusable(cfg, moe, bits: int) -> bool:
    """The JAX gate (``moe_expert.py:259``): every expert's gate/up/down a
    symmetric uniform ``bits``-bit linear with sequential 128-multiple
    groups and no bias or adapter, one intermediate width, widths that the
    planes tile, and top-k routing (the only router the port has)."""
    experts = moe["experts"] if "experts" in moe else None
    if not experts or bits not in (2, 3, 4, 8):
        return False
    _, _, _, g_r = _plan_meta(bits)
    H = cfg.hidden_size
    if H % (g_r * 128):
        return False
    I = None
    for e in experts:
        for k in ("gate", "up", "down"):
            m = e[k] if k in e else None
            if m is None or m.kind != "uniform" or m.bits != bits:
                return False
            if any(x in m for x in ("zeros", "g_idx", "lora_a", "bias")):
                return False
            gs = m.in_features // m["scales"].shape[-1]
            if gs % 128 or m.in_features % gs:
                return False
        Ie = e["gate"]["scales"].shape[0]
        if I is None:
            I = Ie
        elif I != Ie:
            return False
        if e["up"]["scales"].shape[0] != Ie or e["down"].in_features != Ie:
            return False
        if I % (g_r * 128):
            return False
    ti = _mlp_plan(I, bits, H)[0]
    return ti is not None and I // ti >= 1


@torch.no_grad()
def moe_megapack(cfg, moe, bits: int) -> Dict[str, torch.Tensor]:
    """Kernel 15's operands from a layer's experts, byte-equal to the JAX
    package's ``moe_megapack``: ``gate_pk`` [E, 2 I / F, H] int8 (each
    expert's gate tiles, then its up tiles at tile index + NG), ``gu_s``
    [E, G, 2 I] bf16 (tile-interleaved gate and up scales), ``dn_pk``
    [E, H / F, I] and ``dn_s`` [E, NG * gtp, H] (each tile's groups padded to
    a multiple of 8 rows); F = 8 / bits."""
    H = cfg.hidden_size
    experts = moe["experts"]
    I = experts[0]["gate"]["scales"].shape[0]
    ti = _mlp_plan(I, bits, H)[0]
    gs = H // experts[0]["gate"]["scales"].shape[-1]

    def pack(m, tile):
        return _plane_pack(unpack_int_rows(m["qweight"], bits, m.in_features),
                           tile, bits)

    out = {"gate_pk": [], "gu_s": [], "dn_pk": [], "dn_s": []}
    for e in experts:
        out["gate_pk"].append(torch.cat([pack(e["gate"], ti),
                                         pack(e["up"], ti)]))
        out["gu_s"].append(_gu_layout(torch.cat(
            [_scales_t(e["gate"]), _scales_t(e["up"])], dim=1), I, ti))
        out["dn_pk"].append(pack(e["down"], H))
        out["dn_s"].append(_dn_layout(_scales_t(e["down"]), I, ti, gs))
    return {k: torch.stack(v) for k, v in out.items()}


def _geometry(mp, H: int, bits: int):
    """(E, I, ti, NG, gs, gtp) of a :func:`moe_megapack` pack."""
    metas, _, _, g_r = _plan_meta(bits)
    E = mp["gate_pk"].shape[0]
    I = mp["gate_pk"].shape[1] * g_r // len(metas) // 2
    ti = _mlp_plan(I, bits, H)[0]
    NG = I // ti
    gs = H // mp["gu_s"].shape[1]
    return E, I, ti, NG, gs, mp["dn_s"].shape[1] // NG


def moe_expert_plain(x: torch.Tensor, mp: Dict[str, torch.Tensor],
                     slot_ids: torch.Tensor, wts: torch.Tensor, *,
                     bits: int = 4, act: str = "silu") -> torch.Tensor:
    """Plain version of kernel 15, with the kernel's arithmetic. Shapes as
    :func:`moe_expert_decode`."""
    B, H = x.shape
    _, I, ti, NG, gs, gtp = _geometry(mp, H, bits)
    gti = ti // gs
    x8, sx = quantize_rows(x.to(torch.float32))
    w = wts.to(torch.float32)
    acc = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    for s, e in enumerate(slot_ids.tolist()):
        codes = _plane_codes(mp["gate_pk"][e], ti, bits)           # [2I, H]
        gsc = mp["gu_s"][e].reshape(-1, NG, 2, ti)
        dcodes = _plane_codes(mp["dn_pk"][e], H, bits)             # [H, I]
        dsc = mp["dn_s"][e].reshape(NG, gtp, H)
        for t in range(NG):
            rows = slice(t * ti, (t + 1) * ti)
            g = group_linear(x8, codes[rows], gsc[:, t, 0], gs) * sx
            u = group_linear(x8, codes[I:][rows], gsc[:, t, 1], gs) * sx
            a8, sa = quantize_rows(activation(g, act) * u)
            y = group_linear(a8, dcodes[:, rows], dsc[t, :gti], gs)
            acc = acc + y * sa * w[:, s:s + 1]
    return acc


class MoeArgs(ctypes.Structure):
    """``csrc/moe_expert.cu``'s argument block (same field order)."""
    _fields_ = ([(n, ctypes.c_int) for n in ("B", "H", "I", "ti", "S", "gs",
                                            "bits", "act", "gtp")]
                + [(n, ctypes.c_void_p) for n in (
                    "x", "slot_ids", "wts", "gate_pk", "gu_s", "dn_pk",
                    "dn_s", "y", "x8", "sx", "act_a", "amax", "a8")])


def moe_expert_decode(x: torch.Tensor, mp: Dict[str, torch.Tensor],
                      slot_ids: torch.Tensor, wts: torch.Tensor, *,
                      bits: int = 4, act: str = "silu") -> torch.Tensor:
    """Kernel 15: one MoE layer's routed-expert MLP. x [B, H] (B <= 32);
    ``mp`` from :func:`moe_megapack`; ``slot_ids`` [S] int expert index per
    slot (repeats allowed; padded slots carry zero weight), read by the
    kernel from device memory; ``wts`` [B, S] float32 routing weights in
    slot order. Returns y [B, H] float32."""
    from . import cuda_lib
    from .w8a8_args import ACT_CODES

    B, H = x.shape
    if x.device.type == "cpu":
        return moe_expert_plain(x, mp, slot_ids, wts, bits=bits, act=act)
    if B > 32 or bits not in (4, 8) or act not in ACT_CODES:
        raise ValueError("moe_expert_decode: B <= 32, bits 4 or 8")
    E, I, ti, NG, gs, gtp = _geometry(mp, H, bits)
    S = slot_ids.shape[0]
    F = 2 if bits == 4 else 1
    if (H % (128 * F) or gs % 128 or ti % gs or H > 8192 or ti > 8192
            or wts.shape != (B, S) or S > E):
        raise ValueError("moe_expert_decode: 128-multiple groups and tiles, "
                         "H and ti <= 8192, wts [B, S]")
    for name, dtype in (("gate_pk", torch.int8), ("dn_pk", torch.int8),
                        ("gu_s", torch.bfloat16), ("dn_s", torch.bfloat16)):
        if mp[name].dtype != dtype or not mp[name].is_contiguous():
            raise ValueError(f"moe_expert_decode: {name} must be contiguous "
                             f"{dtype}")
    dev = x.device
    ids = slot_ids.to(device=dev, dtype=torch.int32).contiguous()
    w = wts.to(device=dev, dtype=torch.float32).contiguous()
    xf = x.to(torch.float32).contiguous()
    y = torch.empty((B, H), dtype=torch.float32, device=dev)
    scratch = {"x8": torch.empty((B, H), dtype=torch.int8, device=dev),
               "sx": torch.empty((B,), dtype=torch.float32, device=dev),
               "act_a": torch.empty((S, B, I), dtype=torch.float32,
                                    device=dev),
               "amax": torch.empty((S, B, NG), dtype=torch.int32, device=dev),
               "a8": torch.empty((S, B, I), dtype=torch.int8, device=dev)}
    tensors = dict(x=xf, slot_ids=ids, wts=w, gate_pk=mp["gate_pk"],
                   gu_s=mp["gu_s"], dn_pk=mp["dn_pk"], dn_s=mp["dn_s"], y=y,
                   **scratch)
    args = MoeArgs(B=B, H=H, I=I, ti=ti, S=S, gs=gs, bits=bits,
                   act=ACT_CODES[act], gtp=gtp)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"moe_expert_decode: {name} is on {t.device}")
        setattr(args, name, t.data_ptr())
    fn = cuda_lib.function("moe_expert", "ganq_moe_expert",
                           [ctypes.POINTER(MoeArgs), ctypes.c_void_p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_lib.check(fn(ctypes.byref(args), stream), "moe_expert_decode")
    moe_expert_decode.launches += 1
    return y


moe_expert_decode.launches = 0

__all__ = ["moe_expert_decode", "moe_expert_plain", "moe_megapack",
           "moe_mega_fusable"]
