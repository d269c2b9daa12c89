"""GPTQ uniform solver.

The port of ``ganq_tpu/quant/gptq.py`` (the reference's blocked
error-compensating loop, ``gptqmodel/quantization/gptq.py:164-236``): blocks
of 128 columns, a per-column loop inside each block that quantizes a column
and pushes its error onto the block's later columns, and a trailing float32
product that pushes the block's errors onto every later column. Group
scale/zero discovery, static groups, the act-order bookkeeping and the loss
accounting follow the JAX package. The JAX package has no Pallas kernel
here, and the port owes none: the solver is plain PyTorch on W's device, as
the reference's own GPTQ is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..core.backend import full_f32_matmul
from ..core.config import QuantizeConfig
from . import quantizer as qz
from .ganq import _Phases
from .preamble import prepare

BLOCKSIZE = 128


@dataclass
class GPTQResult:
    Q: torch.Tensor            # [m, n] fake-quantized weight, original order
    scale: torch.Tensor        # [m, n_groups]
    zero: torch.Tensor         # [m, n_groups]
    g_idx: torch.Tensor        # [n] int32 column -> group map
    avg_loss: float
    damp_used: float
    nsamples: int
    qidx: Optional[torch.Tensor] = None  # [m, n] int32 codes, original order


def _masked_find_params(W_ref: torch.Tensor, start: int, gs: int, n: int, *,
                        bits: int, sym: bool, mse: float):
    """find_params over W_ref[:, start:start+gs] with the columns past the
    end masked to 0 (the window is clamped to end at n, as JAX's
    dynamic_slice clamps it); masking is exact for the search, since min/max
    pass through 0 and quantizing 0 costs nothing."""
    cs = min(start, n - gs)
    sl = W_ref[:, cs:cs + gs]
    col_ids = cs + torch.arange(gs, device=W_ref.device)
    sl = torch.where(col_ids[None, :] >= start, sl, 0.0)
    p = qz.find_params(sl, bits=bits, sym=sym, mse=mse)
    return p.scale, p.zero


def _gptq_core(W: torch.Tensor, Hinv: torch.Tensor, perm: Optional[list],
               phases: _Phases, *, bits: int, sym: bool, mse: float,
               group_size: int, static_groups: bool, use_perm_groups: bool):
    """The blocked loop on the (already permuted) W. Returns (Q, Qidx, the
    summed loss as a 0-d tensor, scales, zeros), scales and zeros per group
    in processing order."""
    m, n = W.shape
    dev = W.device
    maxq = 2**bits - 1
    # a group wider than the module degrades to one group
    gs = min(group_size, n) if group_size != -1 else n
    n_groups = -(-n // gs)
    scales = torch.zeros((m, n_groups), dtype=torch.float32, device=dev)
    zeros = torch.zeros((m, n_groups), dtype=torch.float32, device=dev)
    if group_size == -1:
        # one quantizer from the raw W, never refreshed
        p = qz.find_params(W, bits=bits, sym=sym, mse=mse)
        scales, zeros = p.scale, p.zero
    elif static_groups:
        # per-group params from the whole (post-perm) W before the loop
        for g in range(n_groups):
            s, z = _masked_find_params(W, g * gs, gs, n, bits=bits, sym=sym,
                                       mse=mse)
            scales[:, g] = s[:, 0]
            zeros[:, g] = z[:, 0]

    W = W.clone()
    Q = torch.zeros_like(W)
    Qidx = torch.zeros(W.shape, dtype=torch.int32, device=dev)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    cur_scale, cur_zero = scales[:, 0:1], zeros[:, 0:1]
    for i1 in range(0, n, BLOCKSIZE):
        i2 = min(i1 + BLOCKSIZE, n)
        Wb = W[:, i1:i2].clone()
        Hb = Hinv[i1:i2, i1:i2]
        dvec = torch.diagonal(Hb)
        qs, qis, errs, diffs = [], [], [], []
        for i in range(i2 - i1):
            col = i1 + i
            if group_size != -1 and not static_groups:
                if col % gs == 0:
                    # group params from the block-start snapshot W, not from
                    # the live (error-updated) column
                    cur_scale, cur_zero = _masked_find_params(
                        W, col, gs, n, bits=bits, sym=sym, mse=mse)
                    scales[:, col // gs] = cur_scale[:, 0]
                    zeros[:, col // gs] = cur_zero[:, 0]
            elif group_size != -1:
                # static groups: with desc_act keyed by the original column
                g = (perm[col] if use_perm_groups else col) // gs
                cur_scale, cur_zero = scales[:, g:g + 1], zeros[:, g:g + 1]
            s1, z1 = cur_scale[:, 0], cur_zero[:, 0]
            w = Wb[:, i]
            qf = torch.clamp(torch.round(w / s1) + z1, 0, maxq)
            q = s1 * (qf - z1)
            diff = w - q
            err = diff / dvec[i]
            qs.append(q)
            qis.append(qf)
            errs.append(err)
            diffs.append(diff)
            # the error onto the block's later columns
            Wb[:, i + 1:] -= err[:, None] * Hb[i, i + 1:][None, :]
        Qb = torch.stack(qs, dim=1)
        Errb = torch.stack(errs, dim=1)
        Q[:, i1:i2] = Qb
        Qidx[:, i1:i2] = torch.stack(qis, dim=1).to(torch.int32)
        loss += torch.sum(torch.stack(diffs, dim=1) ** 2 / dvec ** 2 / 2.0)
        phases.mark("columns")
        if i2 < n:
            with full_f32_matmul():
                W[:, i2:] -= Errb @ Hinv[i1:i2, i2:]
        W[:, i1:i2] = Qb
        phases.mark("trailing")
    return Q, Qidx, loss, scales, zeros


def gptq_quantize(W: torch.Tensor, H: torch.Tensor, qcfg: QuantizeConfig,
                  nsamples: int,
                  timings: Optional[Dict[str, float]] = None) -> GPTQResult:
    """Preamble, blocked loop and the act-order bookkeeping on W's device.
    ``Q`` is the fake-quantized weight in the original column order,
    ``scale``/``zero`` are per group (processing order) and ``g_idx`` maps
    original columns to groups. ``timings``, when given, accumulates seconds
    per phase (``prepare``, ``columns``, ``trailing``, ``final``)."""
    phases = _Phases(timings, W.device)
    prep = prepare(W, H, qcfg)
    phases.mark("prepare")
    act_sort = qcfg.resolved_act_sort()
    use_perm_groups = bool(qcfg.static_groups and qcfg.desc_act
                           and prep.perm is not None)
    perm = prep.perm.tolist() if use_perm_groups else None
    Q, Qidx, loss, scales, zeros = _gptq_core(
        prep.W, prep.Hinv, perm, phases, bits=qcfg.bits, sym=qcfg.sym,
        mse=qcfg.mse, group_size=qcfg.group_size,
        static_groups=qcfg.static_groups, use_perm_groups=use_perm_groups)

    n = W.shape[1]
    gs = min(qcfg.group_size, n) if qcfg.group_size != -1 else n
    if use_perm_groups:
        g_idx = prep.perm // gs
    else:
        g_idx = torch.arange(n, device=W.device) // gs
    if prep.invperm is not None and act_sort != "none":
        # restore the original column order (always, as the JAX package
        # does, also for act_sort without desc_act)
        Q = Q[:, prep.invperm]
        Qidx = Qidx[:, prep.invperm]
        g_idx = g_idx[prep.invperm]
    avg_loss = float(loss) / nsamples
    phases.mark("final")
    phases.close()
    if np.isnan(avg_loss):
        raise FloatingPointError(
            "GPTQ: NaN loss — increase damp or calibration data.")
    return GPTQResult(Q=Q, scale=scales, zero=zeros,
                      g_idx=g_idx.to(torch.int32), avg_loss=avg_loss,
                      damp_used=prep.damp_used, nsamples=nsamples, qidx=Qidx)


__all__ = ["GPTQResult", "gptq_quantize", "BLOCKSIZE"]
