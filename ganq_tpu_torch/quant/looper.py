"""Layer-wise sequential PTQ engine, for GANQ and GPTQ.

The port of ``ganq_tpu/quant/looper.py`` (the reference's hook-driven
``ModuleLooper.loop``, ``gptqmodel/looper/module_looper.py:129-443``): the
layer forward returns submodule-input taps directly, and the engine is a
plain loop:

    layer-0 inputs = embed(calib)
    for layer:
      for subset in layer_modules:                 (true_sequential order)
        taps  = layer_forward(layer, x, want_taps)  # with the current weights
        H     = accumulate(taps[subset])
        quantize the subset's linears -> fake-quant weights, in place
      x = layer_forward(layer, x)                  # next layer's inputs

Per-module artifacts (GANQ codebooks and codes; GPTQ codes, scales, zeros
and g_idx) are collected for the packer; dense weights are replaced by their
fake-quant values, so later subsets and layers see quantized outputs, as in
the reference (gptq_processor.py:193). With an adapter rank
(``QuantizeConfig.adapter={"rank": r}``, per module through ``dynamic``)
each module also gets its EoRA adapter (``adapter/eora.compute_eora`` of
the quantization error under the module's activation covariance), and its
fake-quant weight takes the correction ``B @ A``, so later layers see the
corrected outputs (reference eora_processor.py:119-159). The other methods
(AutoRound, QQQ), rotation, the lm_head pass and pre-embedded (multimodal)
calibration rows raise ``NotImplementedError`` naming the queue item that
brings them.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..adapter.eora import compute_eora
from ..core.backend import full_f32_matmul
from ..core.config import QUANT_METHOD, QuantizeConfig
from ..models import hf_import
from ..models.registry import ArchSpec
from ..models.transformer import (Layer, Model, ModelConfig, embed,
                                  layer_forward, rope_for_layer,
                                  rope_tables_all, sandwich_norms)
from ..ops import qlinear
from ..utils.logger import get_logger
from ..utils.observability import quant_log_table
from .ganq import ganq_quantize
from .gptq import gptq_quantize
from .hessian import HessianAccumulator

log = get_logger(__name__)

_ARRAY_FIELDS = ("lut", "idx", "qidx", "scale", "zero", "g_idx", "lora_a",
                 "lora_b")
_PORTED_METHODS = (QUANT_METHOD.GANQ, QUANT_METHOD.GPTQ)


@dataclass
class ModuleQuantLog:
    layer: int
    module: str
    method: str
    loss: float
    damp: float
    duration: float
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class QuantizedModule:
    """Solver artifact for one linear, consumed by the packer (the GANQ and
    GPTQ fields of the JAX package's artifact)."""
    method: QUANT_METHOD
    bits: int
    group_size: int
    # ganq
    lut: Optional[torch.Tensor] = None       # [out, 2^bits] float32
    idx: Optional[torch.Tensor] = None       # [out, in] int32
    # gptq
    qidx: Optional[torch.Tensor] = None      # [out, in] int32
    scale: Optional[torch.Tensor] = None     # [out, n_groups]
    zero: Optional[torch.Tensor] = None      # [out, n_groups]
    g_idx: Optional[torch.Tensor] = None     # [in] int32
    # EoRA adapter (optional)
    lora_a: Optional[torch.Tensor] = None    # [rank, in] float32
    lora_b: Optional[torch.Tensor] = None    # [out, rank] float32


@dataclass
class QuantizeOutput:
    model: Model                                 # fake-quantized weights
    artifacts: Dict[str, QuantizedModule]        # full module name -> artifact
    log: List[ModuleQuantLog]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with ROADMAP.md queue A item 5 "
        "(adapters and other quantizers)")


def _full_name(spec: ArchSpec, layer_idx: int, module_name: str) -> str:
    return f"{spec.layers_prefix}.{layer_idx}.{module_name}"


def _adapter_rank(qcfg: QuantizeConfig, full_name: str) -> int:
    """A module's EoRA rank: ``qcfg.adapter["rank"]``, overridden per module
    by ``dynamic`` (reference config.py:341-357); 0 for none."""
    if not qcfg.adapter:
        return 0
    rank = int(qcfg.adapter.get("rank", 0))
    dyn = qcfg.dynamic_get(full_name, "adapter", default=None, sub_key="rank")
    if isinstance(dyn, (int, float)):
        rank = int(dyn)
    return rank


def _check_supported(eff: QuantizeConfig, full: str) -> None:
    if eff.quant_method not in _PORTED_METHODS:
        raise _not_ported(f"{full}: quant_method={eff.quant_method}")


def _save_layer_state(resume_dir: str, li: int,
                      layer_arts: Dict[str, QuantizedModule],
                      layer_weights: Dict[str, torch.Tensor]) -> None:
    """Layer ``li``'s artifacts and fake-quant weights as one npz (the JAX
    package's file layout, so either package resumes the other's run)."""
    os.makedirs(resume_dir, exist_ok=True)
    blobs: Dict[str, np.ndarray] = {}
    for name, art in layer_arts.items():
        blobs[f"{name}::method"] = np.asarray(str(art.method))
        blobs[f"{name}::bits"] = np.asarray(art.bits)
        blobs[f"{name}::group_size"] = np.asarray(art.group_size)
        for f in _ARRAY_FIELDS:
            if getattr(art, f) is not None:
                blobs[f"{name}::{f}"] = getattr(art, f).cpu().numpy()
    for slot, w in layer_weights.items():
        blobs[f"__w__::{slot}"] = w.float().cpu().numpy()
    tmp = os.path.join(resume_dir, f"layer_{li}.tmp.npz")   # savez adds .npz
    np.savez(tmp, **blobs)
    os.replace(tmp, os.path.join(resume_dir, f"layer_{li}.npz"))


def _load_layer_state(resume_dir: str, li: int, device):
    path = os.path.join(resume_dir, f"layer_{li}.npz")
    if not os.path.isfile(path):
        return None
    data = np.load(path, allow_pickle=False)
    weights: Dict[str, torch.Tensor] = {}
    fields: Dict[str, Dict[str, Any]] = {}
    for key in data.files:
        name, f = key.split("::", 1)
        if name == "__w__":
            weights[f] = torch.from_numpy(data[key]).to(device)
        else:
            fields.setdefault(name, {})[f] = data[key]
    arts = {}
    for name, fd in fields.items():
        method = QUANT_METHOD(str(fd["method"]))
        if method not in _PORTED_METHODS:
            raise _not_ported(f"{path}: resuming {method} artifacts")
        arts[name] = QuantizedModule(
            method=method, bits=int(fd["bits"]),
            group_size=int(fd["group_size"]),
            **{f: torch.from_numpy(fd[f]).to(device) for f in _ARRAY_FIELDS
               if f in fd})
    return arts, weights


def _set_weight(lin: qlinear.QLinear, w: torch.Tensor) -> None:
    setattr(lin, "weight", w.to(lin["weight"].dtype))


def quantize_model(cfg: ModelConfig, model: Model, spec: ArchSpec,
                   qcfg: QuantizeConfig,
                   calib_batches: Sequence[np.ndarray],
                   codebook_init_fn=None,
                   resume_dir: Optional[str] = None) -> QuantizeOutput:
    """Quantize every layer's linears in place (fake-quant) and collect the
    artifacts. ``calib_batches``: int [batch, seq] token-id arrays.
    ``resume_dir``: per-layer results are checkpointed there, and a crashed
    run resumes after the last completed layer.

    Each module's ``ModuleQuantLog.extra`` holds its seconds per solver
    phase (GANQ: ``prepare``, ``init``, ``s_step``, ``t_step``, ``final``
    and ``fallback``; GPTQ: ``prepare``, ``columns``, ``trailing``,
    ``final``; with an adapter rank also ``eora``); the first module of
    each subset also holds ``hessian``, the subset's Hessian capture."""
    if qcfg.rotation:
        raise _not_ported("rotation")
    if cfg.num_experts:
        raise NotImplementedError(
            "quantizing a MoE model (per-expert routed Hessian taps) is not "
            "ported yet: it comes first in ROADMAP.md queue A item 6")
    if qcfg.lm_head:
        if model.lm_head is None:
            # reference module_looper.py:131-135
            raise NotImplementedError(
                "lm_head quantization requires untied weights "
                "(tie_word_embeddings=False)")
        raise _not_ported("lm_head quantization (its 8-bit GPTQ default)")
    device = model.embed_tokens.weight.device
    subsets: List[List[str]] = spec.layer_modules
    if not qcfg.true_sequential:
        subsets = [[m for sub in spec.layer_modules for m in sub]]

    acts: List[torch.Tensor] = []
    ropes: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for batch in calib_batches:
        arr = np.asarray(batch)
        if not np.issubdtype(arr.dtype, np.integer):
            raise NotImplementedError(
                "pre-embedded calibration rows are not ported yet (the VL "
                "slice, ROADMAP.md queue A item 7)")
        ids = torch.as_tensor(arr, dtype=torch.int64, device=device)
        b, s = ids.shape
        acts.append(embed(cfg, model, ids))
        ropes.append(rope_tables_all(cfg, torch.arange(s, device=device)
                                     .expand(b, s)))
    nsamples = sum(int(a.shape[0]) for a in acts)

    artifacts: Dict[str, QuantizedModule] = {}
    qlog: List[ModuleQuantLog] = []
    with torch.inference_mode():
        for li in range(cfg.num_hidden_layers):
            lp = model.layers[li]
            t_layer = time.perf_counter()
            restored = (_load_layer_state(resume_dir, li, device)
                        if resume_dir is not None else None)
            if restored is not None:
                layer_arts, layer_weights = restored
                artifacts.update(layer_arts)
                for slot, w in layer_weights.items():
                    _set_weight(hf_import.get_module(model, li, slot), w)
                log.info(f"layer {li}: restored from {resume_dir}")
            else:
                layer_arts, layer_weights = _quantize_layer(
                    cfg, spec, qcfg, model, li, subsets, acts, ropes,
                    nsamples, codebook_init_fn, qlog)
                artifacts.update(layer_arts)
                if resume_dir is not None:
                    _save_layer_state(resume_dir, li, layer_arts, layer_weights)
            acts = [layer_forward(cfg, lp, x, None,
                                  rope_for_layer(cfg, rope, li),
                                  window=cfg.layer_window(li))
                    for x, rope in zip(acts, ropes)]
            log.info(f"layer {li} done in {time.perf_counter() - t_layer:.1f}s")

    log.info("quantization summary:\n" + quant_log_table(qlog))
    return QuantizeOutput(model=model, artifacts=artifacts, log=qlog)


def _quantize_one(W: torch.Tensor, H: torch.Tensor, eff: QuantizeConfig,
                  nsamples: int, codebook_init_fn, phases: Dict[str, float]):
    """One linear through its method's solver: (solver result, artifact)."""
    if eff.quant_method == QUANT_METHOD.GANQ:
        r = ganq_quantize(W, H, eff, nsamples,
                          codebook_init_fn=codebook_init_fn, timings=phases)
        return r, QuantizedModule(method=QUANT_METHOD.GANQ, bits=eff.bits,
                                  group_size=eff.group_size, lut=r.lut,
                                  idx=r.idx)
    r = gptq_quantize(W, H, eff, nsamples, timings=phases)
    return r, QuantizedModule(method=eff.quant_method, bits=eff.bits,
                              group_size=eff.group_size, qidx=r.qidx,
                              scale=r.scale, zero=r.zero, g_idx=r.g_idx)


def _quantize_layer(cfg: ModelConfig, spec: ArchSpec, qcfg: QuantizeConfig,
                    model: Model, li: int, subsets: List[List[str]],
                    acts: List[torch.Tensor], ropes, nsamples: int,
                    codebook_init_fn, qlog: List[ModuleQuantLog]):
    """Quantize layer ``li`` subset by subset; returns its artifacts and
    fake-quant weights by slot."""
    lp = model.layers[li]
    layer_arts: Dict[str, QuantizedModule] = {}
    layer_weights: Dict[str, torch.Tensor] = {}
    device = acts[0].device
    for subset in subsets:
        todo: List[Tuple[str, str, QuantizeConfig]] = []
        for mod in subset:
            slot = spec.module_slots[mod]
            full = _full_name(spec, li, mod)
            if hf_import.get_module(model, li, slot) is None:
                continue
            eff = qcfg.for_module(full)
            if eff is None:
                log.info(f"layer {li}: skipping {mod} (dynamic exclude)")
                continue
            _check_supported(eff, full)
            todo.append((mod, slot, eff))
        if not todo:
            continue

        # one Hessian per distinct tap (q/k/v share their input)
        t0 = time.perf_counter()
        accs: Dict[str, HessianAccumulator] = {}
        for x, rope in zip(acts, ropes):
            _, taps = layer_forward(cfg, lp, x, None,
                                    rope_for_layer(cfg, rope, li),
                                    want_taps=True,
                                    window=cfg.layer_window(li))
            for _, slot, _ in todo:
                if slot not in accs:
                    accs[slot] = HessianAccumulator(taps[slot].shape[-1], device)
                accs[slot].update(taps[slot])
        H_by_slot = {s: a.finalize() for s, a in accs.items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        hessian_s = time.perf_counter() - t0

        for mod, slot, eff in todo:
            H = H_by_slot[slot]
            if float(torch.sum(torch.abs(torch.diagonal(H)))) == 0.0:
                log.warning(f"layer {li}: {mod} saw no activations; skipped")
                continue
            t0 = time.perf_counter()
            lin = hf_import.get_module(model, li, slot)
            phases: Dict[str, float] = {}
            r, art = _quantize_one(lin["weight"], H, eff, nsamples,
                                   codebook_init_fn, phases)
            full = _full_name(spec, li, mod)
            Wq = r.Q
            rank = _adapter_rank(qcfg, full)
            if rank:
                t1 = time.perf_counter()
                cov = accs[slot].acc / max(accs[slot].nsamples, 1)
                A, B = compute_eora(lin["weight"].to(torch.float32)
                                    - Wq.to(torch.float32), cov, rank)
                art.lora_a, art.lora_b = A, B
                with full_f32_matmul():
                    Wq = Wq.to(torch.float32) + B @ A
                phases["eora"] = time.perf_counter() - t1
            _set_weight(lin, Wq)
            layer_arts[full] = art
            layer_weights[slot] = lin["weight"]
            extra: Dict[str, Any] = dict(phases)
            if art.method == QUANT_METHOD.GANQ:
                extra["fallback"] = r.fallback
            if hessian_s is not None:
                extra["hessian"], hessian_s = hessian_s, None
            dur = time.perf_counter() - t0
            qlog.append(ModuleQuantLog(
                layer=li, module=mod, method=str(eff.quant_method),
                loss=r.avg_loss, damp=r.damp_used, duration=dur, extra=extra))
            log.info(f"layer {li:3d} {mod:22s} loss={r.avg_loss:10.4f} "
                     f"damp={r.damp_used:.4f} time={dur:5.1f}s")
    return layer_arts, layer_weights


def _packed(art: QuantizedModule, bias) -> qlinear.QLinear:
    if art.lut is not None:
        ql = qlinear.lut_linear(art.lut, art.idx, art.bits, bias)
    else:
        ql = qlinear.uniform_linear(art.qidx, art.scale, art.zero, art.g_idx,
                                    art.bits, bias)
    if art.lora_a is not None:
        ql.register_buffer("lora_a", art.lora_a)
        ql.register_buffer("lora_b", art.lora_b)
    return ql


def packed_params(spec: ArchSpec, out: QuantizeOutput) -> Model:
    """The quantized model with every artifact realized as a packed linear
    (GANQ: ``lut``; GPTQ: ``uniform``; EoRA adapters attached), sharing
    every other tensor with
    ``out.model``: the in-memory equivalent of the save -> load round
    trip."""
    model = out.model
    layers = []
    for li, lp in enumerate(model.layers):
        groups = {"attn": dict(lp.attn.items()), "mlp": dict(lp.mlp.items())}
        for mod, slot in spec.module_slots.items():
            art = out.artifacts.get(_full_name(spec, li, mod))
            group, name = slot.split(".")
            old = groups[group].get(name)
            if art is None or old is None:
                continue
            groups[group][name] = _packed(
                art, old["bias"] if "bias" in old else None)
        layers.append(Layer(lp.input_norm.weight, lp.post_norm.weight,
                            groups["attn"], groups["mlp"],
                            **sandwich_norms(lp)))
    lm_head = model.lm_head
    art = out.artifacts.get(spec.lm_head_name)
    if art is not None and lm_head is not None:
        lm_head = _packed(art, lm_head["bias"] if "bias" in lm_head else None)
    return Model(model.embed_tokens.weight, model.final_norm.weight, layers,
                 lm_head)


__all__ = ["quantize_model", "packed_params", "QuantizeOutput",
           "QuantizedModule", "ModuleQuantLog"]
