"""Quantized checkpoint save/load for the ``lut`` and GPTQ formats.

The port of the ``lut`` and GPTQ parts of ``ganq_tpu/formats/checkpoint.py``
(llama-family and mixtral models; a MoE layer's experts are stored under the
HF expert names, its router dense; biases, qwen3's and gemma3's q/k norms
and gemma's sandwich norms unquantized under their HF names):
a directory of (possibly sharded) safetensors files plus
``quantize_config.json``, ``config.json`` (with ``quantization_config``
mirrored in) and ``quant_log.csv``. A ``lut`` linear is stored as
``{module}.lut`` fp16 [out, 2^bits] (sorted per row) and
``{module}.idx_packed`` int32 [out, in/packfactor] (planar codes); a
``uniform`` linear in the GPTQ v1 (``format="gptq"``, zeros stored minus one)
or v2 layout (``formats/gptq_compat.py``: ``qweight``, ``qzeros`` and
``g_idx`` int32, ``scales`` fp16). A freshly quantized model is written from
its solver artifacts, as the JAX writer does; a packed ``lut`` model from
its bf16 codebooks. EoRA adapters go beside them in the PEFT layout
(``adapter_model.safetensors``: ``base_model.model.{module}.lora_A.weight``
[r, in] and ``lora_B.weight`` [out, r] in fp16, and
``adapter_config.json``), written from the artifacts or, after a post-quant
``eora_generate``, by :func:`save_adapter`, and attached in float32 at
load. A directory written by either package loads in the other.
:func:`save_dense` writes an unquantized model as an HF checkpoint
directory.
"""

from __future__ import annotations

import csv
import hashlib
import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..core.backend import resolve_device
from ..core.config import FORMAT, META_QUANTIZER_GANQ_TPU, QuantizeConfig
from ..models import hf_import
from ..models.registry import ArchSpec, get_spec
from ..models.transformer import QK_NORMS, Model, ModelConfig, sandwich_norms
from ..ops import qlinear
from ..ops.packing import pack_factor, pack_int_rows, unpack_int_rows
from ..utils.logger import get_logger
from . import gptq_compat
from .safetensors_io import load_file, save_file

log = get_logger(__name__)

MAX_SHARD_BYTES = 4 * 1024**3


def _hf_module_prefix(spec: ArchSpec, layer_idx: int, module_name: str) -> str:
    """HF module prefix ("model.layers.0.self_attn.q_proj") of a layer's
    quantizable module, from the name_map entry of its slot's weight."""
    slot = spec.module_slots[module_name]
    tpl = spec.name_map[f"layers.{{i}}.{slot}.weight"]
    return tpl.format(i=layer_idx).rsplit(".weight", 1)[0]


def _linear_state(prefix: str, p: qlinear.QLinear) -> Dict[str, torch.Tensor]:
    """Checkpoint tensors of one linear: the weight of a dense one, the
    sorted fp16 codebook and unpadded planar codes of a ``lut`` one."""
    out: Dict[str, torch.Tensor] = {}
    if p.kind == "dense":
        out[f"{prefix}.weight"] = p["weight"]
    elif p.kind == "lut":
        lut = p["lut"].to(torch.float16)
        packed = p["idx_packed"]
        padded = packed.shape[1] * pack_factor(p.bits) != p.in_features
        unsorted = bool(torch.any(lut[:, 1:] < lut[:, :-1]))
        if padded or unsorted:
            codes = unpack_int_rows(packed, p.bits, p.in_features).to(torch.int64)
            order = torch.argsort(lut, dim=1, stable=True)
            rank = torch.argsort(order, dim=1, stable=True)
            lut = torch.take_along_dim(lut, order, dim=1)
            packed = pack_int_rows(torch.take_along_dim(rank, codes, dim=1),
                                   p.bits)
        out[f"{prefix}.lut"] = lut
        out[f"{prefix}.idx_packed"] = packed
    else:
        raise NotImplementedError(
            f"saving a packed kind={p.kind} linear: uniform checkpoints are "
            "written from GPTQ solver artifacts, as in the JAX package")
    if "bias" in p:
        out[f"{prefix}.bias"] = p["bias"]
    return out


def _artifact_state(prefix: str, art: Any,
                    v1: bool) -> Dict[str, torch.Tensor]:
    """Checkpoint tensors of one freshly quantized linear, from its solver
    artifact as the JAX writer takes them: a GANQ codebook goes straight to
    fp16, is sorted per row (stable) and the codes remapped; GPTQ codes,
    scales, zeros and g_idx go to the GPTQ layout."""
    if art.lut is None:
        packed = gptq_compat.pack_gptq(
            *(t.cpu().numpy() for t in (art.qidx, art.scale, art.zero,
                                        art.g_idx)), art.bits, v1=v1)
        return {f"{prefix}.{k}": torch.from_numpy(v) for k, v in packed.items()}
    lut = art.lut.to(torch.float16)
    order = torch.argsort(lut, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    idx = torch.take_along_dim(rank, art.idx.to(torch.int64), dim=1)
    return {f"{prefix}.lut": torch.take_along_dim(lut, order, dim=1),
            f"{prefix}.idx_packed": pack_int_rows(idx, art.bits)}


def _hf_state(spec: ArchSpec, model: Model, artifacts: Dict[str, Any],
              v1: bool = True) -> Dict[str, torch.Tensor]:
    """Every tensor of ``model`` under its HF name. Linears named in
    ``artifacts`` are written from their solver artifacts, every other
    linear from the model; ``v1`` picks the GPTQ v1 zero storage."""

    def linear_state(prefix: str, full_name: str, p) -> Dict[str, torch.Tensor]:
        art = artifacts.get(full_name)
        if art is None:
            return _linear_state(prefix, p)
        out = _artifact_state(prefix, art, v1)
        if "bias" in p:
            out[f"{prefix}.bias"] = p["bias"]
        return out

    state: Dict[str, torch.Tensor] = {
        spec.name_map["embed_tokens.weight"]: model.embed_tokens.weight,
        spec.name_map["final_norm.weight"]: model.final_norm.weight,
    }
    for i, lp in enumerate(model.layers):
        for ours in ("input_norm", "post_norm"):
            key = spec.name_map[f"layers.{{i}}.{ours}.weight"].format(i=i)
            state[key] = getattr(lp, ours).weight
        for ours in QK_NORMS:             # qwen3's per-head q/k norms
            if getattr(lp, ours) is not None:
                key = spec.name_map[f"layers.{{i}}.attn.{ours}.weight"]
                state[key.format(i=i)] = getattr(lp, ours)
        for ours, w in sandwich_norms(lp).items():    # gemma2/3
            key = spec.name_map[f"layers.{{i}}.{ours}.weight"]
            state[key.format(i=i)] = w
        if lp.moe is not None:            # the router stays dense
            key = spec.name_map["layers.{i}.moe.router.weight"].format(i=i)
            state[key] = lp.moe["router"]["weight"]
        for mod, slot in spec.module_slots.items():
            p = hf_import.get_module(model, i, slot)
            if p is not None:
                state.update(linear_state(_hf_module_prefix(spec, i, mod),
                                          f"{spec.layers_prefix}.{i}.{mod}", p))
    if model.lm_head is not None:
        state.update(linear_state(spec.lm_head_name, spec.lm_head_name,
                                  model.lm_head))
    return state


def _spec_of(hf_config: Dict[str, Any], model: Model) -> ArchSpec:
    """The config's spec, its expert templates instantiated; raises where
    the model's depth is not the config's."""
    spec = get_spec(hf_config["model_type"])
    cfg = spec.make_config(hf_config)
    if len(model.layers) != cfg.num_hidden_layers:
        raise ValueError("model depth does not match hf_config")
    return spec.expand(cfg.num_experts)


def save_dense(save_dir: str, hf_config: Dict[str, Any], model: Model,
               max_shard_bytes: int = MAX_SHARD_BYTES) -> None:
    """Write an unquantized model as an HF checkpoint directory
    (``config.json`` plus sharded safetensors), the input of
    ``GanqModel.load(dir, quantize_config)``."""
    spec = _spec_of(hf_config, model)
    os.makedirs(save_dir, exist_ok=True)
    _write_sharded(save_dir, _hf_state(spec, model, {}), max_shard_bytes)
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2)


def save_quantized(save_dir: str, hf_config: Dict[str, Any],
                   qcfg: QuantizeConfig, model: Model,
                   quant_log: Optional[Iterable[Any]] = None,
                   max_shard_bytes: int = MAX_SHARD_BYTES,
                   artifacts: Optional[Dict[str, Any]] = None) -> None:
    """Write a self-contained quantized checkpoint directory.

    ``artifacts`` maps full module names (``model.layers.0.self_attn.q_proj``,
    ``lm_head``) to the solver artifacts of a freshly quantized model
    (``quant/looper.QuantizedModule``); those linears are written from their
    artifacts, every other linear from the model (packed ``lut`` linears
    keep their bf16 codebooks). ``quant_log``: entries with ``layer``,
    ``module``, ``method``, ``loss``, ``damp`` and ``duration`` attributes,
    written to ``quant_log.csv``."""
    spec = _spec_of(hf_config, model)
    os.makedirs(save_dir, exist_ok=True)
    _write_sharded(save_dir, _hf_state(spec, model, artifacts or {},
                                       qcfg.format == FORMAT.GPTQ),
                   max_shard_bytes)

    qcfg_dict = qcfg.to_dict()
    qcfg_dict.setdefault("meta", {})
    qcfg_dict["meta"]["quantizer"] = META_QUANTIZER_GANQ_TPU
    with open(os.path.join(save_dir, "quantize_config.json"), "w") as f:
        json.dump(qcfg_dict, f, indent=2)
    hf_out = dict(hf_config)
    hf_out["quantization_config"] = qcfg_dict
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(hf_out, f, indent=2)

    # EoRA adapters of the artifacts (reference writer.py:75-121)
    lora: Dict[str, Tuple[str, torch.Tensor, torch.Tensor]] = {}
    for full_name, art in (artifacts or {}).items():
        if getattr(art, "lora_a", None) is None:
            continue
        if full_name == spec.lm_head_name:
            prefix, target = spec.lm_head_name, None
        else:
            rest = full_name[len(spec.layers_prefix) + 1:]
            li_s, mod = rest.split(".", 1)
            prefix = _hf_module_prefix(spec, int(li_s), mod)
            target = mod.rsplit(".", 1)[-1]
        lora[prefix] = (target, art.lora_a, art.lora_b)
    _write_adapter(save_dir, lora)
    if quant_log:
        _write_quant_log(save_dir, quant_log)
    log.info(f"saved quantized checkpoint to {save_dir}")


def _write_adapter(save_dir: str,
                   lora: Dict[str, Tuple[Optional[str], torch.Tensor,
                                         torch.Tensor]]) -> int:
    """Write ``{hf prefix: (target module or None, A, B)}`` as PEFT
    ``adapter_model.safetensors`` (fp16) and ``adapter_config.json``, the
    JSON fields of the JAX writer; nothing when ``lora`` is empty. Returns
    the number of adapted modules."""
    if not lora:
        return 0
    state: Dict[str, torch.Tensor] = {}
    rank = 0
    targets = set()
    for prefix, (target, a, b) in lora.items():
        if target is not None:
            targets.add(target)
        state[f"base_model.model.{prefix}.lora_A.weight"] = a.to(torch.float16)
        state[f"base_model.model.{prefix}.lora_B.weight"] = b.to(torch.float16)
        rank = a.shape[0]
    os.makedirs(save_dir, exist_ok=True)
    save_file(state, os.path.join(save_dir, "adapter_model.safetensors"))
    with open(os.path.join(save_dir, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": rank, "lora_alpha": rank,
                   "target_modules": sorted(targets),
                   "task_type": "CAUSAL_LM"}, f, indent=2)
    return len(lora)


def save_adapter(save_dir: str, spec: ArchSpec, model: Model,
                 num_layers: int) -> int:
    """Write the EoRA adapters attached to ``model``'s linears (a post-quant
    ``eora_generate``) in the PEFT layout of :func:`save_quantized`
    (reference writer.py eora_save). Returns the number of adapted
    modules."""
    lora: Dict[str, Tuple[Optional[str], torch.Tensor, torch.Tensor]] = {}
    for li in range(num_layers):
        for mod, slot in spec.module_slots.items():
            p = hf_import.get_module(model, li, slot)
            if p is None or "lora_a" not in p:
                continue
            lora[_hf_module_prefix(spec, li, mod)] = (
                mod.rsplit(".", 1)[-1], p["lora_a"], p["lora_b"])
    p = model.lm_head
    if isinstance(p, qlinear.QLinear) and "lora_a" in p:
        lora[spec.lm_head_name] = (None, p["lora_a"], p["lora_b"])
    return _write_adapter(save_dir, lora)


def _write_quant_log(save_dir: str, quant_log: Iterable[Any]) -> None:
    with open(os.path.join(save_dir, "quant_log.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["layer", "module", "method", "loss", "damp", "time"])
        for e in quant_log:
            w.writerow([e.layer, e.module, e.method,
                        f"{e.loss:.6f}", f"{e.damp:.5f}", f"{e.duration:.3f}"])


def _write_sharded(save_dir: str, state: Dict[str, torch.Tensor],
                   max_shard_bytes: int) -> None:
    shards: List[Dict[str, torch.Tensor]] = [{}]
    sizes = [0]
    for k, v in state.items():
        nbytes = v.numel() * v.element_size()
        if sizes[-1] + nbytes > max_shard_bytes and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][k] = v
        sizes[-1] += nbytes
    if len(shards) == 1:
        save_file(shards[0], os.path.join(save_dir, "model.safetensors"))
        return
    index = {"metadata": {"total_size": sum(sizes)}, "weight_map": {}}
    n = len(shards)
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{n:05d}.safetensors"
        save_file(shard, os.path.join(save_dir, fname))
        for k in shard:
            index["weight_map"][k] = fname
    with open(os.path.join(save_dir, "model.safetensors.index.json"), "w") as f:
        json.dump(index, f, indent=2)


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def load_quantized(model_dir: str, device="cuda",
                   dtype: torch.dtype = torch.float32,
                   verify_hash: Optional[Dict[str, str]] = None
                   ) -> Tuple[ModelConfig, Model, QuantizeConfig]:
    """Load a quantized checkpoint into (ModelConfig, Model, QuantizeConfig)
    on ``device`` (the card unless the caller passes ``"cpu"``). Unquantized
    tensors take ``dtype``; codebooks are held in bf16 and codes as int32,
    as the JAX package holds them. ``verify_hash`` maps file name ->
    expected sha256."""
    device = resolve_device(device)
    hf_config = hf_import.load_hf_config(model_dir)
    qcfg = QuantizeConfig.from_pretrained(model_dir)
    spec = get_spec(hf_config["model_type"])

    if verify_hash:
        for fname, expected in verify_hash.items():
            actual = sha256_file(os.path.join(model_dir, fname))
            if actual != expected:
                raise ValueError(f"hash mismatch for {fname}: {actual} != {expected}")

    state = dict(hf_import.iter_safetensors(model_dir))
    cfg, model = hf_import.params_from_state_dict(state, hf_config, dtype, device)
    spec = spec.expand(cfg.num_experts)

    def build_qlinear(prefix: str, bits: int) -> Optional[qlinear.QLinear]:
        bias = state.get(f"{prefix}.bias")
        bias = bias.to(device, dtype) if bias is not None else None
        if f"{prefix}.qweight" in state:
            qidx, scales, zeros, g_idx = (
                torch.from_numpy(np.ascontiguousarray(t)).to(device)
                for t in gptq_compat.unpack_gptq(
                    {k: state[f"{prefix}.{k}"].numpy()
                     for k in ("qweight", "qzeros", "scales", "g_idx")},
                    bits, v1=qcfg.format == FORMAT.GPTQ))
            return qlinear.uniform_linear(qidx, scales, zeros, g_idx, bits,
                                          bias)
        if f"{prefix}.B" in state:
            raise NotImplementedError(
                f"{prefix}: the QQQ format is not ported yet (ROADMAP.md "
                "queue A item 5)")
        if f"{prefix}.lut" not in state:
            return None
        packed = state[f"{prefix}.idx_packed"].to(device)
        arrays = {"lut": state[f"{prefix}.lut"].to(device, torch.bfloat16),
                  "idx_packed": packed}
        if bias is not None:
            arrays["bias"] = bias
        return qlinear.QLinear("lut", arrays, bits=bits,
                               in_features=packed.shape[1] * pack_factor(bits))

    for li in range(cfg.num_hidden_layers):
        for mod, slot in spec.module_slots.items():
            eff = qcfg.for_module(f"{spec.layers_prefix}.{li}.{mod}")
            ql = build_qlinear(_hf_module_prefix(spec, li, mod),
                               eff.bits if eff else qcfg.bits)
            if ql is not None:
                hf_import.set_module(model, li, slot, ql)
            elif hf_import.get_module(model, li, slot) is None:
                raise ValueError(f"{model_dir}: no weights for layer {li} {mod}")
    eff = qcfg.for_module(spec.lm_head_name)
    ql = build_qlinear(spec.lm_head_name, eff.bits if eff else qcfg.bits)
    if ql is not None:
        model.lm_head = ql

    # attach the EoRA adapters where the directory has them
    adapter_path = os.path.join(model_dir, "adapter_model.safetensors")
    if os.path.isfile(adapter_path):
        lora = load_file(adapter_path)
        for li in range(cfg.num_hidden_layers):
            for mod, slot in spec.module_slots.items():
                prefix = _hf_module_prefix(spec, li, mod)
                a_key = f"base_model.model.{prefix}.lora_A.weight"
                m = hf_import.get_module(model, li, slot)
                if a_key in lora and m is not None:
                    m.register_buffer("lora_a", lora[a_key].to(
                        device, torch.float32))
                    m.register_buffer("lora_b", lora[
                        f"base_model.model.{prefix}.lora_B.weight"].to(
                            device, torch.float32))
    return cfg, model, qcfg


__all__ = ["save_quantized", "save_dense", "load_quantized", "save_adapter",
           "sha256_file", "MAX_SHARD_BYTES"]
