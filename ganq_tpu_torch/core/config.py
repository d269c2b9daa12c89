"""Quantization configuration system (the port's own copy).

Same fields, enums, validation and ``quantize_config.json`` serialization as
``ganq_tpu/core/config.py``: a config written by either package is read by
the other, and both write byte-identical JSON for the same settings. The
module is pure Python; the port keeps its own copy so that it never imports
the JAX package.
"""

from __future__ import annotations

import copy
import json
import os
import re
from dataclasses import dataclass, fields
from enum import Enum
from typing import Any, Dict, Optional

META_FIELD_QUANTIZER = "quantizer"
META_FIELD_URI = "uri"
META_QUANTIZER_GANQ_TPU = "ganq-tpu"

QUANT_CONFIG_FILENAME = "quantize_config.json"

# json field (ecosystem name) <-> code field
FORMAT_FIELD_JSON = "checkpoint_format"
FORMAT_FIELD_CODE = "format"
QUANT_METHOD_FIELD = "quant_method"


class FORMAT(str, Enum):
    """On-disk checkpoint formats.

    - ``GPTQ``: ecosystem-compatible uniform format (qweight/qzeros/scales/g_idx,
      zeros stored with the legacy +1 offset, reference ``utils/model.py:354-551``).
    - ``GPTQ_V2``: same tensors without the +1 zero offset (internal runtime format).
    - ``LUT``: packed non-uniform format — per-row codebook ``lut[m, 2^bits]``
      plus 4-bit packed indices. This is the real GANQ artifact the reference
      lacks (its GANQ maps to FAKE fp16, ``qlinear/fake.py:65-89``).
    - ``FAKE``: dequantized full-precision weights (debug / accuracy oracle).
    """

    GPTQ = "gptq"
    GPTQ_V2 = "gptq_v2"
    LUT = "lut"
    FAKE = "fake"
    # W4A8 QQQ format: B (marlin-tiled int4) + s_group (relative fp16) +
    # s_channel (calibrated per-channel fp32), reference
    # nn_modules/qlinear/qqq.py:131-156 (formats/qqq_compat.py)
    QQQ = "qqq"

    def __str__(self) -> str:  # json-friendly
        return self.value


class QUANT_METHOD(str, Enum):
    GPTQ = "gptq"
    GANQ = "ganq"
    # native signed-gradient rounding optimization (the reference delegates
    # this method to the external auto-round package, base.py:638-707;
    # here it is a first-class jitted solver, quant/autoround.py)
    AUTO_ROUND = "auto_round"
    # W4A8: GPTQ solver (sym) + calibrated per-channel int8 scale_extra
    # (reference quantization/qqq.py:9-36)
    QQQ = "qqq"

    def __str__(self) -> str:
        return self.value


QUANT_METHOD_FORMAT_MAPPING = {
    QUANT_METHOD.GPTQ: {FORMAT.GPTQ, FORMAT.GPTQ_V2, FORMAT.FAKE},
    QUANT_METHOD.GANQ: {FORMAT.LUT, FORMAT.FAKE},
    QUANT_METHOD.AUTO_ROUND: {FORMAT.GPTQ, FORMAT.GPTQ_V2, FORMAT.FAKE},
    QUANT_METHOD.QQQ: {FORMAT.QQQ, FORMAT.GPTQ_V2, FORMAT.FAKE},
}

# HF/ecosystem synonyms accepted when parsing quantize_config.json
# (reference config.py:112-118)
QUANT_CONFIG_ARG_SYNONYMS = {
    "w_bit": "bits",
    "q_group_size": "group_size",
    FORMAT_FIELD_JSON: FORMAT_FIELD_CODE,
}


def dynamic_get(
    dynamic: Optional[Dict[str, Dict[str, Any]]],
    module_name: str,
    key: Optional[str] = None,
    default: Any = None,
    sub_key: Optional[str] = None,
) -> Any:
    """Per-module override lookup.

    Rules are an ordered dict of ``"+:regex" -> {field: value}`` overrides and
    ``"-:regex"`` skip rules; first match wins; negative rules are evaluated
    first (reference ``config.py:131-154``). Returns ``False`` when the module
    is excluded from quantization.
    """
    if dynamic is None:
        return default
    for pattern, overrides in dynamic.items():
        if pattern.startswith("-:"):
            if re.match(pattern[2:], module_name):
                return False
        elif re.match(pattern.removeprefix("+:"), module_name):
            if key is None:
                return overrides
            if sub_key is not None:
                sub_value = overrides.get(key, None)
                if isinstance(sub_value, dict):
                    return sub_value.get(sub_key, default)
                return default
            return overrides.get(key, default)
    return default


@dataclass
class QuantizeConfig:
    """All quantization knobs.

    Field set mirrors the reference ``QuantizeConfig`` (``config.py:156-216``)
    minus torch/device-specific fields, plus TPU-native additions
    (``codebook_init``, ``solver_backend``, ``hessian_dtype``).
    """

    bits: int = 4
    group_size: int = 128

    # Hessian damping: H += damp_percent * mean(diag(H)); on Cholesky failure
    # the damp is auto-incremented and retried (reference gptq.py:293-316).
    damp_percent: float = 0.01
    damp_auto_increment: float = 0.0025

    # Which Cholesky factor the GANQ S-step uses: "gptq" = chol of the damped H;
    # "ganq" = chol of H + diag(rowsum|H| - 2 diag H) (diagonally dominant;
    # reference gptq.py:289-291).
    l_damp_style: str = "gptq"

    # Dead (never-activated) input columns: zero them or set to row mean
    # (reference gptq.py:269-276).
    dead: str = "zero"

    # Column ordering by activation magnitude. "auto": desc for gptq when
    # desc_act, none otherwise; GANQ recipe uses "asc".
    desc_act: bool = True
    act_sort: str = "auto"  # auto | none | desc | asc
    static_groups: bool = False
    sym: bool = True
    true_sequential: bool = True

    lm_head: bool = False

    quant_method: QUANT_METHOD = QUANT_METHOD.GPTQ
    format: Optional[FORMAT] = None  # default derived from quant_method

    # mse grid-shrink search exponent for uniform scale search; 0 disables
    # (reference quantizer.py:129-152, typical value 2.4).
    mse: float = 0.0

    # GANQ-specific
    ganq_iterations: int = 5
    # codebook init: "kmeans_exact" = exact weighted 1-D k-means DP (native
    # C++ host op, matching the reference's kmeans1d and 2-4x better local
    # cost on heavy-tailed rows); "kmeans" = batched weighted Lloyd on TPU
    # (faster, approximate); "linear" / "normal" parity inits
    # (reference ganq.py:406-421).
    codebook_init: str = "kmeans_exact"
    # LeanQuant-style weighting exponent: kmeans weights = diag(Hinv)^-exp
    # (reference ganq.py:427).
    codebook_weight_exp: float = 4.0
    # codebook constraint (quant/ganq.py refit dispatch):
    # - "free":       unconstrained per-row 2^bits codebook (the reference's
    #                 GANQ, ganq.py:576-616); serves via the certified int8
    #                 recode or the exact-LUT oracle kernels.
    # - "lut8":       free codebook snapped to a per-row int8 grid inside
    #                 the loop — serves EXACTLY (zero recode error) through
    #                 the w8 megastep.
    # - "affine":     per-row affine grid T = a + b(s - 2^(bits-1)) fit by
    #                 a 2x2 Hessian-weighted solve inside the loop — serves
    #                 EXACTLY through the uniform W4 megastep at packed
    #                 4-bit bytes (the solve-time certified affine recode).
    # - "affine_sym": a = 0 (symmetric grid); rides the sym-only fast path.
    ganq_codebook: str = "free"

    # AutoRound-specific (reference AutoRoundQuantizeConfig fields
    # iters/lr/minmax_lr/enable_minmax_tuning/not_use_best_mse,
    # config.py:511-531; defaults match the external package)
    autoround_iters: int = 200
    autoround_lr: Optional[float] = None          # default 1/iters
    autoround_minmax_lr: Optional[float] = None   # default = lr
    autoround_minmax_tuning: bool = True
    autoround_keep_best: bool = True              # inverse of not_use_best_mse
    # "module": per-linear Hessian-weighted objective (cheap, no layer
    # replays); "block": jointly tune each decoder layer against its output
    # MSE - the external package default granularity (nblocks=1)
    autoround_scope: str = "module"

    # dynamic per-module overrides: {"+:regex": {...}, "-:regex": {}}
    dynamic: Optional[Dict[str, Dict[str, Any]]] = None

    # solver execution: "jax" = pure-XLA batched solver; "pallas" = fused
    # Pallas S-step kernel (the TPU analog of the reference's Metal compute_s).
    solver_backend: str = "auto"  # auto | jax | pallas

    # T-step contraction precision (quant/ganq.py _h_terms):
    # "float32" (default) = split-bf16 passes carrying full f32 precision
    # (loss-identical to the strict path at ~2x its speed);
    # "float32_strict" = 6-pass HIGHEST f32 oracle;
    # "bfloat16" = single-pass bf16 (fastest; H rounds to 8 mantissa bits —
    # measured ~2x ppl cost at 1B, tests/test_accuracy_contract.py).
    hessian_dtype: str = "float32"

    # number of parallel packing workers at save time
    parallel_packing: bool = True

    # EoRA / LoRA adapter config: {"rank": int, "path": str}
    adapter: Optional[Dict[str, Any]] = None

    rotation: Optional[str] = None  # hadamard | random | None

    # free-form provenance metadata, written into quantize_config.json
    meta: Optional[Dict[str, Any]] = None

    def __post_init__(self) -> None:
        if isinstance(self.quant_method, str):
            self.quant_method = QUANT_METHOD(self.quant_method)
        if self.format is None:
            self.format = (
                FORMAT.LUT if self.quant_method == QUANT_METHOD.GANQ
                else FORMAT.QQQ if self.quant_method == QUANT_METHOD.QQQ
                else FORMAT.GPTQ
            )
        if isinstance(self.format, str):
            self.format = FORMAT(self.format)

        if self.bits not in (2, 3, 4, 8):
            raise ValueError(f"QuantizeConfig: `bits` must be one of 2/3/4/8, got {self.bits}")
        if self.format not in QUANT_METHOD_FORMAT_MAPPING[self.quant_method]:
            raise ValueError(
                f"QuantizeConfig: format {self.format} incompatible with method {self.quant_method}"
            )
        if not (0 < self.damp_percent < 1):
            raise ValueError("QuantizeConfig: `damp_percent` must be between 0 and 1.")
        if self.dead not in ("zero", "mean"):
            raise ValueError(f"QuantizeConfig: unknown `dead` mode {self.dead}")
        if self.act_sort not in ("auto", "none", "asc", "desc"):
            raise ValueError(f"QuantizeConfig: unknown `act_sort` {self.act_sort}")
        if self.l_damp_style not in ("gptq", "ganq"):
            raise ValueError(f"QuantizeConfig: unknown `l_damp_style` {self.l_damp_style}")
        if self.quant_method == QUANT_METHOD.QQQ:
            # QQQQuantizer is groupwise-sym (reference quantizer.py:179-181);
            # the QQQ artifact is 4-bit (kernel + format contract)
            if not self.sym:
                raise ValueError("QuantizeConfig: QQQ requires sym=True")
            if self.format == FORMAT.QQQ and self.bits != 4:
                raise ValueError("QuantizeConfig: the QQQ format is 4-bit only")
            if self.format == FORMAT.QQQ and self.desc_act:
                # the QQQ artifact has no g_idx tensor; the reference
                # normalizes this away too (qlinear/qqq.py:112-115)
                self.desc_act = False
        if self.autoround_scope not in ("module", "block"):
            raise ValueError(
                f"QuantizeConfig: unknown `autoround_scope` {self.autoround_scope}")
        if self.group_size != -1 and self.group_size <= 0:
            raise ValueError("QuantizeConfig: `group_size` must be -1 or positive.")

        if self.dynamic is not None:
            # negative (skip) rules are evaluated first (reference config.py:253-257)
            self.dynamic = {
                **{k: v for k, v in self.dynamic.items() if k.startswith("-")},
                **{k: v for k, v in self.dynamic.items() if not k.startswith("-")},
            }

    # ------------------------------------------------------------------ dynamic
    def dynamic_get(self, module_name: str, key: Optional[str] = None,
                    default: Any = None, sub_key: Optional[str] = None) -> Any:
        return dynamic_get(self.dynamic, module_name, key, default, sub_key)

    def for_module(self, module_name: str) -> Optional["QuantizeConfig"]:
        """Resolve the effective config for one module.

        Returns None when a ``-:`` rule excludes the module from quantization
        (reference gptq_processor.py:76-84 semantics).
        """
        overrides = self.dynamic_get(module_name)
        if overrides is False:
            return None
        if not overrides:
            return self
        cfg = copy.deepcopy(self)
        cfg.dynamic = None
        for k, v in overrides.items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
        cfg.__post_init__()
        return cfg

    # ----------------------------------------------------------------- resolve
    def resolved_act_sort(self) -> str:
        if self.act_sort != "auto":
            return self.act_sort
        if self.quant_method == QUANT_METHOD.GANQ:
            return "asc"
        return "desc" if self.desc_act else "none"

    def bits_per_weight(self) -> float:
        """Estimated bpw of the stored artifact (reference config.py:488-508)."""
        if self.format == FORMAT.LUT:
            # idx bits + per-row lut (2^bits entries, 16-bit) amortized over row len
            return float(self.bits)  # lut amortizes to ~0 for realistic n
        if self.group_size == -1:
            return float(self.bits)
        return self.bits + (self.bits + 16) / self.group_size

    # --------------------------------------------------------------- serialize
    def to_dict(self) -> Dict[str, Any]:
        out = {
            "bits": self.bits,
            "group_size": self.group_size,
            "desc_act": self.desc_act,
            "act_sort": self.act_sort,
            "sym": self.sym,
            "true_sequential": self.true_sequential,
            "lm_head": self.lm_head,
            "quant_method": str(self.quant_method),
            FORMAT_FIELD_JSON: str(self.format),
            "mse": self.mse,
            "dead": self.dead,
            "l_damp_style": self.l_damp_style,
            "damp_percent": self.damp_percent,
            "damp_auto_increment": self.damp_auto_increment,
            "static_groups": self.static_groups,
            "ganq_iterations": self.ganq_iterations,
            "codebook_init": self.codebook_init,
            "codebook_weight_exp": self.codebook_weight_exp,
            "ganq_codebook": (self.ganq_codebook
                              if self.ganq_codebook != "free" else None),
            "rotation": self.rotation,
            "dynamic": self.dynamic,
            "adapter": self.adapter,
            "meta": self.meta,
        }
        if self.quant_method == QUANT_METHOD.AUTO_ROUND:
            # the artifact is pure uniform-GPTQ format: advertise it as such
            # for ecosystem compat and keep provenance in meta (reference
            # config.py:565 does the same for vllm/sglang)
            out[QUANT_METHOD_FIELD] = str(QUANT_METHOD.GPTQ)
            out["meta"] = {**(self.meta or {}),
                           "true_quant_method": str(QUANT_METHOD.AUTO_ROUND),
                           "autoround_iters": self.autoround_iters,
                           "autoround_minmax_tuning": self.autoround_minmax_tuning}
        return {k: v for k, v in out.items() if v is not None}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "QuantizeConfig":
        valid = {f.name for f in fields(cls)}
        norm: Dict[str, Any] = {}
        for k, v in d.items():
            key = k.lower()
            key = QUANT_CONFIG_ARG_SYNONYMS.get(key, key)
            if key in valid:
                norm[key] = v
        return cls(**norm)

    def save_pretrained(self, save_dir: str) -> str:
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, QUANT_CONFIG_FILENAME)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
        return path

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "QuantizeConfig":
        path = os.path.join(model_dir, QUANT_CONFIG_FILENAME)
        if os.path.isfile(path):
            with open(path) as f:
                return cls.from_dict(json.load(f))
        # fall back to HF config.json quantization_config (reference auto.py:218-234)
        cfg_path = os.path.join(model_dir, "config.json")
        if os.path.isfile(cfg_path):
            with open(cfg_path) as f:
                hf = json.load(f)
            qc = hf.get("quantization_config")
            if qc:
                return cls.from_dict(qc)
        raise FileNotFoundError(f"No {QUANT_CONFIG_FILENAME} or quantization_config in {model_dir}")


__all__ = [
    "FORMAT",
    "QUANT_METHOD",
    "QuantizeConfig",
    "dynamic_get",
    "QUANT_CONFIG_FILENAME",
]
