"""Post-quantization EoRA generation.

The port of ``ganq_tpu/quant/eora_flow.py`` (the reference's
``GPTQModel.adapter.generate``, ``models/auto.py:566-618`` and
``_eora_generate`` base.py:461-524: DequantizeProcessor + EoraProcessor):
given an already quantized model and the original float weights, fit each
quantized linear's low-rank corrector from calibration activations of the
*quantized* model and attach it (``lora_a``/``lora_b`` buffers, applied by
``ops/qlinear.apply``).

Each layer's forward passes run on the ``"reference"`` backend, as the JAX
flow's do (``layer_forward``'s default there): plain PyTorch on the
model's device, float32 with the products of ``adapter/eora.py`` in full
float32.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..adapter.eora import compute_eora
from ..models import hf_import
from ..models.registry import ArchSpec
from ..models.transformer import (Model, ModelConfig, embed, layer_forward,
                                  rope_for_layer, rope_tables_all)
from ..ops import qlinear
from ..utils.logger import get_logger
from .hessian import HessianAccumulator

log = get_logger(__name__)


def _full_name(spec: ArchSpec, layer_idx: int, module_name: str) -> str:
    return f"{spec.layers_prefix}.{layer_idx}.{module_name}"


def generate_eora(cfg: ModelConfig, fp_model: Model, q_model: Model,
                  spec: ArchSpec, rank: int,
                  calib_batches: Sequence[np.ndarray],
                  timings: Optional[Dict[str, float]] = None) -> List[str]:
    """Attach EoRA adapters to every quantized linear of ``q_model``, layer
    by layer: the quantized layer's taps give each slot's activation
    covariance (``acc / nsamples``, nsamples counting sequences), each
    non-dense linear gets ``compute_eora(W_fp - dequantize(W_q), cov,
    rank)``, and the layer is run again with its adapters so that the next
    layer sees the corrected activations. ``calib_batches``: int [batch,
    seq] token ids, or float [batch, seq, hidden] rows already embedded.
    Returns the adapted module names. ``timings``, when given, sums the
    seconds of ``cov`` (taps and covariances), ``eigh``, ``svd`` and
    ``rest`` (the dequantization, the factors and the second forward)."""
    device = q_model.embed_tokens.weight.device
    t = timings if timings is not None else {}
    for k in ("cov", "eigh", "svd", "rest"):
        t.setdefault(k, 0.0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    acts: List[torch.Tensor] = []
    ropes = []
    for batch in calib_batches:
        arr = np.asarray(batch)
        if np.issubdtype(arr.dtype, np.floating):
            x = torch.as_tensor(arr, device=device).to(
                q_model.embed_tokens.weight.dtype)
        else:
            x = embed(cfg, q_model, torch.as_tensor(arr, dtype=torch.int64,
                                               device=device))
        b, s = x.shape[:2]
        acts.append(x)
        ropes.append(rope_tables_all(cfg, torch.arange(s, device=device)
                                     .expand(b, s)))
    nsamples = sum(int(a.shape[0]) for a in acts)

    done: List[str] = []
    with torch.inference_mode():
        for li in range(cfg.num_hidden_layers):
            lp = q_model.layers[li]
            slots = [(mod, spec.module_slots[mod]) for sub in spec.layer_modules
                     for mod in sub]
            t0 = time.perf_counter()
            accs: Dict[str, HessianAccumulator] = {}
            for x, rope in zip(acts, ropes):
                _, taps = layer_forward(cfg, lp, x, None,
                                        rope_for_layer(cfg, rope, li),
                                        want_taps=True,
                                        window=cfg.layer_window(li))
                for _, slot in slots:
                    if slot in taps:
                        if slot not in accs:
                            accs[slot] = HessianAccumulator(
                                taps[slot].shape[-1], device)
                        accs[slot].update(taps[slot])
            sync()
            t["cov"] += time.perf_counter() - t0

            for mod, slot in slots:
                qmod = hf_import.get_module(q_model, li, slot)
                fmod = hf_import.get_module(fp_model, li, slot)
                if qmod is None or fmod is None or qmod.kind == "dense":
                    continue
                t0 = time.perf_counter()
                delta = (fmod["weight"].to(device, torch.float32)
                         - qlinear.dequantize_weight(qmod).to(torch.float32))
                cov = accs[slot].acc / max(nsamples, 1)
                la = {}
                A, B = compute_eora(delta, cov, rank, la)
                qmod.register_buffer("lora_a", A)
                qmod.register_buffer("lora_b", B)
                done.append(_full_name(spec, li, mod))
                sync()
                t["eigh"] += la["eigh"]
                t["svd"] += la["svd"]
                t["rest"] += (time.perf_counter() - t0 - la["eigh"]
                              - la["svd"])

            t0 = time.perf_counter()
            acts = [layer_forward(cfg, lp, x, None,
                                  rope_for_layer(cfg, rope, li),
                                  window=cfg.layer_window(li))
                    for x, rope in zip(acts, ropes)]
            sync()
            t["rest"] += time.perf_counter() - t0
            log.info(f"eora: layer {li} done")
    return done


__all__ = ["generate_eora"]
