"""Top-level user API: ``GanqModel``.

The port of ``ganq_tpu/api.py``'s main path: ``GanqModel.load`` a dense
checkpoint with a ``QuantizeConfig``, ``quantize`` it (GANQ or GPTQ, layer by
layer), ``save`` the packed checkpoint (``lut``, or the GPTQ v1/v2 layout),
``GanqModel.load`` that, ``optimize`` it (recode ``lut`` linears for the
int8-activation kernels) and ``generate`` (or ``generate_stream``), or
``serve`` it over HTTP (the OpenAI-compatible server, continuous batching
with ``use_batching=True``). EoRA adapters come from ``quantize`` with an
adapter rank (``QuantizeConfig(adapter={"rank": r})``) or, after it, from
``eora_generate``; ``save`` and ``load`` carry them in the PEFT layout.
The model runs on the card unless the caller
passes ``device="cpu"``. The evals come with a later slice of the port and
raise ``NotImplementedError`` until then.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .core.backend import resolve_device, select_backend
from .core.config import QuantizeConfig
from .formats import checkpoint
from .models import hf_import
from .models.registry import get_spec
from .models.transformer import Model, ModelConfig
from .quant.looper import ModuleQuantLog, QuantizeOutput, quantize_model
from .serve.engine import Engine
from .utils.logger import get_logger

log = get_logger(__name__)


def _has_quantize_config(path: str) -> bool:
    if os.path.isfile(os.path.join(path, "quantize_config.json")):
        return True
    cfg = os.path.join(path, "config.json")
    if os.path.isfile(cfg):
        import json
        with open(cfg) as f:
            return "quantization_config" in json.load(f)
    return False


def _not_ported(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(f"GanqModel.{what} is not ported yet: it comes "
                               f"with {slice_} of the PyTorch port")


class GanqModel:
    """A (ModelConfig, Model) pair on one device, with its quantization
    config and an optional tokenizer."""

    def __init__(self, cfg: ModelConfig, model: Model,
                 qcfg: Optional[QuantizeConfig] = None, tokenizer=None,
                 model_dir: Optional[str] = None, device="cuda",
                 backend: Optional[str] = None, quantized: bool = True):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device)
        self.qcfg = qcfg
        self.tokenizer = tokenizer
        self.model_dir = model_dir
        self.quantized = quantized
        self.backend = select_backend(self.model, self.device, backend)
        self._engines: Dict[str, Engine] = {}
        self._quant_output: Optional[QuantizeOutput] = None

    # ------------------------------------------------------------------ load
    @classmethod
    def load(cls, model_dir: str,
             quantize_config: Optional[QuantizeConfig] = None,
             device="cuda", dtype: torch.dtype = torch.float32,
             backend: Optional[str] = None) -> "GanqModel":
        """Load a quantized checkpoint (for serving) or a dense one (for
        :meth:`quantize` with ``quantize_config``) onto ``device``, the card
        by default. Unquantized tensors take ``dtype``. ``backend`` defaults
        to :func:`~ganq_tpu_torch.core.backend.select_backend`'s choice;
        ``"reference"`` runs the plain PyTorch path on the card."""
        dev = resolve_device(device)
        tokenizer = cls._try_tokenizer(model_dir)
        if _has_quantize_config(model_dir):
            cfg, model, qcfg = checkpoint.load_quantized(model_dir, dev, dtype)
            log.info(f"loaded quantized checkpoint ({qcfg.quant_method}/"
                     f"{qcfg.format}) from {model_dir}")
            return cls(cfg, model, qcfg, tokenizer, model_dir, dev, backend)
        cfg, model = hf_import.params_from_dir(model_dir, dtype, dev)
        log.info(f"loaded dense checkpoint from {model_dir}")
        return cls(cfg, model, quantize_config, tokenizer, model_dir, dev,
                   backend, quantized=False)

    @classmethod
    def from_torch_model(cls, model,
                         quantize_config: Optional[QuantizeConfig] = None,
                         tokenizer=None, device="cuda",
                         dtype: torch.dtype = torch.float32) -> "GanqModel":
        """A dense model from a live ``transformers`` causal LM (its state
        dict and config), ready for :meth:`quantize`."""
        cfg, m = hf_import.params_from_state_dict(
            {k: v.detach() for k, v in model.state_dict().items()},
            model.config.to_dict(), dtype, device)
        return cls(cfg, m, quantize_config, tokenizer, None, device,
                   quantized=False)

    @staticmethod
    def _try_tokenizer(model_dir: str):
        """The checkpoint's tokenizer when it ships one and ``transformers``
        is installed, else None (token-id inputs only)."""
        files = ("tokenizer.json", "tokenizer.model", "tokenizer_config.json")
        if not any(os.path.isfile(os.path.join(model_dir, f)) for f in files):
            return None
        try:
            from transformers import AutoTokenizer
        except ImportError:
            return None
        return AutoTokenizer.from_pretrained(model_dir, local_files_only=True)

    # -------------------------------------------------------------- generate
    def _get_engine(self, layout: str = "auto") -> Engine:
        """One engine per layout, shared by every max_seq: the stacked
        layout's certification runs once per model (and again only after
        quantize() or optimize())."""
        eng = self._engines.get(layout)
        if eng is None or eng.backend != self.backend:
            eng = Engine(self.cfg, self.model, backend=self.backend,
                         max_seq=self.cfg.max_position_embeddings,
                         device=self.device, layout=layout)
            self._engines[layout] = eng
        return eng

    def generate(self, inputs: Union[str, Sequence[int], np.ndarray],
                 max_new_tokens: int = 64, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, max_seq: int = 2048,
                 seed: int = 0, layout: str = "auto") -> Union[str, np.ndarray]:
        """Generate from token ids [B, S] (or [S]) or, with a tokenizer, a
        string. Returns tokens [B, max_new_tokens], or the decoded string.
        ``layout``: the engine's (:class:`~ganq_tpu_torch.serve.engine.Engine`):
        "auto" stacks a homogeneous model and decodes through the whole-step
        kernel its variant takes, "perlayer" serves it layer by layer."""
        is_str = isinstance(inputs, str)
        if is_str:
            if self.tokenizer is None:
                raise ValueError("string input requires a tokenizer")
            ids = np.asarray(self.tokenizer(inputs)["input_ids"], np.int64)[None, :]
        else:
            ids = np.asarray(inputs, np.int64)
            if ids.ndim == 1:
                ids = ids[None, :]
        eos = -1
        if self.tokenizer is not None and self.tokenizer.eos_token_id is not None:
            eos = int(self.tokenizer.eos_token_id)
        out = self._get_engine(layout).generate(
            ids, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, eos_id=eos, seed=seed,
            max_seq=min(max_seq, self.cfg.max_position_embeddings))
        if is_str:
            return self.tokenizer.decode([t for t in out[0].tolist() if t != eos])
        return out

    def generate_stream(self, inputs: Union[str, Sequence[int], np.ndarray],
                        max_new_tokens: int = 64, temperature: float = 0.0,
                        top_k: int = 0, top_p: float = 1.0,
                        max_seq: int = 2048, seed: int = 0):
        """Incremental generate for one sequence: yields text deltas for a
        string (with a tokenizer), token ids otherwise; stops at eos (the
        server's SSE streaming mode). A text delta is the new suffix of the
        re-decoded ids, held back while the text ends in U+FFFD (a
        multi-byte character not yet complete), so no character splits
        across deltas."""
        is_str = isinstance(inputs, str)
        if is_str:
            if self.tokenizer is None:
                raise ValueError("string input requires a tokenizer")
            ids = np.asarray(self.tokenizer(inputs)["input_ids"], np.int64)
        else:
            ids = np.asarray(inputs, np.int64).reshape(-1)
        eos = -1
        if self.tokenizer is not None and self.tokenizer.eos_token_id is not None:
            eos = int(self.tokenizer.eos_token_id)
        eng = self._get_engine()
        produced: list = []
        prev_text = ""
        for t in eng.stream(ids, max_new_tokens=max_new_tokens,
                            temperature=temperature, top_k=top_k, top_p=top_p,
                            eos_id=eos, seed=seed,
                            max_seq=min(max_seq,
                                        self.cfg.max_position_embeddings)):
            if not is_str:
                yield t
                continue
            produced.append(t)
            text = self.tokenizer.decode(produced)
            if text.endswith("\ufffd"):      # mid-character: hold it back
                continue
            if len(text) > len(prev_text):
                yield text[len(prev_text):]
                prev_text = text

    # -------------------------------------------------------------- quantize
    def quantize(self, calibration_dataset: Sequence[Any],
                 batch_size: int = 1,
                 calibration_concat_size: Optional[int] = None,
                 resume_dir: Optional[str] = None) -> List[ModuleQuantLog]:
        """Run layer-wise GANQ or GPTQ (``quant_method``) on the model's
        device. ``calibration_dataset``:
        token-id arrays, ``{"input_ids": ...}`` dicts or strings (tokenizer
        required). ``resume_dir``: checkpoint each layer's artifacts there
        and resume a crashed run after the last completed layer. Afterwards
        the model holds the fake-quantized weights and generates with them,
        as the JAX package does right after quantizing."""
        if self.quantized:
            raise RuntimeError("model is already quantized")
        self.qcfg = self.qcfg or QuantizeConfig()
        batches = prepare_dataset(calibration_dataset, self.tokenizer,
                                  batch_size, calibration_concat_size)
        out = quantize_model(self.cfg, self.model,
                             get_spec(self.cfg.model_type), self.qcfg,
                             batches, resume_dir=resume_dir)
        self._quant_output = out
        self.model = out.model
        self.quantized = True
        self._engines = {}
        return out.log

    # ------------------------------------------------------------------ save
    def save(self, save_dir: str) -> None:
        """Write the packed checkpoint of a freshly quantized model from the
        solver's artifacts: ``lut`` for GANQ, the GPTQ v1 or v2 layout
        (``QuantizeConfig.format``) for GPTQ."""
        if self._quant_output is None:
            raise RuntimeError("nothing to save: call quantize() first")
        checkpoint.save_quantized(save_dir, self._hf_config_dict(), self.qcfg,
                                  self.model, self._quant_output.log,
                                  artifacts=self._quant_output.artifacts)
        if self.tokenizer is not None:
            self.tokenizer.save_pretrained(save_dir)

    def _hf_config_dict(self) -> Dict[str, Any]:
        if self.model_dir and os.path.isfile(os.path.join(self.model_dir,
                                                          "config.json")):
            return hf_import.load_hf_config(self.model_dir)
        return hf_import.config_to_hf(self.cfg)

    # ------------------------------------------------------------------ eora
    def eora_generate(self, fp_model, calibration_dataset: Sequence[Any],
                      rank: int = 64, batch_size: int = 1,
                      save_adapter_to: Optional[str] = None,
                      timings: Optional[Dict[str, float]] = None) -> List[str]:
        """Post-quant EoRA accuracy-recovery adapters (reference
        ``GPTQModel.adapter.generate``, auto.py:566-618; the JAX package's
        ``eora_generate``). ``fp_model``: the float checkpoint this model was
        quantized from, a local HF directory or a live ``transformers``
        model. Attaches rank-``rank`` ``lora_a``/``lora_b`` to every
        quantized linear and, with ``save_adapter_to``, writes them as
        PEFT ``adapter_model.safetensors`` and ``adapter_config.json``,
        which :meth:`load` attaches again. ``timings``: seconds by part
        (``quant/eora_flow.generate_eora``). Returns the adapted module
        names."""
        if not self.quantized:
            raise RuntimeError("eora_generate needs a quantized model; "
                               "load a quantized checkpoint first")
        if isinstance(fp_model, str):
            fcfg, fmodel = hf_import.params_from_dir(fp_model, torch.float32,
                                                     self.device)
        else:
            fcfg, fmodel = hf_import.params_from_state_dict(
                {k: v.detach() for k, v in fp_model.state_dict().items()},
                fp_model.config.to_dict(), torch.float32, self.device)
        if (fcfg.model_type, fcfg.hidden_size) != (self.cfg.model_type,
                                                   self.cfg.hidden_size):
            raise ValueError(
                f"fp model {fcfg.model_type}/{fcfg.hidden_size} does not "
                f"match quantized {self.cfg.model_type}/{self.cfg.hidden_size}")
        from .quant.eora_flow import generate_eora

        spec = get_spec(self.cfg.model_type).expand(self.cfg.num_experts)
        batches = prepare_dataset(calibration_dataset, self.tokenizer,
                                  batch_size)
        done = generate_eora(self.cfg, fmodel, self.model, spec, rank,
                             batches, timings)
        self._engines = {}
        log.info(f"attached EoRA rank-{rank} adapters to {len(done)} modules")
        if save_adapter_to:
            n = checkpoint.save_adapter(save_adapter_to, spec, self.model,
                                        self.cfg.num_hidden_layers)
            log.info(f"saved {n} adapters to {save_adapter_to}")
        return done

    # -------------------------------------------------------------- optimize
    def optimize(self, recode: str = "auto") -> "GanqModel":
        """Recode the quantized linears for the fastest serving path, then
        select the backend again (``ganq_tpu/api.py`` ``optimize``).

        ``recode``: "auto" certifies affine-grid ``lut`` codebooks into
        ``uniform`` linears (lossless, ``certify_uniform``) and recodes the
        rest, 3-bit codebooks included, to ``uniform`` 8-bit with
        128-column max-abs scales (``recode_uniform8``); "u4" snaps 3-bit
        codebooks onto a 16-level affine grid (``recode_uniform4``) and
        treats the rest as "auto"; "affine" certifies only; "w8" recodes
        every ``lut`` (and ``uniform``) linear to per-row int8
        (``recode_w8``); "none" leaves the kinds as loaded. On the card the
        recoded models select ``"cuda_a8"``; the engine's stacked layout
        then runs the JAX package's fused kernels where its gates send a
        request (for ``w8``: the fused W8A8 MLP and, for head_dim-128 models
        at decode batch <= 8, the whole-step megastep; for uniform 8-, 4-,
        3- and 2-bit models at decode batch <= 64, the group-scaled whole
        step; ``layout="perlayer"`` keeps the per-layer kernels). A model
        left with 3-bit 8-entry codebooks (``recode="none"`` or a load
        without ``optimize``) decodes through the whole step's Walsh planes
        ("wl8") under ``GANQ_MEGASTEP=1``. A MoE model's experts are recoded too, and on
        the card each MoE layer whose experts are uniform 4- or 8-bit gets
        kernel 15's packed copy (``ops/moe_expert.moe_megapack``), which its
        decode steps take (``models/transformer._moe_combine``)."""
        from .ops.qlinear import (QLinear, certify_uniform, recode_uniform4,
                                  recode_uniform8, recode_w8)

        if recode not in ("auto", "affine", "u4", "w8", "none"):
            raise ValueError(f"unknown recode {recode!r}")

        def rec(v: QLinear) -> QLinear:
            if recode in ("auto", "affine", "u4"):
                q = certify_uniform(v)
                if q is not None:
                    return q
            if recode == "u4":
                q4 = recode_uniform4(v)
                return q4 if q4 is not v else recode_uniform8(v)
            if recode == "auto":
                return recode_uniform8(v)
            if recode == "w8":
                return recode_w8(v)
            return v

        if recode != "none":
            with torch.no_grad():
                for lp in self.model.layers:
                    groups = [lp.attn, lp.mlp]
                    if lp.moe is not None:
                        groups += list(lp.moe["experts"])
                    for group in groups:
                        for name, v in list(group.items()):
                            if isinstance(v, QLinear):
                                group[name] = rec(v)
                if isinstance(self.model.lm_head, QLinear):
                    self.model.lm_head = rec(self.model.lm_head)
        if self.device.type == "cuda":
            self._pack_moe_experts()
        self.backend = select_backend(self.model, self.device)
        self._engines = {}
        return self

    def _pack_moe_experts(self) -> None:
        """Kernel 15's packed experts (``moe["mega"]``) for every MoE layer
        whose experts it takes (``ganq_tpu/api.py:632-649``); prefill keeps
        the per-expert linears, so both are held."""
        from .models.transformer import Pack
        from .ops.moe_expert import moe_mega_fusable, moe_megapack

        for lp in self.model.layers:
            moe = lp.moe
            if moe is None or "mega" in moe:
                continue
            gate = moe["experts"][0]["gate"] if "gate" in moe["experts"][0] \
                else None
            bits = getattr(gate, "bits", None)
            if bits and moe_mega_fusable(self.cfg, moe, bits):
                moe["mega"] = Pack(moe_megapack(self.cfg, moe, bits))

    # ----------------------------------------------------------------- serve
    def serve(self, host: str = "127.0.0.1", port: int = 8000, **kw):
        """Start the OpenAI-compatible server
        (:class:`~ganq_tpu_torch.serve.openai_server.OpenAIServer`; ``kw``:
        ``use_batching``, ``slots``, ``max_seq``, ``max_new_tokens``,
        ``model_id``) on a thread of its own and return it; ``port=0``
        takes a free port (``server.port``). ``server.shutdown()`` stops
        it."""
        from .serve.openai_server import OpenAIServer

        return OpenAIServer(self, host=host, port=port, **kw).start()

    # ------------------------------------------------ later slices of the port

    def eval(self, *args: Any, **kw: Any):
        raise _not_ported("eval", "the evals slice")


def prepare_dataset(dataset: Sequence[Any], tokenizer, batch_size: int = 1,
                    concat_size: Optional[int] = None) -> List[np.ndarray]:
    """Calibration data as int32 [batch, seq] token-id arrays: strings
    (tokenized), ``{"input_ids": ...}`` dicts or id arrays. Rows of equal
    length are batched together; ``concat_size`` packs all rows into
    fixed-length blocks (the reference's ``calibration_dataset_concat_size``,
    base.py:243-307)."""
    rows: List[np.ndarray] = []
    for item in dataset:
        if isinstance(item, str):
            if tokenizer is None:
                raise ValueError("string calibration data requires a tokenizer")
            ids = np.asarray(tokenizer(item)["input_ids"], np.int32)
        elif isinstance(item, dict):
            if "inputs_embeds" in item:
                raise NotImplementedError(
                    "pre-embedded calibration rows are not ported yet (the "
                    "VL slice, ROADMAP.md queue A item 7)")
            ids = np.asarray(item["input_ids"], np.int32).reshape(-1)
        else:
            arr = np.asarray(item)
            if np.issubdtype(arr.dtype, np.floating):
                raise NotImplementedError(
                    "pre-embedded calibration rows are not ported yet (the "
                    "VL slice, ROADMAP.md queue A item 7)")
            ids = arr.astype(np.int32).reshape(-1)
        if ids.size:
            rows.append(ids)
    if not rows:
        raise ValueError("empty calibration dataset")
    if len(rows) < 256:
        log.warning(f"calibration dataset is small ({len(rows)} rows); the "
                    "reference recommends >=256 (loop_processor.py:95-127)")
    if concat_size is not None:
        stream = np.concatenate(rows)
        n = (len(stream) // concat_size) * concat_size
        rows = list(stream[:n].reshape(-1, concat_size))
    by_len: Dict[int, List[np.ndarray]] = {}
    for r in rows:
        by_len.setdefault(len(r), []).append(r)
    return [np.stack(group[i:i + batch_size])
            for group in by_len.values()
            for i in range(0, len(group), batch_size)]


__all__ = ["GanqModel", "prepare_dataset"]
