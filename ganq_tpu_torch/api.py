"""Top-level user API: ``GanqModel``.

The port of the serving half of ``ganq_tpu/api.py``: ``GanqModel.load`` a
packed quantized checkpoint, then ``generate``. The model runs on the card
unless the caller passes ``device="cpu"``. Quantizing, saving, optimize(),
the server and the evals come with later slices of the port and raise
``NotImplementedError`` until then.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .core.backend import resolve_device, select_backend
from .core.config import QuantizeConfig
from .formats import checkpoint
from .models.transformer import Model, ModelConfig
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
                 backend: Optional[str] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device)
        self.qcfg = qcfg
        self.tokenizer = tokenizer
        self.model_dir = model_dir
        self.backend = select_backend(self.model, self.device, backend)
        self._engines: Dict[int, Engine] = {}

    # ------------------------------------------------------------------ load
    @classmethod
    def load(cls, model_dir: str, device="cuda",
             dtype: torch.dtype = torch.float32,
             backend: Optional[str] = None) -> "GanqModel":
        """Load a quantized checkpoint onto ``device`` (the card by default).
        Unquantized tensors take ``dtype``. ``backend`` defaults to
        :func:`~ganq_tpu_torch.core.backend.select_backend`'s choice;
        ``"reference"`` runs the plain PyTorch path on the card."""
        dev = resolve_device(device)
        if not _has_quantize_config(model_dir):
            raise _not_ported("load of an unquantized checkpoint",
                              "slice 2 (quantize)")
        cfg, model, qcfg = checkpoint.load_quantized(model_dir, dev, dtype)
        log.info(f"loaded quantized checkpoint ({qcfg.quant_method}/"
                 f"{qcfg.format}) from {model_dir}")
        return cls(cfg, model, qcfg, cls._try_tokenizer(model_dir), model_dir,
                   dev, backend)

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
    def _get_engine(self, max_seq: int) -> Engine:
        eng = self._engines.get(max_seq)
        if eng is None or eng.backend != self.backend:
            eng = Engine(self.cfg, self.model, backend=self.backend,
                         max_seq=max_seq, device=self.device)
            self._engines[max_seq] = eng
        return eng

    def generate(self, inputs: Union[str, Sequence[int], np.ndarray],
                 max_new_tokens: int = 64, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, max_seq: int = 2048,
                 seed: int = 0) -> Union[str, np.ndarray]:
        """Generate from token ids [B, S] (or [S]) or, with a tokenizer, a
        string. Returns tokens [B, max_new_tokens], or the decoded string."""
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
        eng = self._get_engine(min(max_seq, self.cfg.max_position_embeddings))
        out = eng.generate(ids, max_new_tokens=max_new_tokens,
                           temperature=temperature, top_k=top_k, top_p=top_p,
                           eos_id=eos, seed=seed)
        if is_str:
            return self.tokenizer.decode([t for t in out[0].tolist() if t != eos])
        return out

    # ------------------------------------------------ later slices of the port
    def quantize(self, *args: Any, **kw: Any):
        raise _not_ported("quantize", "slice 2 (quantize)")

    def save(self, *args: Any, **kw: Any):
        raise _not_ported("save", "slice 2 (quantize)")

    def optimize(self, *args: Any, **kw: Any):
        raise _not_ported("optimize", "the optimize() kernel slices")

    def serve(self, *args: Any, **kw: Any):
        raise _not_ported("serve", "the serving slice (batching and server)")

    def eval(self, *args: Any, **kw: Any):
        raise _not_ported("eval", "the evals slice")


__all__ = ["GanqModel"]
