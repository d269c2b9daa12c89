"""Quantized inference engine: KV cache, prefill, decode steps, generation.

The port of ``ganq_tpu/serve/engine.py``. The JAX engine compiles prefill and
a ``lax.scan`` decode loop; PyTorch runs eagerly, so here prefill and each
decode step are plain calls over the layers, and the cache is updated in
place. The position, the sampled tokens and the finished flags stay on the
device, so a decode step needs no host sync.

The JAX engine (``layout="auto"``) serves homogeneous models of more than
one layer through a stacked-layer layout (``serve/stacked.py``), built by
``stack_layers(recode="affine")``: that call first certifies every ``lut``
linear whose codebook lies on an affine grid into a ``uniform`` linear
(``ops/qlinear.certify_uniform``), whose least-squares scale and zero serve
values within 2^-7 of the row's range of the stored codebook, and keeps the
certified layers only if they still stack. The port serves layer by layer
(fusing q/k/v and gate/up rows changes no row's numbers) but applies the
same certification under the same rule (:func:`stacked_model`), so it serves
the numbers the JAX engine serves. On its int8-activation backend the
stacked layout also runs kernels of its own, which come with the stacked
slice of the port: where the JAX engine would (:func:`stacked_only_kernel`),
the port's engine raises, and ``layout="perlayer"`` serves layer by layer as
the JAX engine's ``layout="perlayer"`` does (no certification, no stacked
kernels).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..core.backend import resolve_device, select_backend
from ..models.transformer import (Layer, Model, ModelConfig, causal_mask,
                                  embed, layer_forward, rope_tables, unembed)
from ..ops.qlinear import QLinear, certify_uniform

Cache = List[Dict[str, torch.Tensor]]

# linears the stacked layout fuses by concatenating rows (serve/stacked.py
# fuse_layer): they must share kind and bits, or the JAX engine does not stack
_FUSED = (("attn", ("q", "k", "v")), ("mlp", ("gate", "up")))


def _structure(lp: Layer):
    """What ``jax.tree_util.tree_structure`` and ``jnp.stack`` see of a
    layer: per linear its kind, bits, width and arrays with their shapes."""
    out = []
    for group in ("attn", "mlp"):
        for name, p in getattr(lp, group).items():
            bufs = tuple(sorted((k, tuple(v.shape))
                                for k, v in p._buffers.items() if v is not None))
            out.append((group, name, p.kind, p.bits, p.in_features, bufs))
    return tuple(out)


def _fusable(lp: Layer) -> bool:
    for group, names in _FUSED:
        lins = [getattr(lp, group)[n] for n in names
                if n in getattr(lp, group)]
        if len({(p.kind, p.bits, "zeros" in p) for p in lins}) > 1:
            return False
    return True


def stacked_model(model: Model) -> Optional[Model]:
    """The model the JAX engine's stacked layout serves, or None where that
    engine serves layer by layer (``ganq_tpu/serve/engine.py`` with
    ``stack_layers(recode="affine")``). For a model of more than one layer
    whose layers share one structure, every ``lut`` linear that
    :func:`certify_uniform` accepts becomes a ``uniform`` linear; the
    certified layers stack only if they keep the same kind, bits and
    presence of ``zeros`` in every layer, and fused linears (q/k/v, gate/up)
    of one kind and bits; otherwise the JAX engine serves the uncertified
    params layer by layer. A quantized lm_head is certified as well. Returns
    a new Model sharing every other tensor."""
    layers = list(model.layers)
    if len(layers) <= 1 or len({_structure(lp) for lp in layers}) != 1:
        return None

    def cert(p: QLinear) -> QLinear:
        q = certify_uniform(p)
        return p if q is None else q

    new = [Layer(lp.input_norm.weight, lp.post_norm.weight,
                 {k: cert(v) for k, v in lp.attn.items()},
                 {k: cert(v) for k, v in lp.mlp.items()}) for lp in layers]
    if (len({_structure(lp) for lp in new}) != 1
            or not all(_fusable(lp) for lp in new)):
        return None
    # a quantized lm_head is certified too (serve/stacked.py certify_stacked)
    lm = model.lm_head
    return Model(model.embed_tokens.weight, model.final_norm.weight, new,
                 cert(lm) if isinstance(lm, QLinear) else lm)


# the JAX stacked layout's whole-step megasteps and fused MLP take decode
# batches and forwards of at most this many token rows
# (ganq_tpu/serve/stacked.py mega_env_enabled, models/transformer.py)
_STACKED_KERNEL_ROWS = 64


def stacked_only_kernel(cfg: ModelConfig, model: Model, backend: str,
                        batch: int, prompt_len: int,
                        max_new_tokens: int) -> Optional[str]:
    """The kernel that the JAX engine's stacked layout runs for this request
    on its int8-activation backend (``pallas_a8``, here ``cuda_a8``) and the
    port has not ported, or None. ``model`` is the stacked (certified)
    model. Two kinds, both waiting for the stacked slice:

    - the whole-step megasteps (kernels 12-14, ``serve/stacked.py``
      ``mega_enabled``): decode at batch <= 64 of a head_dim-128 model whose
      linears are all ``w8`` or ``uniform`` (a superset of the JAX gates,
      which add width and group conditions);
    - the fused W8A8 MLP (kernel 9, ``fused_mlp_w8a8``): every forward of at
      most 64 token rows when gate, up and down are ``w8``."""
    if backend != "cuda_a8":
        return None
    decodes = max_new_tokens > 1
    lins = [p for lp in model.layers
            for p in list(lp.attn.values()) + list(lp.mlp.values())]
    if (decodes and batch <= _STACKED_KERNEL_ROWS and cfg.head_dim == 128
            and all(p.kind in ("w8", "uniform") for p in lins)):
        return "a whole-step megastep (kernels 12-14)"
    rows = batch if decodes else batch * prompt_len
    if (rows <= _STACKED_KERNEL_ROWS
            and all(lp.mlp[n].kind == "w8" for lp in model.layers
                    for n in ("gate", "up", "down"))):
        return "fused_mlp_w8a8 (kernel 9)"
    return None


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
               dtype: torch.dtype = torch.bfloat16) -> Cache:
    """Per-layer KV buffers [B, T, Hkv, D] (bf16)."""
    shape = (batch, max_seq, cfg.num_key_value_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_hidden_layers)]


def prefill(cfg: ModelConfig, model: Model, cache: Cache,
            input_ids: torch.Tensor, backend: str = "reference") -> torch.Tensor:
    """Run the prompt [B, S] through the model from position 0, filling the
    cache. Returns the last position's logits [B, vocab]."""
    b, s = input_ids.shape
    max_seq = cache[0]["k"].shape[1]
    positions = torch.arange(s, device=input_ids.device).expand(b, s)
    x = embed(model, input_ids)
    mask = causal_mask(s, max_seq, input_ids.device)
    rope = rope_tables(cfg, positions)
    for lp, lc in zip(model.layers, cache):
        x = layer_forward(cfg, lp, x, mask, rope, cache=lc, cache_pos=0,
                          backend=backend)
    return unembed(cfg, model, x[:, -1:, :], backend)[:, 0, :]


def decode_step(cfg: ModelConfig, model: Model, cache: Cache,
                token: torch.Tensor, pos: torch.Tensor,
                backend: str = "reference") -> torch.Tensor:
    """One decode step. token [B]; pos: 0-d int tensor on the device (the
    position of ``token``). Returns logits [B, vocab]."""
    b = token.shape[0]
    max_seq = cache[0]["k"].shape[1]
    positions = pos.reshape(1, 1).expand(b, 1)
    x = embed(model, token[:, None])
    mask = (torch.arange(max_seq, device=token.device) <= pos)[None, None, None, :]
    rope = rope_tables(cfg, positions)
    for lp, lc in zip(model.layers, cache):
        x = layer_forward(cfg, lp, x, mask, rope, cache=lc, cache_pos=pos,
                          backend=backend)
    return unembed(cfg, model, x, backend)[:, 0, :]


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           temperature: float, top_k: int, top_p: float = 1.0) -> torch.Tensor:
    """Greedy (temperature <= 0) or temperature / top-k / top-p sampling of
    one token per row, as int64."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p < 1.0:
        # nucleus: a token survives if the probability mass sorted before it
        # is below top_p
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        min_keep = torch.min(torch.where(keep, sorted_logits, float("inf")),
                             dim=-1, keepdim=True).values
        logits = torch.where(logits < min_keep, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate_tokens(cfg: ModelConfig, model: Model, cache: Cache,
                    input_ids: torch.Tensor, generator: Optional[torch.Generator],
                    max_new_tokens: int, temperature: float = 0.0,
                    top_k: int = 0, top_p: float = 1.0, eos_id: int = -1,
                    backend: str = "reference") -> torch.Tensor:
    """Prefill + decode loop: input_ids [B, S] -> tokens [B, max_new_tokens]
    (rows that produced ``eos_id`` are padded with it afterwards)."""
    b, s = input_ids.shape
    dev = input_ids.device
    logits = prefill(cfg, model, cache, input_ids, backend)
    tok = sample(logits, generator, temperature, top_k, top_p)
    done = (tok == eos_id) if eos_id >= 0 else torch.zeros(b, dtype=torch.bool,
                                                           device=dev)
    pad = eos_id if eos_id >= 0 else 0
    pos = torch.tensor(s, dtype=torch.int32, device=dev)
    toks = [tok]
    for _ in range(max_new_tokens - 1):
        logits = decode_step(cfg, model, cache, tok, pos, backend)
        nxt = sample(logits, generator, temperature, top_k, top_p)
        nxt = torch.where(done, pad, nxt)
        if eos_id >= 0:
            done = done | (nxt == eos_id)
        toks.append(nxt)
        tok = nxt
        pos = pos + 1
    return torch.stack(toks, dim=1)


class Engine:
    """(cfg, model) on one device with a chosen kernel backend.

    ``device`` defaults to the card; the CPU runs only when asked for.
    ``backend`` defaults to :func:`select_backend`'s choice for the model as
    given. ``layout="auto"`` serves :func:`stacked_model` of it where the
    JAX engine stacks, and raises for a request that the JAX engine would
    serve through a kernel of its stacked layout
    (:func:`stacked_only_kernel`); ``"perlayer"`` serves the model as given,
    as the JAX engine's ``layout="perlayer"`` does."""

    def __init__(self, cfg: ModelConfig, model: Model,
                 backend: Optional[str] = None, max_seq: int = 2048,
                 device="cuda", layout: str = "auto"):
        if layout == "stacked":
            raise NotImplementedError(
                "layout='stacked' comes with the stacked slice of the port "
                "(ROADMAP.md queue A)")
        if layout not in ("auto", "perlayer"):
            raise ValueError(f"unknown layout {layout!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        model = model.to(self.device)
        self.backend = select_backend(model, self.device, backend)
        stacked = stacked_model(model) if layout == "auto" else None
        self.stacked = stacked is not None
        self.model = stacked if self.stacked else model
        self.max_seq = max_seq

    def _prepare(self, input_ids, max_new_tokens: int,
                 max_seq: Optional[int] = None) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.int64,
                              device=self.device)
        if ids.dim() == 1:
            ids = ids[None, :]
        total = ids.shape[1] + max_new_tokens
        if total > (max_seq or self.max_seq):
            raise ValueError(f"sequence {total} exceeds max_seq "
                             f"{max_seq or self.max_seq}")
        kernel = self.stacked and stacked_only_kernel(
            self.cfg, self.model, self.backend, ids.shape[0], ids.shape[1],
            max_new_tokens)
        if kernel:
            raise NotImplementedError(
                f"the JAX engine serves this request through {kernel} of its "
                "stacked layout, which comes with the stacked slice of the "
                "port (ROADMAP.md queue B); pass layout='perlayer' (int8 "
                "activations, per-layer kernels) or backend='cuda'")
        return ids

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 eos_id: int = -1, seed: int = 0,
                 max_seq: Optional[int] = None) -> np.ndarray:
        """Tokens [B, max_new_tokens]; ``max_seq`` sizes this request's KV
        cache (default the engine's)."""
        ids = self._prepare(input_ids, max_new_tokens, max_seq)
        cache = init_cache(self.cfg, ids.shape[0], max_seq or self.max_seq,
                           self.device)
        out = generate_tokens(self.cfg, self.model, cache, ids,
                              self._generator(seed), max_new_tokens,
                              temperature, top_k, top_p, eos_id, self.backend)
        return out.cpu().numpy().astype(np.int32)

    @torch.inference_mode()
    def stream(self, input_ids, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos_id: int = -1, seed: int = 0) -> Iterator[int]:
        """Token-by-token generator for one sequence: yields each token as it
        is produced (one host sync per token); stops at eos."""
        ids = self._prepare(input_ids, max_new_tokens)
        if ids.shape[0] != 1:
            raise ValueError("stream() is single-sequence (batch=1)")
        gen = self._generator(seed)
        cache = init_cache(self.cfg, 1, self.max_seq, self.device)
        logits = prefill(self.cfg, self.model, cache, ids, self.backend)
        pos = torch.tensor(ids.shape[1], dtype=torch.int32, device=self.device)
        for _ in range(max_new_tokens):
            tok = sample(logits, gen, temperature, top_k, top_p)
            t = int(tok[0])
            if eos_id >= 0 and t == eos_id:
                return
            yield t
            logits = decode_step(self.cfg, self.model, cache, tok, pos,
                                 self.backend)
            pos = pos + 1


__all__ = ["Engine", "init_cache", "prefill", "decode_step", "generate_tokens",
           "sample", "stacked_model", "stacked_only_kernel"]
