"""Quantized inference engine: KV cache, prefill, decode steps, generation.

The port of ``ganq_tpu/serve/engine.py``. The JAX engine compiles prefill and
a ``lax.scan`` decode loop; PyTorch runs eagerly, so here prefill and each
decode step are plain calls over the layers, and the cache is updated in
place. The position, the sampled tokens and the finished flags stay on the
device, so a decode step needs no host sync.

As the JAX engine (``layout="auto"``) does, the port serves a homogeneous
dense-MLP model of more than one layer through the stacked layout
(``serve/stacked.py``): ``stack_layers(recode="affine")`` certifies every
``lut`` linear whose codebook lies on an affine grid into a ``uniform``
linear and fuses each layer's rows, and ``prepack`` (at batch 1, as there)
packs the whole-step megastep's operands. Requests then take the fused
kernels and the megasteps (kernels 12-14) where the JAX engine's gates send
them. Where its gate picks a whole-step variant the port does not have yet
(kernel 14's later sub-slices: :func:`stacked_only_kernel`), the engine
raises; ``layout="perlayer"`` serves the model as given, layer by layer, as
the JAX engine's ``layout="perlayer"`` does. MoE models stay per layer,
where the fused expert kernel (kernel 15) serves their decode steps
(``models/transformer._moe_combine``), and so do act-order models whose
groups are not balanced (``prepack`` raises ValueError).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..core.backend import resolve_device, select_backend
from ..models.transformer import (Model, ModelConfig, causal_mask, embed,
                                  layer_forward, rope_tables, unembed)

Cache = List[Dict[str, torch.Tensor]]


def stacked_only_kernel(cfg: ModelConfig, sp: Optional[Model], backend: str,
                        batch: int, max_new_tokens: int,
                        device="cuda") -> Optional[str]:
    """What of the whole-step kernel that the JAX engine's stacked layout
    runs for this request the port has not ported, or None: where the
    request decodes and ``serve/stacked.mega_enabled`` picks a variant that
    ``serve/stacked.missing_kernel`` names (kernel 14's "w3", "w2" and
    "wl8", and its later sub-slices' operands). ``sp`` is the engine's
    stacked model."""
    from . import stacked

    if max_new_tokens <= 1:
        return None
    return stacked.missing_kernel(
        cfg, sp, stacked.mega_enabled(cfg, sp, backend, batch, device))


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
    given. ``layout="auto"`` serves the stacked layout where the JAX engine
    stacks (``serve/stacked.py``; ``self.stacked`` says so) and the model as
    given otherwise; ``"stacked"`` raises ValueError where the layers do not
    stack; ``"perlayer"`` serves the model as given."""

    def __init__(self, cfg: ModelConfig, model: Model,
                 backend: Optional[str] = None, max_seq: int = 2048,
                 device="cuda", layout: str = "auto"):
        from . import stacked

        if layout not in ("auto", "perlayer", "stacked"):
            raise ValueError(f"unknown layout {layout!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        model = model.to(self.device)
        self.backend = select_backend(model, self.device, backend)
        sp = None
        # MoE models stay per layer: the fused expert kernel (kernel 15)
        # is reached through the per-layer MoE combine
        if (layout != "perlayer" and len(model.layers) > 1
                and not any(lp.moe is not None for lp in model.layers)):
            try:
                sp = stacked.stack_layers(model, recode="affine")
                sp = stacked.prepack(cfg, sp, self.backend, 1, self.device)
            except ValueError:
                sp = None            # mixed kinds or bits, or act-order
                                     # groups out of balance: per layer
            except NotImplementedError:
                # a later kernel-14 variant: its requests raise in generate
                sp = stacked.certify_stacked(sp)
        if layout == "stacked" and sp is None:
            raise ValueError("layout='stacked' requires homogeneous layer "
                             "parameters")
        self.stacked = sp is not None
        self.model = sp if self.stacked else model
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
        return ids

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 eos_id: int = -1, seed: int = 0,
                 max_seq: Optional[int] = None) -> np.ndarray:
        """Tokens [B, max_new_tokens]; ``max_seq`` sizes this request's KV
        cache (default the engine's). Raises NotImplementedError where the
        JAX engine would run an unported whole-step kernel
        (:func:`stacked_only_kernel`)."""
        ids = self._prepare(input_ids, max_new_tokens, max_seq)
        T = max_seq or self.max_seq
        if self.stacked:
            from . import stacked

            kernel = stacked_only_kernel(self.cfg, self.model, self.backend,
                                         ids.shape[0], max_new_tokens,
                                         self.device)
            if kernel:
                raise NotImplementedError(
                    f"the JAX engine serves this request through {kernel} "
                    "of its stacked layout, which comes with a later slice "
                    "of the port (ROADMAP.md queue B); pass "
                    "layout='perlayer' (per-layer kernels) or "
                    "backend='cuda'")
            ck, cv = stacked.init_cache(self.cfg, len(self.model.layers),
                                        ids.shape[0], T, self.device)
            out = stacked.generate_tokens(
                self.cfg, self.model, ck, cv, ids, self._generator(seed),
                max_new_tokens, temperature, top_k, top_p, eos_id,
                self.backend)
        else:
            cache = init_cache(self.cfg, ids.shape[0], T, self.device)
            out = generate_tokens(self.cfg, self.model, cache, ids,
                                  self._generator(seed), max_new_tokens,
                                  temperature, top_k, top_p, eos_id,
                                  self.backend)
        return out.cpu().numpy().astype(np.int32)

    @torch.inference_mode()
    def stream(self, input_ids, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos_id: int = -1, seed: int = 0) -> Iterator[int]:
        """Token-by-token generator for one sequence: yields each token as it
        is produced (one host sync per token); stops at eos. Decode steps
        run layer by layer, as the JAX engine's ``stream`` does."""
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
           "sample", "stacked_only_kernel"]
