"""Continuous batching: a fixed pool of KV-cache slots and a host scheduler.

The port of ``ganq_tpu/serve/batching.py``. Requests prefill into a free
slot (the prompt right-padded to a length bucket); every engine step decodes
all slots at once, each at its own position; a finished request frees its
slot for the next one at once.

Two modes, picked at construction in ``ganq_tpu``'s order:

- **whole step**: where ``serve/stacked.mega_env_enabled`` allows it (the
  card under ``"cuda_a8"``, or ``GANQ_MEGASTEP=1``), the model stacks
  (``stack_layers(recode="affine")``), ``w8`` layers convert to uniform
  8-bit (``w8p_stacked``, at every slot count, unless ``GANQ_W8_PLANE=0``:
  only the plane kernels take per-slot positions) and ``mega_enabled``
  picks kernel 13 ("w4") or 14 ("w4p", "w3", "w2", "w8p", and "wl8" for
  3-bit 8-entry codebooks): one launch per decode step over every slot, at
  per-slot positions, with a ``w8`` lm_head folded into that launch
  (``ops/megastep_lowbit.mega_lm_operands``). The per-layer model is
  dropped; prompts prefill through the stacked layers. Qwen3's qk-norm and
  InternLM's biases ride
  the step in the pack (kernel 14's ``qk_nm``, ``o_bias``, ``gu_bias``,
  ``dn_bias``), gemma's sandwich norms too (``pa_norm``, ``pm_norm``), and
  its windows, softcap and dual rope as arguments at each slot's
  position. EoRA adapters ride the step (kernel
  14's epilogue) or, per layer, ``ops/qlinear.apply``'s rank-r term.
- **per layer**: ``models/transformer.layer_forward`` at a vector of cache
  positions (the masked attention, each slot's sliding window, the
  linears' kernels).

Sampling draws from one ``core/prng`` key chain (``PRNGKey(0)``, split once
per sampled token, as ``ganq_tpu`` does), so sampled tokens equal
``ganq_tpu``'s for the same requests in the same order.
"""

from __future__ import annotations

import itertools
import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import prng
from ..core.backend import resolve_device, select_backend
from ..models.transformer import (Model, ModelConfig, _fused_act_kind,
                                  embed, layer_forward, rope_for_layer,
                                  rope_tables_all, unembed)
from ..utils.logger import get_logger
from . import stacked
from .engine import init_cache

log = get_logger(__name__)

Cache = List[Dict[str, torch.Tensor]]


# ------------------------------------------------------------ device programs
@torch.inference_mode()
def prefill_into_slot(cfg: ModelConfig, model: Model, cache: Cache,
                      ids: torch.Tensor, slot: int,
                      backend: str = "reference") -> torch.Tensor:
    """Prefill ids [1, s] into cache slot ``slot`` (zeroed first, as the JAX
    package writes a fresh slot). Returns the last position's logits [V]."""
    s = ids.shape[1]
    positions = torch.arange(s, device=ids.device)[None, :]
    x = embed(cfg, model, ids)
    rope = rope_tables_all(cfg, positions)
    for i, (lp, lc) in enumerate(zip(model.layers, cache)):
        slot_cache = {k: v[slot:slot + 1] for k, v in lc.items()}
        for v in slot_cache.values():
            v.zero_()
        x = layer_forward(cfg, lp, x, None, rope_for_layer(cfg, rope, i),
                          cache=slot_cache, cache_pos=0, backend=backend,
                          window=cfg.layer_window(i))
    return unembed(cfg, model, x[:, -1:, :], backend)[0, 0, :]


@torch.inference_mode()
def _decode_slots_impl(cfg: ModelConfig, model: Model, cache: Cache,
                       tokens: torch.Tensor, pos: torch.Tensor,
                       backend: str) -> torch.Tensor:
    """One decode step over all slots at per-slot positions ``pos`` [S]:
    the full ``layer_forward`` with a vector cache position (each slot's
    own sliding window, ``ganq_tpu/serve/batching.py:87-108``). Logits
    [S, V]."""
    T = cache[0]["k"].shape[1]
    positions = pos[:, None]
    x = embed(cfg, model, tokens[:, None])
    mask = (torch.arange(T, device=pos.device)[None, :]
            <= pos[:, None])[:, None, None, :]
    rope = rope_tables_all(cfg, positions)
    for i, (lp, lc) in enumerate(zip(model.layers, cache)):
        x = layer_forward(cfg, lp, x, mask, rope_for_layer(cfg, rope, i),
                          cache=lc, cache_pos=pos, backend=backend,
                          window=cfg.layer_window(i))
    return unembed(cfg, model, x, backend)[:, 0, :]


@torch.inference_mode()
def _mega_prefill_slot(cfg: ModelConfig, sp: Model, ids: torch.Tensor,
                       mk: torch.Tensor, mv: torch.Tensor, slot: int,
                       backend: str = "reference") -> torch.Tensor:
    """Prefill ids [1, s] through the stacked layers and write the slot's
    rows of the whole-step cache [L, S * Hkv, T, d] in place. Returns the
    last position's logits [V]."""
    L, _, T, d = mk.shape
    ck1, cv1 = stacked.init_cache(cfg, L, 1, T, mk.device, mk.dtype)
    logits = stacked.prefill(cfg, sp, ck1, cv1, ids, backend)
    Hkv = ck1.shape[3]
    rows = slice(slot * Hkv, (slot + 1) * Hkv)
    mk[:, rows] = ck1[:, 0].transpose(1, 2)          # [L, Hkv, T, d]
    mv[:, rows] = cv1[:, 0].transpose(1, 2)
    return logits[0]


@torch.inference_mode()
def _mega_decode_slots(cfg: ModelConfig, sp: Model, mp, mk: torch.Tensor,
                       mv: torch.Tensor, tokens: torch.Tensor,
                       pos: torch.Tensor, variant: str = "w4",
                       backend: str = "reference",
                       fold: bool = True) -> torch.Tensor:
    """One whole-step launch over all slots at per-slot positions ``pos``
    [S] (kernel 13 for "w4", 14 for "w4p"/"w3"/"w2"/"w8p" and, with
    ``walsh=7``, "wl8"): per-row rope tables and
    histories; then each slot's new k/v written at its own position of
    mk/mv [L, S * Hkv, T, d] (in place; a retired slot past T writes its
    last row, as ``dynamic_update_slice`` clamps). Kernel 14 folds a ``w8``
    lm_head into the launch wherever ``mega_lm_operands`` gives operands,
    as ``ganq_tpu``'s batching does (it reads no ``GANQ_LM_FOLD``);
    ``fold=False`` unembeds after the step instead. Logits [S, V]."""
    from ..ops.megastep4 import megastep4_decode
    from ..ops.megastep_lowbit import mega_lm_operands, megastep_lowbit_decode

    S = tokens.shape[0]
    L, _, T, d = mk.shape
    kw = {}
    if variant == "w4":
        step_fn = megastep4_decode
        kv_dim = (mp["qkv_p4"].shape[1] * 2 - cfg.q_dim) // 2
    else:
        step_fn = megastep_lowbit_decode
        kw["bits"] = stacked._LB_BITS[variant]
        if variant == "wl8":
            kw["walsh"] = 7          # the exact 8-entry codebooks
        kv_dim = stacked._lb_kv_dim(cfg, mp, kw["bits"])
        lm = mega_lm_operands(cfg, sp) if fold else None
        if lm is not None:
            kw["lm"] = lm
    Hkv = kv_dim // d
    positions = pos[:, None]
    x = embed(cfg, sp, tokens[:, None])[:, 0, :]
    # each slot's own rope rows; kernel 14 also takes gemma's windows,
    # softcap and dual rope at the slots' positions
    rd, cos_h, sin_h, extra = stacked._mega_rope_kw(cfg, positions, L, T)
    if variant != "w4":
        kw.update(extra)
    scale = cfg.attn_scale if cfg.attn_scale is not None else 1.0 / math.sqrt(d)
    out = step_fn(x, mp, mk, mv, pos, cos_h, sin_h, q_dim=cfg.q_dim,
                  kv_dim=kv_dim, head_dim=d, rotary_dim=rd, eps=cfg.norm_eps,
                  rms_offset=cfg.rms_offset, scale=scale,
                  act=_fused_act_kind(cfg), **kw)
    y, kn, vn = out[:3]
    slots = torch.arange(S, device=mk.device)
    at = pos.to(torch.int64).clamp(max=T - 1)
    for cache, new in ((mk, kn), (mv, vn)):
        # [L, S, Hkv, T, d] viewed as [S, T, L, Hkv, d]: one row per slot
        view = cache.view(L, S, Hkv, T, d).permute(1, 3, 0, 2, 4)
        view[slots, at] = new.reshape(L, S, Hkv, d).transpose(0, 1).to(
            cache.dtype)
    if len(out) == 4:                       # the trailing-unembed fold
        return stacked._fold_logit_epilogue(cfg, out[3])
    return unembed(cfg, sp, y[:, None, :], backend)[:, 0, :]


# --------------------------------------------------------------- host scheduler
@dataclass
class Request:
    req_id: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    generated: List[int] = field(default_factory=list)
    done: bool = False


class BatchingEngine:
    """Continuous-batching scheduler over a fixed slot pool on one device
    (the card unless ``device="cpu"``); ``backend`` defaults to
    :func:`~ganq_tpu_torch.core.backend.select_backend`'s choice. After
    construction ``_mega_variant`` names the whole-step variant, or is None
    in per-layer mode."""

    def __init__(self, cfg: ModelConfig, model: Model,
                 backend: Optional[str] = None, slots: int = 4,
                 max_seq: int = 512, eos_id: int = -1,
                 prompt_buckets=(32, 64, 128, 256, 512), device="cuda"):
        self.device = resolve_device(device)
        model = model.to(self.device)
        self.cfg = cfg
        self.backend = select_backend(model, self.device, backend)
        self.model: Optional[Model] = model
        self.slots = slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.buckets = [b for b in prompt_buckets if b <= max_seq]
        self._sp: Optional[Model] = None
        self._mp = None
        self._mega_kv = None
        self._mega_variant: Optional[str] = None
        # the cheap environment and backend gate first: stacking copies
        # the recoded layers, so it is tried only where the path can engage
        if (stacked.mega_env_enabled(self.backend, slots, self.device)
                and len(model.layers) > 1
                and not any(lp.moe is not None for lp in model.layers)):
            try:
                sp = stacked.stack_layers(model, recode="affine")
            except ValueError:
                sp = None
            if sp is not None and os.environ.get("GANQ_W8_PLANE", "1") != "0":
                # only the plane kernels take per-slot positions, so int8
                # layers convert at every slot count
                sp = stacked.w8p_stacked(sp)
            variant = (None if sp is None else stacked.mega_enabled(
                cfg, sp, self.backend, slots, self.device))
            if variant in ("w4", "w4p", "w3", "w2", "w8p", "wl8"):
                self._sp = stacked.prepack(cfg, sp, self.backend, slots,
                                           self.device)
                self._mega_variant = variant
                self._mp = getattr(self._sp, stacked._PACK_ATTR[variant])
                L = cfg.num_hidden_layers
                shape = (L, slots * cfg.num_key_value_heads, max_seq,
                         cfg.head_dim)
                self._mega_kv = tuple(
                    torch.zeros(shape, dtype=torch.bfloat16,
                                device=self.device) for _ in range(2))
                # the whole step reads the stacked model only: drop the
                # per-layer one
                self.model = None
                log.info("batching: %s whole-step path active", variant)
        self.cache = (None if self._mega_kv is not None else
                      init_cache(cfg, slots, max_seq, self.device))
        self.pos = np.zeros(slots, np.int32)       # next write position
        self.tokens = np.zeros(slots, np.int64)    # last sampled token
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self._ids = itertools.count()
        self._key = prng.prng_key(0)

    # ---------------------------------------------------------------- public
    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0) -> int:
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > self.max_seq:
            raise ValueError("request exceeds max_seq")
        r = Request(next(self._ids), prompt, max_new_tokens, temperature)
        self.queue.append(r)
        return r.req_id

    def step(self) -> Dict[int, List[int]]:
        """Admit from the queue, run one decode step; returns the tokens
        emitted by this call per request (up to two for a request admitted
        now whose prompt fills its bucket exactly)."""
        out: Dict[int, List[int]] = {rid: [t]
                                     for rid, t in self._admit().items()}
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return out
        tokens = torch.as_tensor(self.tokens, device=self.device)
        pos = torch.as_tensor(self.pos, device=self.device)
        if self._mega_kv is not None:
            mk, mv = self._mega_kv
            logits = _mega_decode_slots(self.cfg, self._sp, self._mp, mk, mv,
                                        tokens, pos, self._mega_variant,
                                        self.backend)
        else:
            logits = _decode_slots_impl(self.cfg, self.model, self.cache,
                                        tokens, pos, self.backend)
        logits = logits.float().cpu().numpy()
        for i in active:
            r = self.slot_req[i]
            tok = self._sample_first(logits[i], r.temperature)
            r.generated.append(tok)
            out.setdefault(r.req_id, []).append(tok)
            self.pos[i] += 1
            self.tokens[i] = tok
            if ((self.eos_id >= 0 and tok == self.eos_id)
                    or len(r.generated) >= r.max_new_tokens
                    or self.pos[i] >= self.max_seq):
                r.done = True
                self.slot_req[i] = None
        return out

    def run_all(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Drive until the queue and the slots drain; {req_id: tokens}."""
        submitted = {r.req_id: r for r in self.queue}
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slot_req):
                break
            for r in self.slot_req:
                if r is not None:
                    submitted.setdefault(r.req_id, r)
            self.step()
        return {rid: r.generated for rid, r in submitted.items()}

    # --------------------------------------------------------------- private
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_seq

    def _sample_first(self, logits: np.ndarray, temperature: float) -> int:
        """Admission's first token, with the decode steps' policy: greedy,
        or the Gumbel draw of the next key of the engine's one chain
        (deterministic, so replicas stay in lockstep) over logits /
        temperature."""
        if temperature > 0:
            k = prng.split(self._key)
            self._key = k[0]
            lg = torch.from_numpy(np.asarray(logits, np.float32))
            return int(prng.categorical(k[1], lg / torch.full_like(
                lg, temperature)))
        return int(np.argmax(logits))

    def _admit_slot(self, i: int, r: Request) -> Optional[int]:
        """Prefill ``r`` into slot ``i``. Returns the first token when the
        prompt fills its bucket exactly (drawn from the prefill's logits);
        a padded prompt re-decodes token n-1 at the next step instead."""
        n = len(r.prompt)
        bucket = self._bucket(n)
        padded = np.zeros(bucket, np.int64)
        padded[:n] = r.prompt
        ids = torch.as_tensor(padded[None, :], device=self.device)
        if self._mega_kv is not None:
            mk, mv = self._mega_kv
            logits = _mega_prefill_slot(self.cfg, self._sp, ids, mk, mv, i,
                                        self.backend)
        else:
            logits = prefill_into_slot(self.cfg, self.model, self.cache, ids,
                                       i, self.backend)
        if bucket == n:
            first = self._sample_first(logits.float().cpu().numpy(),
                                       r.temperature)
            r.generated.append(first)
            self.tokens[i] = first
            self.pos[i] = n
            self.slot_req[i] = r
            if ((self.eos_id >= 0 and first == self.eos_id)
                    or r.max_new_tokens <= 1):
                r.done = True
                self.slot_req[i] = None
            return first
        # padded: position n-1's logits are internal; the next decode step
        # recomputes token n-1 and samples token n
        self.tokens[i] = int(r.prompt[-1])
        self.pos[i] = n - 1
        self.slot_req[i] = r
        return None

    def _admit(self) -> Dict[int, int]:
        """Fill free slots; returns the first tokens drawn at admission."""
        emitted: Dict[int, int] = {}
        for i in range(self.slots):
            if self.slot_req[i] is not None or not self.queue:
                continue
            r = self.queue.pop(0)
            first = self._admit_slot(i, r)
            if first is not None:
                emitted[r.req_id] = first
        return emitted


class ThreadedBatcher:
    """Thread-safe front for :class:`BatchingEngine`: concurrent callers
    submit and block; one worker thread drives the engine's steps, so that
    independent requests share decode steps (the OpenAI server's
    ``use_batching=True``)."""

    def __init__(self, cfg: ModelConfig, model: Model,
                 backend: Optional[str] = None, slots: int = 4,
                 max_seq: int = 512, eos_id: int = -1, device="cuda"):
        self.engine = BatchingEngine(cfg, model, backend=backend, slots=slots,
                                     max_seq=max_seq, eos_id=eos_id,
                                     device=device)
        self._cv = threading.Condition(threading.Lock())
        self._done: Dict[int, List[int]] = {}
        self._tracked: Dict[int, Request] = {}
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop:
            with self._cv:
                has_work = (self.engine.queue
                            or any(s is not None
                                   for s in self.engine.slot_req))
            if not has_work:
                time.sleep(0.005)
                continue
            with self._cv:
                for r in list(self.engine.queue):
                    self._tracked[r.req_id] = r
                for r in self.engine.slot_req:
                    if r is not None:
                        self._tracked[r.req_id] = r
                self.engine.step()
                finished = [rid for rid, r in self._tracked.items() if r.done]
                for rid in finished:
                    self._done[rid] = self._tracked.pop(rid).generated
                if finished:
                    self._cv.notify_all()

    def generate_ids(self, prompt_ids, max_new_tokens: int = 32,
                     temperature: float = 0.0, timeout: float = 600.0
                     ) -> List[int]:
        with self._cv:
            rid = self.engine.submit(prompt_ids, max_new_tokens, temperature)
            if not self._cv.wait_for(lambda: rid in self._done,
                                     timeout=timeout):
                raise TimeoutError(f"request {rid} timed out")
            return self._done.pop(rid)

    def shutdown(self) -> None:
        self._stop = True
        self._thread.join(timeout=5)


__all__ = ["BatchingEngine", "Request", "ThreadedBatcher",
           "prefill_into_slot"]
