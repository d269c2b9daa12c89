"""The stacked serving layout: fused layers and the whole-step megasteps.

The port of ``ganq_tpu/serve/stacked.py``. The JAX package stacks the layer
parameters with a leading layer axis and scans one layer body over them;
PyTorch needs no scan, so here "stacked" is a model whose layers are fused
(:func:`fuse_layer`: q/k/v rows into one ``qkv`` linear, gate/up into
``gateup``, and the transposed int8 o weight), served by a Python loop over
the layers, plus the megasteps' ``[L, ...]`` operands (:func:`prepack`).
Fusing rows changes no row's numbers.

Routing follows the JAX package's. :func:`mega_enabled` picks the whole-step
variant of a request from the gates of the whole-step kernels, in the JAX
order: ``"w8"`` is kernel 12 (``ops/megastep.py``), ``"w4"`` kernel 13
(``ops/megastep4.py``), ``"w4p"`` and ``"w8p"`` kernel 14
(``ops/megastep_lowbit.py``); kernel 14's ``"w3"``, ``"w2"`` and ``"wl8"``,
and its variants with optional operands other than zero points and
act-order (EoRA, biases, the lm fold), come with later slices (:func:`missing_kernel`,
``ROADMAP.md`` queue B). The decode steps of a request with a variant run
the megastep once per step; the others, and every prefill, run the layers
one by one (``models/transformer.layer_forward``), where the fused MLP
(kernel 9) and the opt-in kernels 10 and 11 live. The environment switches
(``GANQ_MEGASTEP``, ``GANQ_LUT_AFFINE``, ``GANQ_W8_PLANE``, ``GANQ_WALSH``,
``GANQ_W4_PLANE``, ``GANQ_LM_FOLD``) are the JAX package's, read when a
request is resolved. The megastep is on by default for ``"cuda_a8"`` on the
card; on the CPU only with ``GANQ_MEGASTEP=1`` (then its plain version
runs).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import torch

from ..models.transformer import (Layer, Model, ModelConfig,
                                  _fused_act_kind, _rope_half_tables, embed,
                                  rope_tables, unembed)
from ..ops.qlinear import (QLinear, certify_uniform, concat_rows, recode_w8,
                           w8_to_uniform8)
from .engine import decode_step as _decode_layers
from .engine import prefill as _prefill_layers
from .engine import sample

# whole-step variants and the kernel that serves each; kernel 14's variants
# by their plane bits (``stacked.py:195``)
_LB_BITS = {"w4p": 4, "w3": 3, "w2": 2, "w8p": 8, "wl8": 3}
_KERNEL_OF = {"w8": "megastep_decode_w8a8 (kernel 12)",
              "w4": "megastep4_decode (kernel 13)"}
for _v in _LB_BITS:
    _KERNEL_OF[_v] = f"megastep_lowbit_decode (kernel 14, variant {_v!r})"
# the variants the port serves, and the attribute of the stacked model that
# keeps each one's pack
_PACK_ATTR = {"w8": "megapack_w8", "w4": "megapack4", "w4p": "megapack_lb",
              "w8p": "megapack_lb"}


def _layer(lp: Layer, attn: Dict[str, QLinear], mlp: Dict[str, QLinear],
           **extra) -> Layer:
    return Layer(lp.input_norm.weight, lp.post_norm.weight, attn, mlp,
                 **extra)


def fuse_layer(lp: Layer) -> Layer:
    """q/k/v -> one ``qkv`` linear, gate/up -> ``gateup``; a ``w8`` o
    without bias also gives its transposed weight ``o_t_w8 [Dq', H]`` and
    scale row ``o_t_scale [1, H]`` (kernels 11 and 12). Raises ValueError
    where the rows cannot fuse (:func:`~ganq_tpu_torch.ops.qlinear.concat_rows`)."""
    a, m = lp.attn, lp.mlp
    attn = dict(a.items())
    extra = {}
    if all(k in a for k in ("q", "k", "v")):
        attn = {"qkv": concat_rows([a["q"], a["k"], a["v"]]), "o": a["o"]}
        o = a["o"]
        if o.kind == "w8" and "bias" not in o:
            extra = {"o_t_w8": o["w8"].T.contiguous(),
                     "o_t_scale": o["scale"].reshape(1, -1)}
    mlp = dict(m.items())
    if "gate" in m and "up" in m:
        mlp = {"gateup": concat_rows([m["gate"], m["up"]]), "down": m["down"]}
    return _layer(lp, attn, mlp, **extra)


def _map_linears(lp: Layer, fn) -> Layer:
    return _layer(lp, {k: fn(v) for k, v in lp.attn.items()},
                  {k: fn(v) for k, v in lp.mlp.items()},
                  o_t_w8=lp.o_t_w8, o_t_scale=lp.o_t_scale)


def recode_layer_w8(lp: Layer) -> Layer:
    """Every ``lut`` (or ``uniform``) linear of a layer recoded to ``w8``."""
    return _map_linears(lp, recode_w8)


def _certified(p: QLinear) -> QLinear:
    q = certify_uniform(p)
    return p if q is None else q


def recode_layer_affine(lp: Layer) -> Layer:
    """Affine-grid ``lut`` linears certified to ``uniform`` (lossless within
    2^-7 of the row's range); free codebooks stay ``lut``."""
    return _map_linears(lp, _certified)


def _structure(lp: Layer):
    """What stacking needs equal across layers: per linear its kind, bits,
    width and arrays with their shapes (``jax.tree_util.tree_structure``
    and ``jnp.stack`` of the JAX package)."""
    out = []
    for group in ("attn", "mlp"):
        for name, p in getattr(lp, group).items():
            bufs = tuple(sorted((k, tuple(v.shape))
                                for k, v in p._buffers.items() if v is not None))
            out.append((group, name, p.kind, p.bits, p.in_features, bufs))
    return tuple(out)


def stack_layers(model: Model, fuse: bool = True,
                 recode: str = "none") -> Model:
    """The stacked model: ``recode="affine"`` certifies affine-grid ``lut``
    codebooks (``GANQ_LUT_AFFINE=0`` opts out), ``"w8"`` recodes to int8;
    then each layer is fused. Raises ValueError where the JAX package's
    ``stack_layers`` fails: layers of different structure, or linears whose
    rows cannot fuse. Returns a new Model sharing every other tensor."""
    layers = list(model.layers)
    if recode == "affine" and os.environ.get("GANQ_LUT_AFFINE", "1") != "0":
        layers = [recode_layer_affine(lp) for lp in layers]
    if recode == "w8":
        layers = [recode_layer_w8(lp) for lp in layers]
    if fuse:
        layers = [fuse_layer(lp) for lp in layers]
    if len({_structure(lp) for lp in layers}) != 1:
        raise ValueError("layers of different structure do not stack")
    return Model(model.embed_tokens.weight, model.final_norm.weight, layers,
                 model.lm_head)


def certify_stacked(sp: Model) -> Model:
    """``lut`` linears of the stacked model and a quantized lm_head
    certified onto ``uniform`` where their codebooks lie on an affine grid."""
    lm = sp.lm_head
    out = Model(sp.embed_tokens.weight, sp.final_norm.weight,
                [_map_linears(lp, _certified) for lp in sp.layers],
                _certified(lm) if isinstance(lm, QLinear) else lm)
    for attr in set(_PACK_ATTR.values()):
        setattr(out, attr, getattr(sp, attr, None))
    return out


def w8p_stacked(sp: Model) -> Model:
    """``w8`` linears of the stacked layers converted losslessly to uniform
    8-bit (the ``"w8p"`` variant's artifact); the transposed o goes with
    them. The lm_head stays as it is."""
    changed = False

    def rec(p: QLinear) -> QLinear:
        nonlocal changed
        q = w8_to_uniform8(p)
        changed = changed or q is not p
        return q

    layers = [_map_linears(lp, rec) for lp in sp.layers]
    if not changed:
        return sp
    layers = [_layer(lp, dict(lp.attn.items()), dict(lp.mlp.items()))
              for lp in layers]
    return Model(sp.embed_tokens.weight, sp.final_norm.weight, layers,
                 sp.lm_head)


def mega_env_enabled(backend: str, batch: int, device) -> bool:
    """The environment, backend and batch part of the megastep gate:
    ``GANQ_MEGASTEP=0`` or a batch above 64 turns it off; it is on by
    default for ``"cuda_a8"`` on the card, and ``GANQ_MEGASTEP=1`` forces it
    under any backend and device (on the CPU its plain version runs)."""
    env = os.environ.get("GANQ_MEGASTEP", "")
    if env == "0" or batch > 64:
        return False
    if env != "1" and (backend != "cuda_a8"
                       or torch.device(device).type == "cpu"):
        return False
    return True


def mega_enabled(cfg: ModelConfig, sp: Optional[Model], backend: str,
                 batch: int, device) -> Optional[str]:
    """The whole-step variant the JAX package serves this decode batch with
    (``stacked.py:204-253``, in its order), or None."""
    if sp is None or not mega_env_enabled(backend, batch, device):
        return None
    from ..ops.megastep import megastep_fusable
    from ..ops.megastep4 import megastep4_fusable
    from ..ops.megastep_lowbit import (megastep_lowbit_fusable,
                                       megastep_walsh_fusable)

    if (os.environ.get("GANQ_WALSH", "1") != "0"
            and megastep_walsh_fusable(cfg, sp)):
        return "wl8"
    if (os.environ.get("GANQ_W4_PLANE", "1") != "0"
            and megastep_lowbit_fusable(cfg, sp, 4)):
        return "w4p"
    if batch <= 8 and megastep4_fusable(cfg, sp):
        return "w4"
    if megastep_lowbit_fusable(cfg, sp, 3):
        return "w3"
    if megastep_lowbit_fusable(cfg, sp, 2):
        return "w2"
    if batch <= 8 and megastep_fusable(cfg, sp):
        return "w8"
    if megastep_lowbit_fusable(cfg, sp, 8):
        return "w8p"
    return None


def _lb_kv_dim(cfg: ModelConfig, mp, bits: int) -> int:
    from ..ops.megastep_lowbit import _plan_meta

    metas, _, _, g_r = _plan_meta(bits)
    return (mp["qkv_pk"].shape[1] * g_r // len(metas) - cfg.q_dim) // 2


def lm_fold_engages(cfg: ModelConfig, sp: Model) -> bool:
    """Whether the JAX package's kernel 14 call folds the final norm and the
    lm_head into the step (``mega_lm_operands``, ``megastep_lowbit.py:
    1870``, unless ``GANQ_LM_FOLD=0``): a ``w8`` lm_head without bias with
    one scale per row and a vocabulary tile of at most 4 MB."""
    if os.environ.get("GANQ_LM_FOLD", "1") == "0":
        return False
    lm = sp.lm_head
    if not isinstance(lm, QLinear) or lm.kind != "w8" or "bias" in lm:
        return False
    V, H = lm["w8"].shape
    if lm["scale"].numel() != V:
        return False
    return any(V % tv == 0 and tv * H <= 4 * 1024 * 1024
               for tv in (4096, 2048, 1024, 512, 256, 128))


def _later_operands(sp: Model) -> Optional[str]:
    """The first operand of the stacked layers that kernel 14's later
    sub-slices bring (EoRA, o/gate-up/down biases), or None."""
    lp = sp.layers[0]
    mats = (lp.attn["qkv"], lp.attn["o"], lp.mlp["gateup"], lp.mlp["down"])
    if any("lora_a" in m for m in mats):
        return "EoRA adapters"
    if any("bias" in m for m in mats[1:]):
        return "o/gate-up/down biases"
    return None


def missing_kernel(cfg: ModelConfig, sp: Optional[Model],
                   variant: Optional[str]) -> Optional[str]:
    """What of the whole-step kernel that serves ``variant`` on ``sp`` the
    port has not ported, or None: kernel 14's "w3", "w2" and "wl8" variants,
    and "w4p"/"w8p" with an operand of a later sub-slice or where the JAX
    package folds the lm_head into the step."""
    if variant is None or variant in ("w8", "w4"):
        return None
    if variant not in _PACK_ATTR:
        return _KERNEL_OF[variant]
    feature = _later_operands(sp)
    if feature is None and lm_fold_engages(cfg, sp):
        feature = "the trailing-unembed lm fold"
    return f"{_KERNEL_OF[variant]} with {feature}" if feature else None


def _pack(cfg: ModelConfig, sp: Model, variant: str):
    """The variant's pack; kernel 14's bakes act-order artifacts first
    (``actorder_transform``: ValueError on unbalanced groups) and carries
    the activations' column orders."""
    from ..ops.megastep import megapack
    from ..ops.megastep4 import megapack4
    from ..ops.megastep_lowbit import actorder_transform, megapack_lowbit

    with torch.no_grad():
        if variant == "w8":
            return megapack(cfg, sp)
        if variant == "w4":
            return megapack4(cfg, sp)
        bits = _LB_BITS[variant]
        tsp, aps = actorder_transform(cfg, sp, bits)
        mp = megapack_lowbit(cfg, tsp, bits)
        mp.update(aps)
        return mp


def prepack(cfg: ModelConfig, sp: Model, backend: str, batch: int,
            device) -> Model:
    """Certify the stacked model (``GANQ_LUT_AFFINE=0`` opts out), convert
    ``w8`` to uniform 8-bit for batches above 8 (``GANQ_W8_PLANE=0`` opts
    out), and pack the megastep's operands once for the variant this batch
    takes, one pack per kernel (``sp.megapack_w8``, ``sp.megapack4``,
    ``sp.megapack_lb``, act-order artifacts baked into kernel 14's); a
    variant or an operand of a later slice raises NotImplementedError
    naming it, act-order groups that are not balanced ValueError (the
    engine then serves the model per layer, as the JAX engine does)."""
    if os.environ.get("GANQ_LUT_AFFINE", "1") != "0":
        sp = certify_stacked(sp)
    if (mega_env_enabled(backend, batch, device) and batch > 8
            and os.environ.get("GANQ_W8_PLANE", "1") != "0"):
        sp = w8p_stacked(sp)
    variant = mega_enabled(cfg, sp, backend, batch, device)
    missing = missing_kernel(cfg, sp, variant)
    if missing:
        raise NotImplementedError(
            f"the whole-step variant {variant!r} runs {missing}, which the "
            "port does not have yet (ROADMAP.md queue B)")
    if variant and getattr(sp, _PACK_ATTR[variant], None) is None:
        setattr(sp, _PACK_ATTR[variant], _pack(cfg, sp, variant))
    return sp


def _mega_pack_for(cfg: ModelConfig, sp: Model, variant: str):
    """The prepacked megastep operands for ``variant`` (packed here, and
    kept, when :func:`prepack` did not: ``GANQ_W4_PLANE=0`` sends a model
    prepacked for "w4p" to kernel 13)."""
    missing = missing_kernel(cfg, sp, variant)
    if missing:
        raise NotImplementedError(f"{missing} is not ported yet")
    mp = getattr(sp, _PACK_ATTR[variant], None)
    if mp is None:
        mp = _pack(cfg, sp, variant)
        setattr(sp, _PACK_ATTR[variant], mp)
    return mp


def init_cache(cfg: ModelConfig, n_layers: int, batch: int, max_seq: int,
               device, dtype: torch.dtype = torch.bfloat16
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V caches [L, B, T, Hkv, d]."""
    shape = (n_layers, batch, max_seq, cfg.num_key_value_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _layer_caches(cache_k: torch.Tensor, cache_v: torch.Tensor
                  ) -> List[Dict[str, torch.Tensor]]:
    return [{"k": cache_k[i], "v": cache_v[i]} for i in range(cache_k.shape[0])]


def _mega_cache(cache_k: torch.Tensor, cache_v: torch.Tensor):
    """[L, B, T, Hkv, d] -> the megastep's [L, B * Hkv, T, d] (copies)."""
    L, B, T, Hkv, d = cache_k.shape

    def to(c):
        return c.transpose(2, 3).reshape(L, B * Hkv, T, d).contiguous()

    return to(cache_k), to(cache_v)


def prefill(cfg: ModelConfig, sp: Model, cache_k: torch.Tensor,
            cache_v: torch.Tensor, input_ids: torch.Tensor,
            backend: str = "reference") -> torch.Tensor:
    """The prompt through the stacked layers, filling the caches in place.
    Returns the last position's logits."""
    return _prefill_layers(cfg, sp, _layer_caches(cache_k, cache_v),
                           input_ids, backend)


def decode_step(cfg: ModelConfig, sp: Model, cache_k: torch.Tensor,
                cache_v: torch.Tensor, token: torch.Tensor, pos: torch.Tensor,
                backend: str = "reference") -> torch.Tensor:
    """One decode step through the stacked layers, layer by layer."""
    return _decode_layers(cfg, sp, _layer_caches(cache_k, cache_v), token,
                          pos, backend)


def _decode_one_mega(cfg: ModelConfig, sp: Model, mp, ck: torch.Tensor,
                     cv: torch.Tensor, token: torch.Tensor, pos: torch.Tensor,
                     backend: str, variant: str = "w8") -> torch.Tensor:
    """One decode step through the whole-step kernel of ``variant`` (kernel
    12 for "w8", 13 for "w4", 14 for "w4p"/"w8p"). ck/cv in the megastep
    layout, updated in place with the step's k/v at ``pos`` after the
    kernel; then the full-precision unembed. Where the JAX package folds the
    lm_head into kernel 14's step it raises (``GANQ_LM_FOLD=0`` serves the
    step without the fold, as the JAX package then does)."""
    from ..ops.megastep import megastep_decode_w8a8
    from ..ops.megastep4 import megastep4_decode
    from ..ops.megastep_lowbit import megastep_lowbit_decode

    b = token.shape[0]
    L = ck.shape[0]
    d = cfg.head_dim
    kw = {}
    if variant == "w4":
        kv_dim = (mp["qkv_p4"].shape[1] * 2 - cfg.q_dim) // 2
        step_fn = megastep4_decode
    elif variant in _LB_BITS:
        if lm_fold_engages(cfg, sp):
            raise NotImplementedError(
                f"{_KERNEL_OF[variant]} with the trailing-unembed lm fold "
                "comes with a later slice of the port (ROADMAP.md queue A "
                "item 4); GANQ_LM_FOLD=0 serves the step without it")
        kv_dim = _lb_kv_dim(cfg, mp, _LB_BITS[variant])
        step_fn = megastep_lowbit_decode
        kw["bits"] = _LB_BITS[variant]
    else:
        kv_dim = (mp["qkv_w8"].shape[1] - cfg.q_dim) // 2
        step_fn = megastep_decode_w8a8
    positions = pos.reshape(1, 1).expand(b, 1)
    x = embed(sp, token[:, None])[:, 0, :]
    rd, cos_h, sin_h = _rope_half_tables(cfg, rope_tables(cfg, positions))
    scale = cfg.attn_scale if cfg.attn_scale is not None else 1.0 / math.sqrt(d)
    y, kn, vn = step_fn(
        x, mp, ck, cv, pos, cos_h, sin_h, q_dim=cfg.q_dim, kv_dim=kv_dim,
        head_dim=d, rotary_dim=rd, eps=cfg.norm_eps, scale=scale,
        act=_fused_act_kind(cfg), **kw)
    at = pos.reshape(1).to(torch.int64)
    ck.index_copy_(2, at, kn.reshape(L, -1, 1, d).to(ck.dtype))
    cv.index_copy_(2, at, vn.reshape(L, -1, 1, d).to(cv.dtype))
    return unembed(cfg, sp, y[:, None, :], backend)[:, 0, :]


@torch.inference_mode()
def generate_tokens(cfg: ModelConfig, sp: Model, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, input_ids: torch.Tensor,
                    generator: Optional[torch.Generator], max_new_tokens: int,
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 1.0, eos_id: int = -1,
                    backend: str = "reference") -> torch.Tensor:
    """Prefill + decode loop on the stacked layout (the engine's
    ``generate_tokens`` semantics). The whole-step variant is resolved here,
    once per request; its decode steps run the megastep."""
    b, s = input_ids.shape
    dev = input_ids.device
    variant = mega_enabled(cfg, sp, backend, b, dev)
    logits = prefill(cfg, sp, cache_k, cache_v, input_ids, backend)
    tok = sample(logits, generator, temperature, top_k, top_p)
    done = (tok == eos_id) if eos_id >= 0 else torch.zeros(b, dtype=torch.bool,
                                                           device=dev)
    pad = eos_id if eos_id >= 0 else 0
    pos = torch.tensor(s, dtype=torch.int32, device=dev)
    toks = [tok]
    if variant and max_new_tokens > 1:
        mp = _mega_pack_for(cfg, sp, variant)
        ck, cv = _mega_cache(cache_k, cache_v)

        def step(t, p):
            return _decode_one_mega(cfg, sp, mp, ck, cv, t, p, backend,
                                    variant)
    else:
        def step(t, p):
            return decode_step(cfg, sp, cache_k, cache_v, t, p, backend)
    for _ in range(max_new_tokens - 1):
        logits = step(tok, pos)
        nxt = sample(logits, generator, temperature, top_k, top_p)
        nxt = torch.where(done, pad, nxt)
        if eos_id >= 0:
            done = done | (nxt == eos_id)
        toks.append(nxt)
        tok = nxt
        pos = pos + 1
    return torch.stack(toks, dim=1)


def greedy_decode(cfg: ModelConfig, sp: Model, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, input_ids: torch.Tensor, steps: int,
                  backend: str = "reference") -> torch.Tensor:
    """Prefill + ``steps`` greedy tokens [B, steps]."""
    return generate_tokens(cfg, sp, cache_k, cache_v, input_ids, None, steps,
                           backend=backend)


__all__ = ["fuse_layer", "recode_layer_w8", "recode_layer_affine",
           "stack_layers", "certify_stacked", "w8p_stacked", "mega_enabled",
           "mega_env_enabled", "missing_kernel", "lm_fold_engages", "prepack", "prefill",
           "decode_step", "generate_tokens", "greedy_decode", "init_cache"]
