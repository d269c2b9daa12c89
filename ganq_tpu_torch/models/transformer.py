"""Decoder-only llama-family transformer: modules for the weights, plain
functions for the math.

The port of the llama subset of ``ganq_tpu/models/transformer.py``: RMSNorm
(with Gemma's ``(1 + w)`` offset), rope with linear or llama3 frequency
scaling (and Gemma 3's second, local table), grouped-query attention with
optional q/k/v/o biases (Qwen2, InternLM), Qwen3's per-head q/k RMSNorm,
Gemma's attention softcap, per-layer sliding windows and sandwich norms, the
gated SiLU or GELU MLP, the scaled embedding, the final logit softcap and
tied embeddings; and Mixtral's sparse MoE in place of the
MLP (top-k softmax routing, the masked per-expert loop, and on "cuda_a8"
the fused expert kernel, kernel 15, for decode-shaped steps). The weights live in ``nn.Module``s whose
buffer paths are the JAX package's parameter paths
(``layers.0.attn.q.weight``, ``final_norm.weight``, ...); the forward math is
a set of plain functions over them, as in the JAX package.

The KV cache is updated in place (the JAX version returns new buffers).

Layers of the stacked layout (``serve/stacked.py``) hold fused linears,
``qkv`` (q, k and v rows) and ``gateup`` (gate, then up rows), and for a
``w8`` o the transposed ``o_t_w8`` / ``o_t_scale``. On the int8-activation
backend ``"cuda_a8"`` :func:`layer_forward` then takes the JAX package's
fused kernels under its conditions: the fused W8A8 MLP (kernel 9) for at
most 64 token rows, and, opted in by ``GANQ_FUSED_QKV`` and
``GANQ_FUSED_LAYER=1`` (read at each call), the fused norm + qkv + rope
(kernel 10) and the attention half of a decode layer (kernel 11).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..ops import qlinear
from ..ops.attention import causal_attention
from ..ops.fused_attention import (flash_decode_attention,
                                   fused_qkv_rope_w8a8, qkv_fusable_tile)
from ..ops.fused_layer import attn_half_decode_w8a8, attn_half_fusable
from ..ops.fused_mlp import fused_mlp_w8a8


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    model_type: str                   # "llama", "qwen3", "internlm", ...
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    max_position_embeddings: int = 2048
    norm_eps: float = 1e-5
    act: str = "silu"
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    attn_bias: bool = False
    mlp_bias: bool = False
    tie_word_embeddings: bool = False
    attn_scale: Optional[float] = None  # default 1/sqrt(head_dim)
    num_experts: int = 0              # 0: a dense MLP (mixtral: 8)
    num_experts_per_tok: int = 2
    # per-head RMSNorm of q and k over head_dim before rope (qwen3): True or
    # "head"; the JAX package's "flat" (olmo2) and "cohere" raise
    qk_norm: Any = False
    rms_offset: float = 0.0           # gemma: norm weights stored as (w - 1)
    embed_scale: Optional[float] = None  # gemma: sqrt(hidden) multiplier
    # gemma3: sliding layers take an unscaled rope at this theta
    # (rope_local_base_freq); full layers rope_theta with rope_scaling
    rope_local_theta: Optional[float] = None
    # gemma2/3: x += post_attn_norm(attn(input_norm(x)));
    # x += post_mlp_norm(mlp(post_norm(x)))
    sandwich_norm: bool = False
    # gemma2: cap * tanh(x / cap) on the scaled attention scores (before the
    # mask) and on the final logits
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    # sliding-window attention: the window and the per-layer pattern (HF
    # layer_types: "sliding_attention" / "full_attention"; None: every layer
    # slides)
    sliding_window: Optional[int] = None
    layer_types: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.qk_norm not in (False, True, "head"):
            raise NotImplementedError(
                f"qk_norm={self.qk_norm!r} comes with the rest of the model "
                "zoo (ROADMAP.md queue A item 6)")
        if isinstance(self.layer_types, list):
            object.__setattr__(self, "layer_types", tuple(self.layer_types))

    def layer_window(self, i: int) -> Optional[int]:
        """Layer i's sliding window, or None for full attention."""
        if self.sliding_window is None:
            return None
        if self.layer_types is None:
            return self.sliding_window
        return (self.sliding_window
                if self.layer_types[i] == "sliding_attention" else None)

    @property
    def q_dim(self) -> int:
        return self.num_attention_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_key_value_heads * self.head_dim


# -------------------------------------------------------------------- weights
class Weights(nn.Module):
    """A ``weight`` (and optional ``bias``) buffer, so that module paths
    spell the checkpoint's parameter names."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("weight", weight)
        if bias is not None:
            self.register_buffer("bias", bias)


class Pack(nn.Module):
    """Named tensors as buffers (a kernel's packed operands), so that
    ``.to(device)`` moves them with the model."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for name, value in tensors.items():
            self.register_buffer(name, value)

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self._buffers.items() if v is not None}


QK_NORMS = ("q_norm", "k_norm")


class Layer(nn.Module):
    """One decoder layer's weights: two norms, attention q/k/v/o and the
    gated MLP gate/up/down, each a :class:`~ganq_tpu_torch.ops.qlinear.QLinear`
    (fused ``qkv`` and ``gateup`` in the stacked layout, which may also give
    the transposed ``w8`` o weight ``o_t_w8 [Dq, H]`` and its scale
    ``o_t_scale [1, H]``). A qk-norm layer (qwen3) also holds the per-head
    norm weights ``q_norm`` and ``k_norm`` [head_dim] (given as tensors, or
    as the :class:`Weights` entries of an ``attn`` dict taken from another
    layer), kept in ``attn`` so that their paths are the JAX package's
    (``layers.0.attn.q_norm.weight``); :func:`attn_linears` gives the
    linears alone. A sandwich-norm layer (gemma2/3) also holds
    ``post_attn_norm`` and ``post_mlp_norm`` [H], the norms of the attention
    and MLP outputs before their residual adds. A MoE layer has no MLP
    and holds ``moe``: the dense ``router`` [E, H], the ``experts`` (each a
    dict of gate/up/down linears) and, after ``optimize()`` on the card,
    kernel 15's packed experts ``mega`` (a :class:`Pack`)."""

    def __init__(self, input_norm: torch.Tensor, post_norm: torch.Tensor,
                 attn: Dict[str, nn.Module], mlp: Dict[str, nn.Module],
                 o_t_w8: Optional[torch.Tensor] = None,
                 o_t_scale: Optional[torch.Tensor] = None,
                 moe: Optional[Dict[str, Any]] = None,
                 q_norm: Optional[torch.Tensor] = None,
                 k_norm: Optional[torch.Tensor] = None,
                 post_attn_norm: Optional[torch.Tensor] = None,
                 post_mlp_norm: Optional[torch.Tensor] = None):
        super().__init__()
        self.input_norm = Weights(input_norm)
        self.post_norm = Weights(post_norm)
        if (post_attn_norm is None) != (post_mlp_norm is None):
            raise ValueError("post_attn_norm and post_mlp_norm come together")
        self.post_attn_norm = (None if post_attn_norm is None
                               else Weights(post_attn_norm))
        self.post_mlp_norm = (None if post_mlp_norm is None
                              else Weights(post_mlp_norm))
        attn = dict(attn)
        for name, w in (("q_norm", q_norm), ("k_norm", k_norm)):
            if w is not None:
                attn[name] = Weights(w)
        if ("q_norm" in attn) != ("k_norm" in attn):
            raise ValueError("q_norm and k_norm come together")
        self.attn = nn.ModuleDict(attn)
        self.mlp = nn.ModuleDict(mlp)
        self.register_buffer("o_t_w8", o_t_w8)
        self.register_buffer("o_t_scale", o_t_scale)
        self.moe = None
        if moe is not None:
            experts = nn.ModuleList(nn.ModuleDict(e) for e in moe["experts"])
            self.moe = nn.ModuleDict(
                {**{k: v for k, v in moe.items() if k != "experts"},
                 "experts": experts})

    @property
    def q_norm(self) -> Optional[torch.Tensor]:
        return self.attn["q_norm"].weight if "q_norm" in self.attn else None

    @property
    def k_norm(self) -> Optional[torch.Tensor]:
        return self.attn["k_norm"].weight if "k_norm" in self.attn else None


SANDWICH_NORMS = ("post_attn_norm", "post_mlp_norm")


def sandwich_norms(lp: Layer) -> Dict[str, torch.Tensor]:
    """A layer's sandwich-norm weights by name (empty for other layers), for
    building a layer from another one."""
    return {n: getattr(lp, n).weight for n in SANDWICH_NORMS
            if getattr(lp, n) is not None}


def attn_linears(lp: Layer) -> Dict[str, nn.Module]:
    """The attention linears of a layer (``attn`` without its qk norms)."""
    return {k: v for k, v in lp.attn.items() if k not in QK_NORMS}


class Model(nn.Module):
    """The whole model's weights. ``lm_head`` is None for tied embeddings."""

    def __init__(self, embed_tokens: torch.Tensor, final_norm: torch.Tensor,
                 layers: List[Layer], lm_head: Optional[nn.Module] = None):
        super().__init__()
        self.embed_tokens = Weights(embed_tokens)
        self.final_norm = Weights(final_norm)
        self.layers = nn.ModuleList(layers)
        self.register_module("lm_head", lm_head)


# ---------------------------------------------------------------------- norms
def apply_norm(weight: torch.Tensor, x: torch.Tensor, eps: float,
               offset: float = 0.0) -> torch.Tensor:
    """RMSNorm over the last axis in float32 with the weight ``w + offset``
    (gemma's 1), result in x's type (the JAX package's ``_rms_vec`` too: the
    per-head qk norms are this over head_dim)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (weight.float() + offset)
            ).to(x.dtype)


# ----------------------------------------------------------------------- rope
def _rope_inv_freq(cfg: ModelConfig, device) -> torch.Tensor:
    """Inverse frequencies [head_dim/2], float32, with the config's scaling."""
    rd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd))
    rs = cfg.rope_scaling
    kind = rs.get("rope_type", rs.get("type")) if rs else None
    if kind == "linear":
        return inv_freq / rs["factor"]
    if kind == "yarn":
        raise NotImplementedError("yarn rope scaling is not ported yet")
    if kind == "llama3":
        # HF llama3 frequency-dependent scaling (Llama-3.x checkpoints)
        factor = rs["factor"]
        lo = rs.get("low_freq_factor", 1.0)
        hi = rs.get("high_freq_factor", 4.0)
        orig = rs.get("original_max_position_embeddings", 8192)
        wavelen = 2 * math.pi / inv_freq
        scaled = inv_freq / factor
        smooth = (orig / wavelen - lo) / (hi - lo)
        mid = (1 - smooth) * scaled + smooth * inv_freq
        return torch.where(wavelen > orig / lo, scaled,
                           torch.where(wavelen < orig / hi, inv_freq, mid))
    return inv_freq         # other kinds leave the frequencies unscaled


def rope_tables(cfg: ModelConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim] (half-split layout) for positions."""
    inv_freq = _rope_inv_freq(cfg, positions.device)
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rope_tables_all(cfg: ModelConfig, positions: torch.Tensor):
    """Every rope table the model needs: the (cos, sin) pair, or for a
    dual-rope model (gemma3) ``{"global": ..., "local": ...}``, the local
    table at ``rope_local_theta`` without ``rope_scaling``
    (:func:`rope_for_layer` picks a layer's)."""
    glob = rope_tables(cfg, positions)
    if cfg.rope_local_theta is None:
        return glob
    lcfg = dataclasses.replace(cfg, rope_theta=cfg.rope_local_theta,
                               rope_scaling=None)
    return {"global": glob, "local": rope_tables(lcfg, positions)}


def rope_for_layer(cfg: ModelConfig, rope, i: int):
    """Layer i's (cos, sin): sliding layers of a dual-rope model take the
    local table."""
    if isinstance(rope, dict):
        return (rope["local"] if cfg.layer_window(i) is not None
                else rope["global"])
    return rope


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [b, s, heads, hd]; cos/sin: [b, s, hd] (HF rotate_half)."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos[:, :, None, :] + rot * sin[:, :, None, :]).to(x.dtype)


# ------------------------------------------------------------------ attention
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor], scale: float,
              softcap: Optional[float] = None) -> torch.Tensor:
    """q: [b, s, hq, d]; k, v: [b, t, hkv, d] -> [b, s, hq, d]. GQA through
    grouped einsums (no repeated copy of the cache). ``softcap`` applies
    gemma2's ``cap * tanh(s / cap)`` to the scaled scores before the mask."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d)
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k).float() * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if mask is not None:
        logits = torch.where(mask[:, :, None], logits,
                             torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(b, s, hq, v.shape[-1])


def causal_mask(s: int, t: int, device, offset: int = 0) -> torch.Tensor:
    """[1, 1, s, t] boolean mask; query i attends keys <= i + offset."""
    qi = torch.arange(s, device=device)[:, None] + offset
    ki = torch.arange(t, device=device)[None, :]
    return (ki <= qi)[None, None]


def _window_overlay(T: int, s: int, cache_pos, window, device
                    ) -> torch.Tensor:
    """The sliding-window part of the mask: key j is visible to the query at
    absolute position p iff ``j > p - window`` (``ganq_tpu/models/
    transformer.py:1140-1147``). [b, 1, s, T] for a [b] vector of cache
    positions, else [1, 1, s, T]."""
    keys = torch.arange(T, device=device)
    if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1:
        qpos = (torch.arange(s, device=device)[None, :]
                + cache_pos.to(torch.int64)[:, None])
        return (keys[None, None, :] > qpos[:, :, None] - window)[:, None]
    qpos = torch.arange(s, device=device) + (0 if cache_pos is None
                                             else cache_pos)
    return (keys[None, :] > qpos[:, None] - window)[None, None]


_GELU_TANH = ("gelu_tanh", "gelu_new", "gelu_pytorch_tanh")


def _activation(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return nn.functional.silu(x)
    if act in _GELU_TANH:
        return nn.functional.gelu(x, approximate="tanh")
    if act == "gelu":
        return nn.functional.gelu(x)
    raise NotImplementedError(f"activation {act!r} is not ported yet")


def _fused_act_kind(cfg: ModelConfig) -> str:
    """cfg.act -> the fused kernels' activation name."""
    if cfg.act == "silu":
        return "silu"
    if "tanh" in cfg.act or cfg.act == "gelu_new":
        return "gelu_tanh"
    return "gelu"


def _rope_half_tables(cfg: ModelConfig, rope):
    """(rotary_dim, cos_half, sin_half): the half-dim rope rows at the
    decode position for the fused kernels (the first batch row; every row
    of a decode step sits at the same position)."""
    rd = cfg.head_dim
    cos, sin = rope
    return rd, cos[0, 0, :rd // 2], sin[0, 0, :rd // 2]


def _cache_write(buf: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write ``new`` [b, s, ...] into ``buf`` [b, T, ...] at rows pos.. in
    place; ``pos`` is a python int, a 0-d device tensor or, for slots at
    their own positions, a [b] tensor (:func:`_cache_write_vec`); no host
    sync."""
    new = new.to(buf.dtype)
    if isinstance(pos, int):
        buf[:, pos:pos + new.shape[1]] = new
    elif pos.dim() == 1:
        _cache_write_vec(buf, new, pos)
    else:
        rows = pos.reshape(1) + torch.arange(new.shape[1], device=buf.device)
        buf.index_copy_(1, rows, new)


def _cache_write_vec(buf: torch.Tensor, new: torch.Tensor,
                     pos: torch.Tensor) -> None:
    """Write ``new`` [b, s, ...] into ``buf`` [b, T, ...] at each row's own
    start position ``pos`` [b], in place (continuous-batching slots,
    ``ganq_tpu/models/transformer.py::_cache_write_vec``); rows at or past
    T are dropped, as the JAX gather + select drops them. One token a row
    is a scatter; longer writes select over the whole buffer."""
    b, s = new.shape[:2]
    T = buf.shape[1]
    if s == 1:
        p = pos.to(torch.int64)
        rows = torch.arange(b, device=buf.device)
        at = p.clamp(max=T - 1)
        keep = (p < T).reshape((b,) + (1,) * (new.dim() - 2))
        buf[rows, at] = torch.where(keep, new[:, 0], buf[rows, at])
        return
    off = (torch.arange(T, device=buf.device)[None, :]
           - pos.to(torch.int64)[:, None])                      # [b, T]
    sel = (off >= 0) & (off < s)
    extra = (1,) * (buf.dim() - 2)
    idx = off.clamp(0, s - 1).reshape(off.shape + extra).expand(
        (b, T) + tuple(new.shape[2:]))
    buf.copy_(torch.where(sel.reshape(sel.shape + extra),
                          torch.gather(new, 1, idx), buf))


# ---------------------------------------------------------------------- layer
def _w8_gateup(lp: Layer) -> bool:
    """Kernel 9's operands: a fused ``w8`` gate/up and a ``w8`` down, with
    no EoRA adapter and no bias, which the kernel has no operand for.
    ``ganq_tpu``'s gate (``models/transformer.py:1214-1220``) reads the
    kinds only, and drops an adapter or bias there (``ROADMAP.md`` queue
    C)."""
    mlp = lp.mlp
    return ("gateup" in mlp and mlp["gateup"].kind == "w8"
            and mlp["down"].kind == "w8"
            and not any(extra in m for m in (mlp["gateup"], mlp["down"])
                        for extra in ("lora_a", "bias")))


def layer_forward(cfg: ModelConfig, lp: Layer, x: torch.Tensor,
                  mask: Optional[torch.Tensor],
                  rope: Tuple[torch.Tensor, torch.Tensor],
                  cache: Optional[Dict[str, torch.Tensor]] = None,
                  cache_pos=None, backend: str = "reference",
                  want_taps: bool = False, window: Optional[int] = None):
    """One decoder layer; writes this layer's k/v into ``cache`` (in place).

    ``cache_pos`` is the python int 0 for prefill, a 0-d tensor for a
    decode step, or a [b] tensor for a decode step whose rows sit at their
    own positions (continuous batching: each row's k/v is written at its
    position, and ``mask`` [b, 1, 1, T] is the caller's per-row history).
    Prefilling from position 0 attends over the fresh k/v only. ``window``
    is this layer's sliding window (``cfg.layer_window(i)``; None: full
    attention), ``rope`` this layer's table (:func:`rope_for_layer`). A
    decode step at a 0-d position on a CUDA backend (``"cuda"`` or
    ``"cuda_a8"``) with no softcap, no window and head_dim <= 128 (``ganq_tpu``'s
    ``_plain_decode`` gate) runs the flash decode kernel over the cache
    (which launches or raises), or kernel 11 where it is opted in; every
    other decode step, on the reference backend and at vector positions on
    every backend too, runs the masked plain attention with the window
    overlay and the softcap. The fused kernels of the stacked layout run
    under the JAX package's conditions (``ganq_tpu/models/transformer.py:
    989-1085, 1214-1239``).

    Returns the layer's output; with ``want_taps`` it returns ``(output,
    taps)``, where ``taps`` maps each linear's slot (``attn.q`` ...
    ``mlp.down``, the JAX package's names) to the input it saw, the
    activations a quantizer's Hessian is built from."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    scale = cfg.attn_scale if cfg.attn_scale is not None else 1.0 / math.sqrt(hd)
    is_prefill = cache is None or (isinstance(cache_pos, int) and cache_pos == 0
                                   and s > 1)
    softcap = cfg.attn_softcap
    # the attention flash decode (kernel 2) and kernels 10-11 compute: no
    # softcap, no window, head_dim <= 128
    plain_attn = softcap is None and window is None and hd <= 128
    use_flash_decode = (backend in ("cuda", "cuda_a8") and cache is not None
                        and isinstance(cache_pos, torch.Tensor)
                        and cache_pos.dim() == 0 and plain_attn)
    if use_flash_decode and s != 1:
        raise ValueError(f"a decode step on a cuda backend takes one token "
                         f"per sequence, got {s}")
    plain_decode = (cache is not None and s == 1 and b <= 64 and not want_taps
                    and isinstance(cache_pos, torch.Tensor)
                    and cache_pos.dim() == 0 and plain_attn)
    off = cfg.rms_offset
    attn = lp.attn
    a8 = backend == "cuda_a8"

    # the attention half in one kernel (11) and the fused MLP (9): opt-in
    if (plain_decode and b <= 8 and a8 and hd == 128 and _w8_gateup(lp)
            and lp.o_t_w8 is not None and not cfg.qk_norm
            and os.environ.get("GANQ_FUSED_LAYER", "0") == "1"
            and attn_half_fusable(cfg, lp)):
        ap = attn["qkv"]
        kvd = (ap["w8"].shape[0] - cfg.q_dim) // 2
        rd, cos_h, sin_h = _rope_half_tables(cfg, rope)
        y, k_new, v_new = attn_half_decode_w8a8(
            x[:, 0, :], lp.input_norm.weight, ap["w8"], ap["scale"],
            ap["bias"] if "bias" in ap else None, lp.o_t_w8, lp.o_t_scale,
            cos_h, sin_h, cache["k"], cache["v"], cache_pos, q_dim=cfg.q_dim,
            kv_dim=kvd, head_dim=hd, rotary_dim=rd, eps=cfg.norm_eps,
            rms_offset=off, scale=scale)
        _cache_write(cache["k"], k_new[:, None], cache_pos)
        _cache_write(cache["v"], v_new[:, None], cache_pos)
        gu, dn = lp.mlp["gateup"], lp.mlp["down"]
        return fused_mlp_w8a8(y[:, None, :], gu["w8"], gu["scale"], dn["w8"],
                              dn["scale"], act=_fused_act_kind(cfg),
                              norm_w=lp.post_norm.weight, eps=cfg.norm_eps,
                              rms_offset=off)

    # norm + qkv + rope in one kernel (10): opt-in
    use_fused_qkv = False
    if (plain_decode and a8 and "qkv" in attn and attn["qkv"].kind == "w8"
            and "lora_a" not in attn["qkv"] and not cfg.qk_norm
            and os.environ.get("GANQ_FUSED_QKV", "0") != "0"):
        kvd = (attn["qkv"]["w8"].shape[0] - cfg.q_dim) // 2
        use_fused_qkv = qkv_fusable_tile(cfg.q_dim, kvd, hd) is not None

    taps: Dict[str, torch.Tensor] = {}
    residual = x
    if use_fused_qkv:
        ap = attn["qkv"]
        rd, cos_h, sin_h = _rope_half_tables(cfg, rope)
        qkv = fused_qkv_rope_w8a8(
            x[:, 0, :], lp.input_norm.weight, ap["w8"], ap["scale"],
            ap["bias"] if "bias" in ap else None, cos_h, sin_h,
            q_dim=cfg.q_dim, kv_dim=kvd, head_dim=hd, rotary_dim=rd,
            eps=cfg.norm_eps, rms_offset=off, fold_norm=True)[:, None]
        q = qkv[..., :cfg.q_dim].reshape(b, 1, -1, hd)
        k = qkv[..., cfg.q_dim:cfg.q_dim + kvd].reshape(b, 1, -1, hd)
        v = qkv[..., cfg.q_dim + kvd:].reshape(b, 1, -1, hd)
    else:
        h = apply_norm(lp.input_norm.weight, x, cfg.norm_eps, off)
        if want_taps:
            taps["attn.q"] = taps["attn.k"] = taps["attn.v"] = h
        if "qkv" in attn:        # the stacked layout's fused rows
            qkv = qlinear.apply(attn["qkv"], h, backend)
            kvd = (qkv.shape[-1] - cfg.q_dim) // 2
            q = qkv[..., :cfg.q_dim]
            k = qkv[..., cfg.q_dim:cfg.q_dim + kvd]
            v = qkv[..., cfg.q_dim + kvd:]
        else:
            q = qlinear.apply(attn["q"], h, backend)
            k = qlinear.apply(attn["k"], h, backend)
            v = qlinear.apply(attn["v"], h, backend)
        q = q.reshape(b, s, -1, hd)
        k = k.reshape(b, s, -1, hd)
        v = v.reshape(b, s, -1, hd)
        if cfg.qk_norm:
            # per-head RMSNorm over head_dim before rope (qwen3;
            # ganq_tpu/models/transformer.py:646-652; gemma3 adds its (1+w)
            # offset)
            q = apply_norm(lp.q_norm, q, cfg.norm_eps, off)
            k = apply_norm(lp.k_norm, k, cfg.norm_eps, off)
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if cache is not None:
        _cache_write(cache["k"], k, cache_pos)
        _cache_write(cache["v"], v, cache_pos)

    if use_flash_decode:
        attn_out = flash_decode_attention(q[:, 0], cache["k"], cache["v"],
                                          cache_pos, scale)[:, None]
    elif is_prefill and softcap is None and (window is None or s <= window):
        # a window at least the prompt's length masks nothing causal does
        attn_out = causal_attention(q, k.to(q.dtype), v.to(q.dtype), scale)
    elif is_prefill:
        pre_mask = causal_mask(s, s, x.device)
        if window is not None:
            pre_mask = pre_mask & _window_overlay(s, s, cache_pos, window,
                                                  x.device)
        attn_out = attention(q, k.to(q.dtype), v.to(q.dtype), pre_mask,
                             scale, softcap)
    else:
        T = cache["k"].shape[1]
        if window is not None:
            mask = mask & _window_overlay(T, s, cache_pos, window, x.device)
        attn_out = attention(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                             mask, scale, softcap)
    attn_out = attn_out.reshape(b, s, -1)
    if want_taps:
        taps["attn.o"] = attn_out
    attn_out = qlinear.apply(attn["o"], attn_out, backend)
    if cfg.sandwich_norm:     # gemma2/3: the output normed before the add
        attn_out = apply_norm(lp.post_attn_norm.weight, attn_out,
                              cfg.norm_eps, off)
    x = residual + attn_out

    if lp.moe is not None:
        h = apply_norm(lp.post_norm.weight, x, cfg.norm_eps, off)
        out = x + _moe_forward(cfg, lp.moe, h, backend,
                               taps if want_taps else None)
        return (out, taps) if want_taps else out
    mlp = lp.mlp
    if (a8 and _w8_gateup(lp) and b * s <= 64 and not want_taps
            and not cfg.sandwich_norm):
        # the whole MLP in one kernel (9), norm and residual folded in (the
        # kernel has no output norm)
        gu, dn = mlp["gateup"], mlp["down"]
        return fused_mlp_w8a8(x, gu["w8"], gu["scale"], dn["w8"], dn["scale"],
                              act=_fused_act_kind(cfg),
                              norm_w=lp.post_norm.weight, eps=cfg.norm_eps,
                              rms_offset=off)
    h = apply_norm(lp.post_norm.weight, x, cfg.norm_eps, off)
    if "gateup" in mlp:
        gu = qlinear.apply(mlp["gateup"], h, backend)
        g, u = gu[..., :cfg.intermediate_size], gu[..., cfg.intermediate_size:]
    else:
        g = qlinear.apply(mlp["gate"], h, backend)
        u = qlinear.apply(mlp["up"], h, backend)
    a = _activation(g, cfg.act) * u
    mlp_out = qlinear.apply(mlp["down"], a, backend)
    if cfg.sandwich_norm:
        mlp_out = apply_norm(lp.post_mlp_norm.weight, mlp_out, cfg.norm_eps,
                             off)
    out = x + mlp_out
    if want_taps:
        taps["mlp.gate"] = taps["mlp.up"] = h
        taps["mlp.down"] = a
        return out, taps
    return out


# ------------------------------------------------------------------------ moe
def _moe_forward(cfg: ModelConfig, moe, h: torch.Tensor, backend: str,
                 taps: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """Mixtral-style sparse MoE (``ganq_tpu/models/transformer.py:458-511``,
    the top-k softmax router): the dense router's logits, softmax in
    float32, the selection ``probs >= `` the k-th largest (a threshold:
    ties select more than k), the selected probabilities renormalised by
    ``max(sum, 1e-9)``. The JAX package's other routers (sparsemixer,
    sigmoid scoring, group-limited, shared experts, routed scale) raise."""
    for key in ("shared", "shared_gate", "router_bias"):
        if key in moe:
            raise NotImplementedError(
                f"MoE {key!r}: routers other than Mixtral's top-k softmax "
                "come with the rest of the model zoo (ROADMAP.md queue A "
                "item 6)")
    logits = qlinear.apply(moe["router"], h, backend)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    thresh = torch.topk(probs, cfg.num_experts_per_tok, dim=-1).values[..., -1:]
    sel = probs >= thresh
    gated = torch.where(sel, probs, 0.0)
    gated = gated / torch.clamp(gated.sum(dim=-1, keepdim=True), min=1e-9)
    return _moe_combine(cfg, moe, h, sel, gated, backend, taps)


def moe_slots(gated: torch.Tensor, k: int):
    """Kernel 15's expert slots for routing weights ``gated`` [rows, E]:
    S = min(E, rows * k) slots, the experts of the most routed mass first
    (ties to the lower index, as ``jax.lax.top_k``), and the weights
    [rows, S] in slot order. Stays on the device (no host sync)."""
    rows, E = gated.shape
    S = min(E, rows * k)
    order = torch.sort(gated.sum(dim=0), descending=True, stable=True).indices
    slot_ids = order[:S]
    return slot_ids, gated[:, slot_ids]


def _moe_combine(cfg: ModelConfig, moe, h: torch.Tensor, sel: torch.Tensor,
                 gated: torch.Tensor, backend: str,
                 taps: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """The experts' outputs under routing weights ``gated`` [b, s, E]
    (``ganq_tpu/models/transformer.py:513-603``): the fused expert kernel
    (15) where the layer carries its ``mega`` pack, the backend is
    ``"cuda_a8"``, no taps are taken, the step has at most 32 token rows and
    ``GANQ_MOE_MEGA`` is not "0" (on the CPU only with ``GANQ_MOE_MEGA=1``,
    where its plain version runs); else the masked per-expert loop, every
    expert on every row with its routing weight (zero where unselected)."""
    rows = h.numel() // h.shape[-1]
    env = os.environ.get("GANQ_MOE_MEGA", "")
    if ("mega" in moe and backend == "cuda_a8" and taps is None and rows <= 32
            and env != "0" and (h.device.type != "cpu" or env == "1")):
        from ..ops.moe_expert import moe_expert_decode

        E = gated.shape[-1]
        slot_ids, wts = moe_slots(gated.reshape(rows, E).to(torch.float32),
                                  cfg.num_experts_per_tok)
        y = moe_expert_decode(h.reshape(rows, h.shape[-1]),
                              moe["mega"].tensors(), slot_ids, wts,
                              bits=moe["experts"][0]["gate"].bits,
                              act=_fused_act_kind(cfg))
        return y.reshape(h.shape).to(h.dtype)
    out = torch.zeros_like(h)
    for e, exp in enumerate(moe["experts"]):
        w_e = gated[..., e:e + 1].to(h.dtype)
        x_e = h * sel[..., e:e + 1].to(h.dtype)
        if taps is not None:
            taps[f"moe.experts.{e}.gate"] = taps[f"moe.experts.{e}.up"] = x_e
        a = (_activation(qlinear.apply(exp["gate"], x_e, backend), cfg.act)
             * qlinear.apply(exp["up"], x_e, backend))
        if taps is not None:
            taps[f"moe.experts.{e}.down"] = a * sel[..., e:e + 1].to(a.dtype)
        out = out + w_e * qlinear.apply(exp["down"], a, backend)
    return out


# ------------------------------------------------------------------ embedding
def embed(cfg: ModelConfig, model: Model, input_ids: torch.Tensor
          ) -> torch.Tensor:
    """The token rows; gemma's ``embed_scale`` multiplies them in their own
    type (``ganq_tpu/models/transformer.py:1279-1280``)."""
    x = model.embed_tokens.weight[input_ids]
    if cfg.embed_scale is not None:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype, device=x.device)
    return x


def unembed(cfg: ModelConfig, model: Model, x: torch.Tensor,
            backend: str = "reference") -> torch.Tensor:
    x = apply_norm(model.final_norm.weight, x, cfg.norm_eps, cfg.rms_offset)
    if model.lm_head is None:
        logits = x @ model.embed_tokens.weight.T.to(x.dtype)
    else:
        # logits keep full activation precision: a quantized lm_head takes
        # the full-precision kernels on "cuda_a8" too, as in the JAX package
        logits = qlinear.apply(model.lm_head, x,
                               "cuda" if backend == "cuda_a8" else backend)
    if cfg.logit_softcap is not None:     # gemma2 (transformer.py:1310-1313)
        cap = cfg.logit_softcap
        logits = (cap * torch.tanh(logits.float() / cap)).to(logits.dtype)
    return logits


def forward(cfg: ModelConfig, model: Model, input_ids: torch.Tensor,
            backend: str = "reference") -> torch.Tensor:
    """Full forward without a cache: input_ids [b, s] -> logits [b, s, vocab]."""
    b, s = input_ids.shape
    positions = torch.arange(s, device=input_ids.device).expand(b, s)
    x = embed(cfg, model, input_ids)
    rope = rope_tables_all(cfg, positions)
    for i, lp in enumerate(model.layers):
        x = layer_forward(cfg, lp, x, None, rope_for_layer(cfg, rope, i),
                          backend=backend, window=cfg.layer_window(i))
    return unembed(cfg, model, x, backend)


__all__ = ["ModelConfig", "Weights", "Pack", "Layer", "Model", "attn_linears",
           "sandwich_norms", "layer_forward",
           "forward", "embed", "unembed", "apply_norm", "rope_tables",
           "rope_tables_all", "rope_for_layer", "apply_rope", "attention",
           "causal_mask"]
