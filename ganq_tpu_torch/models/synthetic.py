"""Synthetic models: random weights at real architecture widths.

The port of ``llama_config`` and ``make_model`` (with Mixtral's experts,
Qwen3's q/k norms, the biases of Qwen2 and InternLM and Gemma's sandwich
norms) of
``ganq_tpu/models/synthetic.py``, with its kinds ``dense``, ``lut``,
``lut_affine``, ``lut_affine_sym``, ``uniform`` and ``w8``. Random weights have the compute
and memory behaviour of trained ones, so quantization runs, serving runs and
kernel timings need no download. Everything is made on the target device
(the card unless the caller passes ``device="cpu"``) from a seeded
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..core.backend import resolve_device
from ..ops import qlinear
from ..ops.packing import pack_int_rows
from .transformer import Layer, Model, ModelConfig


def llama_config(hidden: int = 2048, inter: int = 5504, layers: int = 16,
                 heads: int = 16, kv_heads: int = 8, vocab: int = 32000,
                 max_pos: int = 4096, rope_theta: float = 10000.0,
                 rope_scaling: Optional[Dict[str, Any]] = None) -> ModelConfig:
    return ModelConfig(
        model_type="llama", vocab_size=vocab, hidden_size=hidden,
        intermediate_size=inter, num_hidden_layers=layers,
        num_attention_heads=heads, num_key_value_heads=kv_heads,
        head_dim=hidden // heads, max_position_embeddings=max_pos,
        act="silu", rope_theta=rope_theta, rope_scaling=rope_scaling,
        tie_word_embeddings=True)


def llama_3_2_1b_config(layers: int = 16) -> ModelConfig:
    """Llama-3.2-1B at its published widths (huggingface.co/meta-llama/
    Llama-3.2-1B config.json); ``layers`` may cut the depth."""
    return llama_config(
        hidden=2048, inter=8192, layers=layers, heads=32, kv_heads=8,
        vocab=128256, max_pos=131072, rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 32.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 8192})


def llama_3_2_3b_config(layers: int = 28) -> ModelConfig:
    """Llama-3.2-3B at its published widths (huggingface.co/meta-llama/
    Llama-3.2-3B config.json: vocab 128256, hidden 3072, intermediate 8192,
    28 layers, 24 heads, 8 KV heads, head_dim 128, tied embeddings, rms eps
    1e-5, rope theta 500000 with llama3 scaling); ``layers`` may cut the
    depth. The smallest Llama-3 model with head_dim 128."""
    return llama_config(
        hidden=3072, inter=8192, layers=layers, heads=24, kv_heads=8,
        vocab=128256, max_pos=131072, rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 32.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 8192})


def llama_3_1_8b_config(layers: int = 32) -> ModelConfig:
    """Llama-3.1-8B at its published widths (huggingface.co/meta-llama/
    Llama-3.1-8B config.json: vocab 128256, hidden 4096, intermediate 14336,
    32 layers, 32 heads, 8 KV heads, head_dim 128, untied embeddings, rms
    eps 1e-5, rope theta 500000 with llama3 scaling); ``layers`` may cut
    the depth. Power-of-two hidden and query widths: the JAX package's
    whole-step kernel takes act-order artifacts there."""
    return dataclasses.replace(
        llama_config(hidden=4096, inter=14336, layers=layers, heads=32,
                     kv_heads=8, vocab=128256, max_pos=131072,
                     rope_theta=500000.0,
                     rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                   "low_freq_factor": 1.0,
                                   "high_freq_factor": 4.0,
                                   "original_max_position_embeddings": 8192}),
        tie_word_embeddings=False)


def mixtral_8x7b_config(layers: int = 32) -> ModelConfig:
    """Mixtral-8x7B at its published widths (huggingface.co/mistralai/
    Mixtral-8x7B-v0.1 config.json: vocab 32000, hidden 4096, intermediate
    14336, 32 layers, 32 heads, 8 KV heads, head_dim 128, 8 experts, top-2,
    rope theta 1e6, rms eps 1e-5, untied embeddings); ``layers`` may cut the
    depth."""
    return dataclasses.replace(
        llama_config(hidden=4096, inter=14336, layers=layers, heads=32,
                     kv_heads=8, vocab=32000, max_pos=32768,
                     rope_theta=1e6),
        model_type="mixtral", tie_word_embeddings=False, num_experts=8,
        num_experts_per_tok=2)


def qwen3_8b_config(layers: int = 36) -> ModelConfig:
    """Qwen3-8B at its published widths (huggingface.co/Qwen/Qwen3-8B
    config.json: vocab 151936, hidden 4096, intermediate 12288, 36 layers,
    32 heads, 8 KV heads, head_dim 128, per-head q/k RMSNorm, rope theta
    1e6, rms eps 1e-6, untied embeddings); ``layers`` may cut the depth."""
    return dataclasses.replace(
        llama_config(hidden=4096, inter=12288, layers=layers, heads=32,
                     kv_heads=8, vocab=151936, max_pos=40960,
                     rope_theta=1e6),
        model_type="qwen3", norm_eps=1e-6, qk_norm=True,
        tie_word_embeddings=False)


def internlm_7b_config(layers: int = 32) -> ModelConfig:
    """InternLM-7B (v1) at its published widths (huggingface.co/internlm/
    internlm-7b config.json: vocab 103168, hidden 4096, intermediate 11008,
    32 layers, 32 heads (MHA), head_dim 128, q/k/v/o biases (``bias:
    true``), rope theta 10000, rms eps 1e-6, untied); ``layers`` may cut
    the depth."""
    return dataclasses.replace(
        llama_config(hidden=4096, inter=11008, layers=layers, heads=32,
                     kv_heads=32, vocab=103168, max_pos=2048),
        model_type="internlm", norm_eps=1e-6, attn_bias=True,
        tie_word_embeddings=False)


def qwen2_5_7b_config(layers: int = 28) -> ModelConfig:
    """Qwen2.5-7B at its published widths (huggingface.co/Qwen/Qwen2.5-7B
    config.json: vocab 152064, hidden 3584, intermediate 18944, 28 layers,
    28 heads, 4 KV heads, head_dim 128, q/k/v biases, rope theta 1e6, rms
    eps 1e-6, untied); ``layers`` may cut the depth."""
    return dataclasses.replace(
        llama_config(hidden=3584, inter=18944, layers=layers, heads=28,
                     kv_heads=4, vocab=152064, max_pos=131072,
                     rope_theta=1e6),
        model_type="qwen2", norm_eps=1e-6, attn_bias=True,
        tie_word_embeddings=False)


def _both_kinds(cfg: ModelConfig) -> ModelConfig:
    """The config, checked to keep a sliding and a full layer: a cut in
    depth must keep both kinds of attention layer."""
    kinds = {cfg.layer_window(i) is None
             for i in range(cfg.num_hidden_layers)}
    if kinds != {True, False}:
        raise ValueError(f"{cfg.model_type}: a cut in depth must keep a "
                         "sliding and a full layer")
    return cfg


def gemma2_27b_config(layers: int = 46) -> ModelConfig:
    """Gemma-2-27B at its published widths (huggingface.co/google/
    gemma-2-27b config.json: vocab 256000, hidden 4608, intermediate 36864,
    46 layers, 32 heads, 16 KV heads, head_dim 128, query_pre_attn_scalar
    144, sliding window 4096 on alternate layers (the first slides),
    attention softcap 50, final logit softcap 30, rope theta 10000, rms eps
    1e-6, gelu_pytorch_tanh, tied embeddings); ``layers`` may cut the depth
    to 2 or more (the alternation keeps both kinds)."""
    from .registry import get_spec

    return _both_kinds(get_spec("gemma2").make_config({
        "model_type": "gemma2", "vocab_size": 256000, "hidden_size": 4608,
        "intermediate_size": 36864, "num_hidden_layers": layers,
        "num_attention_heads": 32, "num_key_value_heads": 16,
        "head_dim": 128, "max_position_embeddings": 8192,
        "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
        "hidden_activation": "gelu_pytorch_tanh",
        "query_pre_attn_scalar": 144, "sliding_window": 4096,
        "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
        "tie_word_embeddings": True}))


def gemma3_27b_config(layers: int = 62, layer_types=None) -> ModelConfig:
    """Gemma-3-27B's text model at its published widths
    (huggingface.co/google/gemma-3-27b-it config.json, ``text_config``:
    vocab 262208, hidden 5376, intermediate 21504, 62 layers, 32 heads, 16
    KV heads, head_dim 128, query_pre_attn_scalar 168, sliding window 1024
    on five layers of six (``sliding_window_pattern`` 6), rope theta 1e6
    with linear scaling factor 8 on the full layers, rope_local_base_freq
    10000 on the sliding ones, per-head q/k norms, rms eps 1e-6,
    gelu_pytorch_tanh, tied embeddings, no softcaps); ``layers`` may cut
    the depth to 6 (one period of the pattern) or more, or with explicit
    HF ``layer_types`` that hold a sliding and a full layer."""
    from .registry import get_spec

    return _both_kinds(get_spec("gemma3_text").make_config({
        "model_type": "gemma3_text", "vocab_size": 262208,
        "hidden_size": 5376, "intermediate_size": 21504,
        "num_hidden_layers": layers, "num_attention_heads": 32,
        "num_key_value_heads": 16, "head_dim": 128,
        "max_position_embeddings": 131072, "rms_norm_eps": 1e-6,
        "rope_theta": 1e6,
        "rope_scaling": {"rope_type": "linear", "factor": 8.0},
        "rope_local_base_freq": 10000.0,
        "hidden_activation": "gelu_pytorch_tanh",
        "query_pre_attn_scalar": 168, "sliding_window": 1024,
        "sliding_window_pattern": 6, "layer_types": layer_types,
        "attn_logit_softcapping": None, "final_logit_softcapping": None,
        "tie_word_embeddings": True}))


def _rand_lut_linear(gen: torch.Generator, out_f: int, in_f: int, bits: int,
                     device) -> qlinear.QLinear:
    """A random ``lut`` linear: sorted bf16 codebooks with std 0.006 (the
    JAX package's synthetic scale) and uniform random codes."""
    v = 1 << bits
    lut = torch.sort(torch.randn((out_f, v), generator=gen, device=device)
                     * 0.006, dim=1).values.to(torch.bfloat16)
    idx = torch.randint(0, v, (out_f, in_f), generator=gen, device=device,
                        dtype=torch.int32)
    return qlinear.QLinear("lut", {"lut": lut,
                                   "idx_packed": pack_int_rows(idx, bits)},
                           bits=bits, in_features=in_f)


def _rand_affine_lut_linear(gen: torch.Generator, out_f: int, in_f: int,
                            sym: bool, device) -> qlinear.QLinear:
    """A 4-bit ``lut`` linear whose codebooks lie on an affine grid, as a
    ``ganq_codebook="affine"`` / ``"affine_sym"`` solve emits them: slope b
    in [0.001, 0.004) per row, and for the asymmetric grid an offset a in
    [-0.002, 0.002)."""
    b = torch.rand((out_f, 1), generator=gen, device=device) * 0.003 + 0.001
    grid = torch.arange(16, dtype=torch.float32, device=device)
    if sym:
        lut = b * (grid - 8.0)
    else:
        a = torch.rand((out_f, 1), generator=gen, device=device) * 0.004 - 0.002
        lut = a + b * (grid - 7.5)
    idx = torch.randint(0, 16, (out_f, in_f), generator=gen, device=device)
    return qlinear.lut_linear(lut, idx, 4)


def _rand_uniform_linear(gen: torch.Generator, out_f: int, in_f: int,
                         bits: int, device) -> qlinear.QLinear:
    """A symmetric ``uniform`` linear with 128-column groups (one group for
    other widths) and scales in [0.001, 0.004), capped so the weight's range
    stays that of 4 bits."""
    gs = 128 if in_f % 128 == 0 else in_f
    qidx = torch.randint(0, 2**bits, (out_f, in_f), generator=gen,
                         device=device, dtype=torch.int32)
    scales = ((torch.rand((out_f, in_f // gs), generator=gen, device=device)
               * 0.003 + 0.001) * min(1.0, 16.0 / (1 << bits)))
    zeros = torch.full_like(scales, float(1 << (bits - 1)))
    return qlinear.uniform_linear(qidx, scales, zeros, None, bits)


def _rand_w8_linear(gen: torch.Generator, out_f: int, in_f: int,
                    device) -> qlinear.QLinear:
    """A ``w8`` linear: int8 weights and row scales in [1e-4, 4e-4)."""
    w8 = torch.randint(-127, 128, (out_f, in_f), generator=gen, device=device,
                       dtype=torch.int32).to(torch.int8)
    scale = torch.rand((out_f, 1), generator=gen, device=device) * 3e-4 + 1e-4
    return qlinear.QLinear("w8", {"w8": w8, "scale": scale}, bits=8,
                           in_features=in_f)


def _rand_dense_linear(gen: torch.Generator, out_f: int, in_f: int, device,
                       dtype: torch.dtype) -> qlinear.QLinear:
    """A random dense linear of std 0.02 (the JAX package's synthetic scale)."""
    w = torch.randn((out_f, in_f), generator=gen, device=device) * 0.02
    return qlinear.dense_linear(w.to(dtype))


def make_model(cfg: ModelConfig, kind: str = "lut", bits: int = 4,
               seed: int = 0, device="cuda",
               dtype: torch.dtype = torch.bfloat16,
               lm_head_kind: Optional[str] = None,
               lm_head_bits: int = 8) -> Model:
    """Random model with every layer linear of ``kind`` (``"dense"``: std
    0.02 weights in ``dtype``; ``"lut"``: ``bits``-bit codebooks and codes;
    ``"lut_affine"`` / ``"lut_affine_sym"``: 4-bit affine-grid codebooks;
    ``"uniform"``: ``bits``-bit symmetric codes; ``"w8"``), unit norm
    weights and an embedding of std 0.02 (tied, as ``llama_config`` sets;
    an untied config gets a dense lm_head of std 0.02). A MoE config
    (``num_experts``) gets per layer a dense router of std 0.02 and
    ``num_experts`` experts of ``kind`` in place of the MLP. A config with
    ``attn_bias`` gets q/k/v biases of std 0.1 (and an o bias for
    ``internlm``), one with ``qk_norm`` per-head q/k norm weights in
    [0.75, 1.25), all from the seed. Where the config stores norm weights as
    ``w - 1`` (gemma's ``rms_offset``), the norms hold ``1 - rms_offset``
    (unit norms) and the q/k norms lie in [-0.25, 0.25); sandwich-norm
    layers get ``post_attn_norm`` and ``post_mlp_norm`` in [-0.3, 0.3)
    from the seed, as ``ganq_tpu``'s gemma tests set them.
    ``lm_head_kind`` gives the model a quantized lm_head of that kind at
    ``lm_head_bits`` (``ganq_tpu/models/synthetic.py:181-228``: the
    reference's 8-bit lm_head rule), untied whatever the config says."""
    kinds = ("dense", "lut", "lut_affine", "lut_affine_sym", "uniform", "w8")
    if kind not in kinds or lm_head_kind not in (None,) + kinds:
        raise ValueError(f"unknown synthetic kind {kind!r} / "
                         f"{lm_head_kind!r}")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    h, q, kv, it = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                    cfg.intermediate_size)

    def lin(out_f, in_f, kind=kind, bits=bits):
        if kind == "lut":
            return _rand_lut_linear(gen, out_f, in_f, bits, device)
        if kind in ("lut_affine", "lut_affine_sym"):
            return _rand_affine_lut_linear(gen, out_f, in_f,
                                           kind == "lut_affine_sym", device)
        if kind == "uniform":
            return _rand_uniform_linear(gen, out_f, in_f, bits, device)
        if kind == "w8":
            return _rand_w8_linear(gen, out_f, in_f, device)
        return _rand_dense_linear(gen, out_f, in_f, device, dtype)

    def mlp():
        return {"gate": lin(it, h), "up": lin(it, h), "down": lin(h, it)}

    def with_bias(m, n):
        m.register_buffer("bias", (torch.randn(n, generator=gen, device=device)
                                   * 0.1).to(dtype))
        return m

    def unit_norm():
        return torch.full((h,), 1.0 - cfg.rms_offset, dtype=dtype,
                          device=device)

    def layer():
        attn = {"q": lin(q, h), "k": lin(kv, h), "v": lin(kv, h),
                "o": lin(h, q)}
        if cfg.attn_bias:           # q/k/v biases (qwen2), o too (internlm)
            for n, width in (("q", q), ("k", kv), ("v", kv)) + (
                    (("o", h),) if cfg.model_type == "internlm" else ()):
                with_bias(attn[n], width)
        norms = (unit_norm(), unit_norm())
        extra = {}
        if cfg.qk_norm:
            extra = {n: (torch.rand(cfg.head_dim, generator=gen, device=device)
                         * 0.5 + 0.75 - cfg.rms_offset).to(dtype)
                     for n in ("q_norm", "k_norm")}
        if cfg.sandwich_norm:
            extra.update({n: (torch.rand(h, generator=gen, device=device)
                              * 0.6 - 0.3).to(dtype)
                          for n in ("post_attn_norm", "post_mlp_norm")})
        if not cfg.num_experts:
            return Layer(*norms, attn=attn, mlp=mlp(), **extra)
        router = _rand_dense_linear(gen, cfg.num_experts, h, device, dtype)
        return Layer(*norms, attn=attn, mlp={}, moe={
            "router": router,
            "experts": [mlp() for _ in range(cfg.num_experts)]}, **extra)

    layers = [layer() for _ in range(cfg.num_hidden_layers)]
    embed = (torch.randn((cfg.vocab_size, h), generator=gen, device=device)
             * 0.02).to(dtype)
    if lm_head_kind is not None:
        lm_head = lin(cfg.vocab_size, h, lm_head_kind, lm_head_bits)
    else:
        lm_head = (None if cfg.tie_word_embeddings else
                   _rand_dense_linear(gen, cfg.vocab_size, h, device, dtype))
    return Model(embed, unit_norm(), layers, lm_head)


__all__ = ["llama_config", "llama_3_2_1b_config", "llama_3_2_3b_config",
           "llama_3_1_8b_config", "mixtral_8x7b_config", "qwen3_8b_config",
           "internlm_7b_config", "qwen2_5_7b_config", "gemma2_27b_config",
           "gemma3_27b_config", "make_model"]
