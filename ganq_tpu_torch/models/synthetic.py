"""Synthetic models: random weights at real architecture widths.

The port of ``llama_config`` and ``make_model`` (with Mixtral's experts) of
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
               dtype: torch.dtype = torch.bfloat16) -> Model:
    """Random model with every layer linear of ``kind`` (``"dense"``: std
    0.02 weights in ``dtype``; ``"lut"``: ``bits``-bit codebooks and codes;
    ``"lut_affine"`` / ``"lut_affine_sym"``: 4-bit affine-grid codebooks;
    ``"uniform"``: ``bits``-bit symmetric codes; ``"w8"``), unit norm
    weights and an embedding of std 0.02 (tied, as ``llama_config`` sets;
    an untied config gets a dense lm_head of std 0.02). A MoE config
    (``num_experts``) gets per layer a dense router of std 0.02 and
    ``num_experts`` experts of ``kind`` in place of the MLP."""
    if kind not in ("dense", "lut", "lut_affine", "lut_affine_sym", "uniform",
                    "w8"):
        raise ValueError(f"unknown synthetic kind {kind!r}")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    h, q, kv, it = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                    cfg.intermediate_size)

    def lin(out_f, in_f):
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

    def layer():
        attn = {"q": lin(q, h), "k": lin(kv, h), "v": lin(kv, h),
                "o": lin(h, q)}
        norms = (torch.ones(h, dtype=dtype, device=device),
                 torch.ones(h, dtype=dtype, device=device))
        if not cfg.num_experts:
            return Layer(*norms, attn=attn, mlp=mlp())
        router = _rand_dense_linear(gen, cfg.num_experts, h, device, dtype)
        return Layer(*norms, attn=attn, mlp={}, moe={
            "router": router,
            "experts": [mlp() for _ in range(cfg.num_experts)]})

    layers = [layer() for _ in range(cfg.num_hidden_layers)]
    embed = (torch.randn((cfg.vocab_size, h), generator=gen, device=device)
             * 0.02).to(dtype)
    lm_head = (None if cfg.tie_word_embeddings else
               _rand_dense_linear(gen, cfg.vocab_size, h, device, dtype))
    return Model(embed, torch.ones(h, dtype=dtype, device=device), layers,
                 lm_head)


__all__ = ["llama_config", "llama_3_2_1b_config", "llama_3_2_3b_config",
           "llama_3_1_8b_config", "mixtral_8x7b_config", "make_model"]
