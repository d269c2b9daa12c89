"""HF config and tensors -> the port's :class:`Model`.

The port of ``ganq_tpu/models/hf_import.py`` for the llama family (with
Qwen3's q/k norms and the biases of Qwen2 and InternLM, taken where the
checkpoint has them), gemma (Gemma 2 and 3's sandwich norms) and mixtral (MoE layers: a dense router and per-expert
gate/up/down): the HF
config dict becomes a :class:`ModelConfig`, and HF tensor names map onto the
model's parameter paths through the registry's ``name_map``.
:func:`params_from_dir` reads a dense checkpoint directory;
:func:`params_from_numpy` builds a model from the JAX package's parameters
flattened to numpy, so that both packages compute on the same weights.
Every function that builds a model places it on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.backend import resolve_device
from ..formats.safetensors_io import load_file
from ..ops import qlinear
from .registry import get_spec
from .transformer import QK_NORMS, SANDWICH_NORMS, Layer, Model, ModelConfig

_ATTN = ("q", "k", "v", "o")
_MLP = ("gate", "up", "down")


def load_hf_config(model_dir: str) -> Dict[str, Any]:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def config_from_hf(hf_config: Dict[str, Any]) -> ModelConfig:
    return get_spec(hf_config["model_type"]).make_config(hf_config)


def config_to_hf(cfg: ModelConfig) -> Dict[str, Any]:
    """The HF config dict of a :class:`ModelConfig` (written as config.json)."""
    return {"model_type": cfg.model_type, "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "num_key_value_heads": cfg.num_key_value_heads,
            "head_dim": cfg.head_dim,
            "max_position_embeddings": cfg.max_position_embeddings,
            "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
            "rope_scaling": cfg.rope_scaling, "hidden_act": cfg.act,
            "attention_bias": cfg.attn_bias, "mlp_bias": cfg.mlp_bias,
            "tie_word_embeddings": cfg.tie_word_embeddings,
            **({"bias": cfg.attn_bias} if cfg.model_type == "internlm"
               else {}),
            **({"num_local_experts": cfg.num_experts,
                "num_experts_per_tok": cfg.num_experts_per_tok}
               if cfg.num_experts else {}),
            **(_gemma_hf(cfg) if cfg.model_type.startswith("gemma") else {})}


def _gemma_hf(cfg: ModelConfig) -> Dict[str, Any]:
    """The gemma keys of a config.json (the registry reads them back to the
    same :class:`ModelConfig`)."""
    out: Dict[str, Any] = {"hidden_activation": cfg.act}
    if cfg.model_type == "gemma":
        return out
    qpas = cfg.attn_scale ** -2
    if round(qpas) ** -0.5 == cfg.attn_scale:
        qpas = round(qpas)
    out.update(query_pre_attn_scalar=qpas,
               attn_logit_softcapping=cfg.attn_softcap,
               final_logit_softcapping=cfg.logit_softcap,
               sliding_window=cfg.sliding_window,
               layer_types=list(cfg.layer_types or ()) or None)
    if cfg.rope_local_theta is not None:
        out["rope_local_base_freq"] = cfg.rope_local_theta
    return out


def iter_safetensors(model_dir: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every tensor of a checkpoint directory: the shards listed by
    ``model.safetensors.index.json`` when there is one, else every
    ``*.safetensors`` file."""
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.isfile(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
        paths = [os.path.join(model_dir, n) for n in files]
    else:
        paths = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    for path in paths:
        yield from load_file(path).items()


def params_from_dir(model_dir: str, dtype: torch.dtype = torch.float32,
                    device="cuda") -> Tuple[ModelConfig, Model]:
    """Build (ModelConfig, Model) on ``device`` from a dense HF checkpoint
    directory (``config.json`` plus safetensors files), read with the port's
    own safetensors reader."""
    device = resolve_device(device)
    hf_config = load_hf_config(model_dir)
    state = dict(iter_safetensors(model_dir))
    if not state:
        raise FileNotFoundError(f"no *.safetensors found in {model_dir}")
    return params_from_state_dict(state, hf_config, dtype, device)


def _container(model: Model, layer_idx: int, slot: str):
    """(container, name) of a slot: ``attn.q``, ``mlp.down``,
    ``moe.router``, ``moe.experts.3.gate``; the container is None where the
    layer has no such group."""
    parts = slot.split(".")
    node = getattr(model.layers[layer_idx], parts[0])
    for p in parts[1:-1]:
        if node is None:
            break
        node = node[int(p)] if p.isdigit() else node[p]
    return node, parts[-1]


def get_module(model: Model, layer_idx: int, slot: str) -> Optional[torch.nn.Module]:
    """The linear at slot ``attn.q`` / ``mlp.down`` / ``moe.experts.0.gate``
    of layer ``layer_idx``, or None."""
    container, name = _container(model, layer_idx, slot)
    return container[name] if container is not None and name in container \
        else None


def set_module(model: Model, layer_idx: int, slot: str, value) -> None:
    container, name = _container(model, layer_idx, slot)
    container[name] = value


def params_from_state_dict(state: Dict[str, torch.Tensor],
                           hf_config: Dict[str, Any],
                           dtype: torch.dtype = torch.float32,
                           device="cuda") -> Tuple[ModelConfig, Model]:
    """Build (ModelConfig, Model) on ``device`` (the card unless the caller
    passes ``"cpu"``) from HF-named tensors. Linear slots whose weight is
    absent stay empty (a quantized checkpoint fills them)."""
    device = resolve_device(device)
    spec = get_spec(hf_config["model_type"])
    cfg = spec.make_config(hf_config)
    spec = spec.expand(cfg.num_experts)

    def get(ours: str, i: int = 0) -> Optional[torch.Tensor]:
        theirs = spec.name_map.get(ours)
        t = None if theirs is None else state.get(theirs.replace("{i}", str(i)))
        return None if t is None else t.to(device=device, dtype=dtype)

    def slots(i: int, group: str, names) -> Dict[str, qlinear.QLinear]:
        out = {}
        for n in names:
            w = get(f"layers.{{i}}.{group}.{n}.weight", i)
            if w is not None:
                out[n] = qlinear.dense_linear(
                    w, get(f"layers.{{i}}.{group}.{n}.bias", i))
        return out

    def moe(i: int):
        if not cfg.num_experts:
            return None
        router = get("layers.{i}.moe.router.weight", i)
        return {"router": qlinear.dense_linear(router),
                "experts": [slots(i, f"moe.experts.{e}", _MLP)
                            for e in range(cfg.num_experts)]}

    def norms(i: int) -> Dict[str, Optional[torch.Tensor]]:
        out = {}
        if cfg.qk_norm:
            out = {n: get(f"layers.{{i}}.attn.{n}.weight", i)
                   for n in QK_NORMS}
        if cfg.sandwich_norm:
            out.update({n: get(f"layers.{{i}}.{n}.weight", i)
                        for n in SANDWICH_NORMS})
        return out

    layers = [Layer(get("layers.{i}.input_norm.weight", i),
                    get("layers.{i}.post_norm.weight", i),
                    attn=slots(i, "attn", _ATTN),
                    mlp={} if cfg.num_experts else slots(i, "mlp", _MLP),
                    moe=moe(i), **norms(i))
              for i in range(cfg.num_hidden_layers)]
    embed = get("embed_tokens.weight")
    lm = get("lm_head.weight")
    # a config may report tied embeddings while holding a distinct lm_head:
    # trust the tensors over the flag
    tied = cfg.tie_word_embeddings and (
        lm is None or (lm.shape == embed.shape and torch.equal(lm, embed)))
    lm_head = qlinear.dense_linear(lm) if lm is not None and not tied else None
    return cfg, Model(embed, get("final_norm.weight"), layers, lm_head)


def params_from_numpy(cfg_dict: Dict[str, Any], arrays: Dict[str, Any],
                      device="cuda") -> Tuple[ModelConfig, Model]:
    """Build (ModelConfig, Model) on ``device`` from the JAX package's
    parameters flattened to numpy: ``arrays`` maps parameter paths
    (``embed_tokens.weight``, ``layers.0.input_norm.weight``, ...) to arrays.
    Each linear at path P, dense (the fake-quantized weights of a freshly
    quantized model) or quantized, is described by ``P.kind`` / ``P.bits`` /
    ``P.in_features`` plus ``P.<array>`` for its arrays (``weight``,
    ``lut``, ``idx_packed``, ``bias``, ...). Codebooks are stored bf16, as
    the JAX package holds them; every other array keeps its dtype."""
    device = resolve_device(device)
    cfg = config_from_hf(cfg_dict)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def linear(path: str) -> Optional[qlinear.QLinear]:
        if f"{path}.kind" not in arrays:
            return None
        meta = {f"{path}.{k}" for k in ("kind", "bits", "in_features")}
        prefix = f"{path}."
        arrs = {k[len(prefix):]: tensor(v) for k, v in arrays.items()
                if k.startswith(prefix) and k not in meta
                and "." not in k[len(prefix):]}
        if "lut" in arrs:
            arrs["lut"] = arrs["lut"].to(torch.bfloat16)
        return qlinear.QLinear(str(arrays[f"{path}.kind"]), arrs,
                               bits=int(arrays[f"{path}.bits"]),
                               in_features=int(arrays[f"{path}.in_features"]))

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}"
        moe = None
        if cfg.num_experts:
            moe = {"router": linear(f"{p}.moe.router"),
                   "experts": [{n: linear(f"{p}.moe.experts.{e}.{n}")
                                for n in _MLP}
                               for e in range(cfg.num_experts)]}
        norms = {n: tensor(arrays[f"{p}.attn.{n}.weight"]) for n in QK_NORMS
                 if f"{p}.attn.{n}.weight" in arrays}
        norms.update({n: tensor(arrays[f"{p}.{n}.weight"])
                      for n in SANDWICH_NORMS if f"{p}.{n}.weight" in arrays})
        layers.append(Layer(
            tensor(arrays[f"{p}.input_norm.weight"]),
            tensor(arrays[f"{p}.post_norm.weight"]),
            attn={n: linear(f"{p}.attn.{n}") for n in _ATTN},
            mlp={} if moe else {n: linear(f"{p}.mlp.{n}") for n in _MLP},
            moe=moe, **norms))
    model = Model(tensor(arrays["embed_tokens.weight"]),
                  tensor(arrays["final_norm.weight"]), layers,
                  linear("lm_head"))
    return cfg, model


__all__ = ["load_hf_config", "config_from_hf", "config_to_hf",
           "iter_safetensors", "params_from_state_dict", "params_from_numpy",
           "params_from_dir",
           "get_module", "set_module"]
