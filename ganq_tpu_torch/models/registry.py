"""Architecture registry: the llama and mixtral ``ArchSpec``s.

The port of the llama and mixtral entries of ``ganq_tpu/models/registry.py``:
how a HF config becomes a :class:`ModelConfig`, how HF tensor names map
onto the model's parameter paths, and which linears are quantized (their
checkpoint module names, the slots they fill and the order of the
quantization subsets). Expert templates (``{e}``) are instantiated per
model by :meth:`ArchSpec.expand`. The other architectures come with later
slices.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

from .transformer import ModelConfig


@dataclass
class ArchSpec:
    model_type: str
    make_config: Callable[[Dict[str, Any]], ModelConfig]
    # our parameter path -> HF tensor name; {i} = layer index
    name_map: Dict[str, str] = field(default_factory=dict)
    # quantization subsets in true_sequential order (reference layer_modules)
    layer_modules: List[List[str]] = field(default_factory=list)
    # HF module name inside a layer -> our slot ("attn.q", "mlp.down", ...)
    module_slots: Dict[str, str] = field(default_factory=dict)
    lm_head_name: str = "lm_head"
    layers_prefix: str = "model.layers"

    def expand(self, num_experts: int) -> "ArchSpec":
        """The spec with its ``{e}`` expert templates instantiated for
        experts 0 .. num_experts - 1 (``ganq_tpu/models/registry.py:47-80``,
        the reference's expert-index placeholder); itself for a dense
        model."""
        if num_experts <= 0 or not any("{e}" in m for sub in self.layer_modules
                                       for m in sub):
            return self

        def each(name):
            if "{e}" not in name:
                return [name]
            return [name.replace("{e}", str(e)) for e in range(num_experts)]

        def mapping(d):
            return {k: v for ours, theirs in d.items()
                    for k, v in zip(each(ours), each(theirs))}

        return dataclasses.replace(
            self, name_map=mapping(self.name_map),
            layer_modules=[[n for m in sub for n in each(m)]
                           for sub in self.layer_modules],
            module_slots=mapping(self.module_slots))


REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    REGISTRY[spec.model_type] = spec
    return spec


def get_spec(model_type: str) -> ArchSpec:
    if model_type not in REGISTRY:
        raise KeyError(f"Unsupported architecture '{model_type}'. "
                       f"Registered: {sorted(REGISTRY)}")
    return REGISTRY[model_type]


def _llama_config(hf: Dict[str, Any]) -> ModelConfig:
    heads = hf["num_attention_heads"]
    return ModelConfig(
        model_type=hf.get("model_type", "llama"),
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=heads,
        num_key_value_heads=hf.get("num_key_value_heads", heads),
        head_dim=hf.get("head_dim") or hf["hidden_size"] // heads,
        max_position_embeddings=hf.get("max_position_embeddings", 2048),
        norm_eps=hf.get("rms_norm_eps", 1e-5),
        act=hf.get("hidden_act", "silu"),
        rope_theta=hf.get("rope_theta", 10000.0),
        rope_scaling=hf.get("rope_scaling"),
        attn_bias=hf.get("attention_bias", False),
        mlp_bias=hf.get("mlp_bias", False),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )


LLAMA_NAME_MAP = {
    "embed_tokens.weight": "model.embed_tokens.weight",
    "final_norm.weight": "model.norm.weight",
    "lm_head.weight": "lm_head.weight",
    "layers.{i}.input_norm.weight": "model.layers.{i}.input_layernorm.weight",
    "layers.{i}.post_norm.weight": "model.layers.{i}.post_attention_layernorm.weight",
    "layers.{i}.attn.q.weight": "model.layers.{i}.self_attn.q_proj.weight",
    "layers.{i}.attn.k.weight": "model.layers.{i}.self_attn.k_proj.weight",
    "layers.{i}.attn.v.weight": "model.layers.{i}.self_attn.v_proj.weight",
    "layers.{i}.attn.o.weight": "model.layers.{i}.self_attn.o_proj.weight",
    "layers.{i}.attn.q.bias": "model.layers.{i}.self_attn.q_proj.bias",
    "layers.{i}.attn.k.bias": "model.layers.{i}.self_attn.k_proj.bias",
    "layers.{i}.attn.v.bias": "model.layers.{i}.self_attn.v_proj.bias",
    "layers.{i}.mlp.gate.weight": "model.layers.{i}.mlp.gate_proj.weight",
    "layers.{i}.mlp.up.weight": "model.layers.{i}.mlp.up_proj.weight",
    "layers.{i}.mlp.down.weight": "model.layers.{i}.mlp.down_proj.weight",
}

LLAMA_LAYER_MODULES = [
    ["self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"],
    ["self_attn.o_proj"],
    ["mlp.up_proj", "mlp.gate_proj"],
    ["mlp.down_proj"],
]

LLAMA_SLOTS = {
    "self_attn.q_proj": "attn.q",
    "self_attn.k_proj": "attn.k",
    "self_attn.v_proj": "attn.v",
    "self_attn.o_proj": "attn.o",
    "mlp.gate_proj": "mlp.gate",
    "mlp.up_proj": "mlp.up",
    "mlp.down_proj": "mlp.down",
}

register(ArchSpec(
    model_type="llama",
    make_config=_llama_config,
    name_map=LLAMA_NAME_MAP,
    layer_modules=LLAMA_LAYER_MODULES,
    module_slots=LLAMA_SLOTS,
))


# -------------------------------------------------------------------- mixtral
def _mixtral_config(hf: Dict[str, Any]) -> ModelConfig:
    return dataclasses.replace(
        _llama_config(hf), model_type="mixtral",
        num_experts=hf.get("num_local_experts", 8),
        num_experts_per_tok=hf.get("num_experts_per_tok", 2))


MIXTRAL_NAME_MAP = {
    **{k: v for k, v in LLAMA_NAME_MAP.items()
       if ".mlp." not in k and ".bias" not in k},
    "layers.{i}.moe.router.weight":
        "model.layers.{i}.block_sparse_moe.gate.weight",
    "layers.{i}.moe.experts.{e}.gate.weight":
        "model.layers.{i}.block_sparse_moe.experts.{e}.w1.weight",
    "layers.{i}.moe.experts.{e}.down.weight":
        "model.layers.{i}.block_sparse_moe.experts.{e}.w2.weight",
    "layers.{i}.moe.experts.{e}.up.weight":
        "model.layers.{i}.block_sparse_moe.experts.{e}.w3.weight",
}

# the router stays dense: the reference's mixtral definition quantizes only
# the experts' w1/w3/w2
MIXTRAL_LAYER_MODULES = [
    ["self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"],
    ["self_attn.o_proj"],
    ["block_sparse_moe.experts.{e}.w1", "block_sparse_moe.experts.{e}.w3"],
    ["block_sparse_moe.experts.{e}.w2"],
]

MIXTRAL_SLOTS = {
    "self_attn.q_proj": "attn.q",
    "self_attn.k_proj": "attn.k",
    "self_attn.v_proj": "attn.v",
    "self_attn.o_proj": "attn.o",
    "block_sparse_moe.experts.{e}.w1": "moe.experts.{e}.gate",
    "block_sparse_moe.experts.{e}.w3": "moe.experts.{e}.up",
    "block_sparse_moe.experts.{e}.w2": "moe.experts.{e}.down",
}

register(ArchSpec(
    model_type="mixtral",
    make_config=_mixtral_config,
    name_map=MIXTRAL_NAME_MAP,
    layer_modules=MIXTRAL_LAYER_MODULES,
    module_slots=MIXTRAL_SLOTS,
))


__all__ = ["ArchSpec", "REGISTRY", "register", "get_spec"]
