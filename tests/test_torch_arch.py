"""Qwen2/2.5, Qwen3 and InternLM in the PyTorch port against ``ganq_tpu``.

The registry entries (the llama aliases, qwen3's per-head q/k RMSNorm,
internlm's q/k/v/o biases), the per-layer forward, kernel 14's qk-norm and
bias operands (``qk_nm``, ``o_bias``, ``gu_bias``, ``dn_bias``: packs byte
for byte, the plain version against ganq_tpu's Pallas kernel in interpret
mode), the gates of kernels 10-14 on those architectures, a Qwen3 model
through ``optimize()`` and kernel 14's "w8p", and Qwen3 ``lut`` checkpoints
across the two packages. Inputs come from numpy seeds; both packages compute
in float32 from the same weights."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ganq_tpu.models import hf_import as jhf
from ganq_tpu.models import transformer as jtr
from ganq_tpu.models.registry import get_spec as jget_spec
from ganq_tpu.ops import megastep_lowbit as jlb
from ganq_tpu.serve import stacked as jst
from ganq_tpu_torch.models import hf_import as thf
from ganq_tpu_torch.models import registry as treg
from ganq_tpu_torch.models import transformer as ttr
from ganq_tpu_torch.ops import megastep_lowbit as tlb
from ganq_tpu_torch.serve import stacked as tst

from test_torch_fused_w8a8 import assert_kernel_close
from test_torch_megastep import _t
from test_torch_megastep_lowbit import (_step_inputs, inject_zp_ao,
                                        np_uniform_llama)
from test_torch_serve import _flatten_jax
from test_torch_stacked import _np, _port_cfg, np_llama
from test_torch_packing import torch_threads_per_worker  # noqa: F401

_FAMILIES = ("llama", "mistral", "qwen2", "yi", "mobilellm", "qwen3",
             "internlm")


def _hf_dict(model_type, hidden=64, heads=4, kv=2, inter=128, vocab=256,
             **extra):
    return {"model_type": model_type, "vocab_size": vocab,
            "hidden_size": hidden, "intermediate_size": inter,
            "num_hidden_layers": 2, "num_attention_heads": heads,
            "num_key_value_heads": kv, "max_position_embeddings": 128,
            "rms_norm_eps": 1e-6, "rope_theta": 1e6, **extra}


@pytest.mark.parametrize("model_type", _FAMILIES)
def test_configs_match_jax(model_type):
    """Each registered family's ``make_config`` equals ganq_tpu's on every
    field of the port's ModelConfig (qwen2's ``attention_bias``, internlm's
    ``bias``, mistral's ignored ``sliding_window``); the JAX package's other
    qk-norm kinds raise in the port."""
    for extra in ({}, {"attention_bias": True, "head_dim": 16},
                  {"bias": False, "sliding_window": 64}):
        hf = _hf_dict(model_type, **extra)
        got = treg.get_spec(model_type).make_config(hf)
        want = jget_spec(model_type).make_config(hf)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
        back = thf.config_from_hf(thf.config_to_hf(got))
        assert back == got
    for kind in ("flat", "cohere"):
        with pytest.raises(NotImplementedError, match="queue A item 6"):
            dataclasses.replace(got, qk_norm=kind)


def _np_state(model_type, seed, hidden=64, heads=4, kv=2, inter=128,
              vocab=256, layers=2):
    """A random HF state dict of a tiny model of the family: llama names,
    q/k/v biases for qwen2 and internlm, o biases for internlm, q/k norms
    [head_dim] for qwen3 (the shapes of ``tests/test_models.py``'s tiny
    Qwen3 and InternLM)."""
    rng = np.random.default_rng(seed)
    d = hidden // heads

    def w(*shape, s=0.08):
        return (rng.normal(size=shape) * s).astype(np.float32)

    st = {"model.embed_tokens.weight": w(vocab, hidden, s=0.5),
          "model.norm.weight": 1 + w(hidden, s=0.1),
          "lm_head.weight": w(vocab, hidden)}
    for i in range(layers):
        p = f"model.layers.{i}."
        st[p + "input_layernorm.weight"] = 1 + w(hidden, s=0.1)
        st[p + "post_attention_layernorm.weight"] = 1 + w(hidden, s=0.1)
        for n, o in (("q", heads * d), ("k", kv * d), ("v", kv * d)):
            st[p + f"self_attn.{n}_proj.weight"] = w(o, hidden)
            if model_type in ("qwen2", "internlm"):
                st[p + f"self_attn.{n}_proj.bias"] = w(o, s=0.3)
        st[p + "self_attn.o_proj.weight"] = w(hidden, heads * d)
        if model_type == "internlm":
            st[p + "self_attn.o_proj.bias"] = w(hidden, s=0.3)
        if model_type == "qwen3":
            st[p + "self_attn.q_norm.weight"] = 1 + w(d, s=0.2)
            st[p + "self_attn.k_norm.weight"] = 1 + w(d, s=0.2)
        st[p + "mlp.gate_proj.weight"] = w(inter, hidden)
        st[p + "mlp.up_proj.weight"] = w(inter, hidden)
        st[p + "mlp.down_proj.weight"] = w(hidden, inter)
    return st


@pytest.mark.parametrize("model_type", ["qwen3", "internlm", "qwen2"])
def test_forward_logits_match_jax(model_type):
    """A 2-layer tiny model (hidden 64, head_dim 16) from one HF state dict:
    the port's reference forward gives ganq_tpu's logits (float32; they
    differ in summation order and ulp-level rope values, so within 1e-4 of
    the logits' scale, ``test_torch_serve.py``'s tolerance). The qk norms
    and biases matter: without them the logits move far more."""
    hf = _hf_dict(model_type, kv=4 if model_type == "internlm" else 2,
                  **({"bias": True} if model_type == "internlm" else
                     {"attention_bias": True} if model_type == "qwen2"
                     else {}))
    state = _np_state(model_type, seed=13, kv=hf["num_key_value_heads"])
    jcfg, jparams = jhf.params_from_state_dict(state, hf)
    tcfg, tmodel = thf.params_from_state_dict(
        {k: torch.from_numpy(v) for k, v in state.items()}, hf,
        device="cpu")
    ids = np.random.default_rng(14).integers(0, 256, size=(2, 16))
    ref = np.asarray(jtr.forward(jcfg, jparams, jnp.asarray(ids)))
    with torch.inference_mode():
        got = ttr.forward(tcfg, tmodel, torch.as_tensor(ids)).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
    if model_type == "qwen3":
        assert tcfg.qk_norm and tmodel.layers[0].q_norm.shape == (16,)
        bare = {k: v for k, v in state.items() if "_norm." not in k}
        plain = dataclasses.replace(tcfg, qk_norm=False)
    else:
        assert "bias" in tmodel.layers[0].attn["q"]
        assert ("bias" in tmodel.layers[0].attn["o"]) == (
            model_type == "internlm")
        bare = {k: v for k, v in state.items() if not k.endswith(".bias")}
        plain = tcfg
    _, without = thf.params_from_state_dict(
        {k: torch.from_numpy(v) for k, v in bare.items()},
        {**hf, "model_type": "llama"}, device="cpu")
    with torch.inference_mode():
        other = ttr.forward(plain, without, torch.as_tensor(ids)).numpy()
    assert np.abs(other - ref).max() > 1e-2 * scale


# --------------------------------------------- kernel 14's arch operands
def arch_pair(bits, qk_norm, biases, zp=False, hidden=256, heads=2, kvh=1,
              inter=512, seed=3):
    """(jax cfg, jax params, port cfg, port model): a 2-layer uniform
    ``bits``-bit llama (:func:`np_uniform_llama`, random norms), with zero
    points (``zp``), per-head q/k norm weights in [0.5, 1.5) (``qk_norm``:
    a qwen3 config) and random biases of std 5e-2 on q/k/v/o/gate/up/down
    (``biases``), the same weights in both packages."""
    jcfg, params = np_uniform_llama(hidden, heads, kvh, inter, bits, seed=seed)
    if zp:
        inject_zp_ao(params, bits, True, False, seed)
    rng = np.random.default_rng(seed + 100)
    tcfg = _port_cfg(hidden, heads, kvh, inter, 64)
    if qk_norm:
        jcfg = dataclasses.replace(jcfg, model_type="qwen3", qk_norm=True)
        tcfg = dataclasses.replace(tcfg, model_type="qwen3", qk_norm=True)
        for lp in params["layers"]:
            for n in ("q_norm", "k_norm"):
                lp["attn"][n] = {"weight": jnp.asarray(rng.uniform(
                    0.5, 1.5, size=(128,)).astype(np.float32))}
    if biases:
        for lp in params["layers"]:
            for group, names in (("attn", "qkvo"),
                                 ("mlp", ("gate", "up", "down"))):
                for n in names:
                    m = lp[group][n]
                    m["bias"] = jnp.asarray((rng.normal(size=(
                        m["scales"].shape[0],)) * 5e-2).astype(np.float32))
    _, tmodel = thf.params_from_numpy(thf.config_to_hf(tcfg),
                                      _flatten_jax(params), device="cpu")
    return jcfg, params, tcfg, tmodel


# (bits, qk-norm, biases, zero points, batch) at kernel 14's smallest widths
# (hidden 256, 2 heads, 1 kv head, I = 512): ganq_tpu's qk-norm cases
# (tests/test_megastep_lowbit.py:299, bits 4 and 8), its biased case (:605,
# bits 4) and both with zero points
_ARCH = {"qkn4": (4, True, False, False, 8), "qkn8": (8, True, False, False, 8),
         "bias4": (4, False, True, False, 8),
         "qkn_bias_zp4": (4, True, True, True, 4)}


@pytest.fixture(scope="module")
def arch_packs():
    """Per case of ``_ARCH``: (jax cfg, jax pack, port pack, port cfg, port
    stacked model)."""
    out = {}
    for case, (bits, qkn, bias, zp, _) in _ARCH.items():
        jcfg, params, tcfg, tmodel = arch_pair(bits, qkn, bias, zp)
        sp = jst.stack_layers(params, recode="affine")
        tsp = tst.stack_layers(tmodel, recode="affine")
        out[case] = (jcfg, jlb.megapack_lowbit(jcfg, sp, bits),
                     tlb.megapack_lowbit(tcfg, tsp, bits), tcfg, tsp)
    return out


@pytest.mark.parametrize("case", sorted(_ARCH))
def test_arch_packs_match_jax_bytes(arch_packs, case):
    """``qk_nm`` (the lane-expanded norm weights over the apply mask),
    ``o_bias``, ``gu_bias`` (tile-major, gate tile then up tile) and
    ``dn_bias`` equal ganq_tpu's byte for byte, beside every other operand
    of the pack; the stacked layers carry the q/k norms through the fuse."""
    _, qkn, bias, zp, _ = _ARCH[case]
    _, jmp, tmp, _, tsp = arch_packs[case]
    assert ("qk_nm" in tmp) == qkn and ("o_bias" in tmp) == bias
    assert ("qkv_sz" in tmp) == zp
    assert sorted(tmp) == sorted(jmp)
    for k, v in jmp.items():
        assert tuple(tmp[k].shape) == v.shape, k
        assert tmp[k].dtype == _t(v[:1]).dtype, k
        np.testing.assert_array_equal(tmp[k].float().numpy(), _np(v),
                                      err_msg=k)
    assert (tsp.layers[0].q_norm is not None) == qkn


@pytest.mark.parametrize("case", sorted(_ARCH))
def test_arch_plain_matches_jax_interpret(arch_packs, case):
    """The plain version of kernel 14 with qk-norm (bits 4 and 8), biases
    (bits 4) and both with zero points, against ganq_tpu's kernel in
    interpret mode, each slot at its own history length, at the tolerances
    of ganq_tpu's tests: qk-norm k/v atol 8e-2 rtol 2e-2 (an int8 code
    flipped at a rounding tie moves the normed ~unit lanes by ~1/127),
    biases k/v 3e-2 and y 5e-2. The port's own bound, one bf16 ulp plus
    5e-3 of the largest output (``assert_kernel_close``), holds for y."""
    bits, qkn, bias, _, B = _ARCH[case]
    jcfg, jmp, tmp, _, _ = arch_packs[case]
    rng = np.random.default_rng(50 + B)
    T, d = 64, 128
    pos = [30, 3, 20, 63, 41, 7, 33, 12][:B]
    x, jk, jv, cos, sin = _step_inputs(rng, jcfg, B, T, pos)
    kw = dict(q_dim=jcfg.q_dim, kv_dim=jcfg.num_key_value_heads * d,
              head_dim=d, rotary_dim=d, eps=1e-5, scale=float(1 / np.sqrt(d)),
              bits=bits)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.block_until_ready(jlb.megastep_lowbit_decode(
            x, jmp, jk, jv, jnp.asarray(pos, jnp.int32), jnp.asarray(cos),
            jnp.asarray(sin), **kw))
    got = tlb.megastep_lowbit_decode(_t(x), tmp, _t(jk), _t(jv),
                                     torch.tensor(pos), torch.from_numpy(cos),
                                     torch.from_numpy(sin), **kw)
    kv_tol = (8e-2, 2e-2) if qkn else (3e-2, 3e-2)
    for name, g, r in zip(("y", "k", "v"), got, ref):
        assert tuple(g.shape) == r.shape and g.dtype == torch.bfloat16
        atol, rtol = (5e-2, 5e-2) if name == "y" else kv_tol
        np.testing.assert_allclose(g.float().numpy(), _np(r), atol=atol,
                                   rtol=rtol, err_msg=f"{case} {name}")
    assert_kernel_close(got[0].float().numpy(), _np(ref[0]), flips=5e-3,
                        what=f"{case} y B={B}")


def test_wrapper_picks_the_arch_instantiations(arch_packs):
    """Packs with qk_nm or biases launch the ARCH sources
    (``csrc/megastep_lowbit_arch*.cu``), with zero points, the fold and
    EoRA adapters too; the others keep theirs."""
    _, _, tmp, _, _ = arch_packs["qkn_bias_zp4"]
    assert tlb.kernel_library(tmp, False) == "megastep_lowbit_arch_opt"
    assert tlb.kernel_library({**tmp, "la_q": None}, True) == \
        "megastep_lowbit_arch_lora_lm_opt"
    bare = {k: v for k, v in tmp.items() if k not in tlb._ARCH_KEYS}
    assert tlb.kernel_library(bare, False) == "megastep_lowbit_opt"
    from ganq_tpu_torch.ops import cuda_lib
    for lib in ("megastep_lowbit_arch", "megastep_lowbit_arch_lora_lm_opt"):
        assert lib in cuda_lib.KERNEL_SOURCES


# ------------------------------------------------------------------- gates
_GATE_ARCHS = ("llama", "qwen3", "internlm", "qwen2")


@pytest.mark.parametrize("arch", _GATE_ARCHS)
@pytest.mark.parametrize("kind,bits", [("w8", 8), ("uniform", 4),
                                       ("uniform", 8)])
def test_gates_match_jax(monkeypatch, arch, kind, bits):
    """The gates of kernels 11 (``attn_half_fusable``), 12, 13 and 14, the
    variant ``mega_enabled`` picks at batches 1 to 64 and
    the pack of that variant equal ganq_tpu's on head_dim-128 models of
    each family: qwen3's qk-norm keeps a model off kernels 10-13 and on
    kernel 14; internlm's o bias off kernels 11-13; qwen2's q/k/v biases
    off none. Every such request is served: its variant's pack is built on
    the stacked model."""
    from ganq_tpu.ops import fused_layer as jfl
    from ganq_tpu.ops import megastep as jms
    from ganq_tpu.ops import megastep4 as jm4
    from ganq_tpu_torch.ops import fused_layer as tfl
    from ganq_tpu_torch.ops import megastep as tms
    from ganq_tpu_torch.ops import megastep4 as tm4

    jcfg, params, tcfg, tmodel = arch_pair(
        4 if kind == "w8" else bits, arch == "qwen3", False)
    if arch in ("internlm", "qwen2"):
        rng = np.random.default_rng(5)
        names = "qkvo" if arch == "internlm" else "qkv"
        for lp in params["layers"]:
            for n in names:
                lp["attn"][n]["bias"] = jnp.asarray(rng.normal(size=(
                    lp["attn"][n]["scales"].shape[0],)).astype(np.float32))
        tcfg = dataclasses.replace(tcfg, model_type=arch, attn_bias=True)
        jcfg = dataclasses.replace(jcfg, model_type=arch, attn_bias=True)
        _, tmodel = thf.params_from_numpy(thf.config_to_hf(tcfg),
                                          _flatten_jax(params), device="cpu")
    if kind == "w8":
        sp = jst.stack_layers(params, recode="w8")
        tsp = tst.stack_layers(tmodel, recode="w8")
    else:
        sp = jst.certify_stacked(jst.stack_layers(params, recode="affine"))
        tsp = tst.certify_stacked(tst.stack_layers(tmodel, recode="affine"))
    if kind == "w8":
        jlp = jst.fuse_layer(jst.recode_layer_w8(params["layers"][0]))
        assert tfl.attn_half_fusable(tcfg, tsp.layers[0]) == \
            jfl.attn_half_fusable(jcfg, jlp)
    assert tms.megastep_fusable(tcfg, tsp) == jms.megastep_fusable(jcfg, sp)
    assert tm4.megastep4_fusable(tcfg, tsp) == jm4.megastep4_fusable(jcfg, sp)
    for b in (4, 8):
        assert tlb.megastep_lowbit_fusable(tcfg, tsp, b) == \
            jlb.megastep_lowbit_fusable(jcfg, sp, b)
    monkeypatch.setenv("GANQ_MEGASTEP", "1")
    for batch in (1, 8, 9, 64):
        want = jst.mega_enabled(jcfg, sp, "pallas_a8", batch)
        assert tst.mega_enabled(tcfg, tsp, "cuda_a8", batch, "cpu") == want
        if want is not None:
            assert tst._mega_pack_for(tcfg, tsp, want) is getattr(
                tsp, tst._PACK_ATTR[want])
    if arch == "qwen3":
        assert not tms.megastep_fusable(tcfg, tsp)
        assert not tm4.megastep4_fusable(tcfg, tsp)
        assert not tfl.attn_half_fusable(tcfg, tsp.layers[0])
        if kind == "uniform":
            assert tst.mega_enabled(tcfg, tsp, "cuda_a8", 1, "cpu") == \
                {4: "w4p", 8: "w8p"}[bits]


def test_kernel10_refuses_qk_norm(monkeypatch):
    """Kernel 10 (the fused norm + qkv + rope, opted in by
    ``GANQ_FUSED_QKV``) never runs on a qk-norm layer, as
    ``ganq_tpu/models/transformer.py:1050`` gates it: the port's per-layer
    decode step on "cuda_a8" takes the plain projections and the norm, and
    on the same layer without qk-norm it takes the kernel."""
    from ganq_tpu_torch.models import transformer as tt

    _, _, tcfg, tmodel = arch_pair(4, True, False)
    tsp = tst.stack_layers(tmodel, recode="w8")
    calls = []

    def fake(*a, **k):
        calls.append(1)
        raise AssertionError("kernel 10 reached")

    monkeypatch.setattr(tt, "fused_qkv_rope_w8a8", fake)
    monkeypatch.setenv("GANQ_FUSED_QKV", "1")
    lp = tsp.layers[0]
    x = torch.randn(1, 1, tcfg.hidden_size)
    cache = {"k": torch.zeros(1, 8, 1, 128, dtype=torch.bfloat16),
             "v": torch.zeros(1, 8, 1, 128, dtype=torch.bfloat16)}
    rope = tt.rope_tables(tcfg, torch.tensor([[3]]))
    with torch.inference_mode():
        tt.layer_forward(tcfg, lp, x, None, rope, cache, torch.tensor(3),
                         backend="cuda_a8")
        assert not calls
        with pytest.raises(AssertionError, match="kernel 10"):
            tt.layer_forward(dataclasses.replace(tcfg, qk_norm=False), lp, x,
                             None, rope, cache, torch.tensor(3),
                             backend="cuda_a8")


# ------------------------------------------------- the slice as a whole
def test_qwen3_whole_step_greedy_matches_jax(monkeypatch):
    """A 2-layer head_dim-128 Qwen3 ``lut`` model (ganq_tpu's synthetic
    ``lut`` kind, ``test_torch_stacked.np_llama``; q/k norm weights from a
    seed) through ``optimize()`` in both
    packages (uniform 8-bit); with the megastep forced on
    (``GANQ_MEGASTEP=1``) both engines decode a batch of 2 through kernel
    14's "w8p" with ``qk_nm`` (ganq_tpu's kernel in interpret mode, the
    port's plain version). Greedy tokens are equal."""
    from ganq_tpu.api import GanqModel as JGanqModel
    from ganq_tpu.models import synthetic as jsyn
    from ganq_tpu_torch import GanqModel

    jcfg = dataclasses.replace(
        jsyn.llama_config(hidden=256, inter=512, layers=2, heads=2,
                          kv_heads=1, vocab=256, max_pos=128),
        model_type="qwen3", qk_norm=True)
    params = np_llama(jcfg, ("lut", "lut"), seed=1, dtype=jnp.float32)
    rng = np.random.default_rng(11)
    for lp in params["layers"]:
        for n in ("q_norm", "k_norm"):
            lp["attn"][n] = {"weight": jnp.asarray(rng.uniform(
                0.5, 1.5, size=(128,)).astype(np.float32))}
    tcfg = dataclasses.replace(_port_cfg(256, 2, 1, 512, 256),
                               model_type="qwen3", qk_norm=True)
    _, tmodel = thf.params_from_numpy(thf.config_to_hf(tcfg),
                                      _flatten_jax(params), device="cpu")
    monkeypatch.setenv("GANQ_MEGASTEP", "1")
    j = JGanqModel(jcfg, params, quantized=True).optimize()
    g = GanqModel(tcfg, tmodel, device="cpu").optimize()
    eng = g._get_engine("auto")
    assert eng.stacked and tst.mega_enabled(
        g.cfg, eng.model, eng.backend, 2, "cpu") == "w8p"
    sp = jst.prepack(j.cfg, jst.stack_layers(j.params, recode="affine"),
                     j.backend, 1)
    assert jst.mega_enabled(j.cfg, sp, j.backend, 2) == "w8p"
    assert "qk_nm" in jlb.megapack_lowbit(j.cfg, sp, 8)
    ids = np.random.default_rng(9).integers(0, 256, size=(2, 6))
    want = np.asarray(j.generate(ids, max_new_tokens=3, max_seq=32))
    got = g.generate(ids, max_new_tokens=3, max_seq=32)
    assert "qk_nm" in eng.model.megapack_lb
    np.testing.assert_array_equal(got, want)


def _quant_rows():
    """Four batches of 2 x 32 tokens: 256 calibration tokens, twice the
    widest input (the intermediate 128), so that every Hessian has full
    rank, as a real calibration set gives (on a rank-deficient Hessian a
    GANQ solve can settle on other codes from float32 rounding alone, at
    an equal loss)."""
    rng = np.random.default_rng(22)
    return [rng.integers(0, 256, size=(2, 32)).astype(np.int32)
            for _ in range(4)]


@pytest.fixture(scope="module")
def jax_quantized(tmp_path_factory):
    """Per family (qwen3, internlm): (dense directory, hf_config, ganq_tpu's
    quantize output, its saved directory) of a tiny model (hidden 64,
    head_dim 16) quantized by ganq_tpu (GANQ W4, ``lut``) on one batch of
    rows and saved by ganq_tpu."""
    from ganq_tpu.core.config import QuantizeConfig as JQuantizeConfig
    from ganq_tpu.formats import checkpoint as jckpt
    from ganq_tpu.quant.looper import quantize_model
    from ganq_tpu_torch.formats.safetensors_io import save_file

    from test_torch_serve import QCFG

    out = {}
    for model_type, extra in (("qwen3", {"head_dim": 16}),
                              ("internlm", {"bias": True})):
        hf = _hf_dict(model_type, tie_word_embeddings=False,
                      **({"num_key_value_heads": 4} if model_type ==
                         "internlm" else {}), **extra)
        state = _np_state(model_type, seed=21, kv=hf["num_key_value_heads"])
        dense = str(tmp_path_factory.mktemp(f"{model_type}_dense"))
        save_file({k: torch.from_numpy(v) for k, v in state.items()},
                  os.path.join(dense, "model.safetensors"))
        with open(os.path.join(dense, "config.json"), "w") as f:
            json.dump(hf, f)
        jcfg, params = jhf.params_from_state_dict(state, hf)
        qcfg = JQuantizeConfig(**QCFG)
        jout = quantize_model(jcfg, params, jget_spec(model_type), qcfg,
                              _quant_rows())
        d = str(tmp_path_factory.mktemp(f"{model_type}_jax_ckpt"))
        jckpt.save_quantized(d, hf, qcfg, jout.params, jout.artifacts,
                             jout.log)
        out[model_type] = (dense, hf, jout, d)
    return out


@pytest.mark.parametrize("model_type", ["qwen3", "internlm"])
def test_quantize_matches_jax(jax_quantized, model_type, tmp_path):
    """The port's ``GanqModel.load(dense, qcfg)`` -> ``quantize`` on the
    same rows: per module codes agree at >= 0.99 and codebooks within 1e-3
    of the row's largest codeword (``test_torch_quantize.py``'s bounds; the
    taps pass through the qk norms and the biases); the saved checkpoint
    carries the q/k norms and every bias unquantized."""
    from ganq_tpu_torch import GanqModel
    from ganq_tpu_torch.core.config import QuantizeConfig

    from test_torch_serve import QCFG

    dense, _, jout, _ = jax_quantized[model_type]
    g = GanqModel.load(dense, QuantizeConfig(**QCFG), device="cpu")
    g.quantize([r for b in _quant_rows() for r in b], batch_size=2)
    arts = g._quant_output.artifacts
    assert sorted(arts) == sorted(jout.artifacts)
    for name, ja in jout.artifacts.items():
        agree = np.mean(arts[name].idx.numpy() == np.asarray(ja.idx))
        assert agree >= 0.99, (name, agree)
        ref = np.asarray(ja.lut)
        scale = np.abs(ref).max(axis=1, keepdims=True)
        assert (np.abs(arts[name].lut.numpy() - ref) <= 1e-3 * scale).all()
    g.save(str(tmp_path))
    q = GanqModel.load(str(tmp_path), device="cpu")
    lp = q.model.layers[1]
    assert lp.attn["q"].kind == "lut"
    if model_type == "qwen3":
        assert torch.equal(lp.q_norm, g.model.layers[1].q_norm)
    else:
        for n in "qkvo":
            assert torch.equal(lp.attn[n]["bias"],
                               g.model.layers[1].attn[n]["bias"])


def test_qwen3_checkpoints_cross_packages(jax_quantized, tmp_path):
    """A ganq_tpu-written Qwen3 ``lut`` checkpoint loads in the port (q/k
    norms included) with greedy tokens equal to ganq_tpu's Engine; the
    port's checkpoint of it loads in ganq_tpu with equal norms, codebooks
    and codes, and greedy tokens."""
    from ganq_tpu.formats import checkpoint as jckpt
    from ganq_tpu.serve.engine import Engine as JEngine
    from ganq_tpu_torch import GanqModel
    from ganq_tpu_torch.core.config import QuantizeConfig
    from ganq_tpu_torch.formats import checkpoint as tckpt

    from test_torch_serve import QCFG

    _, hf, _, d = jax_quantized["qwen3"]
    jcfg, jparams, _ = jckpt.load_quantized(d)
    ids = np.random.default_rng(3).integers(0, 256, size=(2, 10))
    want = np.asarray(JEngine(jcfg, jparams, backend="reference",
                              max_seq=64).generate(ids, max_new_tokens=8))
    g = GanqModel.load(d, device="cpu")
    assert g.cfg.qk_norm and g.model.layers[1].k_norm is not None
    assert g.model.layers[0].attn["q"].kind == "lut"
    np.testing.assert_array_equal(
        g.generate(ids, max_new_tokens=8, max_seq=64), want)
    out = str(tmp_path / "port_ckpt")
    tckpt.save_quantized(out, hf, QuantizeConfig(**QCFG), g.model)
    jcfg2, jparams2, _ = jckpt.load_quantized(out)
    for li in range(2):
        for n in ("q_norm", "k_norm"):
            np.testing.assert_array_equal(
                np.asarray(jparams2["layers"][li]["attn"][n]["weight"]),
                np.asarray(jparams["layers"][li]["attn"][n]["weight"]))
        for n in ("q", "o"):
            for k in ("lut", "idx_packed"):
                np.testing.assert_array_equal(
                    _np(jparams2["layers"][li]["attn"][n][k]),
                    _np(jparams["layers"][li]["attn"][n][k]))
    got = np.asarray(JEngine(jcfg2, jparams2, backend="reference",
                             max_seq=64).generate(ids, max_new_tokens=8))
    np.testing.assert_array_equal(got, want)
