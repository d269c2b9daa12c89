"""Gemma, Gemma 2 and Gemma 3 in the PyTorch port against ``ganq_tpu``.

The registry entries (``gemma``, ``gemma2``, ``gemma3_text``, ``gemma3``),
the model's gemma parts (norm weights stored as ``w - 1``, the scaled
embedding, gelu-tanh, sandwich norms, the attention and final logit
softcaps, per-layer sliding windows in prefill and decode, Gemma 3's dual
rope and ``(1 + w)`` q/k norms), kernel 14's gemma operands (``pa_norm``,
``pm_norm``, ``windows``, ``softcap``, ``rope_sel``: packs byte for byte,
the plain version against ganq_tpu's Pallas kernel in interpret mode), the
whole-step batching engine, the gates of kernels 2 and 9-14, one GANQ
quantize and Gemma checkpoints across the two packages. Tiny configs with
head_dim 128 (the whole-step kernels' only width) and a window of 8, so
that decode positions past it show the window; inputs from numpy seeds."""

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

from test_torch_megastep import _t
from test_torch_megastep_lowbit import _step_inputs, np_uniform_llama
from test_torch_serve import _flatten_jax
from test_torch_stacked import _np, np_llama
from test_torch_packing import torch_threads_per_worker  # noqa: F401

WINDOW = 8
_TYPES = ("gemma", "gemma2", "gemma3_text", "gemma3")


def _hf(model_type, hidden=256, heads=2, kv=1, head_dim=128, inter=512,
        vocab=256, layers=2, **extra):
    """A tiny HF config dict of the family: a sliding and a full layer."""
    d = {"model_type": model_type, "vocab_size": vocab,
         "hidden_size": hidden, "intermediate_size": inter,
         "num_hidden_layers": layers, "num_attention_heads": heads,
         "num_key_value_heads": kv, "head_dim": head_dim,
         "max_position_embeddings": 64, "rms_norm_eps": 1e-6,
         "query_pre_attn_scalar": 144, "sliding_window": WINDOW,
         "layer_types": ["sliding_attention", "full_attention"][:layers]}
    if model_type.startswith("gemma3"):
        d.update(rope_theta=1e6, rope_local_base_freq=1e4,
                 rope_scaling={"rope_type": "linear", "factor": 8.0})
    if model_type == "gemma2":
        d.update(attn_logit_softcapping=2.0, final_logit_softcapping=3.0)
    d.update(extra)
    return d


def _state(model_type, seed, hidden=256, heads=2, kv=1, head_dim=128,
           inter=512, vocab=256, layers=2):
    """A random HF state dict of a tiny model of the family: gemma2/3's four
    layer norms, gemma3's q/k norms, norm weights stored as ``w - 1``."""
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.08):
        return (rng.normal(size=shape) * s).astype(np.float32)

    st = {"model.embed_tokens.weight": w(vocab, hidden, s=0.5),
          "model.norm.weight": w(hidden, s=0.1)}
    norms = ["input_layernorm", "post_attention_layernorm"]
    if model_type != "gemma":
        norms += ["pre_feedforward_layernorm", "post_feedforward_layernorm"]
    for i in range(layers):
        p = f"model.layers.{i}."
        for n in norms:
            st[p + n + ".weight"] = w(hidden, s=0.1)
        for n, o in (("q", heads), ("k", kv), ("v", kv)):
            st[p + f"self_attn.{n}_proj.weight"] = w(o * head_dim, hidden)
        st[p + "self_attn.o_proj.weight"] = w(hidden, heads * head_dim)
        if model_type.startswith("gemma3"):
            st[p + "self_attn.q_norm.weight"] = w(head_dim, s=0.2)
            st[p + "self_attn.k_norm.weight"] = w(head_dim, s=0.2)
        st[p + "mlp.gate_proj.weight"] = w(inter, hidden)
        st[p + "mlp.up_proj.weight"] = w(inter, hidden)
        st[p + "mlp.down_proj.weight"] = w(hidden, inter)
    return st


@pytest.mark.parametrize("model_type", _TYPES)
def test_configs_match_jax(model_type):
    """Each gemma type's ``make_config`` equals ganq_tpu's on every field of
    the port's ModelConfig and on ``layer_window`` of every layer, with the
    HF defaults too (gemma2's alternation, gemma3's pattern of 6); the
    config.json the port writes reads back to the same config."""
    for extra in ({}, {"layer_types": None, "num_hidden_layers": 7},
                  {"sliding_window_pattern": 3, "layer_types": None,
                   "num_hidden_layers": 6, "query_pre_attn_scalar": 128}):
        hf = _hf(model_type, **extra)
        got = treg.get_spec(model_type).make_config(hf)
        want = jget_spec(model_type).make_config(hf)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
        for i in range(got.num_hidden_layers):
            assert got.layer_window(i) == want.layer_window(i)
        assert thf.config_from_hf(thf.config_to_hf(got)) == got


@pytest.mark.parametrize("model_type", ["gemma2", "gemma3_text"])
def test_forward_and_decode_past_the_window_match_jax(model_type):
    """A 2-layer tiny model (a sliding and a full layer, window 8) from one
    HF state dict: the port's forward over 14 tokens gives ganq_tpu's logits
    (prefill with the window masked); the engine's prefill of 10 tokens
    then 4 decode steps (positions 10-13, past the window: the masked
    attention with the window overlay and the softcap) and the per-layer
    batching step at a vector of positions give ganq_tpu's logits at those
    positions, within 1e-4 of their scale (``test_torch_serve.py``'s
    tolerance). Without the window, the sandwich norms or the softcaps the
    logits move far more."""
    from ganq_tpu_torch.serve import batching as tbat
    from ganq_tpu_torch.serve import engine as teng

    hf = _hf(model_type)
    state = _state(model_type, seed=13)
    jcfg, jparams = jhf.params_from_state_dict(state, hf)
    tcfg, tmodel = thf.params_from_state_dict(
        {k: torch.from_numpy(v) for k, v in state.items()}, hf, device="cpu")
    ids = np.random.default_rng(14).integers(0, 256, size=(2, 14))
    ref = np.asarray(jtr.forward(jcfg, jparams, jnp.asarray(ids)))
    scale = np.abs(ref).max()
    tids = torch.as_tensor(ids)
    with torch.inference_mode():
        got = ttr.forward(tcfg, tmodel, tids).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
        cache = teng.init_cache(tcfg, 2, 16, "cpu", torch.float32)
        steps = [teng.prefill(tcfg, tmodel, cache, tids[:, :10])]
        for p in range(10, 13):
            steps.append(teng.decode_step(tcfg, tmodel, cache, tids[:, p],
                                          torch.tensor(p)))
        np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                                   ref[:, 9:13], rtol=1e-4,
                                   atol=1e-4 * scale)
        # slot 0 at position 13, slot 1 at 12 (its history is the prompt's)
        pos = torch.tensor([13, 12])
        vec = tbat._decode_slots_impl(tcfg, tmodel, cache,
                                      tids[[0, 1], [13, 12]], pos,
                                      "reference")
        np.testing.assert_allclose(vec.numpy(), ref[[0, 1], [13, 12]],
                                   rtol=1e-4, atol=1e-4 * scale)
        for off in ({"sliding_window": None}, {"sandwich_norm": False},
                    {"attn_softcap": None, "logit_softcap": None,
                     "rope_local_theta": None}):
            other = ttr.forward(dataclasses.replace(tcfg, **off), tmodel,
                                tids).numpy()
            assert np.abs(other - ref).max() > 1e-2 * scale, off


# --------------------------------------------- kernel 14's gemma operands
def gemma_pair(model_type, bits, seed=3):
    """(jax cfg, jax params, port cfg, port model): a 2-layer uniform
    ``bits``-bit model of the family at kernel 14's smallest widths
    (hidden 256, 2 heads, 1 kv head, I = 512; :func:`np_uniform_llama`),
    sandwich norms in [-0.3, 0.3) (and gemma3's q/k norms) from a seed, as
    ganq_tpu's gemma tests set them, the same weights in both packages."""
    jcfg, params = np_uniform_llama(256, 2, 1, 512, bits, vocab=256,
                                    seed=seed)
    hf = _hf(model_type)
    jcfg = jget_spec(model_type).make_config(hf)
    tcfg = treg.get_spec(model_type).make_config(hf)
    rng = np.random.default_rng(seed + 100)
    for lp in params["layers"]:
        for n in ("post_attn_norm", "post_mlp_norm"):
            lp[n] = {"weight": jnp.asarray(rng.uniform(
                -0.3, 0.3, size=(256,)).astype(np.float32))}
        if jcfg.qk_norm:
            for n in ("q_norm", "k_norm"):
                lp["attn"][n] = {"weight": jnp.asarray(rng.uniform(
                    -0.3, 0.3, size=(128,)).astype(np.float32))}
    _, tmodel = thf.params_from_numpy(thf.config_to_hf(tcfg),
                                      _flatten_jax(params), device="cpu")
    return jcfg, params, tcfg, tmodel


# (family, bits): ganq_tpu's gemma2-shape case (w4p; tests/
# test_megastep_lowbit.py:335) and its gemma3-shape case
# (:378) at 8 bits ("w8p")
_GEMMA = (("gemma2", 4), ("gemma3_text", 8))


@pytest.fixture(scope="module")
def gemma_packs():
    """Per case of ``_GEMMA``: (jax cfg, jax pack, port cfg, port pack, jax
    params, port model, jax stacked params, port stacked model)."""
    out = {}
    for model_type, bits in _GEMMA:
        jcfg, params, tcfg, tmodel = gemma_pair(model_type, bits)
        sp = jst.stack_layers(params, recode="affine")
        tsp = tst.stack_layers(tmodel, recode="affine")
        out[model_type, bits] = (jcfg, jlb.megapack_lowbit(jcfg, sp, bits),
                                 tcfg, tlb.megapack_lowbit(tcfg, tsp, bits),
                                 params, tmodel, sp, tsp)
    return out


@pytest.mark.parametrize("case", _GEMMA)
def test_gemma_packs_match_jax_bytes(gemma_packs, case):
    """``pa_norm`` and ``pm_norm`` (and gemma3's ``qk_nm``) equal
    ganq_tpu's byte for byte, beside every other operand of the pack."""
    _, jmp, _, tmp = gemma_packs[case][:4]
    assert "pa_norm" in tmp and ("qk_nm" in tmp) == (case[0] != "gemma2")
    assert sorted(tmp) == sorted(jmp)
    for k, v in jmp.items():
        assert tuple(tmp[k].shape) == v.shape, k
        assert tmp[k].dtype == _t(v[:1]).dtype, k
        np.testing.assert_array_equal(tmp[k].float().numpy(), _np(v),
                                      err_msg=k)


def _assert_close_rel(got, want, frac=0.035, mean_frac=7e-3):
    """ganq_tpu's range-relative bound of its gemma-shape tests
    (``tests/test_megastep_lowbit.py:365-377``): rms_offset 1 norms and
    gelu-tanh amplify a single int8 code flip, so the maximum error is held
    to ``frac`` and the mean to ``mean_frac`` of the reference's range."""
    err = np.abs(got - want)
    scale = np.abs(want).max() + 1e-9
    assert err.max() <= frac * scale, (err.max(), scale)
    assert err.mean() <= mean_frac * scale, (err.mean(), scale)


@pytest.mark.parametrize("case", _GEMMA)
def test_gemma_plain_matches_jax_interpret(gemma_packs, case):
    """The plain version of kernel 14 with gemma's operands against
    ganq_tpu's kernel in interpret mode at ganq_tpu's gemma-shape inputs (B
    8, T 64), each slot at its own history length, most past the window:
    sandwich norms and windows on both families, gemma2's softcap, gemma3's
    dual rope (``rope_sel``) and qk-norm; gelu-tanh and rms_offset 1. Held
    to ganq_tpu's range-relative bound."""
    jcfg, jmp, tcfg, tmp = gemma_packs[case][:4]
    bits = case[1]
    B, T, d, L = 8, 64, 128, 2
    pos = [40, 30, 63, 9, 25, 50, 12, 33]
    rng = np.random.default_rng(60 + bits)
    x, jk, jv, cos, sin = _step_inputs(rng, jcfg, B, T, pos)
    windows = [jcfg.layer_window(i) or T for i in range(L)]
    kw = dict(q_dim=jcfg.q_dim, kv_dim=jcfg.kv_dim, head_dim=d, rotary_dim=d,
              eps=1e-6, rms_offset=1.0, act="gelu_tanh",
              scale=float(jcfg.attn_scale), bits=bits)
    ch, sh = np.tile(cos, (B, 1)), np.tile(sin, (B, 1))
    extra = {"windows": windows}
    if jcfg.attn_softcap:
        extra["softcap"] = float(jcfg.attn_softcap)
    if jcfg.rope_local_theta:
        ang = rng.uniform(0, 2 * np.pi, size=(d // 2,)).astype(np.float32)
        ch = np.stack([ch, np.tile(np.cos(ang), (B, 1))])
        sh = np.stack([sh, np.tile(np.sin(ang), (B, 1))])
        extra["rope_sel"] = [1, 0]
    with pltpu.force_tpu_interpret_mode():
        ref = jax.block_until_ready(jlb.megastep_lowbit_decode(
            x, jmp, jk, jv, jnp.asarray(pos, jnp.int32), jnp.asarray(ch),
            jnp.asarray(sh), **kw,
            **{k: (jnp.asarray(v, jnp.int32) if k != "softcap" else v)
               for k, v in extra.items()}))
    got = tlb.megastep_lowbit_decode(
        _t(x), tmp, _t(jk), _t(jv), torch.tensor(pos), torch.from_numpy(ch),
        torch.from_numpy(sh), **kw,
        **{k: (torch.tensor(v) if k != "softcap" else v)
           for k, v in extra.items()})
    for name, g, r in zip(("y", "k", "v"), got, ref):
        assert tuple(g.shape) == r.shape and g.dtype == torch.bfloat16
        _assert_close_rel(g.float().numpy(), _np(r))
    # every operand matters at these inputs: without it the step moves
    # further from the reference than the plain version's own error
    base = np.abs(got[0].float().numpy() - _np(ref[0])).max()
    for drop in ("windows", "softcap", "rope_sel", "pa_norm"):
        if drop not in extra and drop not in tmp:
            continue
        ops = {k: v for k, v in tmp.items() if k not in ("pa_norm", "pm_norm")
               or drop != "pa_norm"}
        kw2 = {k: (torch.tensor(v) if k != "softcap" else v)
               for k, v in extra.items() if k != drop}
        if drop == "rope_sel":
            kw2.pop("rope_sel", None)
            cs, ss = torch.from_numpy(ch[0]), torch.from_numpy(sh[0])
        else:
            cs, ss = torch.from_numpy(ch), torch.from_numpy(sh)
        other = tlb.megastep_lowbit_decode(_t(x), ops, _t(jk), _t(jv),
                                           torch.tensor(pos), cs, ss, **kw,
                                           **kw2)[0].float().numpy()
        assert np.abs(other - _np(ref[0])).max() > 2 * base, drop


def test_wrapper_picks_the_gemma_instantiation(gemma_packs):
    """A call with any of gemma's operands launches the GEMMA source
    (``csrc/megastep_lowbit_gemma.cu``, which takes zero points, the fold
    and EoRA adapters too); the others keep theirs; at 3 and 2 bits and
    through the Walsh planes, which earlier slices refused, gemma's
    operands ride the runtime-flag sources (``megastep_lowbit_w3w2_ext``,
    ``megastep_lowbit_walsh``), and a 2-bit Gemma 2 step is served (its
    plain version: ``test_torch_lowbit_w3_walsh.py`` holds it to
    ganq_tpu's oracle)."""
    tmp = gemma_packs["gemma2", 4][3]
    assert tlb.gemma_call(tmp) and tlb.kernel_library(tmp, True, True) == \
        "megastep_lowbit_gemma"
    bare = {k: v for k, v in tmp.items() if k not in tlb._SAND_KEYS}
    assert not tlb.gemma_call(bare)
    assert tlb.gemma_call(bare, windows=[8, 64])
    assert tlb.gemma_call(bare, softcap=50.0)
    assert tlb.gemma_call(bare, rope_sel=[1, 0])
    assert tlb.kernel_library(bare, False) == "megastep_lowbit"
    from ganq_tpu_torch.ops import cuda_lib
    for lib in ("megastep_lowbit_gemma", "megastep_lowbit_w3w2_ext",
                "megastep_lowbit_walsh"):
        assert lib in cuda_lib.KERNEL_SOURCES
    for bits, walsh, lib in ((3, 0, "megastep_lowbit_w3w2_ext"),
                             (2, 0, "megastep_lowbit_w3w2_ext"),
                             (3, 7, "megastep_lowbit_walsh")):
        assert tlb.kernel_library(tmp, False, True, bits, walsh) == lib
        assert tlb.kernel_library(bare, False, False, bits, walsh) == (
            lib if walsh else "megastep_lowbit_w3w2")


# ------------------------------------------------------------------- gates
def test_gates_match_jax(monkeypatch, gemma_packs):
    """The gates of kernels 11-14 and the variant ``mega_enabled`` picks
    equal ganq_tpu's on Gemma 2 and Gemma 3 models: sandwich norms, the
    softcap, windows and dual rope keep them off kernels 11-13 and on
    kernel 14 ("w4p" / "w8p"); without the sandwich weights kernel 14
    refuses too. At a "cuda_a8" decode step (the port's call sites, counted)
    kernel 2, flash decode, is not launched for a softcap, windowed or
    head_dim-256 step and is for a plain one (``ganq_tpu``'s
    ``_plain_decode``), and kernel 9, the fused MLP, not for a
    sandwich-norm layer (it has no output norm)."""
    from ganq_tpu.ops import fused_layer as jfl
    from ganq_tpu.ops import megastep as jms
    from ganq_tpu.ops import megastep4 as jm4
    from ganq_tpu_torch.models import synthetic as tsyn
    from ganq_tpu_torch.ops import fused_layer as tfl
    from ganq_tpu_torch.ops import megastep as tms
    from ganq_tpu_torch.ops import megastep4 as tm4

    monkeypatch.setenv("GANQ_MEGASTEP", "1")
    for (model_type, bits), case in gemma_packs.items():
        jcfg, _, tcfg, _, params, tmodel, sp, tsp = case
        for b in (1, 8, 64):
            assert tst.mega_enabled(tcfg, tsp, "cuda_a8", b, "cpu") == \
                jst.mega_enabled(jcfg, sp, "pallas_a8", b) == \
                ("w4p" if bits == 4 else "w8p")
        assert tlb.megastep_lowbit_fusable(tcfg, tsp, bits) == \
            jlb.megastep_lowbit_fusable(jcfg, sp, bits) is True
        assert tm4.megastep4_fusable(tcfg, tsp) == \
            jm4.megastep4_fusable(jcfg, sp) is False
        bare = tst.stack_layers(tmodel, recode="affine")
        for lp in bare.layers:
            lp.post_attn_norm = lp.post_mlp_norm = None
        assert not tlb.megastep_lowbit_fusable(tcfg, bare, bits)
        if model_type != "gemma3_text":
            continue
        # the int8 kernels, on a w8 model of the same config
        w8params = np_llama(jcfg, ("w8", "w8"), 8, seed=4, dtype=jnp.float32)
        jw8 = jst.stack_layers(w8params)
        _, tw8 = thf.params_from_numpy(thf.config_to_hf(tcfg),
                                       _flatten_jax(w8params), device="cpu")
        w8 = tst.stack_layers(tw8)
        jlp0 = jax.tree_util.tree_map(lambda a: a[0], jw8["layers_stacked"])
        assert tms.megastep_fusable(tcfg, w8) == \
            jms.megastep_fusable(jcfg, jw8) is False
        assert tfl.attn_half_fusable(tcfg, w8.layers[0]) == \
            jfl.attn_half_fusable(jcfg, jlp0) is False
        for b in (1, 8):
            assert tst.mega_enabled(tcfg, tst.w8p_stacked(w8), "cuda_a8", b,
                                    "cpu") == jst.mega_enabled(
                jcfg, jst.w8p_stacked(jw8), "pallas_a8", b)

    calls = {"flash": 0, "mlp": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(ttr, "flash_decode_attention",
                        counted("flash", ttr.flash_decode_attention))
    monkeypatch.setattr(ttr, "fused_mlp_w8a8",
                        counted("mlp", ttr.fused_mlp_w8a8))
    llama = treg.get_spec("llama").make_config(_hf("llama"))
    gemma2 = treg.get_spec("gemma2").make_config(_hf("gemma2"))
    plain2 = dataclasses.replace(gemma2, attn_softcap=None)
    wide = dataclasses.replace(plain2, head_dim=256)
    for cfg, window, flash in ((llama, None, 1), (plain2, WINDOW, 0),
                               (gemma2, None, 0), (wide, None, 0),
                               (plain2, None, 1)):
        model = tsyn.make_model(cfg, kind="w8", seed=5, device="cpu",
                                dtype=torch.float32)
        lp = tst.stack_layers(model).layers[0]
        d = cfg.head_dim
        cache = {n: torch.zeros((1, 16, 1, d)) for n in ("k", "v")}
        rope = ttr.rope_tables(cfg, torch.tensor([[12]]))
        mask = (torch.arange(16) <= 12)[None, None, None, :]
        calls.update(flash=0, mlp=0)
        ttr.layer_forward(cfg, lp, torch.randn(1, 1, 256), mask, rope, cache,
                          torch.tensor(12), backend="cuda_a8", window=window)
        assert calls == {"flash": flash,
                         "mlp": int(not cfg.sandwich_norm)}, (cfg, window)


# ------------------------------------------ whole step and the batching
def _gemma3_model(kind, bits, seed=1):
    """(jax cfg, jax params, port cfg, port model): a 2-layer Gemma 3 of
    ganq_tpu's synthetic ``kind`` linears (``test_torch_stacked.np_llama``),
    unit norms (stored as 0), q/k and sandwich norms in [-0.3, 0.3) from a
    seed."""
    hf = _hf("gemma3_text")
    jcfg = jget_spec("gemma3_text").make_config(hf)
    tcfg = treg.get_spec("gemma3_text").make_config(hf)
    params = np_llama(jcfg, (kind, kind), bits, seed=seed, dtype=jnp.float32)
    rng = np.random.default_rng(seed + 10)
    for lp in params["layers"]:
        for n in ("input_norm", "post_norm"):
            lp[n] = {"weight": jnp.zeros((256,), jnp.float32)}
        for n in ("post_attn_norm", "post_mlp_norm"):
            lp[n] = {"weight": jnp.asarray(rng.uniform(
                -0.3, 0.3, size=(256,)).astype(np.float32))}
        for n in ("q_norm", "k_norm"):
            lp["attn"][n] = {"weight": jnp.asarray(rng.uniform(
                -0.3, 0.3, size=(128,)).astype(np.float32))}
    params["final_norm"] = {"weight": jnp.zeros((256,), jnp.float32)}
    _, tmodel = thf.params_from_numpy(thf.config_to_hf(tcfg),
                                      _flatten_jax(params), device="cpu")
    return jcfg, params, tcfg, tmodel


def test_gemma3_whole_step_greedy_matches_jax(monkeypatch):
    """A 2-layer uniform 8-bit Gemma-3 model (the artifacts ``optimize()``
    gives) in both packages; with the megastep forced on
    (``GANQ_MEGASTEP=1``) both engines decode a batch of 2 from an
    11-token prompt (past the window) through kernel 14's "w8p" with
    ``qk_nm``, sandwich norms, windows and dual rope (ganq_tpu's kernel in
    interpret mode, the port's plain version). Greedy tokens are equal."""
    from ganq_tpu.api import GanqModel as JGanqModel
    from ganq_tpu_torch import GanqModel

    monkeypatch.setenv("GANQ_MEGASTEP", "1")
    jcfg, params, tcfg, tmodel = _gemma3_model("uniform", 8)
    j = JGanqModel(jcfg, params, quantized=True)
    g = GanqModel(tcfg, tmodel, device="cpu")
    eng = g._get_engine("auto")
    assert eng.stacked and tst.mega_enabled(
        g.cfg, eng.model, eng.backend, 2, "cpu") == "w8p"
    ids = np.random.default_rng(9).integers(0, 256, size=(2, 11))
    want = np.asarray(j.generate(ids, max_new_tokens=3, max_seq=32))
    got = g.generate(ids, max_new_tokens=3, max_seq=32)
    assert "pa_norm" in eng.model.megapack_lb
    assert "qk_nm" in eng.model.megapack_lb
    np.testing.assert_array_equal(got, want)


def test_gemma3_batching_whole_step_greedy_matches_jax(monkeypatch):
    """The batching engine in whole-step mode (``GANQ_MEGASTEP=1``) on a
    2-layer symmetric W4 Gemma 3 in both packages: kernel 14's "w4p" with
    ``qk_nm``, sandwich norms, windows and dual rope at per-slot positions
    (ganq_tpu's kernel in interpret mode, the port's plain version; its
    batching engine has no "w8p" pack). 2 requests on 2 slots, prompts of
    11 and 5 tokens (the first past the window). Greedy tokens are
    equal."""
    from ganq_tpu.serve.batching import BatchingEngine as JBatching
    from ganq_tpu_torch.serve.batching import BatchingEngine

    monkeypatch.setenv("GANQ_MEGASTEP", "1")
    jcfg, params, tcfg, tmodel = _gemma3_model("uniform", 4, seed=2)
    prompts = [np.random.default_rng(s).integers(0, 256, size=n)
               for s, n in ((1, 11), (2, 5))]

    def drive(eng):
        ids = [eng.submit(p, max_new_tokens=3) for p in prompts]
        out = eng.run_all()
        return [list(out[i]) for i in ids]

    teng = BatchingEngine(tcfg, tmodel, slots=2, max_seq=32,
                          prompt_buckets=(16, 32), device="cpu")
    assert teng._mega_variant == "w4p"
    assert "pa_norm" in teng._mp and "qk_nm" in teng._mp
    got = drive(teng)
    want = drive(JBatching(jcfg, params, slots=2, max_seq=32,
                           prompt_buckets=(16, 32)))
    assert got == want


# ------------------------------------------------ quantize and checkpoints
def _quant_rows():
    """Two batches of 2 x 32 tokens: twice the widest input (the
    intermediate 64), so that every Hessian has full rank
    (``test_torch_arch.py::_quant_rows``)."""
    rng = np.random.default_rng(22)
    return [rng.integers(0, 256, size=(2, 32)).astype(np.int32)
            for _ in range(2)]


@pytest.fixture(scope="module")
def jax_gemma3(tmp_path_factory):
    """(dense directory, hf_config, ganq_tpu's quantize output, its saved
    directory) of a tiny Gemma 3 (hidden 64, head_dim 16, window 8)
    quantized by ganq_tpu (GANQ W4, ``lut``) and saved by ganq_tpu."""
    from ganq_tpu.core.config import QuantizeConfig as JQuantizeConfig
    from ganq_tpu.formats import checkpoint as jckpt
    from ganq_tpu.quant.looper import quantize_model
    from ganq_tpu_torch.formats.safetensors_io import save_file

    from test_torch_serve import QCFG

    dims = dict(hidden=64, heads=4, kv=2, head_dim=16, inter=64)
    hf = _hf("gemma3_text", **dims)
    state = _state("gemma3_text", seed=21, **dims)
    dense = str(tmp_path_factory.mktemp("gemma3_dense"))
    save_file({k: torch.from_numpy(v) for k, v in state.items()},
              os.path.join(dense, "model.safetensors"))
    with open(os.path.join(dense, "config.json"), "w") as f:
        json.dump(hf, f)
    jcfg, params = jhf.params_from_state_dict(state, hf)
    qcfg = JQuantizeConfig(**QCFG)
    jout = quantize_model(jcfg, params, jget_spec("gemma3_text"), qcfg,
                          _quant_rows())
    d = str(tmp_path_factory.mktemp("gemma3_jax_ckpt"))
    jckpt.save_quantized(d, hf, qcfg, jout.params, jout.artifacts, jout.log)
    return dense, hf, jout, d


def test_gemma3_quantize_matches_jax(jax_gemma3, tmp_path):
    """The port's ``GanqModel.load(dense, qcfg)`` -> ``quantize`` of the
    tiny Gemma 3 on the same rows (the taps through the scaled embedding,
    the (1 + w) norms, the sandwich norms, the windows and the dual rope):
    codes equal and codebooks within 1e-3 of the row's largest codeword
    (``test_torch_arch.py``'s codebook bound); the saved
    checkpoint carries the q/k and sandwich norms unquantized."""
    from ganq_tpu_torch import GanqModel
    from ganq_tpu_torch.core.config import QuantizeConfig

    from test_torch_serve import QCFG

    dense, _, jout, _ = jax_gemma3
    g = GanqModel.load(dense, QuantizeConfig(**QCFG), device="cpu")
    g.quantize([r for b in _quant_rows() for r in b], batch_size=2)
    arts = g._quant_output.artifacts
    assert sorted(arts) == sorted(jout.artifacts)
    for name, ja in jout.artifacts.items():
        np.testing.assert_array_equal(arts[name].idx.numpy(),
                                      np.asarray(ja.idx), err_msg=name)
        ref = np.asarray(ja.lut)
        scale = np.abs(ref).max(axis=1, keepdims=True)
        assert (np.abs(arts[name].lut.numpy() - ref) <= 1e-3 * scale).all()
    g.save(str(tmp_path))
    q = GanqModel.load(str(tmp_path), device="cpu")
    for n in ("post_attn_norm", "post_mlp_norm"):
        assert torch.equal(getattr(q.model.layers[1], n).weight,
                           getattr(g.model.layers[1], n).weight)
    assert torch.equal(q.model.layers[1].q_norm, g.model.layers[1].q_norm)


def test_gemma3_checkpoints_cross_packages(jax_gemma3, tmp_path):
    """A ganq_tpu-written Gemma 3 ``lut`` checkpoint loads in the port with
    every tensor (sandwich and q/k norms, codebooks, codes) equal to what
    ganq_tpu loads; the port's checkpoint of it loads in ganq_tpu with
    equal tensors."""
    from ganq_tpu.formats import checkpoint as jckpt
    from ganq_tpu_torch import GanqModel
    from ganq_tpu_torch.core.config import QuantizeConfig
    from ganq_tpu_torch.formats import checkpoint as tckpt

    from test_torch_serve import QCFG

    _, hf, _, d = jax_gemma3
    jcfg, jparams, _ = jckpt.load_quantized(d)
    tcfg, tmodel, _ = tckpt.load_quantized(d, device="cpu")
    assert tcfg.sandwich_norm and tcfg.rope_local_theta == 1e4
    flat = _flatten_jax(jparams)
    assert "layers.1.post_mlp_norm.weight" in flat
    assert "layers.1.attn.q_norm.weight" in flat
    got = dict(tmodel.named_buffers())
    for k, v in flat.items():
        if isinstance(v, np.ndarray) and v.dtype.kind in "fiu":
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          v.astype(np.float32), err_msg=k)
    out = str(tmp_path / "port")
    tckpt.save_quantized(out, hf, QuantizeConfig(**QCFG), tmodel)
    _, jparams2, _ = jckpt.load_quantized(out)
    flat2 = _flatten_jax(jparams2)
    assert sorted(flat) == sorted(flat2)
    for k, v in flat.items():
        np.testing.assert_array_equal(flat2[k], v, err_msg=k)
