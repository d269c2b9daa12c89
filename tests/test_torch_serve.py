"""The PyTorch port's serving slice against the JAX package, end to end.

A tiny llama (2 layers, hidden 64) is quantized by ``ganq_tpu`` (GANQ W4,
``lut`` format) and saved by ``ganq_tpu``; the port loads the directory on
the CPU and must compute what ``ganq_tpu`` computes from the same checkpoint.
Both run float32 activations with bf16 codebooks and a bf16 KV cache.
"""

import json
import os

import numpy as np
import pytest
import torch

# transformers only builds the tiny test model here: keep it from importing
# TensorFlow, which costs seconds per process
os.environ.setdefault("USE_TF", "0")

import jax.numpy as jnp

from ganq_tpu.core.config import QuantizeConfig as JQuantizeConfig
from ganq_tpu.formats import checkpoint as jckpt
from ganq_tpu.models import hf_import as jhf
from ganq_tpu.models import transformer as jtr
from ganq_tpu.models.registry import get_spec as jget_spec
from ganq_tpu.ops import qlinear as jql
from ganq_tpu.serve.engine import Engine as JEngine
from ganq_tpu_torch import GanqModel
from ganq_tpu_torch.core.config import QuantizeConfig
from ganq_tpu_torch.formats import checkpoint as tckpt
from ganq_tpu_torch.models import hf_import as thf
from ganq_tpu_torch.models import transformer as ttr
from ganq_tpu_torch.ops import qlinear as tql
from ganq_tpu_torch.serve import engine as teng

VOCAB = 256
QCFG = dict(bits=4, quant_method="ganq", ganq_iterations=2, act_sort="asc",
            l_damp_style="ganq", dead="mean")


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """(directory, hf_config) of a ganq_tpu-quantized, ganq_tpu-saved tiny
    llama (the recipe of tests/test_formats.py)."""
    import transformers as hf

    from ganq_tpu.quant.looper import quantize_model

    hf_cfg = hf.LlamaConfig(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128)
    torch.manual_seed(7)
    model = hf.LlamaForCausalLM(hf_cfg)
    cfg, params = jhf.params_from_torch_model(model)
    qcfg = JQuantizeConfig(**QCFG)
    rng = np.random.default_rng(898)
    batches = [rng.integers(0, VOCAB, size=(2, 32)).astype(np.int32)
               for _ in range(2)]
    out = quantize_model(cfg, params, jget_spec("llama"), qcfg, batches)
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jckpt.save_quantized(d, model.config.to_dict(), qcfg, out.params,
                         out.artifacts, out.log)
    return d, model.config.to_dict()


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape)


def _flatten_jax(params):
    """ganq_tpu params -> the flat numpy dict of params_from_numpy."""
    out = {}

    def arr(v):
        v = jnp.asarray(v)
        return np.array(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)

    def walk(node, path):
        if isinstance(node, jql.QLinear):
            out[f"{path}.kind"] = node.kind
            out[f"{path}.bits"] = node.bits
            out[f"{path}.in_features"] = node.in_features
            for k, v in node.arrays.items():
                out[f"{path}.{k}"] = arr(v)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")
        else:
            out[path] = arr(node)

    walk(params, "")
    return out


def test_forward_logits_match(jax_ckpt):
    """Tolerance: both packages compute in float32 from the same bf16
    codebooks; they differ only in summation order and ulp-level pow/cos
    results (rope), so logits agree to 1e-4 of their scale."""
    d, _ = jax_ckpt
    jcfg, jparams, _ = jckpt.load_quantized(d)
    g = GanqModel.load(d, device="cpu")
    assert g.backend == "reference"
    assert isinstance(thf.get_module(g.model, 0, "attn.q"), tql.QLinear)
    assert thf.get_module(g.model, 0, "attn.q").kind == "lut"
    ids = _ids(1, (2, 24))
    ref = np.array(jtr.forward(jcfg, jparams, jnp.asarray(ids)))
    with torch.inference_mode():
        got = ttr.forward(g.cfg, g.model, torch.as_tensor(ids)).numpy()
    assert got.shape == (2, 24, VOCAB)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)


def test_greedy_tokens_match(jax_ckpt):
    """Greedy tokens equal ganq_tpu's Engine on the same checkpoint. The
    prompt seed was chosen for a clear top-1 margin at every step, and the
    test checks that margin (> 1e-3 against logit differences of ~1e-5), so
    an equality here is not luck."""
    d, _ = jax_ckpt
    jcfg, jparams, _ = jckpt.load_quantized(d)
    ids = _ids(3, (2, 10))
    ref = JEngine(jcfg, jparams, backend="reference", max_seq=64).generate(
        ids, max_new_tokens=12)
    g = GanqModel.load(d, device="cpu")
    got = g.generate(ids, max_new_tokens=12, max_seq=64)
    np.testing.assert_array_equal(got, np.asarray(ref))
    # teacher-force the generated sequence: every step's margin is clear
    full = np.concatenate([ids, got[:, :-1]], axis=1)
    with torch.inference_mode():
        logits = ttr.forward(g.cfg, g.model, torch.as_tensor(full))
    top2 = torch.topk(logits[:, ids.shape[1] - 1:], 2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-3


def test_decode_paths_agree(jax_ckpt):
    """A decode step through the "cuda" dispatch (flash decode and the LUT
    matmul wrappers, which take their plain versions on CPU tensors) agrees
    with the "reference" backend; the flash path reads the bf16 query."""
    d, _ = jax_ckpt
    g = GanqModel.load(d, device="cpu")
    ids = torch.as_tensor(_ids(4, (2, 9)))
    with torch.inference_mode():
        cache = teng.init_cache(g.cfg, 2, 32, "cpu")
        tok = teng.prefill(g.cfg, g.model, cache, ids, "reference").argmax(-1)
        cache2 = [{k: v.clone() for k, v in c.items()} for c in cache]
        pos = torch.tensor(9, dtype=torch.int32)
        a = teng.decode_step(g.cfg, g.model, cache, tok, pos, "reference")
        b = teng.decode_step(g.cfg, g.model, cache2, tok, pos, "cuda")
    # layer 0 writes the same k/v on both paths (they part after attention)
    torch.testing.assert_close(cache[0]["k"], cache2[0]["k"], rtol=0, atol=0)
    torch.testing.assert_close(cache[0]["v"], cache2[0]["v"], rtol=0, atol=0)
    scale = float(a.abs().max())
    torch.testing.assert_close(b, a, rtol=0, atol=2e-2 * scale)


def test_sampling_is_seeded(jax_ckpt):
    d, _ = jax_ckpt
    g = GanqModel.load(d, device="cpu")
    ids = _ids(5, (1, 6))
    greedy = g.generate(ids, max_new_tokens=6, max_seq=32)
    assert np.array_equal(
        g.generate(ids, max_new_tokens=6, max_seq=32, temperature=0.7,
                   top_k=1), greedy)
    s1 = g.generate(ids, max_new_tokens=6, max_seq=32, temperature=1.0,
                    top_p=0.9, seed=11)
    s2 = g.generate(ids, max_new_tokens=6, max_seq=32, temperature=1.0,
                    top_p=0.9, seed=11)
    np.testing.assert_array_equal(s1, s2)
    assert s1.shape == (1, 6) and (0 <= s1).all() and (s1 < VOCAB).all()
    streamed = list(g._get_engine().stream(ids, max_new_tokens=6))
    assert streamed == greedy[0].tolist()


@pytest.mark.parametrize("max_shard_bytes", [4 * 1024**3, 40_000])
def test_port_checkpoint_loads_in_jax(jax_ckpt, tmp_path, max_shard_bytes):
    """The port saves a model built from ganq_tpu's params (params_from_numpy);
    ganq_tpu loads it back with equal dequantized weights, and so does the
    port (sharded through model.safetensors.index.json in the second case)."""
    d, hf_config = jax_ckpt
    jcfg, jparams, jq = jckpt.load_quantized(d)
    cfg, model = thf.params_from_numpy(hf_config, _flatten_jax(jparams),
                                       device="cpu")
    out = str(tmp_path / "port_ckpt")
    tckpt.save_quantized(out, hf_config, QuantizeConfig(**QCFG), model,
                         max_shard_bytes=max_shard_bytes)
    sharded = os.path.isfile(os.path.join(out, "model.safetensors.index.json"))
    assert sharded == (max_shard_bytes < 1e6)
    jcfg2, jparams2, _ = jckpt.load_quantized(out)
    _, tmodel2, _ = tckpt.load_quantized(out, device="cpu")
    for li in range(jcfg.num_hidden_layers):
        for slot in ("attn.q", "attn.k", "attn.v", "attn.o", "mlp.gate",
                     "mlp.up", "mlp.down"):
            w0 = np.array(jql.dequantize_weight(jhf.get_module(jparams, li, slot)))
            w1 = np.array(jql.dequantize_weight(jhf.get_module(jparams2, li, slot)))
            w2 = tql.dequantize_weight(thf.get_module(tmodel2, li, slot)).numpy()
            np.testing.assert_array_equal(w1, w0)
            np.testing.assert_array_equal(w2, w0)
    np.testing.assert_array_equal(
        np.array(jparams2["embed_tokens"]["weight"]),
        np.array(jparams["embed_tokens"]["weight"]))
    np.testing.assert_array_equal(
        np.array(jparams2["lm_head"]["weight"]),
        np.array(jparams["lm_head"]["weight"]))


def test_quantize_config_byte_identical(jax_ckpt, tmp_path):
    d, hf_config = jax_ckpt
    a, b = tmp_path / "jax", tmp_path / "port"
    JQuantizeConfig(**QCFG).save_pretrained(str(a))
    QuantizeConfig(**QCFG).save_pretrained(str(b))
    name = "quantize_config.json"
    assert (a / name).read_bytes() == (b / name).read_bytes()
    # the checkpoint writers too: the port's file equals ganq_tpu's
    _, model = thf.params_from_numpy(
        hf_config, _flatten_jax(jckpt.load_quantized(d)[1]), device="cpu")
    tckpt.save_quantized(str(tmp_path / "c"), hf_config,
                         QuantizeConfig(**QCFG), model)
    assert ((tmp_path / "c" / name).read_bytes()
            == open(os.path.join(d, name), "rb").read())
    with open(tmp_path / "c" / "config.json") as f:
        assert json.load(f)["quantization_config"]["quant_method"] == "ganq"
    assert QuantizeConfig.from_pretrained(d).to_dict() == \
        JQuantizeConfig.from_pretrained(d).to_dict()


def test_load_verifies_hash(jax_ckpt):
    d, _ = jax_ckpt
    good = {"model.safetensors": tckpt.sha256_file(
        os.path.join(d, "model.safetensors"))}
    tckpt.load_quantized(d, device="cpu", verify_hash=good)
    with pytest.raises(ValueError, match="hash mismatch"):
        tckpt.load_quantized(d, device="cpu",
                             verify_hash={"model.safetensors": "0" * 64})


def _engine_logits(jcfg, jparams, tmodel, ids, layout="auto"):
    """Last-position prefill logits of ganq_tpu's Engine (stacked, and
    affine codebooks certified, where its layers stack; per layer
    otherwise) and of the port's Engine, both on the reference backend
    with ``layout``, and the port's engine."""
    from ganq_tpu.serve import engine as jeng_mod
    from ganq_tpu.serve import stacked as jst

    jeng = JEngine(jcfg, jparams, backend="reference", max_seq=32,
                   layout=layout)
    if jeng._sp is not None:
        ck, cv = jst.init_cache(jcfg, jcfg.num_hidden_layers, ids.shape[0], 32)
        ref = jst.prefill(jcfg, jeng._sp, ck, cv, jnp.asarray(ids),
                          "reference")[0]
    else:
        ref = jeng_mod.prefill(jcfg, jparams,
                               jeng_mod.init_cache(jcfg, ids.shape[0], 32),
                               jnp.asarray(ids), "reference")[0]
    eng = teng.Engine(_port_cfg(), tmodel, device="cpu", max_seq=32,
                      layout=layout)
    with torch.inference_mode():
        cache = teng.init_cache(eng.cfg, ids.shape[0], 32, "cpu")
        got = teng.prefill(eng.cfg, eng.model, cache, torch.as_tensor(ids),
                           eng.backend).numpy()
    return np.asarray(ref), got, eng


def _port_cfg(hidden=128, heads=4):
    from ganq_tpu_torch.models import synthetic as tsyn
    return tsyn.llama_config(hidden=hidden, inter=2 * hidden, layers=2,
                             heads=heads, kv_heads=max(heads // 2, 1),
                             vocab=VOCAB)


def _affine_model(kinds, hidden=128, heads=4, bits=4, lm_head=None):
    """A 2-layer llama (float32 embedding and norms) built by ganq_tpu's
    synthetic builder, layer i of kind ``kinds[i]`` (``bits`` for the
    ``uniform`` kind; an untied lm_head of kind ``lm_head``), and the same
    weights in the port. The kinds ``uniform_zp``, ``uniform_ao``,
    ``uniform_zp_ao`` and ``uniform_ao_unbalanced`` (both layers) are
    ``uniform`` with random zero points and/or act-order artifacts
    (``test_torch_megastep_lowbit.inject_zp_ao``)."""
    import jax

    from ganq_tpu.models import synthetic as jsyn

    jcfg = jsyn.llama_config(hidden=hidden, inter=2 * hidden, layers=2,
                             heads=heads, kv_heads=max(heads // 2, 1),
                             vocab=VOCAB)
    variant = kinds[0].split("_")[1:] if kinds[0].startswith("uniform_") \
        else None
    if variant:
        from test_torch_megastep_lowbit import inject_zp_ao, np_uniform_llama
        _, params = np_uniform_llama(hidden, heads, max(heads // 2, 1),
                                     2 * hidden, bits, VOCAB, seed=1,
                                     norms=False)
        inject_zp_ao(params, bits, "zp" in variant, "ao" in variant,
                     unbalanced="unbalanced" in variant)
    else:
        params = jsyn.make_model(jcfg, kind=kinds[0], seed=1,
                                 dtype=jnp.float32, bits=bits)
    if kinds[1] != kinds[0]:
        params["layers"][1] = jsyn.make_model(jcfg, kind=kinds[1], seed=2,
                                              dtype=jnp.float32)["layers"][1]
    if lm_head:
        params["lm_head"] = jsyn._rand_linear(jax.random.PRNGKey(4), VOCAB,
                                              hidden, lm_head)
    _, tmodel = thf.params_from_numpy(thf.config_to_hf(_port_cfg(hidden, heads)),
                                      _flatten_jax(params), device="cpu")
    return jcfg, params, tmodel


@pytest.mark.parametrize("kinds,certified", [
    (("lut_affine_sym", "lut_affine_sym"), True),
    (("lut_affine_sym", "lut"), False),
])
def test_engine_certifies_affine_codebooks_as_jax(kinds, certified):
    """ganq_tpu's Engine serves a multi-layer model through
    ``stack_layers(recode="affine")``, which certifies affine-grid codebooks
    into uniform linears (values within 2^-7 of the row's range of the
    stored ones) when every layer still stacks afterwards. The port's
    Engine does the same: its logits equal ganq_tpu's (float32, 1e-4 of the
    scale), while serving the stored codebooks would differ by more. A
    layer of free codebooks beside a certified one leaves the whole model
    ``lut``, as in ganq_tpu."""
    jcfg, jparams, tmodel = _affine_model(kinds)
    ids = _ids(6, (2, 12))
    ref, got, eng = _engine_logits(jcfg, jparams, tmodel, ids)
    served = {p.kind for lp in eng.model.layers
              for p in list(lp.attn.values()) + list(lp.mlp.values())}
    assert served == ({"uniform"} if certified else {"lut"})
    assert eng.stacked == certified
    assert "zeros" not in next(iter(eng.model.layers[0].attn.values()))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
    with torch.inference_mode():
        cache = teng.init_cache(eng.cfg, 2, 32, "cpu")
        stored = teng.prefill(eng.cfg, tmodel, cache, torch.as_tensor(ids),
                              "reference").numpy()
    if certified:           # serving the stored codebooks fails the match
        assert not np.allclose(stored, ref, rtol=1e-4, atol=1e-4 * scale)
    else:
        np.testing.assert_array_equal(stored, got)


def test_engine_certifies_a_quantized_lm_head_as_jax():
    """A ``lut_affine_sym`` lm_head is certified with the layers
    (``certify_stacked`` covers the lm_head): logits within 1e-4 of the
    scale of ganq_tpu's Engine."""
    import jax

    from ganq_tpu.models import synthetic as jsyn

    jcfg, jparams, _ = _affine_model(("lut_affine_sym",) * 2)
    jparams["lm_head"] = jsyn._rand_linear(jax.random.PRNGKey(4), VOCAB, 128,
                                           "lut_affine_sym")
    _, tmodel = thf.params_from_numpy(thf.config_to_hf(_port_cfg()),
                                      _flatten_jax(jparams), device="cpu")
    assert tmodel.lm_head.kind == "lut"
    ids = _ids(6, (2, 12))
    ref, got, eng = _engine_logits(jcfg, jparams, tmodel, ids)
    assert eng.model.lm_head.kind == "uniform"
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_engine_perlayer_layout_serves_stored_codebooks_as_jax():
    """``layout="perlayer"``: ganq_tpu's Engine neither stacks nor
    certifies, and neither does the port's; both serve the stored affine
    codebooks (logits within 1e-4 of the scale)."""
    jcfg, jparams, tmodel = _affine_model(("lut_affine_sym",) * 2)
    ids = _ids(6, (2, 12))
    ref, got, eng = _engine_logits(jcfg, jparams, tmodel, ids, "perlayer")
    assert not eng.stacked and eng.model is tmodel
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    # layout="stacked" serves layers that stack and raises, as ganq_tpu's
    # does, where they do not (one certified and one free-codebook layer)
    assert teng.Engine(_port_cfg(), tmodel, device="cpu",
                       layout="stacked").stacked
    mixed_cfg, mixed_params, mixed = _affine_model(("lut_affine_sym", "lut"))
    with pytest.raises(ValueError, match="homogeneous"):
        JEngine(mixed_cfg, mixed_params, layout="stacked")
    with pytest.raises(ValueError, match="homogeneous"):
        teng.Engine(_port_cfg(), mixed, device="cpu", layout="stacked")
    with pytest.raises(ValueError, match="unknown layout"):
        teng.Engine(_port_cfg(), tmodel, device="cpu", layout="scan")


@pytest.mark.parametrize(
    "kind,bits,lm,hidden,heads,backend,batch,prompt,new,want", [
        ("uniform", 4, None, 256, 2, "cuda_a8", 8, 12, 4, None),
        ("uniform", 4, None, 256, 2, "cuda_a8", 65, 2, 4, None),
        ("uniform", 4, None, 256, 2, "cuda", 8, 12, 4, None),
        ("uniform", 4, None, 128, 4, "cuda_a8", 8, 12, 4, None),
        ("w8", 4, None, 128, 4, "cuda_a8", 8, 12, 4, None),
        ("w8", 4, None, 128, 4, "cuda_a8", 2, 12, 1, None),
        ("w8", 4, None, 128, 4, "cuda_a8", 8, 12, 1, None),
        ("w8", 4, None, 128, 4, "cuda_a8", 65, 2, 4, None),
        ("w8", 4, None, 256, 2, "cuda_a8", 8, 12, 4, None),
        ("w8", 4, None, 256, 2, "cuda_a8", 9, 12, 4, None),
        ("uniform", 4, None, 256, 2, "cuda_a8", 64, 2, 4, None),
        ("uniform", 4, None, 256, 2, "cuda_a8", 8, 12, 1, None),
        ("uniform", 8, None, 256, 2, "cuda_a8", 16, 2, 4, None),
        ("uniform", 2, None, 512, 4, "cuda_a8", 8, 12, 4, "'w2'"),
        ("uniform", 8, "w8", 256, 2, "cuda_a8", 8, 12, 4, "lm fold"),
        ("uniform", 8, "w8", 256, 2, "cuda_a8", 8, 12, 1, None),
        ("uniform_zp", 4, None, 256, 2, "cuda_a8", 8, 12, 4, None),
        ("uniform_zp", 8, None, 256, 2, "cuda_a8", 16, 2, 4, None),
        ("uniform_ao", 4, None, 256, 2, "cuda_a8", 1, 12, 4, None),
        ("uniform_zp_ao", 4, None, 256, 2, "cuda_a8", 64, 2, 4, None),
    ])
def test_stacked_only_kernels_are_named_where_jax_runs_them(
        monkeypatch, kind, bits, lm, hidden, heads, backend, batch, prompt,
        new, want):
    """The port's engine refuses exactly the requests that ganq_tpu's
    stacked layout serves through a whole-step variant the port has not
    ported: where ganq_tpu's ``mega_enabled`` (on by default for
    "pallas_a8" on a TPU, here forced with ``GANQ_MEGASTEP=1``) picks
    kernel 14's "w3", "w2" or "wl8", or picks "w4p"/"w8p" for a model whose
    lm_head ganq_tpu folds into the step (``mega_lm_operands``), for a
    request that decodes. The port's gate, on the card, gives the same
    variant. Kernels 12 ("w8"), 13 ("w4") and 14's "w4p" and "w8p", with
    zero points and act-order, serve every other request."""
    from ganq_tpu.ops import megastep_lowbit as jlb
    from ganq_tpu.serve import stacked as jst

    jcfg, jparams, tmodel = _affine_model((kind,) * 2, hidden, heads, bits,
                                          lm)
    sp = jst.stack_layers(jparams, recode="affine")
    if backend == "cuda_a8":
        monkeypatch.setenv("GANQ_MEGASTEP", "1")
    variant = jst.mega_enabled(jcfg, sp, "pallas_a8" if backend == "cuda_a8"
                               else "pallas", batch)
    monkeypatch.delenv("GANQ_MEGASTEP", raising=False)
    later = variant in ("w3", "w2", "wl8") or (
        variant in ("w4p", "w8p") and jlb.mega_lm_operands(jcfg, sp)
        is not None)
    refused = new > 1 and later
    eng = teng.Engine(_port_cfg(hidden, heads), tmodel, backend="reference",
                      device="cpu")
    assert eng.stacked
    got = teng.stacked_only_kernel(_port_cfg(hidden, heads), eng.model,
                                   backend, batch, new, device="cuda")
    assert (got is not None) == refused
    assert got is None if want is None else want in got


def test_optimize_whole_step_greedy_matches_jax(monkeypatch):
    """The slice as a whole: ``optimize()`` of a 2-layer head_dim-128 ``lut``
    llama recodes every linear to uniform 8-bit in both packages; with the
    megastep forced on (``GANQ_MEGASTEP=1``) both engines decode a batch of
    2 through kernel 14's "w8p" variant: ganq_tpu's Pallas kernel in
    interpret mode, the port's plain version. Greedy tokens are equal."""
    from ganq_tpu.api import GanqModel as JGanqModel
    from ganq_tpu.serve import stacked as jst

    from ganq_tpu_torch.serve import stacked as tst

    variant = "w8p"
    jcfg, jparams, tmodel = _affine_model(("lut",) * 2, 256, 2)
    monkeypatch.setenv("GANQ_MEGASTEP", "1")
    j = JGanqModel(jcfg, jparams, quantized=True).optimize()
    g = GanqModel(_port_cfg(256, 2), tmodel, device="cpu").optimize()
    eng = g._get_engine("auto")
    assert eng.stacked and tst.mega_enabled(
        g.cfg, eng.model, eng.backend, 2, "cpu") == variant
    sp = jst.prepack(j.cfg, jst.stack_layers(j.params, recode="affine"),
                     j.backend, 1)
    assert jst.mega_enabled(j.cfg, sp, j.backend, 2) == variant
    ids = _ids(9, (2, 8))
    want = np.asarray(j.generate(ids, max_new_tokens=5, max_seq=32))
    np.testing.assert_array_equal(
        g.generate(ids, max_new_tokens=5, max_seq=32), want)


def test_zero_point_actorder_whole_step_greedy_matches_jax(monkeypatch):
    """A 2-layer head_dim-128 W4 llama with zero points and act-order
    (a ``sym=False``, ``desc_act=True`` GPTQ checkpoint's artifacts) on the
    stacked layout with the megastep forced on (``GANQ_MEGASTEP=1``): both
    engines pack kernel 14's "w4p" with the zero-point corrections and the
    act-order routing and decode a batch of 2 through it (ganq_tpu's
    Pallas kernel in interpret mode, the port's plain version); greedy
    tokens are equal."""
    from ganq_tpu.serve import stacked as jst

    from ganq_tpu_torch.serve import stacked as tst

    jcfg, jparams, tmodel = _affine_model(("uniform_zp_ao",) * 2, 256, 2)
    monkeypatch.setenv("GANQ_MEGASTEP", "1")
    jeng = JEngine(jcfg, jparams, backend="reference", max_seq=32)
    eng = teng.Engine(_port_cfg(256, 2), tmodel, backend="reference",
                      device="cpu", max_seq=32)
    assert {"qkv_sz", "ap_q"} <= set(jeng._sp["megapack_lb"])
    assert eng.stacked and {"qkv_sz", "ap_q"} <= set(eng.model.megapack_lb)
    assert jst.mega_enabled(jcfg, jeng._sp, "reference", 2) == "w4p"
    assert tst.mega_enabled(eng.cfg, eng.model, "reference", 2, "cpu") == "w4p"
    ids = _ids(9, (2, 6))
    np.testing.assert_array_equal(
        eng.generate(ids, max_new_tokens=3),
        np.asarray(jeng.generate(ids, max_new_tokens=3)))


def test_unbalanced_actorder_is_served_per_layer_as_jax(monkeypatch):
    """An act-order model whose groups do not all hold the group size
    (``actorder_transform`` raises ValueError): ganq_tpu's Engine serves it
    per layer, and so does the port's (the model as given), with the
    megastep forced on."""
    from ganq_tpu_torch.ops import megastep_lowbit as tlb
    from ganq_tpu_torch.serve import stacked as tst

    jcfg, jparams, tmodel = _affine_model(("uniform_ao_unbalanced",) * 2,
                                          256, 2)
    monkeypatch.setenv("GANQ_MEGASTEP", "1")
    jeng = JEngine(jcfg, jparams, backend="reference", max_seq=32)
    eng = teng.Engine(_port_cfg(256, 2), tmodel, backend="reference",
                      device="cpu", max_seq=32)
    assert jeng._sp is None and not eng.stacked and eng.model is tmodel
    with pytest.raises(ValueError, match="unbalanced"):
        tlb.actorder_transform(eng.cfg, tst.stack_layers(tmodel), 4)


@pytest.mark.parametrize("recode", ["auto", "affine", "u4", "w8", "none"])
def test_optimize_matches_jax(jax_ckpt, recode):
    """``optimize(recode)`` on ganq_tpu's lut checkpoint gives the same
    linears as ganq_tpu's ``optimize`` (kinds, bits, packed codes and
    scales exactly) and the same greedy tokens on the reference backend.
    Widths of 64 are no multiple of 128: their "auto" recode is the per-row
    int8 artifact, as in ganq_tpu."""
    from ganq_tpu.api import GanqModel as JGanqModel

    d, _ = jax_ckpt
    j = JGanqModel.load(d).optimize(recode)
    g = GanqModel.load(d, device="cpu").optimize(recode)
    assert g.backend == "reference"
    for li in range(2):
        for slot in ("attn.q", "attn.k", "attn.v", "attn.o", "mlp.gate",
                     "mlp.up", "mlp.down"):
            jl = jhf.get_module(j.params, li, slot)
            tl = thf.get_module(g.model, li, slot)
            assert (tl.kind, tl.bits, tl.in_features) == \
                (jl.kind, jl.bits, jl.in_features)
            assert sorted(tl._buffers) == sorted(jl.arrays)
            for k, v in jl.arrays.items():
                np.testing.assert_array_equal(
                    tl[k].float().numpy(),
                    np.asarray(jnp.asarray(v).astype(jnp.float32)), err_msg=k)
    ids = _ids(3, (2, 10))
    np.testing.assert_array_equal(
        g.generate(ids, max_new_tokens=8, max_seq=64),
        np.asarray(j.generate(ids, max_new_tokens=8, max_seq=64)))


def test_quant_log_csv_matches(tmp_path):
    from collections import namedtuple

    Entry = namedtuple("Entry", "layer module method loss damp duration")
    log = [Entry(0, "self_attn.q_proj", "ganq", 0.0123456789, 0.01, 1.5),
           Entry(1, "mlp.down_proj", "ganq", 2.5e-6, 0.0125, 0.25)]
    jckpt._write_quant_log(str(tmp_path), log)
    expected = (tmp_path / "quant_log.csv").read_bytes()
    tckpt._write_quant_log(str(tmp_path), log)
    assert (tmp_path / "quant_log.csv").read_bytes() == expected
