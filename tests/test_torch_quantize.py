"""The port's quantize slice against ganq_tpu's, end to end, on the CPU.

A tiny llama (2 layers, hidden 64, random weights from a local
``transformers`` config) is written as a dense safetensors directory. The
port runs the README quick start on it (``GanqModel.load(dir, qcfg)``,
``quantize``, ``save``, ``GanqModel.load``, ``generate``); ganq_tpu quantizes
the same weights on the same calibration batches. Both run float32
activations and weights.
"""

import json
import os

import numpy as np
import pytest
import torch

# transformers only builds the tiny test model here: keep it from importing
# TensorFlow, which costs seconds per process
os.environ.setdefault("USE_TF", "0")

from ganq_tpu.api import prepare_dataset as jprepare
from ganq_tpu.core.config import QuantizeConfig as JQuantizeConfig
from ganq_tpu.formats import checkpoint as jckpt
from ganq_tpu.models import hf_import as jhf
from ganq_tpu.models.registry import get_spec as jget_spec
from ganq_tpu.quant.looper import quantize_model as jquantize_model
from ganq_tpu.serve.engine import Engine as JEngine
from ganq_tpu_torch import GanqModel
from ganq_tpu_torch.api import prepare_dataset
from ganq_tpu_torch.core.config import QuantizeConfig
from ganq_tpu_torch.formats import checkpoint as tckpt
from ganq_tpu_torch.formats.safetensors_io import load_file, save_file
from ganq_tpu_torch.models import hf_import as thf
from ganq_tpu_torch.models.registry import get_spec
from ganq_tpu_torch.quant.looper import QuantizedModule, packed_params
from ganq_tpu_torch.ops import qlinear as tql
from tests.test_torch_serve import _flatten_jax
from test_torch_packing import torch_threads_per_worker  # noqa: F401

VOCAB = 256
QCFG = dict(bits=4, quant_method="ganq", ganq_iterations=3, act_sort="asc",
            l_damp_style="ganq", dead="mean")


def _rows():
    rng = np.random.default_rng(898)
    return list(rng.integers(0, VOCAB, size=(4, 32)).astype(np.int32))


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """(dense directory, hf_config, transformers model) of the tiny llama
    of tests/test_torch_serve.py."""
    import transformers as hf

    hf_cfg = hf.LlamaConfig(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128)
    torch.manual_seed(7)
    model = hf.LlamaForCausalLM(hf_cfg)
    d = str(tmp_path_factory.mktemp("dense"))
    save_file({k: v.detach() for k, v in model.state_dict().items()},
              os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(model.config.to_dict(), f)
    return d, model.config.to_dict(), model


@pytest.fixture(scope="module")
def both(dense, tmp_path_factory):
    """The port's and ganq_tpu's quantization of the same model and rows:
    (port GanqModel after quantize, its saved directory, JAX output)."""
    d, _, model = dense
    g = GanqModel.load(d, QuantizeConfig(**QCFG), device="cpu")
    g.quantize(_rows(), batch_size=2)
    saved = str(tmp_path_factory.mktemp("port_q"))
    g.save(saved)
    jcfg, jparams = jhf.params_from_torch_model(model)
    jout = jquantize_model(jcfg, jparams, jget_spec("llama"),
                           JQuantizeConfig(**QCFG),
                           jprepare(_rows(), None, batch_size=2))
    return g, saved, jout


def test_prepare_dataset_matches_jax():
    rows = _rows() + [np.arange(5), {"input_ids": np.arange(32)}]
    ref = jprepare(rows, None, batch_size=2)
    got = prepare_dataset(rows, None, batch_size=2)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    packed = prepare_dataset(_rows(), None, concat_size=48)
    np.testing.assert_array_equal(np.concatenate(packed),
                                  np.concatenate(jprepare(_rows(), None,
                                                          concat_size=48)))
    with pytest.raises(ValueError, match="tokenizer"):
        prepare_dataset(["text"], None)


def test_artifacts_match_jax(both):
    """Per module: codes agree at >= 0.99 and codebooks within 1e-3 of the
    row's largest codeword. Layer 1 calibrates on layer 0's fake-quantized
    outputs, so float32 differences of layer 0 (summation order, the T-step's
    f32 contraction against JAX's split-bf16) reach its Hessians."""
    g, _, jout = both
    arts = g._quant_output.artifacts
    assert sorted(arts) == sorted(jout.artifacts)
    for name, ja in jout.artifacts.items():
        ta = arts[name]
        agree = np.mean(ta.idx.numpy() == np.asarray(ja.idx))
        assert agree >= 0.99, (name, agree)
        ref = np.asarray(ja.lut)
        scale = np.abs(ref).max(axis=1, keepdims=True)
        assert (np.abs(ta.lut.numpy() - ref) <= 1e-3 * scale).all(), name
    jlog = {(e.layer, e.module): e for e in jout.log}
    for e in g._quant_output.log:
        assert e.loss == pytest.approx(jlog[(e.layer, e.module)].loss, rel=2e-2)
        assert e.damp == jlog[(e.layer, e.module)].damp
        assert not e.extra["fallback"]


def test_same_artifacts_write_the_same_checkpoint(both, dense, tmp_path):
    """Fed ganq_tpu's artifacts and fake-quantized weights, the port's writer
    and ganq_tpu's write the same tensors (codebooks, codes and every dense
    tensor) and byte-identical quantize_config.json."""
    _, hf_config, _ = dense
    _, _, jout = both
    _, model = thf.params_from_numpy(hf_config, _flatten_jax(jout.params),
                                     device="cpu")
    arts = {name: QuantizedModule(method=a.method, bits=a.bits,
                                  group_size=a.group_size,
                                  lut=torch.from_numpy(np.array(a.lut)),
                                  idx=torch.from_numpy(np.array(a.idx)))
            for name, a in jout.artifacts.items()}
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    qcfg = JQuantizeConfig(**QCFG)
    jckpt.save_quantized(jd, hf_config, qcfg, jout.params, jout.artifacts,
                         jout.log)
    tckpt.save_quantized(td, hf_config, QuantizeConfig(**QCFG), model,
                         jout.log, artifacts=arts)
    ref = load_file(os.path.join(jd, "model.safetensors"))
    got = load_file(os.path.join(td, "model.safetensors"))
    assert sorted(got) == sorted(ref)
    assert any(k.endswith(".lut") for k in got)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert torch.equal(got[k], ref[k]), k
    for name in ("quantize_config.json", "quant_log.csv"):
        assert (open(os.path.join(td, name), "rb").read()
                == open(os.path.join(jd, name), "rb").read()), name


def test_port_checkpoint_serves_in_jax(both):
    """The port's saved directory loads in ganq_tpu; greedy tokens from it
    equal the port's own. Its weights are the fake-quantized ones with the
    codebook rounded to fp16 and then bf16 (within (2^-8 + 2^-10) |w|), and
    ``packed_params`` (codebook rounded to bf16 once) within 2^-8 |w|."""
    g, saved, _ = both
    jcfg, jparams, jq = jckpt.load_quantized(saved)
    assert jq.quant_method == "ganq"
    ids = np.random.default_rng(3).integers(0, VOCAB, size=(2, 10))
    ref = JEngine(jcfg, jparams, backend="reference", max_seq=64).generate(
        ids, max_new_tokens=8)
    q = GanqModel.load(saved, device="cpu")
    assert q.backend == "reference"
    np.testing.assert_array_equal(q.generate(ids, max_new_tokens=8, max_seq=64),
                                  np.asarray(ref))
    packed = packed_params(get_spec("llama"), g._quant_output)
    for li in range(2):
        for slot in ("attn.q", "attn.k", "attn.v", "attn.o", "mlp.gate",
                     "mlp.up", "mlp.down"):
            fake = thf.get_module(g.model, li, slot)["weight"].numpy()
            for model, rtol in ((q.model, 2**-8 + 2**-10), (packed, 2**-8)):
                w = tql.dequantize_weight(thf.get_module(model, li, slot))
                np.testing.assert_allclose(w.numpy(), fake, rtol=rtol,
                                           atol=2**-24)


def test_quantized_model_generates_before_saving(both):
    """Right after quantize the model serves its fake-quantized dense
    weights, as ganq_tpu does."""
    g, _, _ = both
    assert g.quantized and g.backend == "reference"
    assert thf.get_module(g.model, 0, "attn.q").kind == "dense"
    out = g.generate(_rows()[0][None, :8], max_new_tokens=4, max_seq=32)
    assert out.shape == (1, 4)
    with pytest.raises(RuntimeError, match="already quantized"):
        g.quantize(_rows())


def test_resume_restores_every_layer(dense, tmp_path):
    d, _, _ = dense
    qcfg = QuantizeConfig(**dict(QCFG, ganq_iterations=1))
    a = GanqModel.load(d, qcfg, device="cpu")
    a.quantize(_rows(), batch_size=2, resume_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["layer_0.npz", "layer_1.npz"]
    b = GanqModel.load(d, qcfg, device="cpu")
    log = b.quantize(_rows(), batch_size=2, resume_dir=str(tmp_path))
    assert log == []                          # nothing re-solved
    for name, art in a._quant_output.artifacts.items():
        assert torch.equal(b._quant_output.artifacts[name].idx, art.idx)
    for li in range(2):
        assert torch.equal(thf.get_module(b.model, li, "mlp.up")["weight"],
                           thf.get_module(a.model, li, "mlp.up")["weight"])


def test_gptq_resume_restores_every_layer_in_both_packages(dense, tmp_path):
    """A GPTQ run's per-layer files (codes, scales, zeros, g_idx and the
    fake-quantized weights) resume in the port and load in ganq_tpu's
    resume reader with the same arrays."""
    from ganq_tpu.quant.looper import _load_layer_state as jload

    d, _, _ = dense
    qcfg = QuantizeConfig(quant_method="gptq", bits=4, group_size=32)
    a = GanqModel.load(d, qcfg, device="cpu")
    a.quantize(_rows(), batch_size=2, resume_dir=str(tmp_path))
    b = GanqModel.load(d, qcfg, device="cpu")
    assert b.quantize(_rows(), batch_size=2, resume_dir=str(tmp_path)) == []
    for li in range(2):
        jarts, _ = jload(str(tmp_path), li)
        for name, ja in jarts.items():
            ta, tb = a._quant_output.artifacts[name], \
                b._quant_output.artifacts[name]
            assert ja.method == tb.method == "gptq" and tb.lut is None
            for f in ("qidx", "scale", "zero", "g_idx"):
                assert torch.equal(getattr(tb, f), getattr(ta, f))
                np.testing.assert_array_equal(np.asarray(getattr(ja, f)),
                                              getattr(ta, f).numpy())
    assert torch.equal(thf.get_module(b.model, 1, "mlp.up")["weight"],
                       thf.get_module(a.model, 1, "mlp.up")["weight"])


@pytest.mark.parametrize("kw,match", [
    (dict(quant_method="auto_round"), "queue A item 5"),
    (dict(quant_method="qqq"), "qqq"),
    (dict(quant_method="ganq", rotation="hadamard"), "rotation"),
    (dict(quant_method="ganq", lm_head=True), "lm_head"),
])
def test_unported_options_raise(dense, kw, match):
    d, _, _ = dense
    g = GanqModel.load(d, QuantizeConfig(**kw), device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        g.quantize(_rows()[:1])
    with pytest.raises(RuntimeError, match="quantize"):
        g.save("unused")
