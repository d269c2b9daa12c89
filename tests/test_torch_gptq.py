"""The port's GPTQ against ``ganq_tpu``'s, on the CPU: the uniform parameter
search, the blocked solver, the GPTQ v1/v2 checkpoint layout, and a tiny
llama (2 layers, hidden 64) quantized by both packages end to end, saved,
cross-loaded and served. Inputs come from numpy with a seed."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ganq_tpu.api import prepare_dataset as jprepare
from ganq_tpu.core.config import QuantizeConfig as JQuantizeConfig
from ganq_tpu.formats import checkpoint as jckpt
from ganq_tpu.formats import gptq_compat as jcompat
from ganq_tpu.models import hf_import as jhf
from ganq_tpu.models.registry import get_spec as jget_spec
from ganq_tpu.quant import gptq as jgptq
from ganq_tpu.quant import quantizer as jqz
from ganq_tpu.quant.looper import quantize_model as jquantize_model
from ganq_tpu.serve.engine import Engine as JEngine
from ganq_tpu_torch import GanqModel
from ganq_tpu_torch.core.config import QuantizeConfig
from ganq_tpu_torch.formats import checkpoint as tckpt
from ganq_tpu_torch.formats import gptq_compat as tcompat
from ganq_tpu_torch.formats.safetensors_io import load_file
from ganq_tpu_torch.models import hf_import as thf
from ganq_tpu_torch.ops import qlinear as tql
from ganq_tpu_torch.quant import gptq as tgptq
from ganq_tpu_torch.quant import quantizer as tqz
from ganq_tpu_torch.quant.looper import QuantizedModule
from tests.test_torch_serve import _flatten_jax
from test_torch_packing import torch_threads_per_worker  # noqa: F401

VOCAB = 256
QCFG = dict(quant_method="gptq", bits=4, group_size=32, desc_act=True)
SLOTS = ("attn.q", "attn.k", "attn.v", "attn.o", "mlp.gate", "mlp.up",
         "mlp.down")


def _problem(seed, m=96, n=256):
    rng = np.random.default_rng(seed)
    W = (rng.normal(size=(m, n)) * 0.02).astype(np.float32)
    X = rng.normal(size=(2 * n, n)).astype(np.float32)
    X[:, ::7] *= 3.0                  # uneven activations: act order matters
    H = (2.0 / X.shape[0]) * (X.T @ X)
    return W, H.astype(np.float32)


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("mse", [0.0, 2.4])
def test_find_params_matches_jax(sym, mse):
    """Per-row scale and zero of the same slice, including an all-zero row
    (the degenerate guard) and an all-positive one (min clamped through
    0): zeros equal, scales within 1e-6 relative (the mse search's pow and
    sums may round apart; its choice agrees on every row)."""
    W, _ = _problem(0, m=64, n=128)
    W[3] = 0.0
    W[5] = np.abs(W[5])
    ref = jqz.find_params(jnp.asarray(W), bits=4, sym=sym, mse=mse)
    got = tqz.find_params(torch.from_numpy(W), bits=4, sym=sym, mse=mse)
    np.testing.assert_array_equal(got.zero.numpy(), np.asarray(ref.zero))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(ref.scale),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("kw", [dict(desc_act=False), dict(desc_act=True),
                                dict(desc_act=True, static_groups=True),
                                dict(desc_act=False, sym=False, group_size=-1)])
def test_gptq_quantize_matches_jax(kw):
    """The same W and H through both solvers: codes agree at >= 0.999 (the
    per-column loop and the float32 trailing products sum in another
    order), g_idx equal, scales within 1e-5 relative and zeros within one
    step where the codes agree, the loss within 1e-4 relative."""
    W, H = _problem(1)
    cfg = dict(dict(quant_method="gptq", bits=4, group_size=128), **kw)
    ref = jgptq.gptq_quantize(jnp.asarray(W), jnp.asarray(H),
                              JQuantizeConfig(**cfg), nsamples=4)
    got = tgptq.gptq_quantize(torch.from_numpy(W), torch.from_numpy(H),
                              QuantizeConfig(**cfg), nsamples=4)
    agree = np.mean(got.qidx.numpy() == np.asarray(ref.qidx))
    assert agree >= 0.999, agree
    np.testing.assert_array_equal(got.g_idx.numpy(), np.asarray(ref.g_idx))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(ref.scale),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.zero.numpy(), np.asarray(ref.zero), atol=1)
    assert got.avg_loss == pytest.approx(ref.avg_loss, rel=1e-4)
    same = got.qidx.numpy() == np.asarray(ref.qidx)
    np.testing.assert_allclose(got.Q.numpy()[same], np.asarray(ref.Q)[same],
                               rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("v1", [True, False])
def test_gptq_layout_is_bit_exact(bits, v1):
    rng = np.random.default_rng(bits)
    out_f, in_f, G = 32, 128, 4
    qidx = rng.integers(0, 2**bits, size=(out_f, in_f)).astype(np.int32)
    scales = rng.uniform(0.001, 0.01, size=(out_f, G)).astype(np.float32)
    zeros = rng.integers(1, 2**bits, size=(out_f, G)).astype(np.float32)
    g_idx = rng.permutation(np.arange(in_f) // (in_f // G)).astype(np.int32)
    ref = jcompat.pack_gptq(qidx, scales, zeros, g_idx, bits, v1=v1)
    got = tcompat.pack_gptq(qidx, scales, zeros, g_idx, bits, v1=v1)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])
    for a, b in zip(tcompat.unpack_gptq(got, bits, v1=v1),
                    jcompat.unpack_gptq(ref, bits, v1=v1)):
        np.testing.assert_array_equal(a, b)
    back = tcompat.unpack_gptq(got, bits, v1=v1)
    np.testing.assert_array_equal(back[0], qidx)
    np.testing.assert_array_equal(back[2], zeros)


# ------------------------------------------------------------------ end to end
def _rows():
    rng = np.random.default_rng(898)
    return list(rng.integers(0, VOCAB, size=(4, 32)).astype(np.int32))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """A tiny random llama (the port's synthetic dense builder, saved as an
    HF directory) GPTQ-quantized (W4, group 32, desc_act) by the port
    through GanqModel and by ganq_tpu on the same rows, each saved by its
    own writer: (port GanqModel, port dir, JAX output, JAX dir, hf_config)."""
    from ganq_tpu_torch.formats.checkpoint import save_dense
    from ganq_tpu_torch.models import synthetic as tsyn

    cfg = tsyn.llama_config(hidden=64, inter=128, layers=2, heads=4,
                            kv_heads=2, vocab=VOCAB, max_pos=128)
    hf_config = thf.config_to_hf(cfg)
    d = str(tmp_path_factory.mktemp("gptq_dense"))
    save_dense(d, hf_config, tsyn.make_model(cfg, kind="dense", seed=11,
                                             device="cpu",
                                             dtype=torch.float32))
    g = GanqModel.load(d, QuantizeConfig(**QCFG), device="cpu")
    g.quantize(_rows(), batch_size=2)
    tdir = str(tmp_path_factory.mktemp("gptq_port"))
    g.save(tdir)
    jcfg, jparams = jhf.params_from_dir(d)
    jout = jquantize_model(jcfg, jparams, jget_spec("llama"),
                           JQuantizeConfig(**QCFG),
                           jprepare(_rows(), None, batch_size=2))
    jdir = str(tmp_path_factory.mktemp("gptq_jax"))
    jckpt.save_quantized(jdir, hf_config, JQuantizeConfig(**QCFG),
                         jout.params, jout.artifacts, jout.log)
    return g, tdir, jout, jdir, hf_config


def test_gptq_artifacts_match_jax(both):
    g, _, jout, _, _ = both
    arts = g._quant_output.artifacts
    assert sorted(arts) == sorted(jout.artifacts)
    for name, ja in jout.artifacts.items():
        ta = arts[name]
        assert ta.method == "gptq" and ta.lut is None
        agree = np.mean(ta.qidx.numpy() == np.asarray(ja.qidx))
        assert agree >= 0.999, (name, agree)
        np.testing.assert_array_equal(ta.g_idx.numpy(), np.asarray(ja.g_idx))
        np.testing.assert_allclose(ta.scale.numpy(), np.asarray(ja.scale),
                                   rtol=1e-4)
    jlog = {(e.layer, e.module): e for e in jout.log}
    for e in g._quant_output.log:
        assert e.loss == pytest.approx(jlog[(e.layer, e.module)].loss, rel=1e-2)
        assert {"prepare", "columns", "final"} <= set(e.extra)


@pytest.mark.parametrize("fmt", ["gptq", "gptq_v2"])
def test_same_artifacts_write_the_same_gptq_checkpoint(both, tmp_path, fmt):
    """Fed ganq_tpu's artifacts, the port's writer and ganq_tpu's write the
    same tensors in the v1 and v2 layouts."""
    _, _, jout, _, hf_config = both
    _, model = thf.params_from_numpy(hf_config, _flatten_jax(jout.params),
                                     device="cpu")
    arts = {name: QuantizedModule(
        method=a.method, bits=a.bits, group_size=a.group_size,
        **{f: torch.from_numpy(np.array(getattr(a, f)))
           for f in ("qidx", "scale", "zero", "g_idx")})
            for name, a in jout.artifacts.items()}
    qcfg = dict(QCFG, format=fmt)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_quantized(jd, hf_config, JQuantizeConfig(**qcfg), jout.params,
                         jout.artifacts, jout.log)
    tckpt.save_quantized(td, hf_config, QuantizeConfig(**qcfg), model,
                         jout.log, artifacts=arts)
    ref = load_file(os.path.join(jd, "model.safetensors"))
    got = load_file(os.path.join(td, "model.safetensors"))
    assert sorted(got) == sorted(ref)
    assert any(k.endswith(".qzeros") for k in got)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert torch.equal(got[k], ref[k]), k
    assert (open(os.path.join(td, "quantize_config.json"), "rb").read()
            == open(os.path.join(jd, "quantize_config.json"), "rb").read())


def _assert_same_model(jparams, tmodel):
    for li in range(2):
        for slot in SLOTS:
            j = jhf.get_module(jparams, li, slot)
            t = thf.get_module(tmodel, li, slot)
            assert t.kind == j.kind == "uniform"
            assert sorted(t._buffers) == sorted(j.arrays)
            for k, v in j.arrays.items():
                np.testing.assert_array_equal(t[k].numpy(), np.asarray(v))


def test_gptq_checkpoints_cross_load(both):
    """Each package's GPTQ v1 checkpoint loads in the other with identical
    tensors (codes, fp16-rounded scales, g_idx; sym zeros omitted)."""
    _, tdir, _, jdir, _ = both
    for d in (tdir, jdir):
        _, jparams, jq = jckpt.load_quantized(d)
        assert jq.quant_method == "gptq" and jq.format == "gptq"
        _, tmodel, _ = tckpt.load_quantized(d, device="cpu")
        _assert_same_model(jparams, tmodel)
        assert "g_idx" in thf.get_module(tmodel, 0, "attn.q")   # desc_act
        assert "zeros" not in thf.get_module(tmodel, 0, "attn.q")  # sym


def test_gptq_greedy_tokens_match_jax(both):
    """Greedy tokens from the port's checkpoint equal ganq_tpu's Engine on
    the reference backend (both packages load the same tensors from either
    checkpoint, test above); and right after quantize the port serves its
    fake-quantized weights, which the saved checkpoint reproduces within
    the fp16 rounding of the scales."""
    g, tdir, _, _, _ = both
    ids = np.random.default_rng(3).integers(0, VOCAB, size=(2, 10))
    jcfg, jparams, _ = jckpt.load_quantized(tdir)
    ref = JEngine(jcfg, jparams, backend="reference", max_seq=64).generate(
        ids, max_new_tokens=8)
    q = GanqModel.load(tdir, device="cpu")
    assert q.backend == "reference"
    np.testing.assert_array_equal(
        q.generate(ids, max_new_tokens=8, max_seq=64), np.asarray(ref))
    for li in range(2):
        for slot in SLOTS:
            fake = thf.get_module(g.model, li, slot)["weight"].numpy()
            w = tql.dequantize_weight(thf.get_module(q.model, li, slot)).numpy()
            np.testing.assert_allclose(w, fake, rtol=2**-10, atol=1e-7)
