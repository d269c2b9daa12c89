"""EoRA adapters of the port against ganq_tpu's, on the CPU.

The math (``adapter/eora.py``: the eigen-scaled SVD of a quantization error)
is compared by its product ``B @ A`` and its activation-weighted residual,
not by the factors: eigenvectors and singular vectors have free signs. The
rank-r term ``(x @ A^T) @ B^T`` rides every linear kind and every recode,
and fuses block-diagonally with q/k/v and gate/up. The quantize loop with an
adapter rank, the post-quant ``generate_eora`` flow, the PEFT adapter files
and the routing gates of the fused kernels are held against ganq_tpu's on
the tiny llamas of ``tests/test_torch_quantize.py`` and
``tests/test_torch_serve.py``; the slice as a whole (load, eora_generate,
save, load, optimize, greedy generate) gives ganq_tpu's greedy tokens.
"""

import json
import os

import numpy as np
import pytest
import torch

os.environ.setdefault("USE_TF", "0")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ganq_tpu.adapter.eora import apply_lora as japply_lora  # noqa: E402
from ganq_tpu.adapter.eora import compute_eora as jcompute_eora  # noqa: E402
from ganq_tpu.api import GanqModel as JGanqModel  # noqa: E402
from ganq_tpu.api import prepare_dataset as jprepare  # noqa: E402
from ganq_tpu.core.config import QuantizeConfig as JQuantizeConfig  # noqa: E402
from ganq_tpu.formats import checkpoint as jckpt  # noqa: E402
from ganq_tpu.models import hf_import as jhf  # noqa: E402
from ganq_tpu.models import transformer as jtr  # noqa: E402
from ganq_tpu.models.registry import get_spec as jget_spec  # noqa: E402
from ganq_tpu.ops import qlinear as jql  # noqa: E402
from ganq_tpu.quant.looper import quantize_model as jquantize_model  # noqa: E402
from ganq_tpu_torch import GanqModel  # noqa: E402
from ganq_tpu_torch.adapter.eora import apply_lora, compute_eora  # noqa: E402
from ganq_tpu_torch.adapter.eora import compute_eora_full  # noqa: E402
from ganq_tpu_torch.core.config import QuantizeConfig  # noqa: E402
from ganq_tpu_torch.formats import checkpoint as tckpt  # noqa: E402
from ganq_tpu_torch.formats.safetensors_io import load_file  # noqa: E402
from ganq_tpu_torch.models import hf_import as thf  # noqa: E402
from ganq_tpu_torch.models import transformer as ttr  # noqa: E402
from ganq_tpu_torch.models.registry import get_spec  # noqa: E402
from ganq_tpu_torch.ops import qlinear as tql  # noqa: E402
from ganq_tpu_torch.ops.packing import pack_int_rows  # noqa: E402
from ganq_tpu_torch.quant.eora_flow import generate_eora  # noqa: E402

from test_torch_quantize import QCFG, VOCAB, _rows, dense  # noqa: E402,F401
from test_torch_packing import torch_threads_per_worker  # noqa: F401

SLOTS = ("attn.q", "attn.k", "attn.v", "attn.o", "mlp.gate", "mlp.up",
         "mlp.down")


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _ba(a, b):
    """B @ A in float64 from either package's factors."""
    return np.asarray(b, np.float64) @ np.asarray(a, np.float64)


# ------------------------------------------------------------------ math
@pytest.mark.parametrize("negative", [False, True])
def test_compute_eora_matches_jax(negative):
    """``compute_eora`` against ganq_tpu's on a rank-4 error plus noise
    (sigma_4 / sigma_5 > 10, so the rank-4 subspace is well defined): B @ A
    within 1e-4 of its largest entry, the weighted residual ||(delta - B A)
    X|| within 1e-4 relative, and below a tenth of ||delta X||. With
    ``negative`` the covariance has a negative eigenvalue, clamped to the
    least positive one in both packages."""
    rng = np.random.default_rng(11)
    m, n, r = 24, 32, 4
    delta = (rng.normal(size=(m, r)) @ rng.normal(size=(r, n))
             + 1e-2 * rng.normal(size=(m, n))).astype(np.float32)
    X = rng.normal(size=(n, 128)).astype(np.float32)
    cov = (X @ X.T / 128).astype(np.float32)
    if negative:
        L, Q = np.linalg.eigh(cov.astype(np.float64))
        L[0] = -0.5
        cov = (Q @ np.diag(L) @ Q.T).astype(np.float32)
    jA, jB = jcompute_eora(jnp.asarray(delta), jnp.asarray(cov), r)
    tA, tB = compute_eora(torch.from_numpy(delta), torch.from_numpy(cov), r)
    assert tA.shape == (r, n) and tB.shape == (m, r)
    assert tA.dtype == tB.dtype == torch.float32
    _, S, _, _ = compute_eora_full(torch.from_numpy(delta),
                                   torch.from_numpy(cov))
    assert float(S[r - 1] / S[r]) > 10
    got, want = _ba(tA, tB), _ba(jA, jB)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    d64 = delta.astype(np.float64)
    res_t = np.linalg.norm((d64 - got) @ X)
    res_j = np.linalg.norm((d64 - want) @ X)
    assert abs(res_t - res_j) <= 1e-4 * res_j
    assert res_t < 0.1 * np.linalg.norm(d64 @ X)


def _uniform_pair(rng, out_f, in_f, bits, rank, lora=True):
    """A symmetric uniform g128 linear with (or without) an adapter in
    both packages: (jax QLinear, port QLinear)."""
    codes = rng.integers(0, 2 ** bits, size=(out_f, in_f))
    scales = rng.uniform(1e-3, 4e-3, size=(out_f, in_f // 128)).astype(
        np.float32)
    arrays = {"qweight": pack_int_rows(torch.from_numpy(codes), bits).numpy(),
              "scales": scales}
    if lora:
        arrays["lora_a"] = (rng.normal(size=(rank, in_f))
                            / np.sqrt(in_f)).astype(np.float32)
        arrays["lora_b"] = (rng.normal(size=(out_f, rank)) * 1e-2).astype(
            np.float32)
    return (jql.QLinear("uniform", {k: jnp.asarray(v)
                                    for k, v in arrays.items()}, bits, in_f),
            tql.QLinear("uniform", {k: torch.from_numpy(v)
                                    for k, v in arrays.items()},
                        bits=bits, in_features=in_f))


def _lut_pair(rng, out_f, in_f, bits, rank, affine=False):
    """A ``lut`` linear (free or affine-grid codebooks) with an adapter."""
    k = 1 << bits
    if affine:
        lut = (rng.uniform(1e-3, 4e-3, size=(out_f, 1))
               * (np.arange(k) - k // 2)[None, :]).astype(np.float32)
    else:
        lut = np.sort(rng.normal(size=(out_f, k)), axis=1).astype(np.float32)
    codes = rng.integers(0, k, size=(out_f, in_f))
    lut_bf = torch.from_numpy(lut).to(torch.bfloat16)
    arrays = {"lut": lut_bf,
              "idx_packed": pack_int_rows(torch.from_numpy(codes), bits),
              "lora_a": torch.from_numpy((rng.normal(size=(rank, in_f))
                                          / np.sqrt(in_f)).astype(np.float32)),
              "lora_b": torch.from_numpy((rng.normal(size=(out_f, rank))
                                          * 1e-2).astype(np.float32))}
    jarr = {k_: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
            if k_ == "lut" else jnp.asarray(v.numpy())
            for k_, v in arrays.items()}
    return (jql.QLinear("lut", jarr, bits, in_f),
            tql.QLinear("lut", arrays, bits=bits, in_features=in_f))


def test_apply_concat_and_recodes_carry_the_adapter_as_jax():
    """``apply`` adds ``(x A^T) B^T`` before the bias, as ganq_tpu's does
    (float32 within 1e-6 of the scale); ``concat_rows`` fuses adapters
    block-diagonally (A rows stacked, B block-diagonal: ganq_tpu's arrays
    exactly) and raises on a mix of adapted and plain linears, as
    ganq_tpu's does; ``w8_to_uniform8``, ``recode_uniform8``,
    ``recode_uniform4`` and ``certify_uniform`` carry the adapter as
    ganq_tpu's do. ganq_tpu's ``recode_w8`` drops it (ROADMAP.md queue C);
    the port's carries it, so ``optimize("w8")`` keeps the adapters."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 2, 256)).astype(np.float32)
    pairs = [_uniform_pair(rng, n, 256, 4, 4) for n in (256, 128, 128)]
    for jp, tp in pairs:
        want = _np(jql.apply(jp, jnp.asarray(x)))
        got = tql.apply(tp, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        np.testing.assert_allclose(
            apply_lora(torch.from_numpy(x), tp["lora_a"], tp["lora_b"]).numpy(),
            _np(japply_lora(jnp.asarray(x), jp["lora_a"], jp["lora_b"])),
            rtol=1e-5, atol=1e-7)
    jf = jql.concat_rows([p[0] for p in pairs])
    tf = tql.concat_rows([p[1] for p in pairs])
    assert sorted(tf._buffers) == sorted(jf.arrays)
    for k, v in jf.arrays.items():
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(v), err_msg=k)
    assert tuple(tf["lora_b"].shape) == (512, 12)
    plain = _uniform_pair(rng, 128, 256, 4, 4, lora=False)
    with pytest.raises(ValueError, match="adapted"):
        jql.concat_rows([pairs[0][0], plain[0]])
    with pytest.raises(ValueError, match="adapted"):
        tql.concat_rows([pairs[0][1], plain[1]])

    cases = {"recode_uniform8": _lut_pair(rng, 64, 256, 4, 4),
             "recode_uniform4": _lut_pair(rng, 64, 256, 3, 4),
             "certify_uniform": _lut_pair(rng, 64, 256, 4, 4, affine=True)}
    for name, (jp, tp) in cases.items():
        jr, tr = getattr(jql, name)(jp), getattr(tql, name)(tp)
        assert jr.kind == tr.kind == "uniform", name
        for k in ("lora_a", "lora_b"):
            np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]))
    jw8, tw8 = jql.recode_w8(cases["recode_uniform8"][0]), \
        tql.recode_w8(cases["recode_uniform8"][1])
    assert "lora_a" not in jw8.arrays and "lora_a" in tw8
    ju8, tu8 = jql.w8_to_uniform8(jw8), tql.w8_to_uniform8(tw8)
    assert ju8.kind == tu8.kind == "uniform" and "lora_b" in tu8
    jw8.arrays.update(lora_a=jnp.asarray(tw8["lora_a"].numpy()),
                      lora_b=jnp.asarray(tw8["lora_b"].numpy()))
    np.testing.assert_array_equal(
        tql.w8_to_uniform8(tw8)["lora_b"].numpy(),
        np.asarray(jql.w8_to_uniform8(jw8)["lora_b"]))


# ------------------------------------------------------------ quantize
EORA_RANK = 4


@pytest.fixture(scope="module")
def both_eora(dense, tmp_path_factory):
    """The port's and ganq_tpu's quantization of the tiny llama with an
    adapter rank: (port GanqModel after quantize, its saved directory, JAX
    output, JAX saved directory, JAX config)."""
    d, hf_config, model = dense
    qcfg = dict(QCFG, ganq_iterations=1, adapter={"rank": EORA_RANK})
    g = GanqModel.load(d, QuantizeConfig(**qcfg), device="cpu")
    g.quantize(_rows(), batch_size=2)
    saved = str(tmp_path_factory.mktemp("port_eora"))
    g.save(saved)
    jcfg, jparams = jhf.params_from_torch_model(model)
    jout = jquantize_model(jcfg, jparams, jget_spec("llama"),
                           JQuantizeConfig(**qcfg),
                           jprepare(_rows(), None, batch_size=2))
    jsaved = str(tmp_path_factory.mktemp("jax_eora"))
    jckpt.save_quantized(jsaved, hf_config, JQuantizeConfig(**qcfg),
                         jout.params, jout.artifacts, jout.log)
    return g, saved, jout, jsaved, jcfg


def test_quantize_with_adapter_matches_jax(both_eora):
    """``quantize`` with ``adapter={"rank": 4}``: every module gets a rank-4
    adapter; codes equal ganq_tpu's on layer 0 and agree at >= 0.99 on
    layer 1 (which calibrates on layer 0's corrected outputs), B @ A within
    2e-2 of its largest entry (float32 eigh/SVD of two libraries on the
    solvers' slightly different errors), and the fake-quantized models'
    logits (W_q + B A) within 1e-2 of ganq_tpu's largest."""
    g, _, jout, _, jcfg = both_eora
    arts = g._quant_output.artifacts
    assert sorted(arts) == sorted(jout.artifacts) and len(arts) == 14
    for name, ja in jout.artifacts.items():
        ta = arts[name]
        assert tuple(ta.lora_a.shape) == tuple(ja.lora_a.shape)
        assert ta.lora_a.shape[0] == EORA_RANK
        agree = np.mean(ta.idx.numpy() == np.asarray(ja.idx))
        assert agree == 1.0 if ".0." in name else agree >= 0.99, (name, agree)
        want = _ba(ja.lora_a, ja.lora_b)
        np.testing.assert_allclose(_ba(ta.lora_a, ta.lora_b), want, rtol=0,
                                   atol=2e-2 * np.abs(want).max(),
                                   err_msg=name)
    assert all("eora" in e.extra for e in g._quant_output.log)
    ids = np.random.default_rng(4).integers(0, VOCAB, size=(2, 12))
    want = _np(jtr.forward(jcfg, jout.params, jnp.asarray(ids)))
    got = ttr.forward(g.cfg, g.model, torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


def test_resume_keeps_the_adapters(dense, tmp_path):
    """With an adapter rank the per-layer resume files hold each module's
    ``lora_a``/``lora_b`` (the JAX package's npz layout), and a resumed run
    restores them, and the corrected weights, without solving again."""
    d, _, _ = dense
    qcfg = QuantizeConfig(**dict(QCFG, ganq_iterations=1,
                                 adapter={"rank": 2}))
    a = GanqModel.load(d, qcfg, device="cpu")
    a.quantize(_rows()[:2], batch_size=2, resume_dir=str(tmp_path))
    blob = np.load(os.path.join(tmp_path, "layer_0.npz"))
    assert "model.layers.0.mlp.down_proj::lora_b" in blob.files
    b = GanqModel.load(d, qcfg, device="cpu")
    assert b.quantize(_rows()[:2], batch_size=2,
                      resume_dir=str(tmp_path)) == []
    for name, art in a._quant_output.artifacts.items():
        got = b._quant_output.artifacts[name]
        assert torch.equal(got.lora_a, art.lora_a), name
        assert torch.equal(got.lora_b, art.lora_b), name
    assert torch.equal(thf.get_module(b.model, 1, "mlp.up")["weight"],
                       thf.get_module(a.model, 1, "mlp.up")["weight"])


def test_adapter_files_load_across_packages(both_eora):
    """Either package's saved directory holds ``adapter_model.safetensors``
    with the same PEFT keys (``base_model.model.{module}.lora_A.weight``
    [r, in] and ``lora_B.weight`` [out, r], fp16) and an equal
    ``adapter_config.json``; each loads in the other with the adapters
    attached in float32, equal to the file's values."""
    _, saved, _, jsaved, _ = both_eora
    tfile = load_file(os.path.join(saved, "adapter_model.safetensors"))
    jfile = load_file(os.path.join(jsaved, "adapter_model.safetensors"))
    assert sorted(tfile) == sorted(jfile) and len(tfile) == 28
    assert all(v.dtype == torch.float16 for v in tfile.values())
    assert "base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight" \
        in tfile
    with open(os.path.join(saved, "adapter_config.json")) as f:
        tconf = json.load(f)
    with open(os.path.join(jsaved, "adapter_config.json")) as f:
        jconf = json.load(f)
    assert tconf == jconf
    assert tconf["r"] == EORA_RANK and tconf["peft_type"] == "LORA"
    spec = get_spec("llama")
    for src, files in ((jsaved, jfile), (saved, tfile)):
        _, tmodel, _ = tckpt.load_quantized(src, device="cpu")
        _, jparams, _ = jckpt.load_quantized(src)
        for li in range(2):
            for mod, slot in spec.module_slots.items():
                prefix = tckpt._hf_module_prefix(spec, li, mod)
                for ab in ("A", "B"):
                    want = files[f"base_model.model.{prefix}.lora_{ab}.weight"]
                    tm = thf.get_module(tmodel, li, slot)
                    jm = jhf.get_module(jparams, li, slot)
                    key = f"lora_{ab.lower()}"
                    assert tm[key].dtype == torch.float32
                    np.testing.assert_array_equal(tm[key].numpy(),
                                                  want.float().numpy())
                    np.testing.assert_array_equal(np.asarray(jm[key]),
                                                  want.float().numpy())


# ----------------------------------------------------- post-quant flow
@pytest.fixture(scope="module")
def dense128(tmp_path_factory):
    """(dense directory, hf_config, transformers model) of a 2-layer llama
    at hidden 128 (``optimize()``'s 8-bit recode needs 128-multiple
    widths to keep an adapter in ganq_tpu: below them it goes through
    ``recode_w8``, which drops it)."""
    import transformers as hf

    from ganq_tpu_torch.formats.safetensors_io import save_file

    hf_cfg = hf.LlamaConfig(
        vocab_size=VOCAB, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128)
    torch.manual_seed(17)
    model = hf.LlamaForCausalLM(hf_cfg)
    d = str(tmp_path_factory.mktemp("dense128"))
    save_file({k: v.detach() for k, v in model.state_dict().items()},
              os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(model.config.to_dict(), f)
    return d, model.config.to_dict(), model


@pytest.fixture(scope="module")
def ganq3(dense128, tmp_path_factory):
    """A 3-bit GANQ checkpoint of :func:`dense128` (no adapters; written by
    the port, which ganq_tpu loads: ``tests/test_torch_serve.py`` holds the
    format across the packages) and its calibration batches."""
    d, _, _ = dense128
    g = GanqModel.load(d, QuantizeConfig(**dict(QCFG, bits=3,
                                                ganq_iterations=1)),
                       device="cpu")
    g.quantize(_rows(), batch_size=2)
    out = str(tmp_path_factory.mktemp("ganq3"))
    g.save(out)
    return out, jprepare(_rows(), None, batch_size=2)


@pytest.fixture(scope="module")
def jax_eora8(dense128, ganq3, tmp_path_factory):
    """ganq_tpu's ``GanqModel.eora_generate`` (rank 8, the test rows in
    batches of 2) on a copy of the 3-bit checkpoint, its adapters saved
    beside it: (the adapted model, its directory, the modules it adapted).
    The post-quant flow and the slice test both hold the port to it."""
    import shutil

    _, _, model = dense128
    ckpt, _ = ganq3
    jdir = str(tmp_path_factory.mktemp("jax_eora8"))
    shutil.copytree(ckpt, jdir, dirs_exist_ok=True)
    j = JGanqModel.load(jdir)
    done = j.eora_generate(model, _rows(), rank=8, batch_size=2,
                           save_adapter_to=jdir)
    return j, jdir, done


def test_generate_eora_matches_jax(dense128, ganq3, jax_eora8):
    """``generate_eora`` on the saved 3-bit checkpoint: both packages adapt
    the same 14 modules; B @ A within 2e-2 of the largest entry of
    ganq_tpu's; the logits' error to the float model falls, by about as
    much as ganq_tpu's adapters lower it (within 10%; both errors through
    the port's reference forward, held to ganq_tpu's elsewhere)."""
    _, _, model = dense128
    ckpt, batches = ganq3
    j, _, jdone = jax_eora8
    jq = j.params
    tcfg, tq, _ = tckpt.load_quantized(ckpt, device="cpu")
    _, tfp = thf.params_from_state_dict(
        {k: v.detach() for k, v in model.state_dict().items()},
        model.config.to_dict(), device="cpu")
    ids = np.random.default_rng(8).integers(0, VOCAB, size=(2, 16))
    ref = ttr.forward(tcfg, tfp, torch.as_tensor(ids)).numpy()
    before = np.mean((ttr.forward(tcfg, tq, torch.as_tensor(ids)).numpy()
                      - ref) ** 2)
    timings = {}
    done = generate_eora(tcfg, tfp, tq, get_spec("llama"), 8, batches,
                         timings)
    assert done == jdone and len(done) == 14
    assert set(timings) == {"cov", "eigh", "svd", "rest"}
    for li in range(2):
        for slot in SLOTS:
            tm, jm = thf.get_module(tq, li, slot), jhf.get_module(jq, li, slot)
            want = _ba(jm["lora_a"], jm["lora_b"])
            np.testing.assert_allclose(_ba(tm["lora_a"], tm["lora_b"]), want,
                                       rtol=0, atol=2e-2 * np.abs(want).max(),
                                       err_msg=f"{li} {slot}")
    after = np.mean((ttr.forward(tcfg, tq, torch.as_tensor(ids)).numpy()
                     - ref) ** 2)
    _, jmodel, _ = tckpt.load_quantized(ckpt, device="cpu")
    for li in range(2):
        for slot in SLOTS:
            jm = jhf.get_module(jq, li, slot)
            for k in ("lora_a", "lora_b"):
                thf.get_module(jmodel, li, slot).register_buffer(
                    k, torch.from_numpy(np.asarray(jm[k], np.float32)))
    jafter = np.mean((ttr.forward(tcfg, jmodel, torch.as_tensor(ids)).numpy()
                      - ref) ** 2)
    assert after < before
    assert abs(after - jafter) <= 0.1 * (before - jafter)


def test_eora_slice_greedy_matches_jax(dense128, ganq3, jax_eora8, tmp_path):
    """The slice end to end in both packages: load the 3-bit checkpoint,
    ``eora_generate(fp_model, calib, rank=8, save_adapter_to=...)``, load
    again (the adapters attached from the saved files), ``optimize()``,
    greedy generate: equal tokens. The API's checks are ganq_tpu's: a
    RuntimeError on an unquantized model, a ValueError on an fp model of
    another hidden size."""
    import shutil
    import transformers as hf

    d, _, model = dense128
    ckpt, _ = ganq3
    _, jdir, jdone = jax_eora8
    calib = _rows()
    tdir = str(tmp_path / "port")
    shutil.copytree(ckpt, tdir)
    q = GanqModel.load(tdir, device="cpu")
    with pytest.raises(RuntimeError, match="quantized"):
        GanqModel.load(d, QuantizeConfig(), device="cpu").eora_generate(
            model, calib)
    other = hf.LlamaForCausalLM(hf.LlamaConfig(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1))
    with pytest.raises(ValueError, match="does not match"):
        q.eora_generate(other, calib)
    done = q.eora_generate(d, calib, rank=8, batch_size=2,
                           save_adapter_to=tdir)
    assert len(done) == 14 and len(jdone) == 14
    q2 = GanqModel.load(tdir, device="cpu").optimize()
    j2 = JGanqModel.load(jdir).optimize()
    lin = thf.get_module(q2.model, 0, "attn.q")
    assert lin.kind == "uniform" and "lora_a" in lin
    assert "lora_a" in jhf.get_module(j2.params, 0, "attn.q").arrays
    ids = np.random.default_rng(12).integers(0, VOCAB, size=(2, 10))
    want = np.asarray(j2.generate(ids, max_new_tokens=6, max_seq=64))
    np.testing.assert_array_equal(
        q2.generate(ids, max_new_tokens=6, max_seq=64), want)


# ------------------------------------------------------------- routing
def _add_lora(jparams, tmodel, slots, rank=4, seed=21):
    """The same random rank-``rank`` adapter on ``slots`` of every layer of
    ganq_tpu's params and the port's model."""
    rng = np.random.default_rng(seed)
    for li, lp in enumerate(jparams["layers"]):
        for slot in slots:
            jm = jhf.get_module(jparams, li, slot)
            out_f, in_f = jql.dequantize_weight(jm).shape
            a = (rng.normal(size=(rank, in_f)) / np.sqrt(in_f)).astype(
                np.float32)
            b = (rng.normal(size=(out_f, rank)) * 5e-2).astype(np.float32)
            jm.arrays.update(lora_a=jnp.asarray(a), lora_b=jnp.asarray(b))
            tm = thf.get_module(tmodel, li, slot)
            tm.register_buffer("lora_a", torch.from_numpy(a))
            tm.register_buffer("lora_b", torch.from_numpy(b))


@pytest.mark.parametrize("kind,slots", [
    ("w8", ()), ("w8", ("attn.q", "attn.k", "attn.v")), ("w8", ("attn.o",)),
    ("w8", ("mlp.gate", "mlp.up", "mlp.down")), ("uniform", ()),
    ("uniform", SLOTS), ("uniform", ("attn.q", "attn.k", "attn.v",
                                     "mlp.gate", "mlp.up", "mlp.down"))])
def test_fused_kernel_gates_refuse_adapters_as_jax(kind, slots):
    """The gates of the fused kernels on adapted models, against ganq_tpu's
    (2-layer head_dim-128 llamas): kernel 12 (``megastep_fusable``) refuses
    an adapter on q/k/v or the MLP and kernel 11 (``attn_half_fusable``) on
    q/k/v, and the transposed o both need exists only for an o without
    adapter; kernel 13
    (``megastep4_fusable``) refuses any adapter; kernel 14
    (``megastep_lowbit_fusable``) takes adapters on all four projections
    and refuses a partial set. The port's gate gives ganq_tpu's answer in
    every case."""
    from ganq_tpu.ops import megastep as jm12
    from ganq_tpu.ops import megastep4 as jm13
    from ganq_tpu.ops import megastep_lowbit as jm14
    from ganq_tpu.ops.fused_layer import attn_half_fusable as jahf
    from ganq_tpu.serve import stacked as jst

    from ganq_tpu_torch.ops import megastep as tm12
    from ganq_tpu_torch.ops import megastep4 as tm13
    from ganq_tpu_torch.ops import megastep_lowbit as tm14
    from ganq_tpu_torch.ops.fused_layer import attn_half_fusable as tahf
    from ganq_tpu_torch.serve import stacked as tst
    from test_torch_serve import _affine_model, _port_cfg

    jcfg, jparams, tmodel = _affine_model((kind,) * 2, 256, 2)
    _add_lora(jparams, tmodel, slots)
    tcfg = _port_cfg(256, 2)
    sp, tsp = jst.stack_layers(jparams), tst.stack_layers(tmodel)
    if kind == "w8":
        got = (tm12.megastep_fusable(tcfg, tsp),
               tahf(tcfg, tst.fuse_layer(tmodel.layers[0])))
        want = (jm12.megastep_fusable(jcfg, sp),
                jahf(jcfg, jst.fuse_layer(jparams["layers"][0])))
        attn = any(sl.startswith("attn.") for sl in slots)
        assert got == want == (not slots, not attn)
    else:
        got = (tm13.megastep4_fusable(tcfg, tsp),
               tm14.megastep_lowbit_fusable(tcfg, tsp, 4))
        want = (jm13.megastep4_fusable(jcfg, sp),
                jm14.megastep_lowbit_fusable(jcfg, sp, 4))
        assert got == want == (not slots, len(slots) in (0, len(SLOTS)))


def test_moe_kernel_refuses_adapters_as_jax():
    """Kernel 15's gate (``moe_mega_fusable``) refuses an expert with an
    adapter, as ganq_tpu's does."""
    from ganq_tpu.ops.moe_expert import moe_mega_fusable as jfusable

    from ganq_tpu_torch.ops.moe_expert import moe_mega_fusable as tfusable
    from test_torch_moe import _cfgs, _experts

    jcfg, tcfg = _cfgs(4, 256, 512, 2)
    jmoe, tmoe = _experts(np.random.default_rng(2), 4, 256, 512, 4)
    assert tfusable(tcfg, tmoe, 4) == jfusable(jcfg, jmoe, 4) is True
    a = np.full((4, 256), 1e-2, np.float32)
    b = np.full((512, 4), 1e-2, np.float32)
    jmoe["experts"][1]["gate"].arrays.update(lora_a=jnp.asarray(a),
                                             lora_b=jnp.asarray(b))
    tg = tmoe["experts"][1]["gate"]
    tg.register_buffer("lora_a", torch.from_numpy(a))
    tg.register_buffer("lora_b", torch.from_numpy(b))
    assert tfusable(tcfg, tmoe, 4) == jfusable(jcfg, jmoe, 4) is False


def test_fused_mlp_keeps_the_adapter_where_jax_drops_it(monkeypatch):
    """Kernel 9 (the fused W8A8 MLP) has no adapter or bias operand.
    ganq_tpu's gate reads only the kinds (``models/transformer.py:
    1214-1220``), so its ``pallas_a8`` layer (interpret mode) drops the MLP
    adapters: its output equals the same layer's without them. The port's
    gate refuses a ``w8`` MLP with an adapter or a bias, so ``"cuda_a8"``
    serves it through the int8 linears with the rank-r term: within the
    int8 activations' error of the reference, and kernel 9 (and kernels 10
    and 11, opted in) never runs on it. ROADMAP.md queue C."""
    from jax.experimental.pallas import tpu as pltpu

    from ganq_tpu_torch.models import transformer as ttf
    from ganq_tpu_torch.serve import engine as teng
    from test_torch_serve import _affine_model, _port_cfg

    jcfg, jparams, tmodel = _affine_model(("w8",) * 2, 256, 2)
    _, jbare, _ = _affine_model(("w8",) * 2, 256, 2)
    _add_lora(jparams, tmodel, ("mlp.gate", "mlp.up", "mlp.down"))
    tcfg = _port_cfg(256, 2)
    rng = np.random.default_rng(3)
    b, s = 2, 4
    x = (rng.normal(size=(b, s, 256)) * 0.5).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(s), (b, s))

    def jlayer(params, backend):
        import functools

        from ganq_tpu.serve.stacked import fuse_layer
        lp = fuse_layer(params["layers"][0])
        rope = jtr.rope_for_layer(jcfg, jtr.rope_tables_all(jcfg, pos), 0)
        fn = jax.jit(functools.partial(jtr.layer_forward, jcfg,
                                       backend=backend))
        with pltpu.force_tpu_interpret_mode():
            y = jax.block_until_ready(fn(lp, jnp.asarray(x),
                                         jtr.causal_mask(s, s), rope)[0])
        return _np(y)

    jk9, jbare_k9 = jlayer(jparams, "pallas_a8"), jlayer(jbare, "pallas_a8")
    jref = jlayer(jparams, "reference")
    np.testing.assert_array_equal(jk9, jbare_k9)        # the adapter is lost
    effect = np.abs(jref - jlayer(jbare, "reference")).max()
    assert np.abs(jk9 - jref).max() > 0.5 * effect

    called = []
    for name in ("fused_mlp_w8a8", "fused_qkv_rope_w8a8",
                 "attn_half_decode_w8a8"):
        monkeypatch.setattr(ttf, name, lambda *a, _f=getattr(ttf, name),
                            _n=name, **k: (called.append(_n), _f(*a, **k))[1])
    monkeypatch.setenv("GANQ_FUSED_QKV", "1")
    monkeypatch.setenv("GANQ_FUSED_LAYER", "1")
    from ganq_tpu_torch.serve import stacked as tst
    tlp = tst.fuse_layer(tmodel.layers[0])
    rope = ttf.rope_tables(tcfg, torch.arange(s).expand(b, s))
    xt = torch.from_numpy(x)
    ta8 = ttf.layer_forward(tcfg, tlp, xt, None, rope, backend="cuda_a8")
    tref = ttf.layer_forward(tcfg, tlp, xt, None, rope)
    assert not called
    np.testing.assert_allclose(ta8.numpy(), jref, rtol=0, atol=0.1 * effect)
    np.testing.assert_allclose(tref.numpy(), jref, rtol=0,
                               atol=1e-4 * np.abs(jref).max())

    def decode(model):
        cache = teng.init_cache(tcfg, b, 16, "cpu")
        sp = tst.stack_layers(model)
        for p in range(2):
            teng.decode_step(tcfg, sp, cache, torch.tensor([1, 2]),
                             torch.tensor(p), "cuda_a8")

    # decode steps with a cache, where kernels 9-11 would engage: the
    # adapted MLP keeps kernels 9 and 11 off (kernel 10 runs on the plain
    # q/k/v), and adapters on q/k/v keep kernel 10 off as well
    decode(tmodel)
    assert set(called) == {"fused_qkv_rope_w8a8"}
    called.clear()
    _add_lora(jparams, tmodel, ("attn.q", "attn.k", "attn.v"), seed=22)
    decode(tmodel)
    assert not called
    # a bias on down alone also keeps kernel 9 off
    _, _, plain = _affine_model(("w8",) * 2, 256, 2)
    dn = plain.layers[0].mlp["down"]
    dn.register_buffer("bias", torch.zeros(256))
    ttf.layer_forward(tcfg, tst.fuse_layer(plain.layers[0]), xt, None, rope,
                      backend="cuda_a8")
    assert not called
    del dn._buffers["bias"]
    ttf.layer_forward(tcfg, tst.fuse_layer(plain.layers[0]), xt, None, rope,
                      backend="cuda_a8")
    assert called == ["fused_mlp_w8a8"]
