"""Mixtral serving and the fused expert kernel (kernel 15,
``ops/moe_expert.py``) of the port against ``ganq_tpu``.

Experts are made with numpy and carried into both packages. The port's
``moe_megapack`` must equal ganq_tpu's byte for byte; its plain
``moe_expert_plain`` is held to ganq_tpu's ``moe_expert_decode`` in
interpret mode (the cases of ``tests/test_moe_kernel.py:54-60``), routing
to ganq_tpu's ``_moe_forward`` / ``_moe_combine``, and a 2-layer Mixtral
that ganq_tpu quantized and saved decodes the same greedy tokens in both
packages through the kernel (``GANQ_MOE_MEGA=1``)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ganq_tpu.models import transformer as jtr
from ganq_tpu.ops import moe_expert as jmoe
from ganq_tpu.ops import qlinear as jql
from ganq_tpu_torch.models import transformer as ttr
from ganq_tpu_torch.models.transformer import Pack
from ganq_tpu_torch.ops import moe_expert as tmoe
from ganq_tpu_torch.ops import qlinear as tql
from ganq_tpu_torch.ops.packing import pack_int_rows as tpack

from test_torch_fused_w8a8 import assert_kernel_close
from test_torch_megastep import _t


def _cfgs(E, H, I, k):
    """(jax, port) ModelConfig of a 1-layer Mixtral-shaped MoE."""
    jcfg = jtr.ModelConfig(
        model_type="mixtral", vocab_size=64, hidden_size=H,
        intermediate_size=I, num_hidden_layers=1, num_attention_heads=4,
        num_key_value_heads=4, head_dim=H // 4, num_experts=E,
        num_experts_per_tok=k)
    tcfg = ttr.ModelConfig(
        model_type="mixtral", vocab_size=64, hidden_size=H,
        intermediate_size=I, num_hidden_layers=1, num_attention_heads=4,
        num_key_value_heads=4, head_dim=H // 4, num_experts=E,
        num_experts_per_tok=k)
    return jcfg, tcfg


def _experts(rng, E, H, I, bits):
    """A MoE layer (dense float32 router, symmetric uniform experts with
    128-column groups and scales capped as ``tests/test_moe_kernel.py``
    makes them) in both packages: (jax moe dict, port moe dict)."""
    jexp, texp = [], []
    for _ in range(E):
        je, te = {}, {}
        for name, (out_f, in_f) in (("gate", (I, H)), ("up", (I, H)),
                                    ("down", (H, I))):
            qidx = rng.integers(0, 2 ** bits, size=(out_f, in_f)).astype(
                np.int32)
            scales = (rng.uniform(0.002, 0.008, size=(out_f, in_f // 128))
                      * min(1.0, 16.0 / (1 << bits))).astype(np.float32)
            # the port's packer gives ganq_tpu's bytes
            # (tests/test_torch_packing.py)
            qweight = tpack(torch.from_numpy(qidx), bits)
            je[name] = jql.QLinear("uniform", {
                "qweight": jnp.asarray(qweight.numpy()),
                "scales": jnp.asarray(scales)}, bits, in_f)
            te[name] = tql.QLinear("uniform", {
                "qweight": qweight, "scales": torch.from_numpy(scales)},
                bits, in_f)
        jexp.append(je)
        texp.append(te)
    router = rng.normal(size=(E, H)).astype(np.float32)
    return ({"router": jql.dense_linear(jnp.asarray(router)),
             "experts": jexp},
            {"router": tql.dense_linear(torch.from_numpy(router)),
             "experts": texp})


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# E, H, I, B, k, bits: tests/test_moe_kernel.py:54-60
_CASES = [(4, 256, 512, 8, 2, 4),
          (8, 256, 512, 2, 2, 4),      # S = B * k = 4 < E
          (4, 512, 8192, 4, 2, 4),     # NG = 2: two MLP tiles
          (4, 256, 512, 8, 2, 8),      # 8-bit experts
          (4, 256, 512, 3, 2, 4)]      # B below the TPU's row octet


@pytest.mark.parametrize("E,H,I,B,k,bits", _CASES)
def test_moe_expert_plain_matches_jax_interpret(E, H, I, B, k, bits):
    """``moe_megapack`` gives ganq_tpu's keys, shapes, types and bytes (bits
    4 and 8, one and two MLP tiles), and both gates agree; the plain
    version of kernel 15 against ganq_tpu's kernel in interpret mode on the
    same slots and weights (the top-S experts of random routing,
    zero-weight padding slots included), within one bf16 ulp plus 5e-3 of
    the largest output: both form the same integer group dots and float32
    operations in the same order, except the activation's exp, which XLA
    and PyTorch round differently in the last bit, so an int8 activation at
    a rounding tie may flip by one code."""
    rng = np.random.default_rng(100 + B + E)
    jm, tm = _experts(rng, E, H, I, bits)
    jcfg, tcfg = _cfgs(E, H, I, k)
    assert jmoe.moe_mega_fusable(jcfg, jm, bits)
    assert tmoe.moe_mega_fusable(tcfg, tm, bits)
    assert not tmoe.moe_mega_fusable(tcfg, tm, 12 - bits)
    jmp = jmoe.moe_megapack(jcfg, jm, bits)
    tmp = tmoe.moe_megapack(tcfg, tm, bits)
    assert sorted(tmp) == sorted(jmp)
    for key, v in jmp.items():
        assert tuple(tmp[key].shape) == v.shape, key
        assert tmp[key].dtype == _t(v[:1]).dtype, key
        np.testing.assert_array_equal(tmp[key].float().numpy(), _np(v),
                                      err_msg=key)
    x = (rng.normal(size=(B, H)) * 0.4).astype(np.float32)
    gated = np.zeros((B, E), np.float32)
    for b in range(B):
        sel = rng.choice(E, size=k, replace=False)
        gated[b, sel] = rng.dirichlet(np.ones(k)).astype(np.float32)
    slot_ids, wts = ttr.moe_slots(torch.from_numpy(gated), k)
    xb = jnp.asarray(x, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.block_until_ready(jmoe.moe_expert_decode(
            xb, jmp, jnp.asarray(slot_ids.numpy()), jnp.asarray(wts.numpy()),
            bits=bits, interpret=True))
    got = tmoe.moe_expert_decode(_t(xb), tmp, slot_ids, wts, bits=bits)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    assert_kernel_close(got.numpy(), np.asarray(ref), flips=5e-3,
                        what=f"E={E} I={I} B={B} bits={bits}")


@pytest.mark.parametrize("B,S", [(3, 1), (5, 4)])
def test_moe_routing_matches_jax(monkeypatch, B, S):
    """Mixtral's top-k softmax routing: the selection (ties included, a
    threshold) and the slot ids equal ganq_tpu's exactly; the renormalised
    weights and the slots' weights agree within 2 float32 ulps (XLA's and
    PyTorch's exp differ in the last bit on about a tenth of their
    inputs). Captured from ganq_tpu's ``_moe_combine`` and its kernel call
    and from the port's, on the same router logits."""
    E, H, I, k = 8, 256, 512, 2
    rng = np.random.default_rng(B * 10 + S)
    jm, tm = _experts(rng, E, H, I, 4)
    # integer-valued router operands: both frameworks' float32 logits exact
    router = rng.integers(-3, 4, size=(E, H)).astype(np.float32) / 8
    jm["router"] = jql.dense_linear(jnp.asarray(router))
    tm["router"] = tql.dense_linear(torch.from_numpy(router))
    jcfg, tcfg = _cfgs(E, H, I, k)
    jm["mega"], tm["mega"] = {}, Pack({})     # the kernels are stubbed
    h = rng.integers(-4, 5, size=(B, S, H)).astype(np.float32) / 16
    h[0, 0] = h[0, -1]          # two rows with tied routing
    got = {}

    def capture(name, fn):
        def wrapped(*a, **kw):
            got[name] = (a, kw)
            return fn(*a, **kw)
        return wrapped

    def record(name, zeros):
        def stub(x, *a, **kw):          # the kernels' values are held above
            got[name] = ((x, *a), kw)
            return zeros(x)
        return stub

    monkeypatch.setenv("GANQ_MOE_MEGA", "1")
    monkeypatch.setattr(jtr, "_moe_combine",
                        capture("j_combine", jtr._moe_combine))
    monkeypatch.setattr(jmoe, "moe_expert_decode",
                        record("j_kernel", lambda x: jnp.zeros(
                            x.shape, jnp.float32)))
    monkeypatch.setattr(ttr, "_moe_combine",
                        capture("t_combine", ttr._moe_combine))
    monkeypatch.setattr(tmoe, "moe_expert_decode",
                        record("t_kernel", torch.zeros_like))
    jax.block_until_ready(jtr._moe_forward(jcfg, jm, jnp.asarray(h), None,
                                           "pallas_a8"))
    ttr._moe_forward(tcfg, ttr.Layer(torch.ones(H), torch.ones(H), {}, {},
                                     moe=tm).moe, torch.from_numpy(h),
                     "cuda_a8")
    jsel, jgated = (np.asarray(v) for v in got["j_combine"][0][3:5])
    tsel, tgated = (v.numpy() for v in got["t_combine"][0][3:5])
    np.testing.assert_array_equal(tsel, jsel)
    assert (jsel.sum(-1) >= k).all()
    np.testing.assert_array_max_ulp(tgated, jgated, maxulp=2)
    jids, jw = (np.asarray(v) for v in got["j_kernel"][0][2:4])
    tids, tw = (v.numpy() for v in got["t_kernel"][0][2:4])
    assert len(tids) == min(E, B * S * k)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_max_ulp(tw, jw, maxulp=2)


def _mixtral_hf(layers=2, E=4, H=256, I=512, vocab=256):
    return {"model_type": "mixtral", "vocab_size": vocab, "hidden_size": H,
            "intermediate_size": I, "num_hidden_layers": layers,
            "num_attention_heads": 2, "num_key_value_heads": 2,
            "head_dim": 128, "max_position_embeddings": 128,
            "rms_norm_eps": 1e-5, "rope_theta": 1e6,
            "num_local_experts": E, "num_experts_per_tok": 2,
            "tie_word_embeddings": False}


@pytest.fixture(scope="module")
def jax_mixtral(tmp_path_factory):
    """A 2-layer Mixtral (E = 4, H = 256, I = 512, dense attention and
    router, 4-bit GANQ ``lut`` experts of random codebooks), saved by
    ganq_tpu's checkpoint writer."""
    from ganq_tpu.core.config import QUANT_METHOD as JQM
    from ganq_tpu.core.config import QuantizeConfig as JQuantizeConfig
    from ganq_tpu.formats import checkpoint as jckpt
    from ganq_tpu.quant.looper import QuantizedModule

    hf = _mixtral_hf()
    rng = np.random.default_rng(21)
    H, I, E, V = 256, 512, 4, 256

    def w(*shape, std=0.05):
        return jnp.asarray((rng.normal(size=shape) * std).astype(np.float32))

    params = {"embed_tokens": {"weight": w(V, H, std=0.3)},
              "final_norm": {"weight": jnp.ones((H,))},
              "lm_head": {"weight": w(V, H)}, "layers": []}
    arts = {}
    for i in range(2):
        params["layers"].append({
            "input_norm": {"weight": jnp.ones((H,))},
            "post_norm": {"weight": jnp.ones((H,))},
            "attn": {n: {"weight": w(*s)} for n, s in (
                ("q", (256, H)), ("k", (256, H)), ("v", (256, H)),
                ("o", (H, 256)))},
            "moe": {"router": {"weight": w(E, H, std=0.3)}}})
        for e in range(E):
            for mod, (out_f, in_f) in (("w1", (I, H)), ("w3", (I, H)),
                                       ("w2", (H, I))):
                lut = np.sort(rng.normal(size=(out_f, 16)) * 0.02, axis=1)
                arts[f"model.layers.{i}.block_sparse_moe.experts.{e}.{mod}"] = \
                    QuantizedModule(
                        method=JQM.GANQ, bits=4, group_size=-1,
                        lut=jnp.asarray(lut.astype(np.float32)),
                        idx=jnp.asarray(rng.integers(0, 16,
                                                     size=(out_f, in_f))))
    d = str(tmp_path_factory.mktemp("jax_mixtral"))
    jckpt.save_quantized(d, hf, JQuantizeConfig(bits=4, quant_method="ganq"),
                         params, arts)
    return d


def test_mixtral_greedy_matches_jax(jax_mixtral, tmp_path, monkeypatch):
    """The slice as a whole. The port loads ganq_tpu's Mixtral checkpoint
    (experts under the HF names, the router dense): the same config, router
    and expert codebooks, and a checkpoint the port writes from it holds
    the same tensors (the codebooks, held in bf16 by both packages, as the
    bf16 rounding of the stored fp16 ones). Both packages ``optimize()``
    it (the experts recoded to uniform 8-bit), each MoE layer gets kernel
    15's pack, and both decode on the int8-activation backends with
    ``GANQ_MOE_MEGA=1`` (ganq_tpu's Pallas kernels in interpret mode, the
    port's plain versions): the prefill (2 x 6 rows) and every decode step
    go through kernel 15; greedy tokens are equal."""
    from ganq_tpu.api import GanqModel as JGanqModel
    from ganq_tpu.formats import checkpoint as jckpt
    from ganq_tpu.serve.engine import Engine as JEngine
    from ganq_tpu_torch import GanqModel
    from ganq_tpu_torch.formats import checkpoint as tckpt
    from ganq_tpu_torch.formats.safetensors_io import load_file
    from ganq_tpu_torch.serve import engine as teng

    jcfg, jparams, _ = jckpt.load_quantized(jax_mixtral)
    g = GanqModel.load(jax_mixtral, device="cpu")
    assert (g.cfg.num_experts, g.cfg.num_experts_per_tok) == (4, 2)
    for jl, tl in zip(jparams["layers"], g.model.layers):
        np.testing.assert_array_equal(tl.moe["router"]["weight"].numpy(),
                                      np.asarray(jl["moe"]["router"]["weight"]))
        for je, te in zip(jl["moe"]["experts"], tl.moe["experts"]):
            for n in ("gate", "up", "down"):
                assert te[n].kind == je[n].kind == "lut"
                for key in ("lut", "idx_packed"):
                    np.testing.assert_array_equal(te[n][key].float().numpy(),
                                                  _np(je[n][key]))
    out = str(tmp_path / "port")
    tckpt.save_quantized(out, g._hf_config_dict(), g.qcfg, g.model)
    mine = load_file(f"{out}/model.safetensors")
    theirs = load_file(f"{jax_mixtral}/model.safetensors")
    assert sorted(mine) == sorted(theirs)
    for key, v in theirs.items():
        if key.endswith(".lut"):
            v = v.to(torch.bfloat16)
        np.testing.assert_array_equal(mine[key].float().numpy(),
                                      v.float().numpy(), err_msg=key)

    monkeypatch.setenv("GANQ_MOE_MEGA", "1")
    j = JGanqModel(jcfg, jparams, quantized=True).optimize()
    g.optimize()
    for jl, tl in zip(j.params["layers"], g.model.layers):
        assert tl.moe["experts"][0]["gate"].bits == 8
        jl["moe"]["mega"] = dict(jmoe.moe_megapack(j.cfg, jl["moe"], 8))
        tl.moe["mega"] = Pack(tmoe.moe_megapack(g.cfg, tl.moe, 8))
    eng = teng.Engine(g.cfg, g.model, device="cpu", max_seq=64)
    assert not eng.stacked                # MoE models stay per layer
    ids = np.random.default_rng(4).integers(0, 256, size=(2, 6))
    with torch.inference_mode():
        cache = teng.init_cache(g.cfg, 2, 64, "cpu")
        got = teng.generate_tokens(g.cfg, g.model, cache, torch.as_tensor(ids),
                                   None, 3, backend="cuda_a8").numpy()
    want = np.asarray(JEngine(j.cfg, j.params, max_seq=64,
                              backend="pallas_a8").generate(
        ids, max_new_tokens=3))
    np.testing.assert_array_equal(got, want)


def test_moe_models_refuse_what_comes_later():
    """Quantizing a MoE model, and routers other than Mixtral's top-k
    softmax, raise naming ROADMAP.md queue A item 6; the MoE layer serves
    per layer through the masked expert loop on the reference backend, the
    same result as the kernel's arithmetic within its int8 tolerance."""
    from ganq_tpu_torch.core.config import QuantizeConfig
    from ganq_tpu_torch.models import synthetic
    from ganq_tpu_torch.models.registry import get_spec
    from ganq_tpu_torch.quant.looper import quantize_model

    cfg = dataclasses.replace(
        synthetic.mixtral_8x7b_config(1), hidden_size=256,
        intermediate_size=512, num_attention_heads=2, num_key_value_heads=2,
        head_dim=128, vocab_size=64, num_experts=4)
    model = synthetic.make_model(cfg, kind="dense", device="cpu",
                                 dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="item 6"):
        quantize_model(cfg, model, get_spec("mixtral"), QuantizeConfig(),
                       [np.zeros((1, 4), np.int32)])
    moe = model.layers[0].moe
    moe["shared"] = moe["router"]
    with pytest.raises(NotImplementedError, match="item 6"):
        ttr._moe_forward(cfg, moe, torch.zeros(1, 1, 256), "reference")
