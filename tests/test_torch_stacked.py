"""The port's stacked serving layout (``serve/stacked.py``) against
``ganq_tpu``'s: row fusion and the megapack carried across, the whole-step
gates and the variant each request takes, and greedy decoding through the
int8-activation path as a whole.

Models are ganq_tpu's synthetic llamas, carried into the port with
``params_from_numpy``. ganq_tpu's Pallas kernels run in interpret mode with
``GANQ_MEGASTEP=1`` (the megastep forced on the CPU); the port runs its
plain versions on CPU tensors under the same switch."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ganq_tpu.models import synthetic as jsyn
from ganq_tpu.ops import megastep as jms
from ganq_tpu.ops import megastep4 as jm4
from ganq_tpu.ops import megastep_lowbit as jlb
from ganq_tpu.ops import qlinear as jql
from ganq_tpu.serve import stacked as jst
from ganq_tpu_torch.models import hf_import as thf
from ganq_tpu_torch.ops import megastep as tms
from ganq_tpu_torch.ops import megastep4 as tm4
from ganq_tpu_torch.ops import megastep_lowbit as tlb
from ganq_tpu_torch.serve import engine as teng
from ganq_tpu_torch.serve import stacked as tst

from test_torch_serve import _flatten_jax
from test_torch_packing import torch_threads_per_worker  # noqa: F401


def _np_linear(rng, out_f, in_f, kind, bits, dtype=jnp.bfloat16):
    """One random linear of ``kind`` as ganq_tpu's synthetic ``make_model``
    makes it (its kinds, scales and layouts, ``ganq_tpu/models/
    synthetic.py:107-144``), drawn with numpy and packed by the port's
    packer (ganq_tpu's bytes): no JAX compile per weight shape."""
    from ganq_tpu_torch.ops.packing import pack_factor, pack_int_rows

    def packed(codes, b):
        align = 128 * pack_factor(b)
        K = codes.shape[1]
        Kp = -(-K // align) * align if K > align else K
        codes = np.pad(codes, ((0, 0), (0, Kp - K)))
        return jnp.asarray(pack_int_rows(torch.from_numpy(codes), b).numpy())

    if kind == "dense":
        return jql.dense_linear(jnp.asarray(
            rng.normal(size=(out_f, in_f)).astype(np.float32) * 0.02, dtype))
    if kind == "w8":
        return jql.QLinear("w8", {
            "w8": jnp.asarray(rng.integers(-127, 128, size=(out_f, in_f),
                                           dtype=np.int8)),
            "scale": jnp.asarray(rng.uniform(1e-4, 4e-4, size=(
                out_f, 1)).astype(np.float32))}, 8, in_f)
    if kind == "uniform":
        gs = 128 if in_f % 128 == 0 else in_f
        return jql.QLinear("uniform", {
            "qweight": packed(rng.integers(0, 2 ** bits, size=(out_f, in_f)),
                              bits),
            "scales": jnp.asarray((rng.uniform(0.001, 0.004, size=(
                out_f, in_f // gs)) * min(1.0, 16.0 / (1 << bits))).astype(
                    np.float32))}, bits, in_f)
    n, b = (8, 3) if kind == "lut3" else (16, 4)
    if kind == "lut_affine_sym":
        lut = rng.uniform(0.001, 0.004, size=(out_f, 1)) * (np.arange(16)
                                                            - 8.0)
    else:           # "lut" (4-bit, ganq_tpu's), "lut3" (8 entries)
        lut = np.sort(rng.normal(size=(out_f, n)) * 0.02, axis=1)
    return jql.QLinear("lut", {
        "lut": jnp.asarray(lut.astype(np.float32), jnp.bfloat16),
        "idx_packed": packed(rng.integers(0, n, size=(out_f, in_f)), b)},
        b, in_f)


def np_llama(jcfg, kinds, bits=4, seed=1, dtype=jnp.bfloat16):
    """ganq_tpu params of a 2-layer llama ``jcfg`` whose layer i has linears
    of the synthetic kind ``kinds[i]`` (:func:`_np_linear`), embeddings of
    std 0.02 and unit norms in ``dtype``, drawn with numpy."""
    rng = np.random.default_rng(seed + 1000)
    h, it = jcfg.hidden_size, jcfg.intermediate_size
    q, kv = jcfg.q_dim, jcfg.kv_dim

    def ones():
        return {"weight": jnp.ones((h,), dtype)}

    def layer(kind):
        lin = {n: (o, i) for n, o, i in (
            ("q", q, h), ("k", kv, h), ("v", kv, h), ("o", h, q),
            ("gate", it, h), ("up", it, h), ("down", h, it))}
        mk = {n: _np_linear(rng, o, i, kind, bits, dtype)
              for n, (o, i) in lin.items()}
        return {"input_norm": ones(), "post_norm": ones(),
                "attn": {n: mk[n] for n in "qkvo"},
                "mlp": {n: mk[n] for n in ("gate", "up", "down")}}

    return {"embed_tokens": {"weight": jnp.asarray(
        rng.normal(size=(jcfg.vocab_size, h)).astype(np.float32) * 0.02,
        dtype)}, "final_norm": ones(), "layers": [layer(k) for k in kinds]}


def _pair(hidden, heads, kv_heads, inter, kind, bits=4, seed=1, vocab=256,
          norms=False):
    """(jax cfg, jax params, port cfg, port model): a 2-layer llama of
    ganq_tpu's synthetic ``kind`` linears ("lut3": 8-entry codebooks, GANQ
    bits=3), bf16 embeddings of std 0.02 and unit norms (random norm weights
    with ``norms``), drawn with numpy (:func:`np_llama`), and the same
    weights in the port."""
    jcfg = jsyn.llama_config(hidden=hidden, inter=inter, layers=2,
                             heads=heads, kv_heads=kv_heads, vocab=vocab,
                             max_pos=128)
    params = np_llama(jcfg, (kind, kind), bits, seed)
    if norms:
        rng = np.random.default_rng(seed)
        for lp in params["layers"]:
            for n in ("input_norm", "post_norm"):
                lp[n]["weight"] = jnp.asarray(rng.uniform(
                    0.5, 1.5, size=(hidden,)).astype(np.float32), jnp.bfloat16)
    tcfg, tmodel = thf.params_from_numpy(
        thf.config_to_hf(_port_cfg(hidden, heads, kv_heads, inter, vocab)),
        _flatten_jax(params), device="cpu")
    return jcfg, params, tcfg, tmodel


def _port_cfg(hidden, heads, kv_heads, inter, vocab):
    from ganq_tpu_torch.models import synthetic as tsyn
    return tsyn.llama_config(hidden=hidden, inter=inter, layers=2, heads=heads,
                             kv_heads=kv_heads, vocab=vocab, max_pos=128)


def _np(a):
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


# ------------------------------------------------------ carry-across
def test_fuse_layer_and_megapack_match_jax():
    """stack_layers (q/k/v and gate/up rows fused, the transposed w8 o) and
    megapack of the port equal ganq_tpu's, array for array."""
    jcfg, params, tcfg, tmodel = _pair(256, 2, 1, 1536, "w8", norms=True)
    sp = jst.stack_layers(params, recode="affine")
    tsp = tst.stack_layers(tmodel, recode="affine")
    ls = sp["layers_stacked"]
    for li, lp in enumerate(tsp.layers):
        for group, name in (("attn", "qkv"), ("attn", "o"), ("mlp", "gateup"),
                            ("mlp", "down")):
            j = ls[group][name]
            t = getattr(lp, group)[name]
            assert (t.kind, t.bits, t.in_features) == (j.kind, j.bits,
                                                       j.in_features)
            for k, v in j.arrays.items():
                np.testing.assert_array_equal(t[k].float().numpy(),
                                              _np(v[li]), err_msg=k)
        for k in ("o_t_w8", "o_t_scale"):
            np.testing.assert_array_equal(getattr(lp, k).float().numpy(),
                                          _np(ls["attn"][k][li]))
    jmp = jms.megapack(jcfg, sp)
    tmp = tms.megapack(tcfg, tsp)
    assert sorted(jmp) == sorted(tmp)
    for k, v in jmp.items():
        assert tuple(tmp[k].shape) == v.shape, k
        np.testing.assert_array_equal(tmp[k].float().numpy(), _np(v),
                                      err_msg=k)


# ------------------------------------------------------------ gates
_GATE_CASES = [
    # hidden, heads, kv_heads, inter, kind, bits, the variant at batch 1
    (256, 2, 1, 512, "w8", 4, "w8"),
    (256, 2, 1, 512, "uniform", 4, "w4p"),
    (256, 2, 1, 512, "uniform", 8, "w8p"),
    (1024, 8, 4, 1024, "uniform", 3, "w3"),
    (512, 4, 2, 512, "uniform", 2, "w2"),
    (256, 2, 1, 256, "lut", 4, None),
    (256, 2, 1, 512, "lut_affine_sym", 4, "w4p"),
    (384, 3, 1, 384, "uniform", 4, None),
    (256, 4, 2, 256, "w8", 4, None),
    (1024, 8, 4, 1024, "lut3", 3, "wl8"),
]


@pytest.mark.parametrize("case", _GATE_CASES,
                         ids=[f"{c[4]}{c[5]}-h{c[0]}-d{c[0] // c[1]}"
                              for c in _GATE_CASES])
def test_mega_gates_match_jax(monkeypatch, case):
    """For each config and kind, the gates of kernels 12 (``w8``), 13
    (``w4``) and 14 (``w4p``/``w3``/``w2``/``w8p``/``wl8``) and the variant
    ``mega_enabled`` picks at batches 1 to 65, under the default switches
    and with ``GANQ_W4_PLANE=0`` / ``GANQ_WALSH=0``, equal ganq_tpu's (the
    megastep forced on, as on a TPU, with ``GANQ_MEGASTEP=1``); the cases
    reach every variant."""
    hidden, heads, kv_heads, inter, kind, bits, variant = case
    jcfg, params, tcfg, tmodel = _pair(hidden, heads, kv_heads, inter, kind,
                                       bits, vocab=64)
    sp = jst.certify_stacked(jst.stack_layers(params, recode="affine"))
    tsp = tst.certify_stacked(tst.stack_layers(tmodel, recode="affine"))
    assert tms.megastep_fusable(tcfg, tsp) == jms.megastep_fusable(jcfg, sp)
    assert tm4.megastep4_fusable(tcfg, tsp) == jm4.megastep4_fusable(jcfg, sp)
    assert tlb.megastep_walsh_fusable(tcfg, tsp) == \
        jlb.megastep_walsh_fusable(jcfg, sp)
    for b in (2, 3, 4, 8):
        assert tlb.megastep_lowbit_fusable(tcfg, tsp, b) == \
            jlb.megastep_lowbit_fusable(jcfg, sp, b)
    monkeypatch.setenv("GANQ_MEGASTEP", "1")
    for env in ({}, {"GANQ_W4_PLANE": "0"}, {"GANQ_WALSH": "0"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for batch in (1, 8, 9, 64, 65):
            want = jst.mega_enabled(jcfg, sp, "pallas_a8", batch)
            got = tst.mega_enabled(tcfg, tsp, "cuda_a8", batch, "cpu")
            assert got == want, (env, batch)
            if batch == 1 and not env:
                assert got == variant
            if batch == 1 and "GANQ_W4_PLANE" in env and variant == "w4p":
                assert got == "w4"
        for k in env:
            monkeypatch.delenv(k)


def test_prepack_routes_and_refuses_as_jax(monkeypatch):
    """``prepack`` at batch 1 packs the operands of the whole-step kernel
    the variant takes (kernel 12's for w8, kernel 14's for uniform W4, with
    zero points and act-order too, and kernel 13's at request time under
    ``GANQ_W4_PLANE=0``); kernel 14's "w2" (which earlier slices refused)
    packs too, its 2-bit planes on ``megapack_lb``, and the engine keeps
    the pack and serves its decoding requests through the variant ganq_tpu
    picks ("w2" at batch 4, none at batch 65 or without decode steps). Off
    by default on the CPU, as ganq_tpu's is; on by default for "cuda_a8"
    on the card."""
    _, _, tcfg, w8 = _pair(256, 2, 1, 512, "w8", vocab=64)
    _, _, _, u4 = _pair(256, 2, 1, 512, "uniform", 4, vocab=64)
    _, _, tcfg2, u2 = _pair(512, 4, 2, 512, "uniform", 2, vocab=64)
    assert not tst.mega_env_enabled("cuda_a8", 1, "cpu")
    assert tst.mega_env_enabled("cuda_a8", 1, "cuda")
    assert not tst.mega_env_enabled("cuda", 1, "cuda")
    assert not tst.mega_env_enabled("cuda_a8", 65, "cuda")
    monkeypatch.setenv("GANQ_MEGASTEP", "1")
    sp = tst.prepack(tcfg, tst.stack_layers(w8, recode="affine"), "cuda_a8",
                     1, "cpu")
    assert sp.megapack_w8 is not None
    sp = tst.prepack(tcfg, tst.stack_layers(u4, recode="affine"), "cuda_a8",
                     1, "cpu")
    assert sp.megapack_lb["gu_pk"].dtype == torch.int8
    assert sp.megapack4 is None and sp.megapack_w8 is None
    monkeypatch.setenv("GANQ_W4_PLANE", "0")
    assert tst.mega_enabled(tcfg, sp, "cuda_a8", 8, "cpu") == "w4"
    assert "qkv_p4" in tst._mega_pack_for(tcfg, sp, "w4")
    assert sp.megapack4 is not None
    monkeypatch.delenv("GANQ_W4_PLANE")
    sp2 = tst.prepack(tcfg2, tst.stack_layers(u2, recode="affine"),
                      "cuda_a8", 1, "cpu")
    # 2-bit planes: one plane byte holds 4 row blocks
    assert sp2.megapack_lb["qkv_pk"].shape[1] == (512 + 2 * 256) // 4
    eng = teng.Engine(tcfg2, u2, backend="reference", device="cpu")
    assert eng.stacked and eng.model.megapack_lb is not None
    for batch, want in ((4, "w2"), (65, None)):
        assert tst.mega_enabled(tcfg2, eng.model, "cuda_a8", batch,
                                "cpu") == want
    out = eng.generate(np.zeros((4, 3), np.int64), max_new_tokens=2,
                       max_seq=8)
    assert out.shape == (4, 2)
    eng4 = teng.Engine(tcfg, u4, backend="reference", device="cpu")
    assert tst.mega_enabled(tcfg, eng4.model, "cuda_a8", 4, "cpu") == "w4p"
    # zero points and act-order: kernel 14's pack carries the corrections
    # and the activations' column orders, and the requests are served
    from test_torch_megastep_lowbit import zp_ao_pair
    _, _, tcfg3, zpao = zp_ao_pair(256, 2, 1, 512, 4, True, True)
    sp = tst.prepack(tcfg3, tst.stack_layers(zpao, recode="affine"),
                     "cuda_a8", 1, "cpu")
    assert {"qkv_sz", "dn_sz", "ap_q", "ap_g", "ap_o"} <= set(sp.megapack_lb)
    assert "g_idx" in sp.layers[0].attn["qkv"]       # prefill keeps g_idx
    assert tst.mega_enabled(tcfg3, sp, "cuda_a8", 4, "cpu") == "w4p"
    monkeypatch.setenv("GANQ_MEGASTEP", "0")
    assert tst.mega_enabled(tcfg2, eng.model, "cuda_a8", 4, "cpu") is None


# ------------------------------------------------- the slice as a whole
@pytest.fixture(scope="module")
def w8_stacked():
    """A 2-layer w8 llama (head_dim 128, random norms, I = 1536: three MLP
    tiles) stacked and prepacked by both packages, the megastep forced on."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GANQ_MEGASTEP", "1")
        jcfg, params, tcfg, tmodel = _pair(256, 2, 1, 1536, "w8", seed=5,
                                           norms=True)
        sp = jst.prepack(jcfg, jst.stack_layers(params, recode="affine"),
                         "pallas_a8", 1)
        tsp = tst.prepack(tcfg, tst.stack_layers(tmodel, recode="affine"),
                          "cuda_a8", 1, "cpu")
    return jcfg, sp, tcfg, tsp


@pytest.mark.parametrize("batch", [2, 9])
def test_stacked_a8_greedy_matches_jax(monkeypatch, w8_stacked, batch):
    """A 2-layer w8 llama (head_dim 128, three MLP tiles) on the stacked
    int8-activation path: batch 2 decodes through the megastep (kernel 12),
    batch 9 layer by layer (the fused MLP, kernel 9, int8 qkv/o and flash
    decode); both prefill 2 x 8 / 9 x 8 token rows, 9 x 8 past the fused
    MLP's 64. Greedy tokens equal ganq_tpu's ("pallas_a8", interpret
    mode). The prefill logits and the teacher-forced logits of the first
    decode step agree within 5e-2 relative L2: the two frameworks' bf16
    prefill attention rounds scores, probabilities and outputs in another
    order (0.6% of a layer's output on the reference backend), and each
    such difference flips int8 activations downstream (the int8 path is
    itself 2% from the reference backend's logits at this size)."""
    monkeypatch.setenv("GANQ_MEGASTEP", "1")
    monkeypatch.setenv("GANQ_FLASH_DECODE", "1")
    jcfg, sp, tcfg, tsp = w8_stacked
    want_variant = "w8" if batch <= 8 else None
    assert jst.mega_enabled(jcfg, sp, "pallas_a8", batch) == want_variant
    assert tst.mega_enabled(tcfg, tsp, "cuda_a8", batch, "cpu") == \
        want_variant
    ids = np.random.default_rng(batch).integers(0, 256, size=(batch, 8))
    new, T = 5, 32
    with pltpu.force_tpu_interpret_mode():
        # ganq_tpu's greedy decode (``generate_tokens``' prefill and scan
        # body, step by step): its prefill and first step are the
        # teacher-forced logits
        ck, cv = jst.init_cache(jcfg, 2, batch, T)
        lg0, ck, cv = jax.block_until_ready(jst.prefill(
            jcfg, sp, ck, cv, jnp.asarray(ids), "pallas_a8"))
        tok = jnp.argmax(lg0, axis=-1).astype(jnp.int32)
        if want_variant:
            mk, mv = jst._mega_cache(jcfg, ck, cv)
            mega = jax.jit(lambda mk, mv, tok, pos: jst._decode_one_mega(
                jcfg, sp, sp["megapack_w8"], mk, mv, tok, pos))

            def step(c, tok, pos):
                lg, mk, mv = mega(*c, tok, pos)
                return lg, (mk, mv)
            carry = (mk, mv)
        else:
            def step(c, tok, pos):
                lg, ck, cv = jst.decode_step(jcfg, sp, *c, tok, pos,
                                             "pallas_a8")
                return lg, (ck, cv)
            carry = (ck, cv)
        toks = [tok]
        for i in range(new - 1):
            lg, carry = step(carry, toks[-1], jnp.int32(8 + i))
            lg = jax.block_until_ready(lg)
            if i == 0:
                lg1 = lg
            toks.append(jnp.argmax(lg, axis=-1).astype(jnp.int32))
        want = np.stack([np.asarray(t) for t in toks], axis=1)
    with torch.inference_mode():
        ck, cv = tst.init_cache(tcfg, 2, batch, T, "cpu")
        got = tst.generate_tokens(tcfg, tsp, ck, cv, torch.as_tensor(ids),
                                  None, new, backend="cuda_a8").numpy()
        ck, cv = tst.init_cache(tcfg, 2, batch, T, "cpu")
        tl0 = tst.prefill(tcfg, tsp, ck, cv, torch.as_tensor(ids), "cuda_a8")
        tok_t = torch.as_tensor(np.array(tok)).long()
        pos = torch.tensor(8, dtype=torch.int32)
        if want_variant:
            mk, mv = tst._mega_cache(ck, cv)
            tl1 = tst._decode_one_mega(tcfg, tsp, tsp.megapack_w8, mk, mv,
                                       tok_t, pos, "cuda_a8")
        else:
            tl1 = tst.decode_step(tcfg, tsp, ck, cv, tok_t, pos, "cuda_a8")
    np.testing.assert_array_equal(got, want)
    for t, j in ((tl0, lg0), (tl1, lg1)):
        j = _np(j)
        assert np.linalg.norm(t.float().numpy() - j) <= 5e-2 * np.linalg.norm(j)
