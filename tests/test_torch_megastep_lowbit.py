"""Kernels 13 (``megastep4_decode``) and 14 (``megastep_lowbit_decode``,
variants "w4p" and "w8p") of the port against ``ganq_tpu``.

ganq_tpu's synthetic uniform llamas are carried into the port with
``params_from_numpy`` and stacked by both packages. The port's packs must
equal ganq_tpu's byte for byte, and its plans (the MLP tiles baked into the
packs, the flash block, the tiles per grid step) ganq_tpu's values, read
from the pallas_call that ganq_tpu's wrapper builds. The port's wrappers run
their plain versions on CPU tensors; ganq_tpu's Pallas kernels run in
interpret mode at the JAX tests' smallest shapes. Both compute the same
integer group dots and the same float32 operations in the same order except
float32 sums (the rmsnorms, attention scores, p . v), rsqrt and exp, which
XLA and PyTorch round in their last bits; an int8 activation within those
bits of a rounding tie flips by one code. So the port is held to the
interpret-mode kernel within one bf16 ulp plus 5e-3 of the largest output
(``assert_kernel_close``), and to ganq_tpu's oracle ``megastep4_reference``
(which rounds the residual to bf16 after every layer and computes the
softmax in one piece) at the JAX tests' tolerances
(``tests/test_megastep_lowbit.py:203-213``)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ganq_tpu.ops import megastep4 as jm4
from ganq_tpu.ops import megastep_lowbit as jlb
from ganq_tpu.serve import stacked as jst
from ganq_tpu_torch.models import hf_import as thf
from ganq_tpu_torch.ops import megastep4 as tm4
from ganq_tpu_torch.ops import megastep_lowbit as tlb
from ganq_tpu_torch.serve import stacked as tst

from test_torch_fused_w8a8 import assert_kernel_close
from test_torch_megastep import _t
from test_torch_serve import _flatten_jax
from test_torch_stacked import _np, _pair, _port_cfg
from test_torch_packing import torch_threads_per_worker  # noqa: F401


# the JAX tests' smallest shapes: kernel 14's (tests/test_megastep_lowbit.py:
# 39) hidden 2048, 16 heads, 4 kv heads, I = 1024; kernel 13's
# (tests/test_megastep4.py:32) hidden 256, 2 heads, 1 kv head, I = 512; two
# layers each
_VARIANT_BITS = {"w8p": 8, "w4p": 4, "w4": 4}
_MODEL_OF = {"w8p": (2048, 16, 4, 1024, 8), "w4p": (2048, 16, 4, 1024, 4),
             "w4": (256, 2, 1, 512, 4)}


@pytest.fixture(scope="module")
def packed():
    """Per variant: (jax cfg, jax stacked params, jax pack, port cfg, port
    pack, port stacked model); random norms."""
    out = {}
    for variant, bits in _VARIANT_BITS.items():
        hidden, heads, kvh, inter, _ = _MODEL_OF[variant]
        if variant == "w4":
            jcfg, params, tcfg, tmodel = _pair(hidden, heads, kvh, inter,
                                               "uniform", bits, seed=7,
                                               vocab=64, norms=True)
        else:       # numpy-built: no JAX compile per weight shape
            jcfg, params = np_uniform_llama(hidden, heads, kvh, inter, bits,
                                            seed=7)
            tcfg, tmodel = thf.params_from_numpy(
                thf.config_to_hf(_port_cfg(hidden, heads, kvh, inter, 64)),
                _flatten_jax(params), device="cpu")
        sp = jst.stack_layers(params, recode="affine")
        tsp = tst.stack_layers(tmodel, recode="affine")
        if variant == "w4":
            jmp, tmp = jm4.megapack4(jcfg, sp), tm4.megapack4(tcfg, tsp)
        else:
            jmp = jlb.megapack_lowbit(jcfg, sp, bits)
            tmp = tlb.megapack_lowbit(tcfg, tsp, bits)
        out[variant] = (jcfg, sp, jmp, tcfg, tmp, tsp)
    return out


@pytest.mark.parametrize("variant", sorted(_VARIANT_BITS))
def test_packs_match_jax_bytes(packed, variant):
    """megapack_lowbit (bits 4 and 8) and megapack4 give ganq_tpu's keys,
    shapes, types and bytes."""
    _, _, jmp, _, tmp, _ = packed[variant]
    assert sorted(tmp) == sorted(jmp)
    for k, v in jmp.items():
        assert tuple(tmp[k].shape) == v.shape, k
        assert tmp[k].dtype == _t(v[:1]).dtype, k
        np.testing.assert_array_equal(tmp[k].float().numpy(), _np(v),
                                      err_msg=k)


def test_pack_refuses_later_features(packed):
    """Kernel 14 packs planes at 8, 4, 3 and 2 bits (the 3- and 2-bit
    packs, which earlier slices refused, are held to ganq_tpu's bytes in
    ``test_torch_lowbit_w3_walsh.py``): a pack at 3 bits takes 3-bit
    linears only (ValueError for this 4-bit model), and bits without a
    plane plan raise. Zero points are kernel 14's (kernel 13's pack still
    refuses them), and act-order artifacts must go through
    ``actorder_transform`` first, as in ganq_tpu (ValueError)."""
    _, _, _, tcfg, _, tsp = packed["w4p"]
    with pytest.raises(ValueError, match="uniform 3-bit"):
        tlb.megapack_lowbit(tcfg, tsp, 3)
    with pytest.raises(ValueError, match="no plane plan"):
        tlb.megapack_lowbit(tcfg, tsp, 5)
    lin = tsp.layers[0].attn["qkv"]
    lin.register_buffer("zeros", torch.full_like(lin["scales"], 7.0))
    try:
        with pytest.raises(NotImplementedError, match="zero points"):
            tm4.megapack4(tcfg, tsp)
        assert "qkv_sz" in tlb.megapack_lowbit(tcfg, tsp, 4)
    finally:
        del lin._buffers["zeros"]
    lin.register_buffer("g_idx", torch.arange(lin.in_features,
                                              dtype=torch.int32) // 128)
    try:
        with pytest.raises(ValueError, match="actorder_transform"):
            tlb.megapack_lowbit(tcfg, tsp, 4)
    finally:
        del lin._buffers["g_idx"]


def _jax_plan(B, H, q_dim, kv_dim, T, Dqkv, I, bits, gs, sand=False):
    """ganq_tpu's tiles per grid step and flash block, read from the block
    shapes of the pallas_call its wrapper builds (abstract shapes only;
    with gemma's sandwich norms where ``sand``)."""
    d = 128
    metas, _, _, g_r = jlb._plan_meta(bits)
    npl = len(metas)
    ti = jlb._mlp_plan(I, bits, H)[0]
    gtp = -(-(ti // gs) // 8) * 8
    S = jax.ShapeDtypeStruct
    L, i8, bf = 2, jnp.int8, jnp.bfloat16
    mp = {"qkv_pk": S((L, npl * Dqkv // g_r, H), i8),
          "qkv_s": S((L, H // gs, Dqkv), bf),
          "o_pk": S((L, npl * H // g_r, q_dim), i8),
          "o_s": S((L, q_dim // gs, H), bf),
          "gu_pk": S((L, 2 * npl * I // g_r, H), i8),
          "gu_s": S((L, H // gs, 2 * I), bf),
          "dn_pk": S((L, npl * H // g_r, I), i8),
          "dn_s": S((L, I // ti * gtp, H), bf),
          "qkv_bias": S((L, 1, Dqkv), jnp.float32),
          "attn_norm": S((L, 1, H), jnp.float32),
          "mlp_norm": S((L, 1, H), jnp.float32)}
    if sand:
        mp.update(pa_norm=S((L, 1, H), jnp.float32),
                  pm_norm=S((L, 1, H), jnp.float32))
    cache = S((L, B * kv_dim // d, T, d), bf)
    jpr = jax.make_jaxpr(lambda *a: jlb.megastep_lowbit_decode(
        *a, q_dim=q_dim, kv_dim=kv_dim, head_dim=d, rotary_dim=d, bits=bits))(
        S((B, H), bf), mp, cache, cache, S((), jnp.int32),
        S((d // 2,), jnp.float32), S((d // 2,), jnp.float32))

    def find(jaxpr):
        for e in jaxpr.eqns:
            if e.primitive.name == "pallas_call":
                return e
            for p in e.params.values():
                inner = getattr(p, "jaxpr", None)
                if inner is not None:
                    got = find(getattr(inner, "jaxpr", inner))
                    if got is not None:
                        return got
        return None

    blocks = [[getattr(b, "block_size", b) for b in bm.block_shape]
              for bm in find(jpr.jaxpr).params["grid_mapping"].block_mappings]
    pq0, pi0 = npl * jlb._qkv_tile_lb(Dqkv, d, g_r) // g_r, npl * ti // g_r
    return {"ptq": blocks[3][1] // pq0, "Tb": blocks[8][2],
            "ptg": blocks[12][1] // pi0}


@pytest.mark.parametrize("case", [
    # B, hidden, q_dim, kv_dim, T, Dqkv, I, bits
    (1, 3072, 3072, 1024, 2048, 5120, 8192, 4),    # Llama-3.2-3B, w4p
    (64, 3072, 3072, 1024, 2048, 5120, 8192, 4),   # Tb degraded
    (64, 3072, 3072, 1024, 4096, 5120, 8192, 8),   # w8p
    (16, 3072, 3072, 1024, 160, 5120, 8192, 8),    # T not a power of two
    (9, 2048, 2048, 512, 64, 3072, 1024, 8),
    (8, 4096, 4096, 1024, 2048, 6144, 14336, 4),   # Llama-3-8B widths
    (64, 5376, 4096, 2048, 1280, 8192, 21504, 8, True),  # Gemma-3-27B
])
def test_plans_match_jax(case):
    """The run-time plan (qkv tile, MLP tile, tiles per grid step, flash
    block) equals ganq_tpu's, at 3B widths up to B = 64 and with gemma's
    sandwich norms at Gemma-3-27B widths; ``_mlp_plan`` and ``_mlp_tile4``
    equal ganq_tpu's over a grid of widths."""
    B, H, q_dim, kv_dim, T, Dqkv, I, bits = case[:8]
    sand = case[8:] == (True,)
    got = tlb.megastep_lowbit_plan(B, H, q_dim, kv_dim, 128, T, Dqkv, I,
                                   bits, 128, sand=sand)
    _, _, _, g_r = jlb._plan_meta(bits)
    assert got["tq"] == jlb._qkv_tile_lb(Dqkv, 128, g_r)
    assert got["ti"] == jlb._mlp_plan(I, bits, H)[0]
    want = _jax_plan(B, H, q_dim, kv_dim, T, Dqkv, I, bits, 128, sand)
    assert {k: got[k] for k in want} == want
    if B == 1:
        for inter in (256, 512, 1024, 1536, 2816, 5632, 8192, 11008, 14336):
            assert tm4._mlp_tile4(inter) == jm4._mlp_tile4(inter)
            for b in (2, 3, 4, 8):
                for hidden in (256, 1024, 2048, 3072, 4096):
                    assert tlb._mlp_plan(inter, b, hidden) == \
                        jlb._mlp_plan(inter, b, hidden), (inter, b, hidden)


def _step_inputs(rng, jcfg, B, T, pos):
    L, H, d = jcfg.num_hidden_layers, jcfg.hidden_size, 128
    Hkv = jcfg.num_key_value_heads
    kc = rng.normal(size=(L, B * Hkv, T, d)).astype(np.float32) * 0.3
    vc = rng.normal(size=(L, B * Hkv, T, d)).astype(np.float32) * 0.3
    for b, p in enumerate(pos):                     # never attended
        kc[:, b * Hkv:(b + 1) * Hkv, p:] = 23.0
        vc[:, b * Hkv:(b + 1) * Hkv, p:] = -7.0
    x = rng.normal(size=(B, H)).astype(np.float32) * 0.4
    ang = rng.uniform(0, 2 * np.pi, size=(d // 2,)).astype(np.float32)
    return (jnp.asarray(x, jnp.bfloat16), jnp.asarray(kc, jnp.bfloat16),
            jnp.asarray(vc, jnp.bfloat16), np.cos(ang), np.sin(ang))


def _lw_list(jcfg, sp):
    """ganq_tpu's oracle operands: per layer the dequantized float32
    weights and norms (``tests/test_megastep_lowbit.py::_lw_list``)."""
    from ganq_tpu.ops.qlinear import QLinear, dequantize_weight

    ls = sp["layers_stacked"]
    out = []
    for i in range(jcfg.num_hidden_layers):
        def w(m):
            return dequantize_weight(QLinear(
                m.kind, {k: v[i] for k, v in m.arrays.items()}, m.bits,
                m.in_features)).astype(jnp.float32)
        gu = w(ls["mlp"]["gateup"])
        I = gu.shape[0] // 2
        qkv = w(ls["attn"]["qkv"])
        out.append({
            "attn_norm": ls["input_norm"]["weight"][i].astype(jnp.float32),
            "mlp_norm": ls["post_norm"]["weight"][i].astype(jnp.float32),
            "qkv_w": qkv, "qkv_bias": jnp.zeros((qkv.shape[0],), jnp.float32),
            "o_w": w(ls["attn"]["o"]), "gate_w": gu[:I], "up_w": gu[I:],
            "down_w": w(ls["mlp"]["down"])})
    return out


@pytest.mark.parametrize("variant,B", [("w8p", 2), ("w8p", 9), ("w4p", 2),
                                       ("w4", 2)])
def test_plain_matches_jax_interpret(packed, variant, B):
    """The plain versions of kernels 14 ("w8p" at B = 2 and 9, "w4p") and 13
    ("w4") against ganq_tpu's kernels in interpret mode, each slot at its own
    history length; for "w4p" and "w4" also, with every slot at the shortest
    length, against ganq_tpu's oracle at the JAX tests' tolerances (kernel
    13's: ``tests/test_megastep4.py:119-127``). "w8p" shares every float
    operation with "w4p"; its 8-bit codes are checked against the
    interpret-mode kernel."""
    jcfg, sp, jmp, _, tmp, _ = packed[variant]
    bits = _VARIANT_BITS[variant]
    rng = np.random.default_rng(30 + B)
    T, d = 64, 128
    pos = [50, 3, 20, 63, 41, 7, 33, 12, 28][:B]
    x, jk, jv, cos, sin = _step_inputs(rng, jcfg, B, T, pos)
    kw = dict(q_dim=jcfg.q_dim, kv_dim=jcfg.num_key_value_heads * d,
              head_dim=d, rotary_dim=d, eps=1e-5, scale=float(1 / np.sqrt(d)))
    if variant == "w4":
        jfn, tfn = jm4.megastep4_decode, tm4.megastep4_decode
    else:
        jfn = functools.partial(jlb.megastep_lowbit_decode, bits=bits)
        tfn = functools.partial(tlb.megastep_lowbit_decode, bits=bits)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.block_until_ready(jfn(x, jmp, jk, jv,
                                        jnp.asarray(pos, jnp.int32),
                                        jnp.asarray(cos), jnp.asarray(sin),
                                        **kw))
    got = tfn(_t(x), tmp, _t(jk), _t(jv), torch.tensor(pos),
              torch.from_numpy(cos), torch.from_numpy(sin), **kw)
    for name, g, r in zip(("y", "k", "v"), got, ref):
        assert tuple(g.shape) == r.shape and g.dtype == torch.bfloat16
        assert_kernel_close(g.float().numpy(), _np(r), flips=5e-3,
                            what=f"{variant} {name} B={B}")
    if variant == "w8p":
        return
    got = tfn(_t(x), tmp, _t(jk), _t(jv), min(pos), torch.from_numpy(cos),
              torch.from_numpy(sin), **kw)
    oracle = jax.block_until_ready(jax.jit(functools.partial(
        jlb.megastep_lowbit_reference, pos=min(pos), **kw))(
            x, _lw_list(jcfg, sp), jk, jv, cos_half=jnp.asarray(cos),
            sin_half=jnp.asarray(sin)))
    kv_atol = 2e-2 if variant == "w4" else 3e-2
    for name, g, o, atol in zip(("y", "k", "v"), got, oracle,
                                (5e-2, kv_atol, kv_atol)):
        np.testing.assert_allclose(g.float().numpy(), _np(o), atol=atol,
                                   rtol=5e-2 if name == "y" else 2e-2)


def _random_lowbit_pack(tmp, bits, walsh, seed=4):
    """A kernel-14 pack of random codes at ``bits`` (with ``walsh`` the
    Walsh planes and float32 coefficient rows) in the layout of the pack
    ``tmp`` (its norms and qkv bias kept)."""
    metas, _, _, g_r = tlb._plan_meta(bits)
    L, _, H = tmp["qkv_pk"].shape
    Dqkv, I = tmp["qkv_bias"].shape[2], tmp["gu_s"].shape[2] // 2
    q_dim = tmp["o_pk"].shape[2]
    gen = torch.Generator().manual_seed(seed)

    def codes(R, K):
        return torch.randint(-128, 128, (L, R * len(metas) // g_r, K),
                             generator=gen, dtype=torch.int32).to(torch.int8)

    def coef(R):
        return tlb.walsh_coef(torch.randn((L, R, 8), generator=gen) * 0.01)

    mp = {k: tmp[k] for k in ("attn_norm", "mlp_norm", "qkv_bias")}
    mp.update(qkv_pk=codes(Dqkv, H), o_pk=codes(H, q_dim),
              gu_pk=codes(2 * I, H), dn_pk=codes(H, I))
    if walsh:
        mp.update(qkv_s=coef(Dqkv), o_s=coef(H), gu_s=coef(2 * I),
                  dn_s=coef(H))
        return mp
    ti = tlb._mlp_plan(I, bits, H)[0]
    gtp = -(-(ti // 128) // 8) * 8

    def scales(G, R):
        return (torch.rand((L, G, R), generator=gen) * 1e-3).to(
            torch.bfloat16)

    mp.update(qkv_s=scales(H // 128, Dqkv), o_s=scales(q_dim // 128, H),
              gu_s=scales(H // 128, 2 * I), dn_s=scales(I // ti * gtp, H))
    return mp


def test_wrappers_refuse_later_features(packed):
    """Kernel 14's variants that earlier slices refused are served: on a
    pack of random 3-bit ("w3"), 2-bit ("w2") and Walsh ("wl8", walsh=7)
    planes at these widths the wrapper runs its plain version on the CPU
    (finite outputs of the step's shapes) and names the source it launches
    on the card (``megastep_lowbit_w3w2``, ``megastep_lowbit_walsh``); only
    ``walsh`` other than 7 at 3 bits (or 0) is refused (ValueError). Zero
    points and act-order are served (``test_zero_point_actorder_*``; the lm
    fold: ``test_lm_fold_*``; EoRA adapters: ``test_lora_*``; qwen3's
    qk-norm, the o/gate-up/down biases and gemma's softcap, windows and
    sandwich norms are served here and held against ganq_tpu in
    ``test_torch_arch.py`` and ``test_torch_gemma.py``)."""
    jcfg, _, _, _, tmp, _ = packed["w8p"]
    B, T, d = 1, 64, 128
    x = torch.zeros((B, jcfg.hidden_size), dtype=torch.bfloat16)
    kc = torch.zeros((2, B * jcfg.num_key_value_heads, T, d),
                     dtype=torch.bfloat16)
    kw = dict(q_dim=jcfg.q_dim, kv_dim=jcfg.num_key_value_heads * d,
              head_dim=d, bits=8)
    for bits, walsh, lib in ((3, 7, "megastep_lowbit_walsh"),
                             (3, 0, "megastep_lowbit_w3w2"),
                             (2, 0, "megastep_lowbit_w3w2")):
        mp = _random_lowbit_pack(tmp, bits, walsh)
        y, kn, vn = tlb.megastep_lowbit_decode(
            x + 0.1, mp, kc, kc, 3, None, None,
            **{**kw, "bits": bits, "walsh": walsh})
        assert y.shape == x.shape and kn.shape == (2, B, kw["kv_dim"])
        assert torch.isfinite(y.float()).all()
        assert tlb.kernel_library(mp, False, False, bits, walsh) == lib
    for bits, walsh in ((8, 7), (3, 3)):
        with pytest.raises(ValueError, match="walsh=7"):
            tlb.megastep_lowbit_decode(x, tmp, kc, kc, 3, None, None,
                                       **{**kw, "bits": bits,
                                          "walsh": walsh})
    for extra in ({"softcap": 30.0}, {"windows": [T, T]}):
        y, _, _ = tlb.megastep_lowbit_decode(x, tmp, kc, kc, 3, None, None,
                                             **{**kw, **extra})
        assert y.shape == x.shape
    L, H = tmp["o_s"].shape[0], jcfg.hidden_size
    Dqkv = tmp["qkv_bias"].shape[2]
    I2 = tmp["gu_s"].shape[2]
    served = {"qk_nm": torch.ones((L, 2, Dqkv)),
              "o_bias": torch.zeros((L, 1, H)),
              "gu_bias": torch.zeros((L, 1, I2)),
              "dn_bias": torch.zeros((L, 1, H)),
              "pa_norm": torch.zeros((L, 1, H)),
              "pm_norm": torch.zeros((L, 1, H))}
    for key, what in (("o_bias", "biases"), ("qk_nm", "qk-norm"),
                      ("pa_norm", "sandwich")):
        ops = ({k: served[k] for k in ("pa_norm", "pm_norm")}
               if key == "pa_norm" else {"qk_nm": served["qk_nm"]}
               if key == "qk_nm" else
               {k: served[k] for k in ("o_bias", "gu_bias", "dn_bias")})
        y, kn, _ = tlb.megastep_lowbit_decode(x, {**tmp, **ops}, kc, kc, 3,
                                              None, None, **kw)
        assert y.shape == x.shape and kn.shape == (2, B, kw["kv_dim"]), what
    with pytest.raises(ValueError, match="B <= 8"):
        tm4.megastep4_decode(torch.zeros((9, 256)), {}, kc, kc, 3, None,
                             None, q_dim=256, kv_dim=128, head_dim=d)


# ------------------------------------------- zero points and act-order
def inject_zp_ao(params, bits, asym, actorder, seed=3, unbalanced=False):
    """Give every uniform linear of ganq_tpu's per-layer params random
    fractional zero points (``asym``, as
    ``tests/test_megastep_lowbit.py:117-121``) and act-order artifacts
    (``actorder``: columns shuffled by one permutation per shared input,
    g_idx recording each column's group, as ``_inject_gidx``; with
    ``unbalanced`` one group holds a column more than the next). Codes are
    repacked with the port's packer, whose bytes are ganq_tpu's
    (``tests/test_torch_packing.py``)."""
    from ganq_tpu.ops import qlinear as jql
    from ganq_tpu_torch.ops.packing import pack_int_rows, unpack_int_rows

    rng = np.random.default_rng(seed)
    for lp in params["layers"]:
        perms = {}
        for group, name, shared in (
                ("attn", "q", "h"), ("attn", "k", "h"), ("attn", "v", "h"),
                ("attn", "o", "o"), ("mlp", "gate", "g"), ("mlp", "up", "g"),
                ("mlp", "down", "d")):
            m = lp[group][name]
            n = m.in_features
            arrays = {"scales": m["scales"]}
            scales = np.asarray(m["scales"])
            gs = n // scales.shape[1]
            if asym:
                arrays["zeros"] = jnp.asarray(rng.uniform(
                    0.25 * 2 ** bits, 0.75 * 2 ** bits,
                    size=scales.shape).astype(np.float32))
            qweight = m["qweight"]
            if actorder:
                p = perms.setdefault(shared, rng.permutation(n))
                gi = np.arange(n) // gs
                if unbalanced:
                    gi[gs] = 0
                codes = unpack_int_rows(torch.from_numpy(np.asarray(qweight)),
                                        bits, n)
                qweight = jnp.asarray(pack_int_rows(
                    codes[:, torch.from_numpy(p)], bits).numpy())
                arrays["g_idx"] = jnp.asarray(gi[p], jnp.int32)
            arrays["qweight"] = qweight
            lp[group][name] = jql.QLinear("uniform", arrays, bits, n)
    return params


def np_uniform_llama(hidden, heads, kvh, inter, bits, vocab=64, seed=3,
                     norms=True, dtype=np.float32):
    """(jax cfg, params): a 2-layer llama of symmetric uniform ``bits``-bit
    g128 linears (the scale range of ganq_tpu's synthetic models) made
    with numpy and packed by the port's packer (ganq_tpu's bytes), random
    norm weights in [0.5, 1.5) with ``norms``; no JAX compile."""
    from ganq_tpu.models import synthetic as jsyn
    from ganq_tpu.ops import qlinear as jql
    from ganq_tpu_torch.ops.packing import pack_int_rows

    jcfg = jsyn.llama_config(hidden=hidden, inter=inter, layers=2,
                             heads=heads, kv_heads=kvh, vocab=vocab,
                             max_pos=128)
    rng = np.random.default_rng(seed)
    q, kv = jcfg.q_dim, jcfg.kv_dim

    def lin(out_f, in_f):
        codes = rng.integers(0, 2 ** bits, size=(out_f, in_f))
        scales = (rng.uniform(0.001, 0.004, size=(out_f, in_f // 128))
                  * min(1.0, 16.0 / (1 << bits))).astype(np.float32)
        return jql.QLinear("uniform", {
            "qweight": jnp.asarray(pack_int_rows(
                torch.from_numpy(codes), bits).numpy()),
            "scales": jnp.asarray(scales)}, bits, in_f)

    def norm():
        w = rng.uniform(0.5, 1.5, size=(hidden,)) if norms \
            else np.ones(hidden)
        return {"weight": jnp.asarray(w.astype(dtype))}

    params = {"embed_tokens": {"weight": jnp.asarray(
        (rng.normal(size=(vocab, hidden)) * 0.02).astype(dtype))},
        "final_norm": {"weight": jnp.ones((hidden,), dtype)}, "layers": [
            {"input_norm": norm(), "post_norm": norm(),
             "attn": {"q": lin(q, hidden), "k": lin(kv, hidden),
                      "v": lin(kv, hidden), "o": lin(hidden, q)},
             "mlp": {"gate": lin(inter, hidden), "up": lin(inter, hidden),
                     "down": lin(hidden, inter)}} for _ in range(2)]}
    return jcfg, params


def zp_ao_pair(hidden, heads, kvh, inter, bits, asym, actorder, seed=3,
               unbalanced=False, vocab=64):
    """(jax cfg, jax params, port cfg, port model): a 2-layer uniform llama
    (random norms, :func:`np_uniform_llama`) through :func:`inject_zp_ao`,
    the same weights in both packages."""
    from ganq_tpu_torch.models import hf_import as thf

    from test_torch_serve import _flatten_jax
    from test_torch_stacked import _port_cfg

    jcfg, params = np_uniform_llama(hidden, heads, kvh, inter, bits, vocab,
                                    seed)
    inject_zp_ao(params, bits, asym, actorder, seed, unbalanced)
    tcfg, tmodel = thf.params_from_numpy(
        thf.config_to_hf(_port_cfg(hidden, heads, kvh, inter, vocab)),
        _flatten_jax(params), device="cpu")
    return jcfg, params, tcfg, tmodel


def zp_ao_packs(jcfg, params, tcfg, tmodel, bits):
    """Both packages' kernel 14 packs of the pair, act-order baked
    (``actorder_transform``) and its activation routing attached: the
    JAX package's Beneš masks, the port's column orders."""
    sp = jst.stack_layers(params, recode="affine")
    jtsp, masks = jlb.actorder_transform(jcfg, sp, bits)
    jmp = dict(jlb.megapack_lowbit(jcfg, jtsp, bits))
    jmp.update(masks)
    ttsp, aps = tlb.actorder_transform(
        tcfg, tst.stack_layers(tmodel, recode="affine"), bits)
    tmp = tlb.megapack_lowbit(tcfg, ttsp, bits)
    tmp.update(aps)
    return sp, jmp, tmp


# (bits, zero points, act-order, decode batch) at hidden 256, 2 heads, 1 kv
# head, I = 512: the JAX tests' cases (tests/test_megastep_lowbit.py:429,
# :681) at the smallest widths kernel 14 takes, for the test budget
_ZP_AO = {"zp8": (8, True, False, 12), "ao4": (4, False, True, 8),
          "zp_ao4": (4, True, True, 8)}


@pytest.fixture(scope="module")
def zp_ao():
    """Per case of ``_ZP_AO``: (jax cfg, jax pack, port pack)."""
    out = {}
    for case, (bits, asym, actorder, _) in _ZP_AO.items():
        pair = zp_ao_pair(256, 2, 1, 512, bits, asym, actorder)
        out[case] = (pair[0], *zp_ao_packs(*pair, bits)[1:])
    return out


@pytest.mark.parametrize("case", sorted(_ZP_AO))
def test_zero_point_actorder_packs_match_jax(zp_ao, case):
    """With zero points the port's pack adds ganq_tpu's float32 corrections
    ``qkv_sz``/``o_sz``/``gu_sz``/``dn_sz`` byte for byte; act-order packs
    (columns group-sorted, gate/up rows with their scales and zeros in
    down's order) equal ganq_tpu's byte for byte, and each column order
    ``ap_q``/``ap_g``/``ap_o`` is the permutation ganq_tpu's Beneš masks
    apply to ``arange``."""
    from ganq_tpu.ops.lane_perm import apply_benes_np

    _, asym, actorder, _ = _ZP_AO[case]
    _, jmp, tmp = zp_ao[case]
    assert sorted(tmp) == sorted(jmp)
    assert ("qkv_sz" in tmp) == asym and ("ap_q" in tmp) == actorder
    for k, v in jmp.items():
        if k in ("ap_q", "ap_g", "ap_o"):
            masks = np.asarray(jnp.asarray(v, jnp.float32))
            n = masks.shape[-1]
            want = np.stack([apply_benes_np(np.arange(n)[None], m)[0]
                             for m in masks])
            assert tmp[k].dtype == torch.int32
            np.testing.assert_array_equal(tmp[k].numpy(), want, err_msg=k)
            assert not np.array_equal(want[0], np.arange(n))
            continue
        assert tuple(tmp[k].shape) == v.shape, k
        assert tmp[k].dtype == _t(v[:1]).dtype, k
        np.testing.assert_array_equal(tmp[k].float().numpy(), _np(v),
                                      err_msg=k)


@pytest.mark.parametrize("case", sorted(_ZP_AO))
def test_zero_point_actorder_plain_matches_jax_interpret(zp_ao, case):
    """The plain version of kernel 14 with zero points (bits 8, batch 12),
    act-order (bits 4, batch 8) and both (bits 4, batch 8) against
    ganq_tpu's kernel in interpret mode, each slot at its own history
    length, within ``assert_kernel_close``'s bound (one bf16 ulp plus 5e-3
    of the largest output: an int8 activation within the frameworks'
    last-bit rounding differences of a tie flips by one code; with zero
    points the flip also moves the group sum S by one, which adds +-sz,
    inside the same bound)."""
    bits, asym, actorder, B = _ZP_AO[case]
    jcfg, jmp, tmp = zp_ao[case]
    rng = np.random.default_rng(40 + B)
    T, d = 64, 128
    pos = [30, 3, 20, 63, 41, 7, 33, 12, 28, 50, 5, 60][:B]
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
    for name, g, r in zip(("y", "k", "v"), got, ref):
        assert tuple(g.shape) == r.shape and g.dtype == torch.bfloat16
        assert_kernel_close(g.float().numpy(), _np(r), flips=5e-3,
                            what=f"{case} {name} B={B}")


# ------------------------------------------------ the trailing-unembed fold
def _lm_pair(bits, vocab=256, seed=5):
    """(jax cfg, jax stacked params, port cfg, port stacked model, lm_head
    arrays): :func:`np_uniform_llama` at kernel 14's smallest shapes of
    ``_ZP_AO`` (hidden 256, 2 heads, 1 kv head, I = 512) with a random
    ``w8`` lm_head (int8 rows, float32 row scales) and final norm weights in
    [0.5, 1.5) (``tests/test_megastep_lowbit.py::
    test_megastep_lowbit_lm_fold``), the same in both packages."""
    from ganq_tpu.ops import qlinear as jql
    from ganq_tpu_torch.models import hf_import as thf
    from ganq_tpu_torch.ops import qlinear as tql

    from test_torch_serve import _flatten_jax
    from test_torch_stacked import _port_cfg

    H = 256
    jcfg, params = np_uniform_llama(H, 2, 1, 512, bits, vocab, seed)
    tcfg, tmodel = thf.params_from_numpy(
        thf.config_to_hf(_port_cfg(H, 2, 1, 512, vocab)),
        _flatten_jax(params), device="cpu")
    rng = np.random.default_rng(seed)
    arrays = {"w8": rng.integers(-127, 128, size=(vocab, H)).astype(np.int8),
              "scale": rng.uniform(1e-4, 4e-4, size=(vocab, 1)).astype(
                  np.float32),
              "norm": rng.uniform(0.5, 1.5, size=(H,)).astype(np.float32)}
    sp = jst.stack_layers(params, recode="affine")
    sp["lm_head"] = jql.QLinear("w8", {"w8": jnp.asarray(arrays["w8"]),
                                       "scale": jnp.asarray(arrays["scale"])},
                                8, H)
    sp["final_norm"] = {"weight": jnp.asarray(arrays["norm"])}
    tsp = tst.stack_layers(tmodel, recode="affine")
    tsp.lm_head = tql.QLinear("w8", {
        "w8": torch.from_numpy(arrays["w8"]),
        "scale": torch.from_numpy(arrays["scale"])}, bits=8, in_features=H)
    tsp.final_norm.weight = torch.from_numpy(arrays["norm"])
    return jcfg, sp, tcfg, tsp, arrays


@pytest.fixture(scope="module")
def lm_fold():
    return _lm_pair(8)


def test_lm_fold_plain_matches_jax_interpret(lm_fold):
    """Kernel 14 "w8p" with the trailing-unembed fold (batch 4, each slot at
    its own history length): the port's plain version against ganq_tpu's
    kernel in interpret mode. y, k and v are those of the step without the
    fold, bit for bit, and within ``assert_kernel_close`` of ganq_tpu's;
    the fold's operands equal ganq_tpu's (the scales without the TPU's
    8-sublane copy). From one float32 residual both packages' final norm
    and int8 rows (``_quant_rows``) give equal x8 and sx, and the plain
    fold's logits then equal ganq_tpu's formula ``(dv * sx) * scale`` bit
    for bit. Against the interpret-mode kernel, whose residual differs from
    the plain version's by the frameworks' last-bit rounding, the logits
    agree within 2e-2 of their largest magnitude (an int8 code that flips
    at a tie moves a logit by at most 127 * sx * scale) and correlate above
    0.9999."""
    from ganq_tpu.ops.megastep4 import _quant_rows

    jcfg, sp, tcfg, tsp, arrays = lm_fold
    jlm = jlb.mega_lm_operands(jcfg, sp)
    tlm = tlb.mega_lm_operands(tcfg, tsp)
    assert jlm is not None and tlm is not None
    np.testing.assert_array_equal(tlm["w8"].numpy(), np.asarray(jlm["w8"]))
    np.testing.assert_array_equal(tlm["scale"].numpy(),
                                  np.asarray(jlm["scale"])[:, 0, :])
    np.testing.assert_array_equal(tlm["norm"].numpy(),
                                  np.asarray(jlm["norm"]).reshape(-1))
    jmp = jlb.megapack_lowbit(jcfg, sp, 8)
    tmp = tlb.megapack_lowbit(tcfg, tsp, 8)
    B, T, d = 4, 64, 128
    pos = [17, 5, 40, 63]
    rng = np.random.default_rng(61)
    x, jk, jv, cos, sin = _step_inputs(rng, jcfg, B, T, pos)
    kw = dict(q_dim=jcfg.q_dim, kv_dim=jcfg.num_key_value_heads * d,
              head_dim=d, rotary_dim=d, eps=1e-5, scale=float(1 / np.sqrt(d)),
              bits=8)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.block_until_ready(jlb.megastep_lowbit_decode(
            x, jmp, jk, jv, jnp.asarray(pos, jnp.int32), jnp.asarray(cos),
            jnp.asarray(sin), lm=jlm, **kw))
    args = (tmp, _t(jk), _t(jv), torch.tensor(pos), torch.from_numpy(cos),
            torch.from_numpy(sin))
    got = tlb.megastep_lowbit_decode(_t(x), *args, lm=tlm, **kw)
    plain = tlb.megastep_lowbit_decode(_t(x), *args, **kw)
    assert len(got) == 4 and len(plain) == 3
    for g, p in zip(got[:3], plain):
        assert torch.equal(g, p)
    for name, g, r in zip(("y", "k", "v"), got[:3], ref[:3]):
        assert_kernel_close(g.float().numpy(), _np(r), flips=5e-3,
                            what=f"lm fold {name}")
    lg, rlg = got[3].numpy(), np.asarray(ref[3])
    assert lg.shape == rlg.shape == (B, 256) and got[3].dtype == torch.float32
    assert np.abs(lg - rlg).max() <= 2e-2 * np.abs(rlg).max()
    assert np.corrcoef(lg.ravel(), rlg.ravel())[0, 1] > 0.9999
    # the fold from one float32 residual: the port's float32 y is it
    xs = tlb.megastep_lowbit_decode(_t(x).float(), *args, **kw)[0]
    assert xs.dtype == torch.float32
    xj = jnp.asarray(xs.numpy())
    var = jnp.mean(xj * xj, axis=1, keepdims=True)
    x8j, sxj = _quant_rows(xj * jax.lax.rsqrt(var + 1e-5)
                           * (jnp.asarray(arrays["norm"]) + 0.0))
    from ganq_tpu_torch.ops.fused_attention import rms_rows
    from ganq_tpu_torch.ops.uniform_matmul import quantize_rows
    x8t, sxt = quantize_rows(rms_rows(xs, tlm["norm"], 1e-5))
    np.testing.assert_array_equal(x8t.numpy(), np.asarray(x8j, np.float32))
    np.testing.assert_array_equal(sxt.numpy(), np.asarray(sxj))
    dv = jax.lax.dot_general(x8j, jnp.asarray(arrays["w8"]),
                             (((1,), (1,)), ((), ())),
                             preferred_element_type=jnp.int32)
    want = np.asarray(dv.astype(jnp.float32) * sxj
                      * jnp.asarray(arrays["scale"]).reshape(1, -1))
    np.testing.assert_array_equal(
        tlb.lm_fold_plain(xs, tlm, 1e-5).numpy(), want)


def test_lm_fold_operands_none_where_jax(lm_fold):
    """``mega_lm_operands`` gives operands, and the same vocabulary tile,
    exactly where ganq_tpu's does: None without an lm_head, for a dense
    one, with a bias, with a per-tensor scale, or where no tile of 4096 ..
    128 rows divides the vocabulary within the byte cap."""
    from ganq_tpu.ops import qlinear as jql
    from ganq_tpu_torch.ops import qlinear as tql

    jcfg, sp, tcfg, tsp, arrays = lm_fold
    w8, sc = arrays["w8"], arrays["scale"]
    H = w8.shape[1]

    def pair(kind, arrs):
        j = jql.QLinear(kind, {k: jnp.asarray(v) for k, v in arrs.items()},
                        8, H)
        t = tql.QLinear(kind, {k: torch.from_numpy(v)
                               for k, v in arrs.items()},
                        bits=8, in_features=H)
        return j, t

    cases = {
        "w8": pair("w8", {"w8": w8, "scale": sc}),
        "none": (None, None),
        "dense": pair("dense", {"weight": w8.astype(np.float32)}),
        "bias": pair("w8", {"w8": w8, "scale": sc,
                            "bias": np.zeros(len(w8), np.float32)}),
        "per_tensor": pair("w8", {"w8": w8, "scale": sc[:1]}),
        "vocab_200": pair("w8", {"w8": w8[:200], "scale": sc[:200]}),
        "vocab_384": pair("w8", {"w8": np.concatenate([w8, w8[:128]]),
                                 "scale": np.concatenate([sc, sc[:128]])}),
    }
    for name, (jl, tl) in cases.items():
        jsp = dict(sp)
        if jl is None:
            jsp.pop("lm_head")
        else:
            jsp["lm_head"] = jl
        tsp.lm_head = tl
        jo = jlb.mega_lm_operands(jcfg, jsp)
        to = tlb.mega_lm_operands(tcfg, tsp)
        assert (jo is None) == (to is None), name
        if to is not None:
            assert tuple(to["scale"].shape) == tuple(
                np.asarray(jo["scale"]).shape[::2]), name
        jo = jlb.mega_lm_operands(jcfg, jsp, max_tile_bytes=64 * H)
        to = tlb.mega_lm_operands(tcfg, tsp, max_tile_bytes=64 * H)
        assert jo is None and to is None, name
    tsp.lm_head = cases["w8"][1]


# ------------------------------------------------------ the EoRA epilogue
def inject_lora(params, rank, seed=9):
    """Give every linear of ganq_tpu's per-layer params a random EoRA
    adapter (``tests/test_megastep_lowbit.py::_inject_lora``'s role): A
    [rank, in] with rows of norm ~1, B [out, rank] at 2e-2, float32."""
    from ganq_tpu.ops import qlinear as jql

    rng = np.random.default_rng(seed)
    for lp in params["layers"]:
        for group in ("attn", "mlp"):
            for name, m in list(lp[group].items()):
                out_f = m["scales"].shape[0]
                arrays = dict(m.arrays)
                arrays["lora_a"] = jnp.asarray(
                    (rng.normal(size=(rank, m.in_features))
                     / np.sqrt(m.in_features)).astype(np.float32))
                arrays["lora_b"] = jnp.asarray(
                    (rng.normal(size=(out_f, rank)) * 2e-2).astype(
                        np.float32))
                lp[group][name] = jql.QLinear(m.kind, arrays, m.bits,
                                              m.in_features)
    return params


# (bits, zero points, act-order, decode batch, rank) at hidden 256: the
# cases of ganq_tpu's test_megastep_lowbit_eora_epilogue (bits 4 at B 8,
# bits 4 with act-order), and 8 bits with zero points
_LORA = {"lora4": (4, False, False, 8, 8), "lora_ao4": (4, False, True, 8, 8),
         "lora_zp8": (8, True, False, 8, 16)}


@pytest.fixture(scope="module")
def lora_packs():
    """Per case of ``_LORA``: (jax cfg, jax pack, port pack)."""
    from ganq_tpu_torch.models import hf_import as thf

    from test_torch_serve import _flatten_jax
    from test_torch_stacked import _port_cfg

    out = {}
    for case, (bits, asym, actorder, _, rank) in _LORA.items():
        jcfg, params = np_uniform_llama(256, 2, 1, 512, bits)
        inject_zp_ao(params, bits, asym, actorder)
        inject_lora(params, rank)
        tcfg, tmodel = thf.params_from_numpy(
            thf.config_to_hf(_port_cfg(256, 2, 1, 512, 64)),
            _flatten_jax(params), device="cpu")
        out[case] = (jcfg, *zp_ao_packs(jcfg, params, tcfg, tmodel,
                                        bits)[1:])
    return out


@pytest.mark.parametrize("case", sorted(_LORA))
def test_lora_plain_matches_jax_interpret(lora_packs, case):
    """Kernel 14's EoRA operands and epilogue: the port's pack carries
    ganq_tpu's ``la_*``/``lb_*`` byte for byte (bf16; ``lb_g`` tile-major;
    under act-order every ``lora_a`` in its projection's column order and
    gate/up's ``lora_b`` rows in down's), and its plain version matches
    ganq_tpu's kernel in interpret mode (whose rank-r dots run in float32
    on the CPU) within ``assert_kernel_close``'s bound, each slot at its
    own history length."""
    bits, asym, actorder, B, rank = _LORA[case]
    jcfg, jmp, tmp = lora_packs[case]
    assert sorted(tmp) == sorted(jmp)
    # q/k/v and gate/up fuse block-diagonally: 3 and 2 ranks stacked
    assert tmp["la_q"].shape[1] == 3 * rank and tmp["la_g"].shape[1] == 2 * rank
    for k, v in jmp.items():
        if k in ("ap_q", "ap_g", "ap_o"):
            continue
        assert tuple(tmp[k].shape) == v.shape, k
        assert tmp[k].dtype == _t(v[:1]).dtype, k
        np.testing.assert_array_equal(tmp[k].float().numpy(), _np(v),
                                      err_msg=k)
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
    without = tlb.megastep_lowbit_decode(
        _t(x), {k: v for k, v in tmp.items() if k not in tlb._LORA_KEYS},
        _t(jk), _t(jv), torch.tensor(pos), torch.from_numpy(cos),
        torch.from_numpy(sin), **kw)
    for name, g, r, w in zip(("y", "k", "v"), got, ref, without):
        assert tuple(g.shape) == r.shape and g.dtype == torch.bfloat16
        assert_kernel_close(g.float().numpy(), _np(r), flips=5e-3,
                            what=f"{case} {name} B={B}")
        assert not torch.equal(g, w), f"{case} {name}: no rank-r term"
