"""Kernel 14's "w3", "w2" and "wl8" variants of the port against ``ganq_tpu``.

"w3"/"w2" are uniform 3- and 2-bit weights in ``ganq_tpu``'s 3-plane and
1-plane field packs (``_PLAN``); "wl8" serves per-row 8-entry codebooks
(GANQ at ``bits=3``) at 3 bits a weight through the Walsh planes: the 3
linear bit planes and 8 float32 coefficient rows per output row. The models
are 2-layer llamas at hidden 1024, 8 heads, 4 kv heads, I = 1024 (3-bit
planes hold 8 row blocks of 128-lane fields, so the hidden size is a
multiple of 1024), drawn with numpy and carried into the port. The port's
packs equal ``ganq_tpu``'s byte for byte (the Walsh coefficients too: the
port sums them in ``ganq_tpu``'s float32 order); its plain version of the
kernel is held to ``ganq_tpu``'s kernel in interpret mode within
``assert_kernel_close``'s bound, and with the optional operands to its XLA
oracle ``megastep_lowbit_reference`` at the JAX tests' tolerances (y atol
5e-2 / rtol 5e-2, k/v atol 3e-2 / rtol 2e-2: the oracle rounds the residual
to bf16 after every layer and takes one dot per product). The serving paths
(``GANQ_MEGASTEP=1``: the static engine and the batching engine) are held
to ``ganq_tpu``'s tokens, and checkpoints cross between the packages."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ganq_tpu.ops import megastep_lowbit as jlb
from ganq_tpu.ops import qlinear as jql
from ganq_tpu.serve import stacked as jst
from ganq_tpu_torch.models import hf_import as thf
from ganq_tpu_torch.ops import megastep_lowbit as tlb
from ganq_tpu_torch.serve import stacked as tst

from test_torch_fused_w8a8 import assert_kernel_close
from test_torch_megastep import _t
from test_torch_megastep_lowbit import (_step_inputs, inject_lora,
                                        zp_ao_packs, zp_ao_pair)
from test_torch_serve import _flatten_jax
from test_torch_stacked import _np, _pair, _port_cfg
from test_torch_packing import torch_threads_per_worker  # noqa: F401

# hidden, heads, kv heads, intermediate of every model here (2 layers)
_W = (1024, 8, 4, 1024)


# variant -> (synthetic kind, plane bits, walsh)
_VARIANTS = {"w3": ("uniform", 3, 0), "w2": ("uniform", 2, 0),
             "wl8": ("lut3", 3, 7)}


def _packs(jcfg, params, tcfg, tmodel, variant):
    """(jax stacked params, jax pack, port stacked model, port pack)."""
    _, bits, walsh = _VARIANTS[variant]
    sp = jst.stack_layers(params, recode="affine")
    tsp = tst.stack_layers(tmodel, recode="affine")
    if walsh:
        return (sp, jlb.megapack_walsh(jcfg, sp), tsp,
                tlb.megapack_walsh(tcfg, tsp))
    return (sp, jlb.megapack_lowbit(jcfg, sp, bits), tsp,
            tlb.megapack_lowbit(tcfg, tsp, bits))


@pytest.fixture(scope="module")
def variants():
    """Per variant: (jax cfg, jax stacked params, jax pack, port cfg, port
    stacked model, port pack); random norms."""
    out = {}
    for variant, (kind, bits, _) in _VARIANTS.items():
        jcfg, params, tcfg, tmodel = _pair(*_W, kind, bits, seed=7,
                                           norms=True)
        sp, jmp, tsp, tmp = _packs(jcfg, params, tcfg, tmodel, variant)
        out[variant] = (jcfg, sp, jmp, tcfg, tsp, tmp)
    return out


def _gptq_pair(bits):
    """(jax cfg, jax params, port cfg, port model): GPTQModel's default
    layout at ``bits``, asymmetric with integer zero points and act-order
    (g_idx over shuffled columns), 2 layers at ``_W``, vocab 64."""
    jcfg, params, tcfg, _ = zp_ao_pair(*_W, bits, True, True)
    for lp in params["layers"]:
        for group in ("attn", "mlp"):
            for m in lp[group].values():
                m.arrays["zeros"] = jnp.round(m["zeros"])
    _, tmodel = thf.params_from_numpy(thf.config_to_hf(tcfg),
                                      _flatten_jax(params), device="cpu")
    return jcfg, params, tcfg, tmodel


@pytest.fixture(scope="module")
def gptq():
    """Per bits 3 and 2: (jax cfg, jax params, port cfg, port model, jax
    stacked params, jax pack, port pack) of :func:`_gptq_pair`, act-order
    baked into both packs (``zp_ao_packs``)."""
    out = {}
    for bits in (3, 2):
        pair = _gptq_pair(bits)
        out[bits] = (*pair, *zp_ao_packs(*pair, bits))
    return out


@pytest.fixture(scope="module")
def lut3():
    """(jax cfg, jax params, port cfg, port model): a GANQ-3 ``lut`` llama
    (8-entry codebooks, random norms) at ``_W``, vocab 64."""
    return _pair(*_W, "lut3", 3, seed=5, norms=True, vocab=64)


def _assert_same_pack(tmp, jmp):
    assert sorted(tmp) == sorted(jmp)
    for k, v in jmp.items():
        assert tuple(tmp[k].shape) == v.shape, k
        assert tmp[k].dtype == _t(v[:1]).dtype, k
        np.testing.assert_array_equal(tmp[k].float().numpy(), _np(v),
                                      err_msg=k)


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_packs_match_jax_bytes(variants, variant):
    """``megapack_lowbit`` at 3 and 2 bits and ``megapack_walsh`` give
    ``ganq_tpu``'s keys, shapes, types and bytes: the plane bytes, the bf16
    scales, and the float32 Walsh coefficient rows bit for bit; the gates
    agree that each model takes its variant."""
    jcfg, sp, jmp, tcfg, tsp, tmp = variants[variant]
    _assert_same_pack(tmp, jmp)
    _, bits, walsh = _VARIANTS[variant]
    if walsh:
        assert jlb.megastep_walsh_fusable(jcfg, sp)
        assert tlb.megastep_walsh_fusable(tcfg, tsp)
        assert tmp["qkv_s"].dtype == torch.float32
    else:
        assert tlb.megastep_lowbit_fusable(tcfg, tsp, bits)
        assert jlb.megastep_lowbit_fusable(jcfg, sp, bits)


@pytest.mark.parametrize("bits", [3, 2])
def test_zero_point_actorder_packs_match_jax(gptq, bits):
    """3- and 2-bit packs with zero points and act-order: the planes of the
    group-sorted columns, the scales and float32 corrections equal
    ``ganq_tpu``'s byte for byte, and each column order ``ap_*`` is the
    permutation ``ganq_tpu``'s Beneš masks apply to ``arange``."""
    from ganq_tpu.ops.lane_perm import apply_benes_np

    jmp, tmp = (dict(m) for m in gptq[bits][5:])
    assert {"qkv_sz", "dn_sz", "ap_q", "ap_g", "ap_o"} <= set(tmp)
    for k in ("ap_q", "ap_g", "ap_o"):
        masks = np.asarray(jnp.asarray(jmp.pop(k), jnp.float32))
        n = masks.shape[-1]
        want = np.stack([apply_benes_np(np.arange(n)[None], m)[0]
                         for m in masks])
        np.testing.assert_array_equal(tmp.pop(k).numpy(), want, err_msg=k)
    _assert_same_pack(tmp, jmp)


def test_plane_codes_invert_the_packs():
    """The plain version's decodes of the 3- and 2-bit planes
    (``_plane_codes``: split rows joined, top fields XOR their sign bit) and
    of the Walsh planes (``_walsh_codes``) give back every code of a tile,
    and ``walsh_coef`` reproduces any 8-entry codebook at every code:
    ``T[r, c] = c0[r] + sum_j c_j[r] m_j(c)`` (``tests/test_megastep_
    lowbit.py:254``)."""
    rng = np.random.default_rng(0)
    for bits, tile in ((3, 2048), (2, 1024), (4, 512), (8, 128)):
        codes = torch.from_numpy(rng.integers(0, 2 ** bits, size=(2 * tile,
                                                                   256)))
        pk = tlb._plane_pack(codes, tile, bits)
        np.testing.assert_array_equal(
            pk.numpy(), np.asarray(jlb._plane_pack(codes.numpy(), tile,
                                                   bits)))
        assert torch.equal(tlb._plane_codes(pk, tile, bits),
                           (codes - (1 << (bits - 1))).to(torch.int32))
    codes = torch.from_numpy(rng.integers(0, 8, size=(2048, 256)))
    pk = tlb._walsh_plane_pack(codes, 1024)
    np.testing.assert_array_equal(
        pk.numpy(), np.asarray(jlb._walsh_plane_pack(codes.numpy(), 1024)))
    assert torch.equal(tlb._walsh_codes(pk, 1024), codes.to(torch.int32))
    lut = rng.normal(size=(64, 8)).astype(np.float32)
    cf = tlb.walsh_coef(torch.from_numpy(lut)).numpy()
    np.testing.assert_array_equal(cf, np.asarray(jlb.walsh_coef(lut)))
    rec = np.zeros_like(lut)
    for c in range(8):
        v = cf[0]
        for j, S in enumerate(tlb._MONO):
            bit = 0
            for b in S:
                bit ^= (c >> b) & 1
            v = v + cf[1 + j] * bit
        rec[:, c] = v
    np.testing.assert_allclose(rec, lut, atol=1e-5)


@pytest.mark.parametrize("variant,B", [("w3", 8), ("w2", 8), ("wl8", 8),
                                       ("wl8", 16)])
def test_plain_matches_jax_interpret(variants, variant, B):
    """The plain version of kernel 14 ("w3", "w2" and "wl8" at B = 8, "wl8"
    at B = 16, the octet row stride of the TPU kernel) against
    ``ganq_tpu``'s kernel in interpret mode, each slot at its own history
    length. Both take the same integer dots (the uniform groups' and the
    Walsh walks' exact int32 sums) and the same float32 steps in the same
    order; the frameworks round the rmsnorm and attention sums in their last
    bits, which flips an int8 activation near a tie by one code, inside
    ``assert_kernel_close``'s bound."""
    jcfg, _, jmp, _, _, tmp = variants[variant]
    _, bits, walsh = _VARIANTS[variant]
    rng = np.random.default_rng(30 + B)
    T, d = 64, 128
    pos = ([50, 3, 20, 63, 41, 7, 33, 12] * 2)[:B]
    x, jk, jv, cos, sin = _step_inputs(rng, jcfg, B, T, pos)
    kw = dict(q_dim=jcfg.q_dim, kv_dim=jcfg.num_key_value_heads * d,
              head_dim=d, rotary_dim=d, eps=1e-5, scale=float(1 / np.sqrt(d)),
              bits=bits, walsh=walsh)
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
                            what=f"{variant} {name} B={B}")


# ------------------------------------------------- optional operands
def _dequant(m, i):
    """Layer i's float32 weight [out, in] of ganq_tpu's stacked uniform or
    ``lut`` linear, as ``ganq_tpu.ops.qlinear.dequantize_weight`` forms it
    (``scale * (q - zero)`` per column's group; the codebook entry), in
    numpy (the codes unpacked by the port's unpacker, whose bytes are
    ganq_tpu's: ``tests/test_torch_packing.py``)."""
    from ganq_tpu_torch.ops.packing import unpack_int_rows

    def codes(key):
        return unpack_int_rows(torch.from_numpy(np.array(m[key][i])), m.bits,
                               m.in_features).numpy()

    if m.kind == "lut":
        return np.take_along_axis(np.asarray(m["lut"][i], np.float32),
                                  codes("idx_packed"), axis=1)
    s = np.asarray(m["scales"][i], np.float32)
    gi = (np.asarray(m["g_idx"][i]) if "g_idx" in m.arrays
          else np.arange(m.in_features) // (m.in_features // s.shape[1]))
    z = (np.asarray(m["zeros"][i], np.float32) if "zeros" in m.arrays
         else np.full_like(s, float(1 << (m.bits - 1))))
    return s[:, gi] * (codes("qweight").astype(np.float32) - z[:, gi])


def _oracle_layers(sp):
    """``megastep_lowbit_reference``'s per-layer operands of ganq_tpu's
    stacked params: dequantized float32 weights (:func:`_dequant`), norms,
    biases, q/k norms, sandwich norms and EoRA factors."""
    ls = sp["layers_stacked"]
    mods = {"qkv": ls["attn"]["qkv"], "o": ls["attn"]["o"],
            "gu": ls["mlp"]["gateup"], "down": ls["mlp"]["down"]}
    f32 = jnp.float32
    out = []
    for i in range(ls["input_norm"]["weight"].shape[0]):
        w = {k: jnp.asarray(_dequant(m, i)) for k, m in mods.items()}
        arr = {k: {a: v[i] for a, v in m.arrays.items()}
               for k, m in mods.items()}
        I = w["gu"].shape[0] // 2
        lw = {"attn_norm": ls["input_norm"]["weight"][i].astype(f32),
              "mlp_norm": ls["post_norm"]["weight"][i].astype(f32),
              "qkv_w": w["qkv"],
              "qkv_bias": arr["qkv"].get(
                  "bias", jnp.zeros((w["qkv"].shape[0],), f32)).astype(f32),
              "o_w": w["o"], "gate_w": w["gu"][:I], "up_w": w["gu"][I:],
              "down_w": w["down"]}
        for name in ("q_norm", "k_norm"):
            if name in ls["attn"]:
                lw[name] = ls["attn"][name]["weight"][i].astype(f32)
        for name in ("post_attn_norm", "post_mlp_norm"):
            if name in ls:
                lw[name] = ls[name]["weight"][i].astype(f32)
        for k, name in (("o", "o_bias"), ("down", "down_bias")):
            if "bias" in arr[k]:
                lw[name] = arr[k]["bias"].astype(f32)
        if "bias" in arr["gu"]:
            lw["gate_bias"] = arr["gu"]["bias"][:I].astype(f32)
            lw["up_bias"] = arr["gu"]["bias"][I:].astype(f32)
        if "lora_a" in arr["qkv"]:
            for k in mods:
                lw[f"{k}_la"] = arr[k]["lora_a"].astype(f32)
                lw[f"{k}_lb"] = arr[k]["lora_b"].astype(f32)
        out.append(lw)
    return out


def _jax_operands(jcfg, sp, bits):
    """``ganq_tpu``'s operands every kernel-14 pack shares
    (``_common_pack_ops``: norms, qkv bias, qk-norm rows, sandwich norms,
    o/gate-up/down biases, EoRA factors) of its stacked params, without
    packing the planes."""
    ls = sp["layers_stacked"]
    mods = (ls["attn"]["qkv"], ls["attn"]["o"], ls["mlp"]["gateup"],
            ls["mlp"]["down"])
    L, Dqkv = _stacked_rows(mods[0])
    I = _stacked_rows(mods[2])[1] // 2
    H = jcfg.hidden_size
    return jlb._common_pack_ops(jcfg, ls, *mods, L, H, Dqkv, I,
                                jlb._mlp_plan(I, bits, H)[0])


def _stacked_rows(m):
    """(layers, output rows) of a stacked uniform or ``lut`` linear."""
    return (m["scales"] if "scales" in m.arrays else m["lut"]).shape[:2]


def _bias_lora(params, rank, seed=12):
    """q/k/v, o, gate/up and down biases of std 0.05 and EoRA adapters of
    ``rank`` (A rows of norm ~1, B at 2e-2) on ganq_tpu's per-layer params
    of any kind."""
    rng = np.random.default_rng(seed)
    for lp in params["layers"]:
        for group, names in (("attn", "qkvo"), ("mlp", ("gate", "up",
                                                        "down"))):
            for n in names:
                m = lp[group][n]
                out_f = (m["scales"] if "scales" in m.arrays
                         else m["lut"]).shape[0]
                arrays = dict(m.arrays, bias=jnp.asarray(rng.normal(
                    size=(out_f,)).astype(np.float32) * 0.05))
                if rank:
                    arrays["lora_a"] = jnp.asarray((rng.normal(size=(
                        rank, m.in_features)) / np.sqrt(m.in_features)
                    ).astype(np.float32))
                    arrays["lora_b"] = jnp.asarray((rng.normal(size=(
                        out_f, rank)) * 2e-2).astype(np.float32))
                lp[group][n] = jql.QLinear(m.kind, arrays, m.bits,
                                           m.in_features)
    return params


def _gemma2_pair(bits):
    """(jax cfg, jax params, port cfg, port model): a 2-layer Gemma 2 of
    uniform ``bits``-bit linears at hidden 512 (4 heads of 128, 2 kv heads,
    I = 1024; a sliding layer of window 8 and a full one, attention softcap
    2, sandwich norm weights stored as w - 1 in [-0.3, 0.3);
    ``test_torch_gemma.gemma_pair`` at the widths 2-bit planes take)."""
    from ganq_tpu.models.registry import get_spec as jget_spec
    from ganq_tpu_torch.models import registry as treg

    from test_torch_gemma import _hf
    from test_torch_megastep_lowbit import np_uniform_llama

    H = 512
    _, params = np_uniform_llama(H, 4, 2, 1024, bits, vocab=256, seed=13)
    hf = _hf("gemma2", hidden=H, heads=4, kv=2, inter=1024)
    jcfg = jget_spec("gemma2").make_config(hf)
    tcfg = treg.get_spec("gemma2").make_config(hf)
    rng = np.random.default_rng(113)
    for lp in params["layers"]:
        for n in ("post_attn_norm", "post_mlp_norm"):
            lp[n] = {"weight": jnp.asarray(rng.uniform(
                -0.3, 0.3, size=(H,)).astype(np.float32))}
    _, tmodel = thf.params_from_numpy(thf.config_to_hf(tcfg),
                                      _flatten_jax(params), device="cpu")
    return jcfg, params, tcfg, tmodel


# case -> (variant, zero points and act-order, qk-norm, biases, EoRA,
# gemma, fold)
_OPS = {"w3_zp_ao": ("w3", 1, 0, 0, 0, 0, 0),
        "w3_qkn": ("w3", 0, 1, 0, 0, 0, 0),
        "w2_gemma": ("w2", 0, 0, 0, 0, 1, 0),
        "wl8_bias_lora_lm": ("wl8", 0, 0, 1, 1, 0, 1)}


@pytest.mark.parametrize("case", sorted(_OPS))
def test_operands_match_jax_oracle(gptq, case):
    """The plain version with each family of optional operands against
    ``ganq_tpu``'s oracle on the same weights (batch 4, every slot at one
    position), at the JAX tests' tolerances (gemma's range-relative bound
    for the gemma case, ``test_torch_gemma._assert_close_rel``): "w3" with
    zero points and act-order, "w3" with qwen3's qk-norm, "w2" with gemma
    2's sandwich norms, sliding window (past it) and softcap, and "wl8" with
    o/gate-up/down biases, EoRA adapters (rank 8) and the trailing-unembed
    fold, whose logits are held to the oracle's final norm, int8 rows and
    lm_head product within 2e-2 of their largest magnitude. Each pack's
    optional operands equal ``ganq_tpu``'s (``_common_pack_ops``; the
    planes' bytes are held in ``test_packs_match_jax_bytes``); each call
    takes the source that takes its operands."""
    from test_torch_arch import arch_pair
    from test_torch_gemma import _assert_close_rel

    variant, zpao, qkn, bias, lora, gemma, fold = _OPS[case]
    kind, bits, walsh = _VARIANTS[variant]
    if zpao:
        jcfg, _, tcfg, _, sp, jmp, tmp = gptq[bits]
        assert {"qkv_sz", "ap_q"} <= set(tmp)
    else:
        if gemma:
            jcfg, params, tcfg, tmodel = _gemma2_pair(bits)
        elif qkn:
            jcfg, params, tcfg, tmodel = arch_pair(bits, True, False,
                                                   hidden=1024, heads=8,
                                                   kvh=4, inter=1024)
        else:
            jcfg, params, tcfg, _ = _pair(*_W, kind, bits, seed=9,
                                          norms=True)
            _bias_lora(params, 8)
            _, tmodel = thf.params_from_numpy(
                thf.config_to_hf(tcfg), _flatten_jax(params), device="cpu")
        sp = jst.stack_layers(params, recode="affine")
        tsp = tst.stack_layers(tmodel, recode="affine")
        tmp = (tlb.megapack_walsh(tcfg, tsp) if walsh
               else tlb.megapack_lowbit(tcfg, tsp, bits))
        for k, v in _jax_operands(jcfg, sp, bits).items():
            np.testing.assert_array_equal(tmp[k].float().numpy(), _np(v),
                                          err_msg=k)
    B, T, d = 4, 64, 128
    pos = 40 if gemma else 20
    rng = np.random.default_rng(70)
    x, jk, jv, cos, sin = _step_inputs(rng, jcfg, B, T, [pos] * B)
    kw = dict(q_dim=jcfg.q_dim, kv_dim=jcfg.num_key_value_heads * d,
              head_dim=d, rotary_dim=d, eps=jcfg.norm_eps,
              scale=float(jcfg.attn_scale or 1 / np.sqrt(d)),
              rms_offset=float(jcfg.rms_offset))
    ext, lws = {}, _oracle_layers(sp)
    if gemma:
        kw["act"] = "gelu_tanh"
        wins = [jcfg.layer_window(i) or T for i in range(2)]
        ext = {"windows": torch.tensor(wins), "softcap": jcfg.attn_softcap}
        for lw, w in zip(lws, wins):
            if w < T:
                lw["window"] = w
    lm = None
    if fold:
        rs = np.random.default_rng(71)
        V, H = 256, jcfg.hidden_size
        w8 = rs.integers(-127, 128, size=(V, H)).astype(np.int8)
        sc = rs.uniform(1e-4, 4e-4, size=(V,)).astype(np.float32)
        norm = rs.uniform(0.5, 1.5, size=(H,)).astype(np.float32)
        lm = {"w8": torch.from_numpy(w8),
              "scale": torch.from_numpy(sc).reshape(1, V),
              "norm": torch.from_numpy(norm)}
    got = tlb.megastep_lowbit_decode(
        _t(x), tmp, _t(jk), _t(jv), pos, torch.from_numpy(cos),
        torch.from_numpy(sin), bits=bits, walsh=walsh, lm=lm, **kw, **ext)
    oracle = jax.block_until_ready(jax.jit(functools.partial(
        jlb.megastep_lowbit_reference, pos=pos,
        softcap=float(ext.get("softcap") or 0.0), **kw))(
            x, lws, jk, jv, cos_half=jnp.asarray(cos),
            sin_half=jnp.asarray(sin)))
    for name, g, o, atol in zip(("y", "k", "v"), got, oracle,
                                (5e-2, 3e-2, 3e-2)):
        if gemma:
            _assert_close_rel(g.float().numpy(), _np(o))
            continue
        np.testing.assert_allclose(g.float().numpy(), _np(o), atol=atol,
                                   rtol=5e-2 if name == "y" else 2e-2,
                                   err_msg=f"{case} {name}")
    if fold:
        from ganq_tpu.ops.megastep4 import _quant_rows

        yo = jnp.asarray(_np(oracle[0]), jnp.float32)
        var = jnp.mean(yo * yo, axis=1, keepdims=True)
        x8, sx = _quant_rows(yo * jax.lax.rsqrt(var + kw["eps"])
                             * jnp.asarray(norm))
        want = np.asarray(x8.astype(jnp.float32) @ jnp.asarray(
            w8, jnp.float32).T * sx * jnp.asarray(sc)[None, :])
        assert np.abs(got[3].numpy() - want).max() <= 2e-2 * np.abs(
            want).max()
    keys = {"qk_nm"} if qkn else set()
    keys |= {"o_bias", "gu_bias", "dn_bias", *tlb._LORA_KEYS} if bias else set()
    keys |= set(tlb._SAND_KEYS) if gemma else set()
    assert keys <= set(tmp)
    assert tlb.kernel_library(tmp, fold, gemma, bits, walsh) == (
        "megastep_lowbit_walsh" if walsh else "megastep_lowbit_w3w2_ext")


# ------------------------------------------------------- serving paths
@pytest.mark.parametrize("variant", ["wl8", "w3"])
def test_whole_step_greedy_matches_jax(monkeypatch, gptq, lut3, variant):
    """With ``GANQ_MEGASTEP=1`` the port's stacked layout routes a GANQ-3
    ``lut`` model (8-entry codebooks) to "wl8" and an asymmetric act-order
    GPTQ W3 model to "w3", packs them (``megapack_wl``; ``megapack_lb`` with
    the column orders) and decodes every step through kernel 14's plain
    version; its greedy tokens agree with ``ganq_tpu``'s ``greedy_decode``
    (the per-layer reference path) on at least 90% of the tokens, the JAX
    tests' bound for a whole step with int8 activations
    (``tests/test_megastep_lowbit.py:272``), and the first token (prefill)
    is the same."""
    jcfg, params, tcfg, tmodel = gptq[3][:4] if variant == "w3" else lut3
    B, prompt, steps, T = 4, 8, 4, 64
    ids = np.random.default_rng(2).integers(0, 64, size=(B, prompt))
    monkeypatch.setenv("GANQ_MEGASTEP", "0")
    sp = jst.stack_layers(params, recode="affine")
    ck, cv = jst.init_cache(jcfg, 2, B, T)
    ref = np.asarray(jst.greedy_decode(jcfg, sp, ck, cv, jnp.asarray(ids),
                                       steps, "reference"))
    monkeypatch.setenv("GANQ_MEGASTEP", "1")
    assert jst.mega_enabled(jcfg, sp, "pallas_a8", B) == variant
    tsp = tst.prepack(tcfg, tst.stack_layers(tmodel, recode="affine"),
                      "reference", B, "cpu")
    assert tst.mega_enabled(tcfg, tsp, "reference", B, "cpu") == variant
    attr = tst._PACK_ATTR[variant]
    assert getattr(tsp, attr) is not None
    assert ("ap_q" in getattr(tsp, attr)) == (variant == "w3")
    ck, cv = tst.init_cache(tcfg, 2, B, T, "cpu")
    before = tlb.megastep_lowbit_decode.by_source.copy()
    toks = tst.greedy_decode(tcfg, tsp, ck, cv, torch.from_numpy(ids),
                             steps, "reference").numpy()
    agree = (toks == ref).mean()
    assert agree >= 0.9, f"token agreement {agree:.2f}\n{toks}\n{ref}"
    np.testing.assert_array_equal(toks[:, 0], ref[:, 0])
    assert tlb.megastep_lowbit_decode.by_source == before   # CPU: plain


@pytest.mark.parametrize("variant", ["w3", "wl8"])
def test_batching_engine_matches_jax(monkeypatch, gptq, lut3, variant):
    """The batching engine serves "w3" and "wl8" through one kernel-14 step
    per engine step over all slots at per-slot positions (two slots, three
    requests, so a slot is refilled); its tokens agree with ``ganq_tpu``'s
    batching engine (per layer) on at least 90% of the tokens
    (``tests/test_megastep_lowbit.py:508``)."""
    from ganq_tpu.serve.batching import BatchingEngine as JBatching
    from ganq_tpu_torch.serve.batching import BatchingEngine

    jcfg, params, tcfg, tmodel = gptq[3][:4] if variant == "w3" else lut3
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 64, size=(n,)) for n in (5, 7, 3)]
    monkeypatch.setenv("GANQ_MEGASTEP", "0")
    jeng = JBatching(jcfg, params, backend="reference", slots=2, max_seq=64,
                     prompt_buckets=(8, 16))
    for p in prompts:
        jeng.submit(p, max_new_tokens=4)
    ref = jeng.run_all()
    monkeypatch.setenv("GANQ_MEGASTEP", "1")
    eng = BatchingEngine(tcfg, tmodel, backend="reference", slots=2,
                         max_seq=64, prompt_buckets=(8, 16), device="cpu")
    assert eng._mega_variant == variant
    assert eng._mp is getattr(eng._sp, tst._PACK_ATTR[variant])
    for p in prompts:
        eng.submit(p, max_new_tokens=4)
    got = eng.run_all()
    assert set(got) == set(ref)
    n_tok = sum(len(v) for v in ref.values())
    n_agree = sum((np.asarray(got[k]) == np.asarray(ref[k])).sum()
                  for k in ref)
    assert n_agree >= 0.9 * n_tok, (got, ref)


# ---------------------------------------------------------- checkpoints
def _affine_lut3(params, seed=15):
    """Each 8-entry codebook of ganq_tpu's per-layer ``lut3`` params
    replaced by a symmetric affine grid ``s * (c - 4)`` (s in [1e-3, 4e-3)
    per row): a GANQ ``ganq_codebook="affine"`` checkpoint at 3 bits, which
    both engines certify to uniform 3-bit ("w3")."""
    rng = np.random.default_rng(seed)
    for lp in params["layers"]:
        for group in ("attn", "mlp"):
            for m in lp[group].values():
                R = m["lut"].shape[0]
                s = rng.uniform(1e-3, 4e-3, size=(R, 1))
                m.arrays["lut"] = jnp.asarray(
                    (s * (np.arange(8) - 4.0)).astype(np.float32),
                    jnp.bfloat16)
    return params


def _ckpt_pair(variant, gptq, lut3):
    """(jax cfg, jax params, port cfg, port model, quantize config) of a
    checkpoint that decodes through ``variant``: GPTQModel's W2 layout, a
    GANQ-3 ``lut`` model, or one with affine-grid codebooks."""
    if variant == "w2":
        return (*gptq[2][:4], dict(quant_method="gptq", bits=2,
                                   group_size=128, desc_act=True, sym=False))
    qcfg = dict(quant_method="ganq", bits=3)
    if variant == "wl8":
        return (*lut3, qcfg)
    jcfg, params, tcfg, _ = _pair(*_W, "lut3", 3, seed=5, norms=True,
                                  vocab=64)
    _affine_lut3(params)
    _, tmodel = thf.params_from_numpy(thf.config_to_hf(tcfg),
                                      _flatten_jax(params), device="cpu")
    return jcfg, params, tcfg, tmodel, qcfg


@pytest.mark.parametrize("variant", ["wl8", "w3", "w2"])
def test_checkpoints_cross_packages(tmp_path, gptq, lut3, variant):
    """A GANQ ``bits=3`` ``lut`` checkpoint (8-entry codebooks: "wl8"), one
    with affine-grid codebooks (``ganq_codebook="affine"``, certified to
    uniform 3-bit: "w3") and an asymmetric act-order GPTQ v1 W2 checkpoint
    ("w2"), each written by the port and by ``ganq_tpu`` (from the same
    codes, codebooks, scales, zeros and g_idx as solver artifacts): both
    packages load every tensor of either checkpoint alike, the port's
    writer keeps the model's codes, zeros and g_idx exactly (codebooks and
    scales as the formats' fp16), and the loaded models take the variant
    in both packages' gates. The GPTQ layout has no 3-bit form in either
    package (``gptq_compat``: 2, 4 and 8 bits): both writers refuse a GPTQ
    W3 checkpoint alike."""
    from ganq_tpu.core.config import QUANT_METHOD
    from ganq_tpu.core.config import QuantizeConfig as JQuantizeConfig
    from ganq_tpu.formats import checkpoint as jckpt
    from ganq_tpu.formats import gptq_compat as jcompat
    from ganq_tpu.models.registry import get_spec as jget_spec
    from ganq_tpu.ops.packing import unpack_int_rows as junpack
    from ganq_tpu.quant.looper import QuantizedModule as JArtifact
    from ganq_tpu_torch.core.config import QuantizeConfig
    from ganq_tpu_torch.formats import checkpoint as tckpt
    from ganq_tpu_torch.formats import gptq_compat as tcompat

    jcfg, params, tcfg, tmodel, qcfg = _ckpt_pair(variant, gptq, lut3)
    hf = thf.config_to_hf(tcfg)
    spec = jget_spec("llama")
    arts = {}
    for li, lp in enumerate(params["layers"]):
        for mod, slot in spec.module_slots.items():
            group, name = slot.split(".")
            m = lp[group][name]
            if qcfg["quant_method"] == "ganq":
                arts[f"{spec.layers_prefix}.{li}.{mod}"] = JArtifact(
                    method=QUANT_METHOD.GANQ, bits=3, group_size=-1,
                    lut=m["lut"].astype(jnp.float32),
                    idx=junpack(m["idx_packed"], 3, m.in_features))
            else:
                arts[f"{spec.layers_prefix}.{li}.{mod}"] = JArtifact(
                    method=QUANT_METHOD.GPTQ, bits=2, group_size=128,
                    qidx=junpack(m["qweight"], 2, m.in_features),
                    scale=m["scales"], zero=m["zeros"], g_idx=m["g_idx"])
    tarts = None
    if qcfg["quant_method"] == "gptq":      # uniform: from GPTQ artifacts
        from ganq_tpu_torch.ops.packing import unpack_int_rows
        from ganq_tpu_torch.quant.looper import QuantizedModule

        tarts = {}
        for li in range(2):
            for mod, slot in spec.module_slots.items():
                p = thf.get_module(tmodel, li, slot)
                tarts[f"{spec.layers_prefix}.{li}.{mod}"] = QuantizedModule(
                    method=QUANT_METHOD.GPTQ, bits=2, group_size=128,
                    qidx=unpack_int_rows(p["qweight"], 2, p.in_features),
                    scale=p["scales"], zero=p["zeros"], g_idx=p["g_idx"])
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_quantized(jd, hf, JQuantizeConfig(**qcfg), params, arts)
    tckpt.save_quantized(td, hf, QuantizeConfig(**qcfg), tmodel,
                         artifacts=tarts)
    loaded = {}
    for d in (td, jd):
        _, jparams, _ = jckpt.load_quantized(d)
        _, tm, _ = tckpt.load_quantized(d, device="cpu")
        flat, got = _flatten_jax(jparams), dict(tm.named_buffers())
        n = 0
        for k, v in flat.items():
            if isinstance(v, np.ndarray) and v.dtype.kind in "fiu":
                np.testing.assert_array_equal(
                    got[k].float().numpy(), v.astype(np.float32), err_msg=k)
                n += k.startswith("layers.")
        assert n >= 14 * (4 if variant == "w2" else 2)
        loaded[d] = (jparams, tm, flat)
    mine = dict(tmodel.named_buffers())
    for k, v in loaded[td][2].items():
        if k in mine and not k.endswith((".lut", ".scales")):
            np.testing.assert_array_equal(mine[k].float().numpy(),
                                          np.asarray(v, np.float32),
                                          err_msg=k)
    jsp = jst.certify_stacked(jst.stack_layers(loaded[td][0],
                                               recode="affine"))
    tsp = tst.certify_stacked(tst.stack_layers(loaded[jd][1],
                                               recode="affine"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GANQ_MEGASTEP", "1")
        assert jst.mega_enabled(jcfg, jsp, "pallas_a8", 1) == variant
        assert tst.mega_enabled(tcfg, tsp, "cuda_a8", 1, "cpu") == variant
    if variant == "w3":
        q = np.zeros((8, 128), np.int64)
        s = np.ones((8, 1), np.float32)
        for pack in (jcompat.pack_gptq, tcompat.pack_gptq):
            with pytest.raises(ValueError, match="2/4/8 bits"):
                pack(q, s, s * 4, np.zeros(128, np.int32), 3)
