"""Kernels 9-11 of the port against ``ganq_tpu``: the fused W8A8 MLP
(``fused_mlp_w8a8``), the fused norm + qkv + rope (``fused_qkv_rope_w8a8``)
and the attention half of a decode layer (``attn_half_decode_w8a8``).

The same inputs, made with numpy from a seed, go through ganq_tpu's Pallas
kernels in interpret mode and through the port's wrappers on CPU tensors,
which run the kernels' plain versions. An interpret-mode kernel runs its
callbacks on another thread: each result is waited for before the next JAX
call (dispatching while they run can deadlock). Both compute the same operations in
the same order except float32 sums (rmsnorm's mean of squares, attention
scores and p . v), rsqrt and exp, which XLA and PyTorch round in their last
bits: outputs agree within one bf16 ulp, plus, where an int8 activation sits
within those bits of a rounding tie and flips by one code, the moved
output (at most sx * max|w|, under 1e-3 of the largest output). The JAX
oracles (``fused_qkv_rope_reference``, ``attn_half_decode_reference``, the
unfused MLP) differ more: they rotate the float32 y where the kernels read
the partner lane in bf16, or compute in full precision; they are held at
the JAX tests' own tolerances."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ganq_tpu.ops import fused_attention as jfa
from ganq_tpu.ops import fused_layer as jfl
from ganq_tpu.ops import fused_mlp as jfm
from ganq_tpu.ops import qlinear as jql
from ganq_tpu_torch.ops import fused_attention as tfa
from ganq_tpu_torch.ops import fused_layer as tfl
from ganq_tpu_torch.ops import fused_mlp as tfm
from ganq_tpu_torch.ops import qlinear as tql


def _bf16(rng, shape, scale=1.0):
    """numpy float32 values that are bf16-exact, and the torch bf16 copy."""
    a = np.array(jnp.asarray(rng.normal(size=shape).astype(np.float32)
                             * scale, jnp.bfloat16).astype(jnp.float32))
    return a, torch.from_numpy(a).to(torch.bfloat16)


def _w8(rng, M, K):
    w = rng.integers(-127, 128, size=(M, K)).astype(np.int8)
    s = rng.uniform(1e-4, 4e-4, size=(M, 1)).astype(np.float32)
    return w, s


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_kernel_close(got, ref, flips=2e-3, what=""):
    """|got - ref| <= one bf16 ulp of the larger + ``flips`` * max|ref|."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    big = np.maximum(np.abs(got), np.abs(ref))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    tol = ulp + flips * np.abs(ref).max()
    err = np.abs(got - ref)
    assert np.all(err <= tol), (what, float(err.max()),
                                float((err / tol).max()))


# -------------------------------------------------------------- tile rules
@pytest.mark.parametrize("H,I", [(3072, 8192), (2048, 8192), (256, 1536),
                                 (4096, 14336), (256, 96)])
def test_tile_rules_match_jax(H, I):
    """Kernel 9's activation tile (VMEM budget rule) and kernel 12's (1024
    halved until it divides I) are ganq_tpu's: 512 and 1024 at the 3B
    shape, 1024 and 1024 at the 1B shape."""
    from ganq_tpu.ops import megastep as jms
    from ganq_tpu_torch.ops import megastep as tms

    ti = 1024
    while I % ti:
        ti //= 2
    mega = ti
    while ti > 256 and 6 * ti * H > 13 * 2**20:
        ti //= 2
    assert tfm.fused_mlp_tile(I, H) == ti
    assert tms.megastep_tile(I) == mega
    if (H, I) == (3072, 8192):
        assert (tfm.fused_mlp_tile(I, H), tms.megastep_tile(I)) == (512, 1024)
    # ganq_tpu's megastep oracle tiles its MLP with the same rule
    assert "ti = 1024" in open(jms.__file__).read()


# ---------------------------------------------------------------- kernel 9
@pytest.mark.parametrize("B,fold", [(1, True), (8, True), (64, True),
                                    (8, False)])
def test_fused_mlp_matches_jax(B, fold):
    """Three activation tiles (H = 256, I = 1536, ti = 512); the norm and
    residual folded in or not."""
    rng = np.random.default_rng(B)
    H, I = 256, 1536
    gu, gs = _w8(rng, 2 * I, H)
    dn, ds = _w8(rng, H, I)
    xn, xt = _bf16(rng, (B, H), 0.5)
    nw = rng.uniform(0.5, 1.5, size=(H,)).astype(np.float32)
    jargs = [jnp.asarray(xn, jnp.bfloat16), jnp.asarray(gu), jnp.asarray(gs),
             jnp.asarray(dn), jnp.asarray(ds)]
    targs = [xt] + [torch.from_numpy(a) for a in (gu, gs, dn, ds)]
    jkw = {"norm_w": jnp.asarray(nw)} if fold else {}
    tkw = {"norm_w": torch.from_numpy(nw)} if fold else {}
    with pltpu.force_tpu_interpret_mode():
        ref = _np(jax.block_until_ready(jfm.fused_mlp_w8a8(*jargs, **jkw)))
    got = tfm.fused_mlp_w8a8(*targs, **tkw)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H)
    assert_kernel_close(got.float().numpy(), ref, what="fused_mlp")
    # the full-precision MLP (the JAX test's oracle), at its tolerance
    x = jnp.asarray(xn)
    h = x
    if fold:
        h = x * jax.lax.rsqrt(jnp.mean(x * x, axis=1, keepdims=True)
                              + 1e-5) * jnp.asarray(nw)
    gw = jnp.asarray(gu, jnp.float32) * jnp.asarray(gs)
    a = jax.nn.silu(h @ gw[:I].T) * (h @ gw[I:].T)
    full = a @ (jnp.asarray(dn, jnp.float32) * jnp.asarray(ds)).T
    full = np.asarray(full + x if fold else full)
    denom = np.abs(full).max()
    err = np.abs(got.float().numpy() - full)
    assert err.max() / denom < 0.06 and err.mean() / denom < 0.01


@pytest.mark.parametrize("B", [3, 65])
def test_fused_mlp_fallback_matches_jax(B):
    """Shapes the kernel refuses (a tile under 256 columns, or more than 64
    token rows) take ganq_tpu's full-precision route, with the norm and
    residual outside: float32 sums in another order, so 1e-5 of the
    scale."""
    rng = np.random.default_rng(7)
    H, I = 128, 96 if B == 3 else 512
    gu, gs = _w8(rng, 2 * I, H)
    dn, ds = _w8(rng, H, I)
    x = rng.normal(size=(B, H)).astype(np.float32)
    nw = rng.uniform(0.5, 1.5, size=(H,)).astype(np.float32)
    ref = np.asarray(jfm.fused_mlp_w8a8(
        jnp.asarray(x), jnp.asarray(gu), jnp.asarray(gs), jnp.asarray(dn),
        jnp.asarray(ds), norm_w=jnp.asarray(nw)))
    got = tfm.fused_mlp_w8a8(*(torch.from_numpy(a) for a in
                               (x, gu, gs, dn, ds)),
                             norm_w=torch.from_numpy(nw)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


# --------------------------------------------------------------- kernel 10
def _qkv_problem(seed, B, bias, rd):
    rng = np.random.default_rng(seed)
    H, q_dim, kv_dim, d = 256, 256, 128, 128
    w, s = _w8(rng, q_dim + 2 * kv_dim, H)
    b = (rng.normal(size=(q_dim + 2 * kv_dim,)).astype(np.float32) * 0.05
         if bias else None)
    xn, xt = _bf16(rng, (B, H), 0.5)
    nw = rng.uniform(0.5, 1.5, size=(H,)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, size=(rd // 2,)).astype(np.float32)
    return xn, xt, nw, w, s, b, np.cos(ang), np.sin(ang), q_dim, kv_dim, d


@pytest.mark.parametrize("B,inter,bias,rd", [(1, False, False, 128),
                                             (8, True, False, 128),
                                             (8, False, True, 64)])
def test_fused_qkv_rope_matches_jax(B, inter, bias, rd):
    xn, xt, nw, w, s, b, cos, sin, q_dim, kv_dim, d = _qkv_problem(
        B, B, bias, rd)
    jargs = (jnp.asarray(xn, jnp.bfloat16), jnp.asarray(nw), jnp.asarray(w),
             jnp.asarray(s), None if b is None else jnp.asarray(b),
             jnp.asarray(cos), jnp.asarray(sin))
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=d, rotary_dim=rd,
              interleaved=inter)
    with pltpu.force_tpu_interpret_mode():
        ref = _np(jax.block_until_ready(jfa.fused_qkv_rope_w8a8(*jargs,
                                                                **kw)))
    oracle = _np(jfa.fused_qkv_rope_reference(*jargs, **kw))
    got = tfa.fused_qkv_rope_w8a8(
        xt, torch.from_numpy(nw), torch.from_numpy(w), torch.from_numpy(s),
        None if b is None else torch.from_numpy(b), torch.from_numpy(cos),
        torch.from_numpy(sin), **kw)
    assert got.dtype == torch.bfloat16
    assert_kernel_close(got.float().numpy(), ref, what="fused_qkv_rope")
    # the oracle rotates the float32 y: one more bf16 ulp at most
    np.testing.assert_allclose(got.float().numpy(), oracle, atol=2e-2,
                               rtol=2e-2)


def test_rope_operands_match_jax():
    """The sign permutation, lane maps and per-lane tables are ganq_tpu's;
    the qkv row tile rule too."""
    for tile, d, rd, inter in ((256, 128, 128, False), (256, 128, 64, True),
                               (128, 64, 32, False)):
        jr = jfa.rope_tile_operands(tile, d, rd, inter)
        tr = tfa.rope_tile_operands(tile, d, rd, inter)
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(a, b)
        half = np.linspace(-1, 1, rd // 2).astype(np.float32)
        jc = jfa.expand_rope_tables(jnp.asarray(half), jnp.asarray(half),
                                    jr[1], jr[2])
        tc = tfa.expand_rope_tables(torch.from_numpy(half),
                                    torch.from_numpy(half), tr[1], tr[2])
        for a, b in zip(jc, tc):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for q, kv, d in ((3072, 1024, 128), (2048, 512, 64), (256, 128, 128),
                     (192, 64, 64), (4096, 1024, 128), (640, 128, 128)):
        assert tfa.qkv_fusable_tile(q, kv, d) == jfa.qkv_fusable_tile(q, kv, d)


# --------------------------------------------------------------- kernel 11
@pytest.mark.parametrize("B", [1, 8])
def test_attn_half_matches_jax(B):
    """pos 3 and 50 over a cache of 64 keys walked in blocks of 32 (50: two
    blocks, the running max rescaled once), garbage past pos."""
    rng = np.random.default_rng(10 + B)
    H, q_dim, kv_dim, d, T = 256, 256, 128, 128, 64
    Hkv = kv_dim // d
    xn, xt = _bf16(rng, (B, H), 0.5)
    w, s = _w8(rng, q_dim + 2 * kv_dim, H)
    ow = rng.integers(-127, 128, size=(q_dim, H)).astype(np.int8)
    osr = rng.uniform(1e-4, 4e-4, size=(1, H)).astype(np.float32)
    nw = rng.uniform(0.5, 1.5, size=(H,)).astype(np.float32)
    kc, kct = _bf16(rng, (B, T, Hkv, d))
    vc, vct = _bf16(rng, (B, T, Hkv, d))
    ang = rng.uniform(0, 2 * np.pi, size=(d // 2,)).astype(np.float32)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=d, rotary_dim=d,
              eps=1e-5, scale=float(1 / np.sqrt(d)))
    for pos in (3, 50):
        kc[:, pos:], vc[:, pos:] = 37.0, -11.0      # never attended
        kct[:, pos:], vct[:, pos:] = 37.0, -11.0
        jargs = (jnp.asarray(xn, jnp.bfloat16), jnp.asarray(nw),
                 jnp.asarray(w), jnp.asarray(s), None, jnp.asarray(ow),
                 jnp.asarray(osr), jnp.asarray(np.cos(ang)),
                 jnp.asarray(np.sin(ang)), jnp.asarray(kc, jnp.bfloat16),
                 jnp.asarray(vc, jnp.bfloat16))
        with pltpu.force_tpu_interpret_mode():
            ref = jax.block_until_ready(jfl.attn_half_decode_w8a8(
                *jargs, jnp.int32(pos), block_t=32, **kw))
        oracle = jfl.attn_half_decode_reference(*jargs, pos, **kw)
        got = tfl.attn_half_decode_w8a8(
            xt, torch.from_numpy(nw), torch.from_numpy(w),
            torch.from_numpy(s), None, torch.from_numpy(ow),
            torch.from_numpy(osr), torch.from_numpy(np.cos(ang)),
            torch.from_numpy(np.sin(ang)), kct, vct, torch.tensor(pos),
            block_t=32, **kw)
        for name, g, r, o, tol in zip(("y", "k", "v"), got, ref, oracle,
                                      (3e-2, 2e-2, 2e-2)):
            assert tuple(g.shape) == r.shape
            assert_kernel_close(g.float().numpy(), _np(r), flips=3e-3,
                                what=f"attn_half {name} pos={pos}")
            np.testing.assert_allclose(g.float().numpy(), _np(o), atol=tol,
                                       rtol=tol)


def test_attn_half_gate_matches_jax():
    """``attn_half_fusable`` on a fused layer: a ``w8`` qkv at head_dim 128
    passes; head_dim 64, a ``uniform`` qkv, a biased o or no transposed o
    do not, in both packages."""
    from ganq_tpu.models import synthetic as jsyn
    from ganq_tpu_torch.models import synthetic as tsyn
    from ganq_tpu_torch.models.transformer import Layer

    rng = np.random.default_rng(0)
    got = []
    for heads, kind, o_bias, o_t in ((2, "w8", False, True),
                                     (4, "w8", False, True),
                                     (2, "uniform", False, True),
                                     (2, "w8", True, True),
                                     (2, "w8", False, False)):
        jcfg = jsyn.llama_config(hidden=256, inter=512, layers=2,
                                 heads=heads, kv_heads=1, vocab=64)
        tcfg = tsyn.llama_config(hidden=256, inter=512, layers=2,
                                 heads=heads, kv_heads=1, vocab=64)
        d = 256 // heads
        w, s = _w8(rng, 256 + 2 * d, 256)
        ow, osc = _w8(rng, 256, 256)
        arrs = ({"w8": w, "scale": s} if kind == "w8" else
                {"qweight": w.view(np.int32)[:, :16], "scales": s})
        oarr = {"w8": ow, "scale": osc}
        if o_bias:
            oarr["bias"] = np.zeros(256, np.float32)
        jattn = {"qkv": jql.QLinear(kind, {k: jnp.asarray(v)
                                           for k, v in arrs.items()},
                                    8, 256),
                 "o": jql.QLinear("w8", {k: jnp.asarray(v)
                                         for k, v in oarr.items()}, 8, 256)}
        tattn = {"qkv": tql.QLinear(kind, {k: torch.from_numpy(v)
                                           for k, v in arrs.items()}, 8, 256),
                 "o": tql.QLinear("w8", {k: torch.from_numpy(v)
                                         for k, v in oarr.items()}, 8, 256)}
        if o_t:
            jattn["o_t_w8"] = jnp.asarray(ow.T)
        tlp = Layer(torch.ones(256), torch.ones(256), tattn, {},
                    o_t_w8=torch.from_numpy(ow.T.copy()) if o_t else None)
        got.append(tfl.attn_half_fusable(tcfg, tlp))
        assert got[-1] == jfl.attn_half_fusable(jcfg, {"attn": jattn})
    assert got == [True, False, False, False, False]


# -------------------------------------------------------------- row fusion
@pytest.mark.parametrize("kind", ["w8", "lut", "uniform"])
def test_concat_rows_matches_jax(kind):
    """Row fusion of q/k/v as ganq_tpu's ``concat_rows`` fuses them: equal
    arrays, kind, bits and width; a mix of kinds raises in both."""
    from ganq_tpu.models import synthetic as jsyn

    key = jax.random.PRNGKey(3)
    lins = [jsyn._rand_linear(jax.random.fold_in(key, i), m, 128, kind)
            for i, m in enumerate((128, 64, 64))]

    def port(p):
        arrays = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32)
                                                 if v.dtype == jnp.bfloat16
                                                 else v))
                  for k, v in p.arrays.items()}
        if "lut" in arrays:
            arrays["lut"] = arrays["lut"].to(torch.bfloat16)
        return tql.QLinear(p.kind, arrays, p.bits, p.in_features)

    j = jql.concat_rows(lins)
    t = tql.concat_rows([port(p) for p in lins])
    assert (t.kind, t.bits, t.in_features) == (j.kind, j.bits, j.in_features)
    assert sorted(t._buffers) == sorted(j.arrays)
    for k, v in j.arrays.items():
        np.testing.assert_array_equal(t[k].float().numpy(), _np(v))
    mixed = [lins[0], jsyn._rand_linear(key, 64, 128, "dense")]
    with pytest.raises(ValueError):
        jql.concat_rows(mixed)
    with pytest.raises(ValueError):
        tql.concat_rows([port(p) for p in mixed])
