"""Kernels 7 and 8 of the port (``w8_matmul``, ``w8a8_matmul``) and the
recodes that ``optimize()`` and the engine use, against ``ganq_tpu``.

The kernels' plain versions (what the wrappers run for CPU tensors) are held
against ganq_tpu's Pallas kernels in interpret mode; each recode against
ganq_tpu's on the same ``lut`` linear, packed codes bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ganq_tpu.ops import qlinear as jql
from ganq_tpu.ops import w8_matmul as jw8
from ganq_tpu_torch.ops import qlinear as tql
from ganq_tpu_torch.ops import w8_matmul as tw8
from test_torch_packing import torch_threads_per_worker  # noqa: F401


def _lut_pair(seed, bits, M, K, affine=None):
    """The same ``lut`` linear built by both packages from numpy: a free
    codebook of std 0.02, or an affine grid ("sym" / "asym") as
    ``ganq_codebook="affine(_sym)"`` solves emit."""
    rng = np.random.default_rng(seed)
    V = 2**bits
    if affine is None:
        lut = rng.normal(size=(M, V)).astype(np.float32) * 0.02
    else:
        b = rng.uniform(0.001, 0.004, size=(M, 1)).astype(np.float32)
        if affine == "sym":
            lut = b * (np.arange(V, dtype=np.float32) - V // 2)
        else:
            a = rng.uniform(-0.002, 0.002, size=(M, 1)).astype(np.float32)
            lut = a + b * (np.arange(V, dtype=np.float32) - (V - 1) / 2)
    idx = rng.integers(0, V, size=(M, K)).astype(np.int32)
    j = jql.lut_linear(jnp.asarray(lut), jnp.asarray(idx), bits)
    t = tql.lut_linear(torch.from_numpy(lut), torch.from_numpy(idx), bits)
    for k in ("lut", "idx_packed"):
        np.testing.assert_array_equal(np.asarray(j[k].astype(jnp.float32)),
                                      t[k].float().numpy())
    return j, t


def _assert_same_linear(j, t, tol=0.0):
    """Same kind, bits, width and arrays: integer arrays bit for bit, float
    arrays within ``tol`` relative (0: exactly)."""
    assert (t.kind, t.bits, t.in_features) == (j.kind, j.bits, j.in_features)
    assert sorted(k for k in t._buffers) == sorted(j.arrays)
    for k, v in j.arrays.items():
        ref = np.asarray(v)
        got = t[k].numpy()
        assert got.shape == ref.shape, k
        if np.issubdtype(ref.dtype, np.integer) or tol == 0.0:
            np.testing.assert_array_equal(got, ref, err_msg=k)
        else:
            np.testing.assert_allclose(got, ref, rtol=tol, atol=0, err_msg=k)


def test_recode_lut_to_int8_matches_jax():
    j, t = _lut_pair(0, 4, 32, 1152)           # lane-padded: K' = 2048
    w8, scale = jw8.recode_lut_to_int8(j["lut"], j["idx_packed"], 4, 1152)
    tw, ts = tw8.recode_lut_to_int8(t["lut"], t["idx_packed"], 4, 1152)
    assert tw.shape == (32, 2048) and tw.dtype == torch.int8
    np.testing.assert_array_equal(tw.numpy(), np.asarray(w8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(scale))


@pytest.mark.parametrize("kernel", ["w8", "w8a8"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B", [1, 8, 40, 128])
def test_w8_kernels_match_jax(kernel, dtype, B):
    """The w8 recode of the same lut linear through both packages' kernels
    (ganq_tpu's in interpret mode, K' = 256 so its gate admits the shape),
    at the token rows of each of the port's paths on the card (decode up
    to 8, the float32 GEMV up to 40, the tiles beyond). w8: both round the
    weight to x's type and sum in float32 (1e-5 of the scale; one bf16 ulp
    for bf16). w8a8: the same int8 activations and exact integer dots, so
    the results are equal."""
    j, t = _lut_pair(1, 4, 32, 256)
    jq, tq = jql.recode_w8(j), tql.recode_w8(t)
    x = np.random.default_rng(2).normal(size=(B, 256)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == jnp.bfloat16
                                else torch.float32)
    jfn = jw8.w8_matmul if kernel == "w8" else jw8.w8a8_matmul
    tfn = tw8.w8_matmul if kernel == "w8" else tw8.w8a8_matmul
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfn(jx, jq["w8"], jq["scale"]).astype(jnp.float32))
    got = tfn(tx, tq["w8"], tq["scale"]).float().numpy()
    if kernel == "w8a8":
        np.testing.assert_array_equal(got, ref)
    elif dtype == jnp.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=2**-7, atol=1e-6)


def test_w8a8_gated_out_is_full_precision():
    """K' = 200 (no multiple of 128) with 64 rows fails the W8A8 gate: both
    packages return the full-precision product, and the port's equals its
    w8 plain version."""
    rng = np.random.default_rng(3)
    w8 = rng.integers(-127, 128, size=(64, 200)).astype(np.int8)
    scale = rng.uniform(1e-4, 4e-4, size=(64, 1)).astype(np.float32)
    x = rng.normal(size=(4, 200)).astype(np.float32)
    assert not tw8.w8a8_eligible(200, 64, 200)
    ref = np.asarray(jw8.w8a8_matmul(jnp.asarray(x), jnp.asarray(w8),
                                     jnp.asarray(scale)))
    tx, tw, ts = (torch.from_numpy(a) for a in (x, w8, scale))
    got = tw8.w8a8_matmul(tx, tw, ts).numpy()
    np.testing.assert_array_equal(got, tw8.w8_matmul_reference(tx, tw, ts).numpy())
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("bits,K", [(4, 256), (3, 256), (4, 192), (2, 256)])
def test_recode_w8_and_uniform8_match_jax(bits, K):
    """recode_w8, recode_uniform8 (which takes recode_w8 + w8_to_uniform8
    for widths that are no multiple of 128) and w8_to_uniform8 give the
    same artifacts as ganq_tpu's, codes and scales exactly."""
    j, t = _lut_pair(4, bits, 32, K)
    _assert_same_linear(jql.recode_w8(j), tql.recode_w8(t))
    _assert_same_linear(jql.recode_uniform8(j), tql.recode_uniform8(t))
    _assert_same_linear(jql.w8_to_uniform8(jql.recode_w8(j)),
                        tql.w8_to_uniform8(tql.recode_w8(t)))


def test_recode_w8_of_a_uniform_linear_matches_jax():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 16, size=(32, 256)).astype(np.int32)
    scale = rng.uniform(0.001, 0.004, size=(32, 2)).astype(np.float32)
    zero = rng.integers(0, 16, size=(32, 2)).astype(np.float32)
    g = rng.permutation(np.arange(256) // 128).astype(np.int32)
    j = jql.uniform_linear(jnp.asarray(codes), jnp.asarray(scale),
                           jnp.asarray(zero), jnp.asarray(g), 4)
    t = tql.uniform_linear(*(torch.from_numpy(a) for a in (codes, scale, zero,
                                                           g)), 4)
    _assert_same_linear(j, t)
    _assert_same_linear(jql.recode_w8(j), tql.recode_w8(t))


@pytest.mark.parametrize("K", [256, 1152])
def test_recode_uniform4_matches_jax(K):
    """3-bit codebooks snapped onto 16 levels; a lane-padded artifact
    (K = 1152 packs to 2048 columns) passes through unchanged."""
    j, t = _lut_pair(6, 3, 32, K)
    jr, tr = jql.recode_uniform4(j), tql.recode_uniform4(t)
    if K == 1152:
        assert jr is j and tr is t
        return
    _assert_same_linear(jr, tr)
    assert tql.recode_uniform4(_lut_pair(6, 4, 32, K)[1]).kind == "lut"


@pytest.mark.parametrize("affine,bits,K,certified", [
    ("sym", 4, 256, True), ("asym", 4, 256, True), ("sym", 3, 256, True),
    ("asym", 4, 200, True),            # one group per row
    (None, 4, 256, False),             # free codebook
    ("sym", 4, 1152, False),           # lane-padded artifact
])
def test_certify_uniform_matches_jax(affine, bits, K, certified):
    """Affine-grid codebooks certify into uniform linears (sym ones without
    zeros), free codebooks and lane-padded artifacts do not; the certified
    linears equal ganq_tpu's and dequantize within 2^-7 of the row's range
    of the stored codebook."""
    j, t = _lut_pair(7, bits, 32, K, affine)
    jc, tc = jql.certify_uniform(j), tql.certify_uniform(t)
    assert (jc is None) == (tc is None) == (not certified)
    if not certified:
        return
    _assert_same_linear(jc, tc)
    assert ("zeros" in tc) == (affine == "asym")
    w0 = tql.dequantize_weight(t)
    span = (t["lut"].float().amax(1) - t["lut"].float().amin(1))[:, None]
    assert bool(((tql.dequantize_weight(tc) - w0).abs() <= 2**-7 * span).all())
