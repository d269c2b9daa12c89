"""Kernels 5 and 6 of the port (``uniform_matmul``, ``uniform_a8_matmul``):
their plain versions, which the wrappers run for CPU tensors, against
``ganq_tpu``'s Pallas kernels in interpret mode (and its references where
its gate refuses a shape). Inputs come from numpy with a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ganq_tpu.ops import uniform_matmul as jum
from ganq_tpu.ops.packing import pack_int_rows as jpack
from ganq_tpu_torch.ops import uniform_matmul as tum
from ganq_tpu_torch.ops.packing import pack_int_rows
from test_torch_packing import torch_threads_per_worker  # noqa: F401


def _problem(seed, bits, B, M, K, G, sym=False, permuted=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, K)).astype(np.float32)
    codes = rng.integers(0, 2**bits, size=(M, K)).astype(np.int32)
    scales = rng.uniform(0.001, 0.004, size=(M, G)).astype(np.float32)
    zeros = (np.full((M, G), 2.0**(bits - 1), np.float32) if sym else
             rng.integers(0, 2**bits, size=(M, G)).astype(np.float32))
    g_idx = np.arange(K) // (K // G)
    if permuted:
        g_idx = g_idx[rng.permutation(K)]
    return x, codes, scales, zeros, g_idx.astype(np.int32)


def _both(x, codes, scales, zeros, g_idx, bits, sym, seq):
    """The same operands for ganq_tpu (zeros always given; g_idx None when
    sequential, as uniform_linear stores it) and the port (zeros None when
    symmetric)."""
    jargs = (jnp.asarray(x), jpack(jnp.asarray(codes), bits),
             jnp.asarray(scales), jnp.asarray(zeros),
             None if seq else jnp.asarray(g_idx))
    targs = (torch.from_numpy(x), pack_int_rows(torch.from_numpy(codes), bits),
             torch.from_numpy(scales),
             None if sym else torch.from_numpy(zeros),
             None if seq else torch.from_numpy(g_idx))
    np.testing.assert_array_equal(np.asarray(jargs[1]), targs[1].numpy())
    return jargs, targs


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("groups", ["seq", "perm"])
def test_uniform_matmul_matches_jax(bits, groups):
    """A plane of 128 words (K = 128 * packfactor) at every bit width, so
    the sequential case runs ganq_tpu's Pallas kernel (interpret mode); the
    permuted one its XLA reference. Both float32: equal to 1e-5 of the
    output scale (summation order)."""
    seq = groups == "seq"
    K = 128 * 32 // (4 if bits == 3 else bits)
    x, codes, scales, zeros, g_idx = _problem(1, bits, 4, 64, K, K // 128,
                                              permuted=not seq)
    jargs, targs = _both(x, codes, scales, zeros, g_idx, bits, False, seq)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jum.uniform_matmul(*jargs, bits))
    got = tum.uniform_matmul(*targs, bits).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_uniform_matmul_bf16_and_symmetric_matches_jax():
    """bf16 x, symmetric artifact without zeros: both round the float32
    weight to bf16 and sum in float32; outputs within one bf16 ulp."""
    x, codes, scales, zeros, g_idx = _problem(2, 4, 3, 64, 1024, 8, sym=True)
    jargs, targs = _both(x, codes, scales, zeros, g_idx, 4, True, True)
    jargs = (jargs[0].astype(jnp.bfloat16),) + jargs[1:]
    targs = (targs[0].to(torch.bfloat16),) + targs[1:]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jum.uniform_matmul(*jargs, 4).astype(jnp.float32))
    got = tum.uniform_matmul(*targs, 4).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=2**-7, atol=1e-6)


def _rows_where_quotient_differs(rng, n, K):
    """n float32 rows of K N(0, 1) values whose max|x| / 127 (the IEEE
    quotient) differs from max|x| * fl(1/127) (the product jitted JAX
    computes) in the last bit."""
    inv = np.float32(1.0) / np.float32(127.0)
    rows = []
    while len(rows) < n:
        x = rng.normal(size=(64, K)).astype(np.float32)
        m = np.abs(x).max(axis=1)
        rows += list(x[m / np.float32(127.0) != m * inv])
    return np.stack(rows[:n])


def test_quantized_activations_are_exact():
    """The port's per-token int8 activations equal the jitted JAX formula of
    the Pallas kernels bit for bit: sx = max|x| * fl(1/127) (XLA's product
    for the division by the constant 127.0) on rows where the IEEE quotient
    differs from it, and codes from an IEEE quotient, ties to even."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(size=(5, 256)).astype(np.float32),
                        _rows_where_quotient_differs(rng, 6, 256)])
    x[0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]   # sx = 1: ties
    x[1] = 0.0                                                 # sx floor

    @jax.jit
    def jax_rows(xf):
        sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True) / 127.0,
                         1e-12)
        return jnp.clip(jnp.round(xf / sx), -127, 127), sx

    x8, sx = jax_rows(jnp.asarray(x))
    got8, got_sx = tum.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(got8.numpy(), np.asarray(x8))
    np.testing.assert_array_equal(got_sx.numpy(), np.asarray(sx))
    assert got8[0, :8].tolist() == [127, 0, 2, 2, -0, -2, -2, 4]
    amax = np.abs(x[5:]).max(axis=1, keepdims=True)
    assert (got_sx.numpy()[5:] != amax / np.float32(127.0)).all()


@pytest.mark.parametrize("bits,K,G,sym", [(4, 1024, 8, False),
                                          (4, 1024, 8, True),
                                          (8, 1024, 8, False),
                                          (4, 1024, 1, False)])
def test_uniform_a8_matches_jax(bits, K, G, sym):
    """At K = 1024 (4-bit width 128) the a8 gate admits the shape: the
    port's plain a8 version against ganq_tpu's W{b}A8 kernel in interpret
    mode. Both quantize x alike; ganq_tpu sums exact integer dots per group,
    the plain version float32 products: equal to 1e-5 of the output
    scale."""
    x, codes, scales, zeros, g_idx = _problem(4, bits, 8, 64, K, G, sym=sym)
    jargs, targs = _both(x, codes, scales, zeros, g_idx, bits, sym, True)
    assert tum.a8_eligible(K, 64, G, None, bits)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jum.uniform_a8_matmul(*jargs, bits))
    got = tum.uniform_a8_matmul(*targs, bits).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    full = tum.uniform_matmul_reference(*targs, bits).numpy()
    assert np.abs(got - full).max() > 1e-6 * np.abs(full).max()   # a8 ran
    np.testing.assert_allclose(
        tum.uniform_a8_reference(*targs, bits).numpy(),
        np.asarray(jum.uniform_a8_reference(*jargs, bits)), rtol=1e-5,
        atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("K,G,permuted", [(512, 16, False), (1024, 8, True),
                                          (1024, 16, False)])
def test_uniform_a8_gated_out_is_full_precision(K, G, permuted):
    """Where the gate refuses the shape (4-bit width 64; a permuted g_idx;
    64-column groups) both packages return the full-precision product."""
    x, codes, scales, zeros, g_idx = _problem(5, 4, 8, 64, K, G,
                                              permuted=permuted)
    jargs, targs = _both(x, codes, scales, zeros, g_idx, 4, False,
                         not permuted)
    assert not tum.a8_eligible(K, 64, G, targs[4], 4)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jum.uniform_a8_matmul(*jargs, 4))
    got = tum.uniform_a8_matmul(*targs, 4).numpy()
    full = tum.uniform_matmul_reference(*targs, 4).numpy()
    np.testing.assert_array_equal(got, full)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
