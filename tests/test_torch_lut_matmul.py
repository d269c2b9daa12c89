"""LUT matmul of the PyTorch port against the JAX package's Pallas kernel.

The JAX kernel runs in Pallas's TPU interpret mode (as tests/test_kernels.py
runs it); the port's plain version, which its CUDA kernel is held against on
the card, runs in PyTorch on the same inputs. Shapes are chosen so that the
JAX wrapper takes its Pallas path (plane width a multiple of 128, or M <= 8),
not its XLA fallback.

Tolerances: with f32 inputs both sums are float32 over K products, so they
agree to ~1e-5 of the output scale. With bf16 inputs each package rounds its
float32 sum once, so each output is within one bf16 ulp of the exact sum.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ganq_tpu.ops import lut_matmul as jlm
from ganq_tpu.ops import qlinear as jql
from ganq_tpu.ops.packing import pack_factor, pack_int_rows
from ganq_tpu_torch.ops import lut_matmul as tlm


@pytest.fixture
def interp():
    with pltpu.force_tpu_interpret_mode():
        yield


def _problem(rng, bits, B, M, K, Kp=None):
    """x [B, K] f32, sorted bf16-exact codebooks [M, 2^bits], codes packed
    over Kp >= K columns (pad codes are 0)."""
    Kp = Kp or K
    x = rng.normal(size=(B, K)).astype(np.float32)
    lut = np.sort(rng.normal(size=(M, 2**bits)).astype(np.float32), axis=1)
    lut = np.array(jnp.asarray(lut, jnp.bfloat16).astype(jnp.float32))
    idx = np.zeros((M, Kp), np.int32)
    idx[:, :K] = rng.integers(0, 2**bits, size=(M, K))
    packed = np.array(pack_int_rows(jnp.asarray(idx), bits))
    return x, lut, packed


def _exact(x, lut, packed, bits):
    """float64 sum of the bf16 inputs' products (the rounding-free value)."""
    K = x.shape[1]
    t = tlm.lut_matmul_reference(torch.from_numpy(x).double(),
                                 torch.from_numpy(lut).double(),
                                 torch.from_numpy(packed), bits)
    assert t.shape[1] == lut.shape[0] and K == x.shape[1]
    return t.numpy()


def _bf16_ulp(v):
    e = np.floor(np.log2(np.maximum(np.abs(v), 1e-30)))
    return 2.0 ** (e - 7)


def _width_aligned_k(bits):
    return 128 * pack_factor(bits)


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("B", [1, 8, 33])
def test_f32_matches_pallas(rng, interp, bits, B):
    M, K = 16, _width_aligned_k(bits)
    x, lut, packed = _problem(rng, bits, B, M, K)
    ref = np.array(jlm.lut_matmul(jnp.asarray(x), jnp.asarray(lut),
                                  jnp.asarray(packed), bits))
    got = tlm.lut_matmul(torch.from_numpy(x), torch.from_numpy(lut),
                         torch.from_numpy(packed), bits)
    assert got.shape == (B, M) and got.dtype == torch.float32
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_bf16_within_one_ulp(rng, interp, bits):
    B, M, K = 8, 16, _width_aligned_k(bits)
    x, lut, packed = _problem(rng, bits, B, M, K)
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    exact = _exact(xb, lut, packed, bits)
    ref = np.array(jlm.lut_matmul(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(lut, jnp.bfloat16),
                                  jnp.asarray(packed), bits)
                   .astype(jnp.float32))
    got = tlm.lut_matmul(torch.from_numpy(xb).to(torch.bfloat16),
                         torch.from_numpy(lut).to(torch.bfloat16),
                         torch.from_numpy(packed), bits)
    assert got.dtype == torch.bfloat16
    ulp = _bf16_ulp(exact)
    assert np.all(np.abs(ref - exact) <= ulp)
    assert np.all(np.abs(got.float().numpy() - exact) <= ulp)


@pytest.mark.parametrize("bits", [3, 4])
def test_padded_k_matches_pallas(rng, interp, bits):
    """K = 1100 packs to a padded width (lut_linear rounds K up to a multiple
    of 128 * packfactor): the pad columns hold code 0 and must not count."""
    B, M, K = 3, 16, 1100
    x = rng.normal(size=(B, K)).astype(np.float32)
    lut = rng.normal(size=(M, 2**bits)).astype(np.float32)
    idx = rng.integers(0, 2**bits, size=(M, K)).astype(np.int32)
    ql = jql.lut_linear(jnp.asarray(lut), jnp.asarray(idx), bits)
    lut_b = np.array(ql["lut"].astype(jnp.float32))
    packed = np.array(ql["idx_packed"])
    assert packed.shape[1] * pack_factor(bits) == 2048
    ref = np.array(jlm.lut_matmul(jnp.asarray(x), ql["lut"], ql["idx_packed"],
                                  bits))
    got = tlm.lut_matmul(torch.from_numpy(x),
                         torch.from_numpy(lut_b).to(torch.bfloat16),
                         torch.from_numpy(packed), bits)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * scale)


def test_leading_dims_and_dtype(rng):
    x, lut, packed = _problem(rng, 4, 6, 8, 64)
    x3 = torch.from_numpy(x).reshape(2, 3, 64)
    out = tlm.lut_matmul(x3, torch.from_numpy(lut), torch.from_numpy(packed), 4)
    assert out.shape == (2, 3, 8)
    flat = tlm.lut_matmul_reference(torch.from_numpy(x), torch.from_numpy(lut),
                                    torch.from_numpy(packed), 4)
    np.testing.assert_array_equal(out.reshape(6, 8).numpy(), flat.numpy())
