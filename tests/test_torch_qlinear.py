"""Quantized-linear containers of the PyTorch port against the JAX package:
the packed ``lut`` artifact of ``lut_linear`` is bit-exact, ``uniform``
weights dequantize alike, and ``apply`` gives the reference result on both
sides of the 1024-row dequant-GEMM switch."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ganq_tpu.ops import qlinear as jql
from ganq_tpu_torch.ops import qlinear as tql


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("K", [64, 2304])        # unpadded, and padded K
def test_lut_linear_artifact_bit_exact(rng, bits, K):
    M = 8
    lut = rng.normal(size=(M, 2**bits)).astype(np.float32)
    idx = rng.integers(0, 2**bits, size=(M, K)).astype(np.int32)
    ref = jql.lut_linear(jnp.asarray(lut), jnp.asarray(idx), bits)
    got = tql.lut_linear(torch.from_numpy(lut), torch.from_numpy(idx), bits)
    assert got.kind == "lut" and got.bits == bits and got.in_features == K
    np.testing.assert_array_equal(got["idx_packed"].numpy(),
                                  np.asarray(ref["idx_packed"]))
    np.testing.assert_array_equal(
        got["lut"].float().numpy(), np.asarray(ref["lut"].astype(jnp.float32)))
    np.testing.assert_array_equal(
        tql.dequantize_weight(got).numpy(),
        np.asarray(jql.dequantize_weight(ref)))


@pytest.mark.parametrize("sym,act_order", [(True, False), (False, True)])
def test_uniform_dequantize_matches(rng, sym, act_order):
    """Symmetric zeros and sequential groups are omitted from the JAX
    artifact and rebuilt on read; both packages rebuild them alike."""
    M, K, bits, G = 8, 64, 4, 4
    qidx = rng.integers(0, 2**bits, size=(M, K)).astype(np.int32)
    scale = rng.uniform(0.01, 0.1, size=(M, G)).astype(np.float32)
    zero = (np.full((M, G), 8.0) if sym
            else rng.integers(0, 16, size=(M, G))).astype(np.float32)
    g_idx = (rng.permutation(K) % G if act_order
             else np.arange(K) // (K // G)).astype(np.int32)
    ref = jql.uniform_linear(jnp.asarray(qidx), jnp.asarray(scale),
                             jnp.asarray(zero), jnp.asarray(g_idx), bits)
    assert ("zeros" in ref.arrays) != sym and ("g_idx" in ref.arrays) == act_order
    got = tql.QLinear("uniform", {k: torch.from_numpy(np.asarray(v))
                                  for k, v in ref.arrays.items()},
                      bits=bits, in_features=K)
    np.testing.assert_array_equal(tql.dequantize_weight(got).numpy(),
                                  np.asarray(jql.dequantize_weight(ref)))


@pytest.mark.parametrize("rows", [3, 1024])
def test_apply_both_sides_of_the_gemm_switch(rng, rows):
    """Below 1024 token rows the "cuda" backend runs the LUT matmul (its
    plain version for CPU tensors), from 1024 on it dequantizes once to
    bf16 and multiplies; both agree with the float32 reference to bf16
    rounding of x, the weight and the product (2e-2 of the output scale)."""
    M, K = 16, 128
    lut = rng.normal(size=(M, 16)).astype(np.float32)
    idx = rng.integers(0, 16, size=(M, K)).astype(np.int32)
    p = tql.lut_linear(torch.from_numpy(lut), torch.from_numpy(idx), 4,
                       bias=torch.from_numpy(rng.normal(size=M).astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(rows, K)).astype(np.float32))
    ref = tql.apply(p, x, "reference")
    got = tql.apply(p, x.to(torch.bfloat16), "cuda").float()
    assert got.shape == (rows, M)
    scale = float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-2 * scale)
    with pytest.raises(ValueError):
        tql.apply(p, x, "pallas")
