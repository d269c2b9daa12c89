"""Flash decode attention of the PyTorch port against the JAX package's
Pallas kernel, run in Pallas's TPU interpret mode.

The JAX kernel walks the cache in tiles of 256 keys with an online softmax;
the port's plain version takes one masked softmax in float32, and its
split version rounds where the CUDA kernel rounds (spans of 128 keys, tiles
of 64). All return bf16, so they agree to about one bf16 rounding of values
below 1: the tolerance is 1e-2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ganq_tpu.ops import fused_attention as jfa
from ganq_tpu_torch.ops import fused_attention as tfa
from test_torch_packing import torch_threads_per_worker  # noqa: F401

T = 512          # two of the JAX kernel's 256-key tiles


def _problem(rng, B, hq, hkv, d):
    q = rng.normal(size=(B, hq, d)).astype(np.float32)
    k = rng.normal(size=(B, T, hkv, d)).astype(np.float32)
    v = rng.normal(size=(B, T, hkv, d)).astype(np.float32)
    # bf16-exact inputs, so both packages read identical values
    return [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
            for a in (q, k, v)]


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])      # GQA ratios 1, 4
@pytest.mark.parametrize("pos", [5, 300, T - 1])    # first tile, mid, last row
def test_matches_pallas(rng, hq, hkv, pos):
    B, d = 2, 64
    q, k, v = _problem(rng, B, hq, hkv, d)
    scale = 1.0 / np.sqrt(d)
    with pltpu.force_tpu_interpret_mode():
        ref = jfa.flash_decode_attention(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
            jnp.asarray(v, jnp.bfloat16), jnp.int32(pos), scale)
    ref = np.array(ref.astype(jnp.float32))
    tk = torch.from_numpy(k).to(torch.bfloat16)
    tv = torch.from_numpy(v).to(torch.bfloat16)
    got = tfa.flash_decode_attention(torch.from_numpy(q).to(torch.bfloat16),
                                     tk, tv, torch.tensor(pos), scale)
    assert got.shape == (B, hq, d) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2, rtol=0)
    # and the plain version equals the JAX package's plain version
    jref = np.array(jfa.flash_decode_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, scale
    ).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), jref, atol=1e-2, rtol=0)
    split = tfa.flash_decode_split_reference(
        torch.from_numpy(q), tk, tv, torch.tensor(pos), scale)
    assert split.shape == (B, hq, d) and split.dtype == torch.bfloat16
    np.testing.assert_allclose(split.float().numpy(), ref, atol=1e-2, rtol=0)


@pytest.mark.parametrize("t,pos", [(96, 0), (96, 95), (200, 127), (200, 128),
                                   (512, 300), (512, 511)])
def test_split_reference_bound(rng, t, pos):
    """The split version differs from the float32 softmax only by rounding
    p to bf16 (relative error at most 2^-8) and the output to bf16, so per
    element |split - plain| <= one bf16 ulp + 2^-8 * sum_t p_t |v_t| (plus
    1e-5 of that sum for float32 sums in another order). Positions sit in a
    single partial span and on both sides of a span edge."""
    B, hq, hkv, d = 2, 8, 2, 64
    q, k, v = _problem(rng, B, hq, hkv, d)
    k, v = k[:, :t], v[:, :t]
    q_t, k_t, v_t = (torch.from_numpy(a) for a in (q, k, v))
    split = tfa.flash_decode_split_reference(
        q_t, k_t.to(torch.bfloat16), v_t.to(torch.bfloat16), pos, 0.125)
    plain = tfa.flash_decode_reference(q_t, k_t, v_t, pos, 0.125)
    kk = k_t[:, :pos + 1].repeat_interleave(hq // hkv, dim=2)
    vv = v_t[:, :pos + 1].repeat_interleave(hq // hkv, dim=2).abs()
    p = torch.softmax(torch.einsum("bhd,bthd->bht", q_t, kk) * 0.125, dim=-1)
    pv = torch.einsum("bht,bthd->bhd", p, vv)
    big = torch.maximum(split.float().abs(), plain.float().abs())
    ulp = torch.exp2(torch.floor(torch.log2(big.clamp_min(1e-30))) - 7)
    err = (split.float() - plain.float()).abs()
    assert bool((err <= ulp + (2**-8 + 1e-5) * pv).all())
    # keys past pos do not reach the output
    k_t[:, pos + 1:], v_t[:, pos + 1:] = 1e4, -1e4
    dirty = tfa.flash_decode_split_reference(
        q_t, k_t.to(torch.bfloat16), v_t.to(torch.bfloat16), pos, 0.125)
    torch.testing.assert_close(dirty, split, rtol=0, atol=0)


def test_keys_past_pos_do_not_count(rng):
    """Stale values in cache rows past pos must not reach the output."""
    B, hq, hkv, d, pos = 1, 4, 2, 64, 100
    q, k, v = _problem(rng, B, hq, hkv, d)
    tk = torch.from_numpy(k).to(torch.bfloat16)
    tv = torch.from_numpy(v).to(torch.bfloat16)
    clean = tfa.flash_decode_attention(torch.from_numpy(q), tk, tv, pos, 0.125)
    tk[:, pos + 1:] = 1e4
    tv[:, pos + 1:] = -1e4
    dirty = tfa.flash_decode_attention(torch.from_numpy(q), tk, tv, pos, 0.125)
    torch.testing.assert_close(dirty, clean, rtol=0, atol=0)


@pytest.mark.parametrize("pos", [63, 200, 400])
def test_split_bound_catches_an_off_by_one_mask(rng, pos):
    """The bound that holds the CUDA kernel to the split version on the card
    is tight enough to fail a kernel that attends one key too many or too
    few."""
    B, hq, hkv, d = 2, 8, 2, 64
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _problem(rng, B, hq, hkv, d))
    split = tfa.flash_decode_split_reference(q, k, v, pos, 0.125)
    assert bool((tfa.flash_decode_split_bound(q, k, v, pos, 0.125, split, split)
                 > 0).all())
    for wrong in (pos - 1, pos + 1):
        bad = tfa.flash_decode_split_reference(q, k, v, wrong, 0.125)
        err = (bad.float() - split.float()).abs()
        bound = tfa.flash_decode_split_bound(q, k, v, pos, 0.125, bad, split)
        assert bool((err > bound).any())
