"""The port's seeded sampling chain (``core/prng``) against ``jax.random``.

Keys, splits, random bits and uniforms must equal JAX's bit for bit; the
Gumbel noise may differ from XLA's ``log`` in the last float32 bit, so a
categorical draw is compared where no two candidates tie within that. The
engine's sampler draws the tokens ``ganq_tpu/serve/engine.py::_sample``
draws for the same key.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ganq_tpu.serve.engine import _sample as jax_sample
from ganq_tpu_torch.core import prng
from ganq_tpu_torch.serve.engine import next_key, sample
from test_torch_packing import torch_threads_per_worker  # noqa: F401

SEEDS = (0, 1, 2**31 - 1, 2**40 + 5, -3)
SHAPES = ((5,), (3, 7), (2, 3, 4), (1, 300))
_DTYPES = ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
           (torch.float16, jnp.float16))


def _j(key):
    return np.asarray(key).astype(np.int64)


def test_partitionable_layout_is_pinned():
    """The sandbox's JAX splits and draws in the partitionable counter
    layout (``jax_threefry_partitionable``), and without 64-bit types a
    seed is taken modulo 2^32; the port copies that layout. Pinned by
    values of JAX 0.9: PRNGKey(0) splits into these keys and draws these
    bits."""
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64
    k = prng.prng_key(0)
    assert prng.split(k).tolist() == [[1797259609, 2579123966],
                                      [928981903, 3453687069]]
    assert prng.random_bits(k, (3,)).tolist() == [4070199207, 4202968722,
                                                  1427181096]
    assert prng.prng_key(2**40 + 5).tolist() == [0, 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_uniforms_match_jax(seed):
    """Keys, 2- and 3-way splits, a split of a split, 32-, 16- and 8-bit
    words and uniforms in float32, bfloat16 and float16 equal JAX's."""
    k, kj = prng.prng_key(seed), jax.random.PRNGKey(seed)
    assert k.tolist() == _j(kj).tolist()
    for n in (2, 3):
        np.testing.assert_array_equal(prng.split(k, n).numpy(),
                                      _j(jax.random.split(kj, n)))
    np.testing.assert_array_equal(prng.split(prng.split(k)[1]).numpy(),
                                  _j(jax.random.split(jax.random.split(kj)[1])))
    for shape in SHAPES:
        np.testing.assert_array_equal(prng.random_bits(k, shape).numpy(),
                                      _j(jax.random.bits(kj, shape)))
        for width, dt in ((16, jnp.uint16), (8, jnp.uint8)):
            np.testing.assert_array_equal(
                prng.random_bits(k, shape, width).numpy(),
                _j(jax.random.bits(kj, shape, dt)))
        for tdt, jdt in _DTYPES:
            tiny = float(jnp.finfo(jdt).tiny)
            for lo, hi in ((0.0, 1.0), (tiny, 1.0), (-2.0, 3.0)):
                got = prng.uniform(k, shape, tdt, lo, hi)
                want = jax.random.uniform(kj, shape, jdt, lo, hi)
                assert got.dtype == tdt
                np.testing.assert_array_equal(
                    got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("tdt,jdt", _DTYPES[:2])
def test_gumbel_within_log_rounding(tdt, jdt):
    """Gumbel noise ``-log(-log(u))`` in the engines' logit types (float32
    within one ulp of JAX's, bfloat16 equal): the uniforms are equal and
    only ``log`` rounds differently."""
    k, kj = prng.prng_key(9), jax.random.PRNGKey(9)
    got = prng.gumbel(k, (4, 500), tdt).float().numpy()
    want = np.asarray(jax.random.gumbel(kj, (4, 500), jdt), np.float32)
    eps = float(jnp.finfo(jdt).eps)
    assert np.all(np.abs(got - want) <= eps * np.maximum(np.abs(want), 1))


def _logits(seed, shape, spread=3.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * spread).astype(np.float32)


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_matches_jax(seed):
    """``categorical`` draws JAX's index for 1-d logits (the batching
    engine's per-slot draw) and per row of 2-d ones (the engine's)."""
    k, kj = prng.prng_key(seed), jax.random.PRNGKey(seed)
    for shape in ((300,), (4, 128), (2, 1000)):
        lg = _logits(abs(seed) % 97, shape)
        got = prng.categorical(k, torch.from_numpy(lg))
        want = jax.random.categorical(kj, jnp.asarray(lg), axis=-1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kw", [
    {"temperature": 0.0, "top_k": 0},
    {"temperature": 0.7, "top_k": 0},
    {"temperature": 1.0, "top_k": 5},
    {"temperature": 1.3, "top_k": 0, "top_p": 0.8},
    {"temperature": 0.9, "top_k": 20, "top_p": 0.9},
])
def test_sampled_tokens_match_jax_sample(kw):
    """The engine's ``sample`` with the key ``next_key`` splits off draws
    ``ganq_tpu``'s ``_sample`` tokens for the same key, through the
    temperature, top-k and top-p filters, over several steps of the
    chain."""
    key, kj = prng.prng_key(5), jax.random.PRNGKey(5)
    for step in range(4):
        lg = _logits(step, (3, 256))
        key, sub = next_key(key, kw["temperature"])
        kj, subj = jax.random.split(kj)
        got = sample(torch.from_numpy(lg), sub, **kw)
        want = jax_sample(jnp.asarray(lg), subj, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"step {step}")
