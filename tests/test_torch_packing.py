"""Planar packing of the PyTorch port: packed int32 words bit-exact with the
JAX package for 2, 3, 4 and 8 bits, and unpacking exact both ways."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ganq_tpu.ops import packing as jpack
from ganq_tpu_torch.ops import packing as tpack


@pytest.fixture(scope="module", autouse=True)
def torch_threads_per_worker():
    """Under pytest-xdist (``PYTEST_XDIST_WORKER_COUNT`` worker processes)
    torch's intra-op threads of a worker are the cores over the workers, at
    least one: torch's default of a thread per core in every worker
    oversubscribes the cores and its OpenMP threads spin (a batching case of
    ``test_torch_lowbit_w3_walsh.py`` took 313 s under such load, 45 s with
    one thread). A single process keeps torch's default; the previous count
    is restored. The port's test modules import this fixture."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = torch.get_num_threads()
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_packed_words_bit_exact(rng, bits):
    idx = rng.integers(0, 2**bits, size=(16, 256)).astype(np.int32)
    ref = np.array(jpack.pack_int_rows(jnp.asarray(idx), bits))
    got = tpack.pack_int_rows(torch.from_numpy(idx), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # words with the top bit set (negative int32) are covered; 3-bit codes
    # sit one per nibble and never reach it
    assert (ref < 0).any() == (bits != 3)
    # each package unpacks the other's words exactly
    np.testing.assert_array_equal(
        tpack.unpack_int_rows(torch.from_numpy(ref), bits, 256).numpy(), idx)
    np.testing.assert_array_equal(
        np.asarray(jpack.unpack_int_rows(jnp.asarray(got.numpy()), bits, 256)),
        idx)
    assert tpack.pack_factor(bits) == jpack.pack_factor(bits)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_unpack_plane_matches(rng, bits):
    idx = rng.integers(0, 2**bits, size=(4, 64)).astype(np.int32)
    packed = np.array(jpack.pack_int_rows(jnp.asarray(idx), bits))
    for p in range(tpack.pack_factor(bits)):
        np.testing.assert_array_equal(
            tpack.unpack_plane(torch.from_numpy(packed), bits, p).numpy(),
            np.asarray(jpack.unpack_plane(jnp.asarray(packed), bits, p)))


def test_pack_rejects_ragged_rows():
    with pytest.raises(ValueError):
        tpack.pack_int_rows(torch.zeros((2, 12), dtype=torch.int32), 4)
