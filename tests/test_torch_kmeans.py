"""The port's codebook initializers against ganq_tpu's, on the CPU: the exact
k-means (the port's own build of its own copy of the C++ source) and the
batched weighted Lloyd solver."""

import os

import numpy as np
import pytest
import torch

from ganq_tpu.ops import kmeans as jkm
from ganq_tpu.ops import kmeans_exact as jkx
from ganq_tpu_torch.ops import kmeans as tkm
from ganq_tpu_torch.ops import kmeans_exact as tkx


def test_exact_kmeans_is_bit_identical():
    """Same source, same flags, float64: the codebooks of every row are
    bit-identical to ganq_tpu's."""
    rng = np.random.default_rng(0)
    X = rng.standard_t(df=3, size=(37, 300)).astype(np.float32)
    w = (rng.uniform(0.1, 2.0, size=300) ** -4.0).astype(np.float32)
    for k in (4, 8, 16):
        np.testing.assert_array_equal(tkx.kmeans_rows_exact(X, w, k),
                                      jkx.kmeans_rows_exact(X, w, k))


def test_exact_kmeans_builds_its_own_library():
    """The port builds into build/ under a hash-named file and never loads
    the JAX package's library."""
    path = tkx.build()
    assert path.parent.name == "build" and path.name.startswith("libkmeans1d-")
    assert "ganq_tpu_torch" in str(tkx.SOURCE)
    loaded = tkx.load_lib()._name
    assert os.path.samefile(loaded, path)
    assert os.path.join("ganq_tpu", "native") not in loaded


@pytest.mark.parametrize("k", [4, 16])
def test_weighted_lloyd_matches_jax(k):
    """Same quantile init, 25 Lloyd iterations, sorted centers: 1e-5."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(70, 96)).astype(np.float32)
    w = rng.uniform(0.2, 3.0, size=96).astype(np.float32)
    ref = np.asarray(jkm.weighted_kmeans_1d(x, w, k=k, row_chunk=32))
    got = tkm.weighted_kmeans_1d(torch.from_numpy(x), torch.from_numpy(w),
                                 k=k, row_chunk=32).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert (np.diff(got, axis=1) >= 0).all()


def test_leanquant_weights_match_jax():
    d = np.random.default_rng(2).uniform(0.05, 3.0, size=64).astype(np.float32)
    np.testing.assert_allclose(
        tkm.leanquant_weights(torch.from_numpy(d), 4.0).numpy(),
        np.asarray(jkm.leanquant_weights(d, 4.0)), rtol=1e-6)
