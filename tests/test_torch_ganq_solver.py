"""The port's S-step (``ops/ganq_solver.py``) against ganq_tpu's, on the CPU.

Both plain versions (the blocked one, plain version of kernel 3, and the
per-column one, plain version of kernel 4) are held against the JAX
``s_step`` and against the Pallas ``s_step_blocked_pallas`` run in interpret
mode, as ``tests/test_ganq.py`` runs it: index agreement > 0.999 and Werr
within 1e-4. On CPU tensors the kernel wrappers take these plain versions.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ganq_tpu.ops.ganq_solver import s_step_blocked_pallas
from ganq_tpu.quant import ganq as jganq
from ganq_tpu.quant.preamble import _ganq_L
from ganq_tpu_torch.ops import ganq_solver as sol
from ganq_tpu_torch.quant.ganq import s_step_reference


def _problem(seed, m, n, V):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(m, n)).astype(np.float32)
    X = rng.normal(size=(2 * n, n)).astype(np.float32)
    L = np.array(_ganq_L(X.T @ X / (2 * n)))
    T = np.sort(rng.normal(size=(m, V)).astype(np.float32), axis=1)
    return W, L, T


def _close(got, Q_ref, E_ref):
    Q, E = (t.numpy() for t in got)
    agree = np.mean(Q == np.asarray(Q_ref))
    assert agree > 0.999, agree
    np.testing.assert_allclose(E, np.asarray(E_ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("V", [4, 8, 16])
def test_plain_s_steps_match_jax_and_pallas(V):
    m, n = 128, 256
    W, L, T = _problem(V, m, n, V)
    Qj, Ej = jganq.s_step(W, L, T)
    with pltpu.force_tpu_interpret_mode():
        Qp, Ep = s_step_blocked_pallas(W, L, T)
    args = [torch.from_numpy(a) for a in (W, L, T)]
    for plain in (sol.s_step, sol.s_step_blocked):
        got = plain(*args)
        assert got[0].dtype == torch.int32
        _close(got, Qj, Ej)
        _close(got, Qp, Ep)


@pytest.mark.parametrize("m,n,V", [(24, 300, 16), (9, 130, 8)])
def test_blocked_plain_version_takes_ragged_shapes(m, n, V):
    """n not a multiple of the 128-column block (the kernel's ragged last
    block) and m below any tile: against the JAX scan and the numpy loop."""
    W, L, T = _problem(7, m, n, V)
    Qj, Ej = jganq.s_step(W, L, T)
    got = sol.s_step_blocked(*(torch.from_numpy(a) for a in (W, L, T)))
    _close(got, Qj, Ej)
    assert np.mean(got[0].numpy() == s_step_reference(W, L, T)) > 0.999
    np.testing.assert_array_equal(s_step_reference(W, L, T),
                                  jganq.s_step_reference(W, L, T))


def test_wrappers_take_the_plain_versions_on_cpu():
    W, L, T = (torch.from_numpy(a) for a in _problem(3, 16, 40, 8))
    before = (sol.s_step_blocked_kernel.launches, sol.s_step_kernel.launches)
    for wrapper, plain in ((sol.s_step_blocked_kernel, sol.s_step_blocked),
                           (sol.s_step_kernel, sol.s_step)):
        Q, E = wrapper(W, L, T)
        Qp, Ep = plain(W, L, T)
        assert torch.equal(Q, Qp) and torch.equal(E, Ep)
    assert (sol.s_step_blocked_kernel.launches,
            sol.s_step_kernel.launches) == before
