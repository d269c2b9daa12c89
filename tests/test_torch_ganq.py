"""The port's GANQ solver (``quant/ganq.py``) against ganq_tpu's, on the CPU.

T-steps, the int8 snap and the quadratic loss within 1e-4 relative; the
whole ``ganq_quantize`` (exact k-means init, the default) with codes in
agreement >= 0.99 and the quadratic loss within 1e-4 relative. The JAX
T-step contracts H as three bf16 terms, the port in float32: the same
numbers to float32 rounding."""

import time

import numpy as np
import pytest
import torch

from ganq_tpu.core.config import QuantizeConfig as JQuantizeConfig
from ganq_tpu.quant import ganq as jg
from ganq_tpu_torch.core.config import QuantizeConfig
from ganq_tpu_torch.ops import ganq_solver as sol
from ganq_tpu_torch.quant import ganq as tg


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_close(got, ref, tol=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


def _normal_problem(seed, m=40, n=64, k=16):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(m, n)).astype(np.float32)
    X = rng.normal(size=(3 * n, n)).astype(np.float32)
    H = (X.T @ X / n).astype(np.float32)
    Q = rng.integers(0, k, size=(m, n)).astype(np.int32)
    Q[:, :] = np.where(Q == k - 1, 0, Q)        # one codeword never used
    return W, H, Q, (W @ H).astype(np.float32)


@pytest.mark.parametrize("fast,k", [(False, 16), ("bf16", 16), (False, 8),
                                    ("strict", 4)])
def test_t_step_matches_jax(fast, k):
    W, H, Q, WH = _normal_problem(0, k=k)
    for stats, snap8 in ((False, False), (True, False), (True, True)):
        ref = jg.t_step(WH, H, Q, k, row_chunk=16, fast=fast, stats=stats,
                        snap8=snap8)
        got = tg.t_step(_t(WH), _t(H), _t(Q), k, row_chunk=16, fast=fast,
                        stats=stats, snap8=snap8)
        if stats:
            _rel_close(got[0], ref[0])
            _rel_close(float(got[1]), float(ref[1]))
        else:
            _rel_close(got, ref)


@pytest.mark.parametrize("sym", [False, True])
def test_t_step_affine_matches_jax(sym):
    W, H, Q, WH = _normal_problem(1)
    T, rel = jg.t_step_affine(WH, H, Q, 16, row_chunk=16, sym=sym, stats=True)
    Tt, relt = tg.t_step_affine(_t(WH), _t(H), _t(Q), 16, row_chunk=16,
                                sym=sym, stats=True)
    _rel_close(Tt, T)
    _rel_close(float(relt), float(rel))


def test_snap_lut8_and_quad_loss_match_jax():
    W, H, Q, _ = _normal_problem(2)
    T = np.random.default_rng(3).normal(size=(40, 16)).astype(np.float32)
    _rel_close(tg.snap_lut8(_t(T)), jg.snap_lut8(T))
    Wq = np.take_along_axis(T, Q, axis=1)
    _rel_close(float(tg.quad_loss(_t(W), _t(Wq), _t(H))),
               float(jg.quad_loss(W, Wq, H)))


def _quant_problem(seed, m=64, n=128, p=512):
    rng = np.random.default_rng(seed)
    W = (rng.normal(size=(m, n)) * 0.02).astype(np.float32)
    X = rng.normal(size=(p, n)).astype(np.float32)
    X[:, 5] = 0.0                                  # one dead column
    return W, (2.0 / 4 * X.T @ X).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(bits=4, codebook_init="kmeans_exact"),
    dict(bits=3, codebook_init="kmeans_exact", ganq_codebook="lut8"),
    dict(bits=4, codebook_init="kmeans", ganq_codebook="affine"),
])
def test_ganq_quantize_matches_jax(kw):
    W, H = _quant_problem(4)
    cfg = dict(quant_method="ganq", ganq_iterations=3, act_sort="asc",
               l_damp_style="ganq", dead="mean", **kw)
    ref = jg.ganq_quantize(W, H, JQuantizeConfig(**cfg), nsamples=4)
    got = tg.ganq_quantize(_t(W), _t(H), QuantizeConfig(**cfg), nsamples=4)
    assert got.idx.dtype == torch.int32
    assert np.mean(got.idx.numpy() == np.asarray(ref.idx)) >= 0.99
    assert got.quad_loss == pytest.approx(ref.quad_loss, rel=1e-4)
    assert got.avg_loss == pytest.approx(ref.avg_loss, rel=1e-3)
    assert got.damp_used == ref.damp_used and not got.fallback
    if ref.quad_loss_free is not None:
        assert got.quad_loss_free == pytest.approx(ref.quad_loss_free, rel=1e-4)
    np.testing.assert_allclose(got.Q.numpy(), np.asarray(ref.Q), atol=1e-3)


@pytest.mark.parametrize("backend", ["auto", "pallas", "jax"])
def test_cpu_runs_the_plain_s_step_for_every_backend(backend):
    """On the CPU the JAX package runs its scan S-step whatever
    ``solver_backend`` says; so does the port (its plain per-column version),
    and no kernel wrapper is called."""
    W, H = _quant_problem(5, m=16, n=32, p=64)
    before = (sol.s_step_blocked_kernel.launches, sol.s_step_kernel.launches)
    qcfg = QuantizeConfig(quant_method="ganq", ganq_iterations=2,
                          solver_backend=backend)
    assert tg._select_s_step(qcfg, torch.device("cpu")) is sol.s_step
    tg.ganq_quantize(_t(W), _t(H), qcfg, nsamples=4)
    assert (sol.s_step_blocked_kernel.launches,
            sol.s_step_kernel.launches) == before
    cuda = torch.device("cuda")
    assert tg._select_s_step(qcfg, cuda) is {
        "auto": sol.s_step_blocked_kernel, "pallas": sol.s_step_kernel,
        "jax": sol.s_step}[backend]


def test_no_iteration_falls_back_to_the_initial_codebook():
    W, H = _quant_problem(6, m=16, n=32, p=64)
    cfg = dict(quant_method="ganq", ganq_iterations=0, codebook_init="linear")
    ref = jg.ganq_quantize(W, H, JQuantizeConfig(**cfg), nsamples=4)
    got = tg.ganq_quantize(_t(W), _t(H), QuantizeConfig(**cfg), nsamples=4)
    assert got.fallback
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    _rel_close(got.lut, ref.lut, 1e-6)


def test_timings_split_the_solve_into_its_phases():
    """``timings`` collects seconds per solver phase, adding up to no more
    than the call's wall time, and leaves the result unchanged."""
    W, H = _quant_problem(7, m=16, n=32, p=64)
    qcfg = QuantizeConfig(quant_method="ganq", ganq_iterations=2,
                          codebook_init="kmeans")
    phases = {}
    t0 = time.perf_counter()
    got = tg.ganq_quantize(_t(W), _t(H), qcfg, nsamples=4, timings=phases)
    wall = time.perf_counter() - t0
    assert sorted(phases) == ["final", "init", "prepare", "s_step", "t_step"]
    assert all(v >= 0.0 for v in phases.values())
    assert sum(phases.values()) <= wall
    ref = tg.ganq_quantize(_t(W), _t(H), qcfg, nsamples=4)
    assert torch.equal(got.idx, ref.idx) and torch.equal(got.lut, ref.lut)
