"""The port's Hessian accumulation and solver preamble against ganq_tpu's,
on the same numpy-seeded inputs, on the CPU."""

import numpy as np
import pytest
import torch

from ganq_tpu.core.config import QuantizeConfig as JQuantizeConfig
from ganq_tpu.quant import preamble as jpre
from ganq_tpu.quant.hessian import HessianAccumulator as JHessian
from ganq_tpu_torch.core.config import QuantizeConfig
from ganq_tpu_torch.quant import preamble as tpre
from ganq_tpu_torch.quant.hessian import HessianAccumulator
from test_torch_packing import torch_threads_per_worker  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def test_hessian_matches_jax():
    """Float32 Gram sums of the same batches, 2/nsamples with nsamples
    counting sequences: equal to 1e-6 relative (summation order only)."""
    rng = np.random.default_rng(0)
    batches = [rng.normal(size=(2, 24, 48)).astype(np.float32),
               rng.normal(size=(3, 24, 48)).astype(np.float32),
               rng.normal(size=(24, 48)).astype(np.float32)]   # one sample
    jacc, tacc = JHessian(48), HessianAccumulator(48, "cpu")
    for x in batches:
        jacc.update(x)
        tacc.update(_t(x))
    assert tacc.nsamples == jacc.nsamples == 6
    ref = np.asarray(jacc.finalize())
    got = tacc.finalize().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    with pytest.raises(ValueError):
        HessianAccumulator(4, "cpu").finalize()


def _problem(seed, m=40, n=64, dead=(3, 17, 40), rank=None):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(m, n)).astype(np.float32)
    X = rng.normal(size=(rank or 4 * n, n)).astype(np.float32)
    X[:, list(dead)] = 0.0                     # never-activated columns
    return W, (2.0 / 8) * (X.T @ X).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(dead="mean", act_sort="asc", l_damp_style="ganq"),
    dict(dead="zero", act_sort="desc", l_damp_style="gptq"),
    dict(dead="mean", act_sort="none", l_damp_style="gptq"),
])
def test_prepare_matches_jax(kw):
    """Perm and invperm exact (dead columns tie at diag 1: the stable sorts
    must agree on ties); W exact; L, Hinv, the damped H within 1e-5 of their
    scale; the damp used equal."""
    W, H = _problem(1)
    jp = jpre.prepare(W, H, JQuantizeConfig(quant_method="ganq", **kw))
    tp = tpre.prepare(_t(W), _t(H), QuantizeConfig(quant_method="ganq", **kw))
    if kw["act_sort"] == "none":
        assert jp.perm is None and tp.perm is None
    else:
        np.testing.assert_array_equal(tp.perm.numpy(), np.asarray(jp.perm))
        np.testing.assert_array_equal(tp.invperm.numpy(), np.asarray(jp.invperm))
    np.testing.assert_array_equal(tp.dead.numpy(), np.asarray(jp.dead))
    np.testing.assert_allclose(tp.W.numpy(), np.asarray(jp.W), rtol=1e-6,
                               atol=1e-6)
    for name in ("L", "Hinv", "Xxt", "Xxt_damped"):
        ref = np.asarray(getattr(jp, name))
        np.testing.assert_allclose(getattr(tp, name).numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)
    assert tp.damp_used == jp.damp_used


def test_damp_retry_matches_jax():
    """An indefinite H fails the Cholesky at the first damps: the port reads
    the failure from cholesky_ex's info, the JAX package from NaNs, and both
    retry with the same cumulative damp until it holds."""
    rng = np.random.default_rng(2)
    n = 32
    A = rng.normal(size=(n, n)).astype(np.float32)
    H = (A @ A.T / n).astype(np.float32)
    H -= 0.3 * np.eye(n, dtype=np.float32) * np.mean(np.diag(H))
    W = rng.normal(size=(8, n)).astype(np.float32)
    kw = dict(quant_method="ganq", act_sort="none", l_damp_style="gptq",
              damp_percent=0.01, damp_auto_increment=0.1)
    jp = jpre.prepare(W, H, JQuantizeConfig(**kw))
    tp = tpre.prepare(_t(W), _t(H), QuantizeConfig(**kw))
    assert jp.damp_used > 0.2                    # several retries happened
    assert tp.damp_used == pytest.approx(jp.damp_used, rel=1e-12)
    for name in ("L", "Hinv", "Xxt_damped"):
        ref = np.asarray(getattr(jp, name))
        np.testing.assert_allclose(getattr(tp, name).numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)
    with pytest.raises(FloatingPointError):
        tpre.prepare(_t(W), _t(H), QuantizeConfig(
            **dict(kw, damp_auto_increment=0.0)))
