"""Kernel 12 of the port (``megastep_decode_w8a8``, one decode step over all
layers) against ``ganq_tpu``.

ganq_tpu's megapack of a random stacked ``w8`` llama (head_dim 128, two
layers, three MLP tiles) is carried into the port as tensors. The port's
wrapper runs its plain version on CPU tensors; ganq_tpu's Pallas kernel runs
in interpret mode. Both keep the residual in float32 across the layers and
compute the same operations in the same order except float32 sums (the
rmsnorms, attention scores and p . v), rsqrt and exp, which XLA and
PyTorch round in their last bits; an int8 activation within those bits of a
rounding tie flips by one code and moves its outputs by at most sx * max|w|.
So the port is held to the interpret-mode kernel within one bf16 ulp plus
5e-3 of the largest output, and to ganq_tpu's oracle ``megastep_reference``
(which rounds the residual to bf16 after every layer and computes the
softmax in one piece) at the JAX test's own tolerance (2e-2 for k/v, 5e-2
for y, ``tests/test_megastep.py``)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ganq_tpu.models import synthetic as jsyn
from ganq_tpu.ops import megastep as jms
from ganq_tpu.serve import stacked as jst
from ganq_tpu_torch.ops import megastep as tms

from test_torch_fused_w8a8 import assert_kernel_close
from test_torch_stacked import np_llama
from test_torch_packing import torch_threads_per_worker  # noqa: F401


def _t(a):
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("B", [1, 8])
def test_megastep_matches_jax(B):
    rng = np.random.default_rng(20 + B)
    cfg = jsyn.llama_config(hidden=256, inter=1536, layers=2, heads=2,
                            kv_heads=1, vocab=64, max_pos=128)
    # ganq_tpu's synthetic w8 kind, drawn with numpy and stacked
    sp = jst.stack_layers(np_llama(cfg, ("w8", "w8"), seed=3))
    L, H, d = 2, 256, 128
    for norm in ("input_norm", "post_norm"):
        sp["layers_stacked"][norm]["weight"] = jnp.asarray(
            rng.uniform(0.5, 1.5, size=(L, H)).astype(np.float32))
    mp = jms.megapack(cfg, sp)
    mpt = {k: _t(v) for k, v in mp.items()}
    assert tms.megastep_tile(mp["down_t"].shape[1]) == 512     # three tiles
    T, kv_dim = 64, 128
    kw = dict(q_dim=cfg.q_dim, kv_dim=kv_dim, head_dim=d, rotary_dim=d,
              eps=1e-5, scale=float(1 / np.sqrt(d)))
    ang = rng.uniform(0, 2 * np.pi, size=(d // 2,)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    x = jnp.asarray(rng.normal(size=(B, H)).astype(np.float32) * 0.4,
                    jnp.bfloat16)
    # the oracle compiled once for both positions (eager, every op of its
    # first call compiles on its own)
    reference = jax.jit(functools.partial(jms.megastep_reference, **kw))
    for pos in (3, 50):
        kc = np.array(jnp.asarray(rng.normal(size=(L, B, T, d)).astype(
            np.float32) * 0.3, jnp.bfloat16).astype(jnp.float32))
        vc = np.array(jnp.asarray(rng.normal(size=(L, B, T, d)).astype(
            np.float32) * 0.3, jnp.bfloat16).astype(jnp.float32))
        kc[:, :, pos:], vc[:, :, pos:] = 23.0, -7.0     # never attended
        jk, jv = jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16)
        with pltpu.force_tpu_interpret_mode():
            ref = jax.block_until_ready(jms.megastep_decode_w8a8(
                x, mp, jk, jv, jnp.int32(pos), jnp.asarray(cos),
                jnp.asarray(sin), block_t=32, **kw))
        oracle = reference(x, mp, jk, jv, jnp.int32(pos), jnp.asarray(cos),
                           jnp.asarray(sin))
        got = tms.megastep_decode_w8a8(
            _t(x), mpt, _t(jk), _t(jv), torch.tensor(pos, dtype=torch.int32),
            torch.from_numpy(cos), torch.from_numpy(sin), block_t=32, **kw)
        for name, g, r, o, tol in zip(("y", "k", "v"), got, ref, oracle,
                                      (5e-2, 2e-2, 2e-2)):
            r = np.asarray(jnp.asarray(r).astype(jnp.float32))
            o = np.asarray(jnp.asarray(o).astype(jnp.float32))
            assert tuple(g.shape) == r.shape and g.dtype == torch.bfloat16
            assert_kernel_close(g.float().numpy(), r, flips=5e-3,
                                what=f"megastep {name} B={B} pos={pos}")
            np.testing.assert_allclose(g.float().numpy(), o, atol=tol,
                                       rtol=tol)
