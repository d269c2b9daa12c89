"""The port's one int8 activation rule against every quantization point of
``ganq_tpu`` it replaces: the plain versions of kernels 6 and 8-15, the lm
fold and the attention half's output rows.

Each JAX point runs under ``jax.jit`` (or inside a kernel), where XLA turns
its division by the constant 127.0 into a product with fl(1/127). The rows
are those where that product and the IEEE quotient differ in the last bit,
so a point that divides fails here. Inputs come from numpy with a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganq_tpu.ops import fused_mlp as jfm
from ganq_tpu.ops import megastep as jms
from ganq_tpu.ops import megastep4 as jm4
from ganq_tpu.ops import megastep_lowbit as jml
from ganq_tpu.ops import moe_expert as jmoe
from ganq_tpu_torch.ops import fused_attention as tfa
from ganq_tpu_torch.ops import fused_layer as tfl
from ganq_tpu_torch.ops import fused_mlp as tfm
from ganq_tpu_torch.ops import megastep as tms
from ganq_tpu_torch.ops import megastep4 as tm4
from ganq_tpu_torch.ops import megastep_lowbit as tml
from ganq_tpu_torch.ops import moe_expert as tmoe
from ganq_tpu_torch.ops import uniform_matmul as tum
from ganq_tpu_torch.ops import w8_matmul as tw8
from test_torch_packing import torch_threads_per_worker  # noqa: F401
from test_torch_uniform_matmul import _rows_where_quotient_differs

HEADS, HEAD_DIM = 4, 32          # attention-output rows: 4 heads of 32


def _sx_divided_then_clamped(x):
    """``ganq_tpu/ops/uniform_matmul.py:166``, ``fused_attention.py:116``,
    ``fused_layer.py:73``: max(max|x| / 127.0, 1e-12)."""
    return jnp.maximum(jnp.max(jnp.abs(x), axis=1, keepdims=True) / 127.0,
                       1e-12)


def _sx_w8(x):
    """``ganq_tpu/ops/w8_matmul.py:114``: the quotient, then the clamp."""
    sx = jnp.max(jnp.abs(x), axis=1, keepdims=True) / 127.0
    return jnp.maximum(sx, 1e-12)


def _sa_running_max(a):
    """``ganq_tpu/ops/fused_layer.py:185-194``, ``megastep.py:188-196``,
    ``megastep4.py:248-255``: a running max over the heads from 1e-12, then
    the division by 127.0."""
    sa = jnp.zeros((a.shape[0], 1), jnp.float32) + 1e-12
    for h in range(HEADS):
        a_h = a[:, h * HEAD_DIM:(h + 1) * HEAD_DIM]
        sa = jnp.maximum(sa, jnp.max(jnp.abs(a_h), axis=1, keepdims=True))
    return sa / 127.0


def _sa_lowbit(a):
    """``ganq_tpu/ops/megastep_lowbit.py:722-723``: clamp, then divide."""
    return jnp.maximum(jnp.max(jnp.abs(a), axis=1, keepdims=True),
                       1e-12) / 127.0


def _second(fn):
    return lambda x: fn(x)[1]


# (point, the port's quantizer as the module that runs it names it, the
# JAX point's scale)
_POINTS = [
    ("k6 uniform_a8", tum.quantize_rows, _sx_divided_then_clamped),
    ("k8 w8a8", tw8.quantize_rows, _sx_w8),
    ("k9 fused_mlp", tfm.quantize_rows, _second(jfm._quant_rows)),
    ("k10 fused_qkv_rope", tum.quantize_rows, _sx_divided_then_clamped),
    ("k11 fused_layer x", tum.quantize_rows, _sx_divided_then_clamped),
    ("k11 fused_layer attention out", tfl.attn_out_int8, _sa_running_max),
    ("k12 megastep", tms.quantize_rows, _second(jms._quant_rows)),
    ("k12 megastep attention out", tms.attn_out_int8, _sa_running_max),
    ("k13 megastep4", tm4.quantize_rows, _second(jm4._quant_rows)),
    ("k13 megastep4 attention out", tm4.attn_out_int8, _sa_running_max),
    ("k14 megastep_lowbit", tm4.quantize_rows, _second(jml._quant_rows)),
    ("k14 megastep_lowbit attention out", tm4.attn_out_int8, _sa_lowbit),
    ("k15 moe_expert", tmoe.quantize_rows, _second(jmoe._quant_rows)),
    ("lm fold", tml.quantize_rows, _second(jml._quant_rows)),
]


@pytest.mark.parametrize("point,port,jax_scale", _POINTS,
                         ids=[p[0] for p in _POINTS])
def test_activation_scale_is_jitted_jax(point, port, jax_scale):
    """sx (or the attention output's sa) bit for bit against the jitted JAX
    point, on rows where the quotient differs from the product, and the
    codes with it."""
    rng = np.random.default_rng(11)
    x = _rows_where_quotient_differs(rng, 8, HEADS * HEAD_DIM)
    x[0] = 0.0                                  # the 1e-12 floor
    want = np.asarray(jax.jit(jax_scale)(jnp.asarray(x)))
    x8, got = port(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    amax = np.abs(x[1:]).max(axis=1, keepdims=True)
    assert (want[1:] != amax / np.float32(127.0)).all()
    codes = np.clip(np.round(x / want), -127, 127)
    np.testing.assert_array_equal(x8.numpy(), codes)


def test_quantization_points_share_one_rule():
    """Every plain quantization point of the port reaches the one quantizer
    (``uniform_matmul.quantize_rows``) or the attention output's
    (``fused_layer.attn_out_int8``); kernel 10's plain version imports it
    where it runs."""
    for mod in (tw8, tfm, tms, tm4, tml, tmoe):
        assert mod.quantize_rows is tum.quantize_rows, mod.__name__
    for mod in (tms, tm4):
        assert mod.attn_out_int8 is tfl.attn_out_int8, mod.__name__
    assert "quantize_rows" in tfa.fused_qkv_rope_plain.__code__.co_names
