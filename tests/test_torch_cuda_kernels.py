"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped without a GPU. On a machine with one (and without
JAX, which the root conftest imports) run it as

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Shapes go beyond the serving path's: every bit width, f32 and bf16
activations, padded K, ragged batch tiles, GQA ratios 1/4/32, head dims 64
and 128, and positions at tile edges; for the S-step kernels ragged m and n
(n not a multiple of the 128-column block) and codebooks of 4 to 256
entries; for the uniform and int8 kernels every bit width, symmetric and
asymmetric zeros, sequential and permuted ``g_idx``, and batches 1 to 512.
"""

import math

import pytest
import torch

from ganq_tpu_torch.core.config import QuantizeConfig
from ganq_tpu_torch.ops.fused_attention import (
    flash_decode_attention, flash_decode_reference, flash_decode_split_bound,
    flash_decode_split_reference)
from ganq_tpu_torch.ops.lut_matmul import lut_matmul, lut_matmul_reference
from ganq_tpu_torch.ops.ganq_solver import (s_step, s_step_blocked,
                                            s_step_blocked_kernel,
                                            s_step_kernel)
from ganq_tpu_torch.ops.packing import pack_factor, pack_int_rows
from ganq_tpu_torch.ops.uniform_matmul import (dequantize_uniform,
                                               uniform_a8_matmul,
                                               uniform_a8_reference,
                                               uniform_matmul,
                                               uniform_matmul_reference)
from ganq_tpu_torch.ops.w8_matmul import (w8_matmul, w8_matmul_reference,
                                          w8a8_matmul, w8a8_reference)
from ganq_tpu_torch.quant.ganq import ganq_quantize, quad_loss
from ganq_tpu_torch.quant.preamble import _ganq_L

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _lut_problem(gen, bits, M, K, Kp):
    lut = torch.sort(torch.randn((M, 2**bits), generator=gen, device="cuda"),
                     dim=1).values.to(torch.bfloat16)
    idx = torch.zeros((M, Kp), dtype=torch.int32, device="cuda")
    idx[:, :K] = torch.randint(0, 2**bits, (M, K), generator=gen, device="cuda",
                               dtype=torch.int32)
    return lut, pack_int_rows(idx, bits)


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("B", [1, 2, 3, 8, 9, 33, 1023])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1100, 72])
def test_lut_matmul_matches_plain(gen, bits, B, dtype, K):
    """f32: float32 sums in another order, 1e-5 of the output scale. bf16:
    both round a float32 sum once, so they differ by at most one ulp.
    K = 1100 packs to a padded width that is a multiple of 8 words (GEMV
    and, for bf16 beyond 8 rows, the tensor-core kernel); K = 72 packs to
    an odd width (the GEMV's unaligned path)."""
    M = 72                                  # not a multiple of a row tile
    pf = pack_factor(bits)
    align = 128 * pf if K > 128 * pf else pf    # as lut_linear pads
    Kp = -(-K // align) * align
    lut, packed = _lut_problem(gen, bits, M, K, Kp)
    x = torch.randn((B, K), generator=gen, device="cuda").to(dtype)
    before = lut_matmul.launches
    got = lut_matmul(x, lut, packed, bits)
    assert lut_matmul.launches == before + 1
    plain = lut_matmul_reference(x, lut, packed, bits)
    assert got.dtype == dtype and got.shape == (B, M)
    exact = lut_matmul_reference(x.double(), lut, packed, bits)
    scale = float(exact.abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5 * scale)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(1e-30))) - 7)
        assert bool(((got.double() - exact).abs() <= ulp + 1e-6 * scale).all())


def test_lut_matmul_f32_codebook_and_leading_dims(gen):
    M, K = 16, 256
    lut, packed = _lut_problem(gen, 4, M, K, K)
    x = torch.randn((2, 3, K), generator=gen, device="cuda")
    got = lut_matmul(x, lut.float(), packed, 4)
    plain = lut_matmul_reference(x, lut.float(), packed, 4)
    assert got.shape == (2, 3, M)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-4)


def test_lut_matmul_rejects_what_it_cannot_run(gen):
    lut, packed = _lut_problem(gen, 4, 8, 64, 64)
    with pytest.raises(ValueError):
        lut_matmul(torch.randn((1, 64), device="cuda"), lut, packed, 8)
    with pytest.raises(TypeError):
        lut_matmul(torch.randn((1, 64), device="cuda").half(), lut, packed, 4)
    with pytest.raises(ValueError):
        lut_matmul(torch.randn((1, 128), device="cuda"), lut, packed, 4)


def _assert_flash_close(q, k, v, pos, scale, got):
    """The kernel against the split version, which rounds p and the output
    where the kernel does, within ``flash_decode_split_bound`` (one bf16
    ulp plus terms for float32 order); and against the float32 softmax
    within 1e-2."""
    split = flash_decode_split_reference(q, k, v, pos, scale)
    err = (got.float() - split.float()).abs()
    bound = flash_decode_split_bound(q, k, v, pos, scale, got, split)
    assert bool((err <= bound).all()), float((err / bound).max())
    plain = flash_decode_reference(q, k, v, pos, scale)
    torch.testing.assert_close(got.float(), plain.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("hq,hkv,d", [(8, 8, 64), (32, 8, 64), (16, 4, 128),
                                      (32, 1, 128)])
@pytest.mark.parametrize("pos", [0, 63, 64, 200, 511])
@pytest.mark.parametrize("B", [1, 3])
def test_flash_decode_matches_plain(gen, hq, hkv, d, pos, B):
    T = 512
    q = torch.randn((B, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((B, T, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, T, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    before = flash_decode_attention.launches
    got = flash_decode_attention(q, k, v, pos_t, scale)
    assert flash_decode_attention.launches == before + 1
    _assert_flash_close(q, k, v, pos, scale, got)
    # rows past pos are never read: poisoning them changes nothing
    k[:, pos + 1:] = float("nan")
    v[:, pos + 1:] = float("nan")
    again = flash_decode_attention(q, k, v, pos, scale)        # host int pos
    torch.testing.assert_close(again, got, atol=0, rtol=0)


@pytest.mark.parametrize("pos", [0, 50, 95])
def test_flash_decode_single_span(gen, pos):
    """A cache of at most 128 rows is one span: one block per (row, kv head),
    and the combining pass only divides."""
    B, hq, hkv, d, T = 2, 16, 4, 64, 96
    q = torch.randn((B, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((B, T, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, T, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    got = flash_decode_attention(q, k, v, pos, 0.125)
    _assert_flash_close(q, k, v, pos, 0.125, got)


def test_flash_decode_reads_f32_query_as_bf16(gen):
    B, hq, hkv, d, T, pos = 2, 8, 2, 64, 128, 77
    q = torch.randn((B, hq, d), generator=gen, device="cuda")
    k = torch.randn((B, T, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, T, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    a = flash_decode_attention(q, k, v, pos, 0.125)
    b = flash_decode_attention(q.to(torch.bfloat16), k, v, pos, 0.125)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def _sstep_problem(gen, m, n, V):
    """W and sorted codebooks of std 1, L the GANQ factor of a random
    positive definite H from 2n samples."""
    W = torch.randn((m, n), generator=gen, device="cuda")
    X = torch.randn((2 * n, n), generator=gen, device="cuda")
    H = X.T @ X / (2 * n)
    T = torch.sort(torch.randn((m, V), generator=gen, device="cuda"),
                   dim=1).values
    return W, _ganq_L(H), T, H


def _assert_sstep_close(W, T, H, got, plain):
    """Index agreement >= 0.999; where the indices agree Werr = W - T[Q]
    is the same float operation on both sides, so it must agree to 1e-4;
    the quadratic loss tr(E H E^T) within 1e-5 of the plain version's
    (near-tie flips are expected, ganq_tpu/quant/ganq.py:113-115)."""
    (Q, E), (Qp, Ep) = got, plain
    same = Q == Qp
    assert float(same.float().mean()) >= 0.999
    torch.testing.assert_close(E[same], Ep[same], rtol=1e-4, atol=1e-4)
    loss = float(quad_loss(W, torch.take_along_dim(T, Q.long(), dim=1), H))
    ref = float(quad_loss(W, torch.take_along_dim(T, Qp.long(), dim=1), H))
    assert abs(loss - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize("m,n", [(33, 130), (200, 384), (64, 257)])
@pytest.mark.parametrize("V", [4, 8, 16, 256])
def test_s_step_blocked_kernel_matches_plain(gen, m, n, V):
    W, L, T, H = _sstep_problem(gen, m, n, V)
    before = s_step_blocked_kernel.launches
    got = s_step_blocked_kernel(W, L, T)
    assert s_step_blocked_kernel.launches == before + 1
    assert got[0].dtype == torch.int32 and got[0].shape == (m, n)
    _assert_sstep_close(W, T, H, got, s_step_blocked(W, L, T))


@pytest.mark.parametrize("m,n", [(33, 130), (200, 384), (64, 257)])
@pytest.mark.parametrize("V", [4, 8, 16, 256])
def test_s_step_kernel_matches_plain(gen, m, n, V):
    W, L, T, H = _sstep_problem(gen, m, n, V)
    before = s_step_kernel.launches
    got = s_step_kernel(W, L, T)
    assert s_step_kernel.launches == before + 1
    _assert_sstep_close(W, T, H, got, s_step(W, L, T))


def test_s_step_kernels_reject_what_they_cannot_run(gen):
    W, L, T, _ = _sstep_problem(gen, 8, 16, 16)
    with pytest.raises(ValueError):
        s_step_blocked_kernel(W, L, T[:, :5])
    with pytest.raises(TypeError):
        s_step_kernel(W.double(), L.double(), T.double())


@pytest.mark.parametrize("backend,kernel", [("auto", "blocked"),
                                            ("pallas", "columns"),
                                            ("jax", None)])
def test_ganq_quantize_on_the_card(gen, backend, kernel):
    """One module through ganq_quantize on the card: "auto" runs kernel 3
    and "pallas" kernel 4 once per iteration, "jax" neither. Against the
    same module on the CPU (plain per-column S-step, float32 T-step in
    another summation order): codes agree at >= 0.99 and the quadratic loss
    within 1e-3."""
    m, n, iters = 96, 256, 3
    W = torch.randn((m, n), generator=gen, device="cuda") * 0.02
    X = torch.randn((4 * n, n), generator=gen, device="cuda")
    H = 2.0 / 4 * (X.T @ X)
    qcfg = QuantizeConfig(bits=4, quant_method="ganq", act_sort="asc",
                          l_damp_style="ganq", dead="mean",
                          ganq_iterations=iters, solver_backend=backend)
    counts = (s_step_blocked_kernel.launches, s_step_kernel.launches)
    r = ganq_quantize(W, H, qcfg, nsamples=4)
    grew = (s_step_blocked_kernel.launches - counts[0],
            s_step_kernel.launches - counts[1])
    steps = iters + int(r.fallback)
    assert grew == {"blocked": (steps, 0), "columns": (0, steps),
                    None: (0, 0)}[kernel]
    cpu = ganq_quantize(W.cpu(), H.cpu(), qcfg, nsamples=4)
    assert float((r.idx.cpu() == cpu.idx).float().mean()) >= 0.99
    assert abs(r.quad_loss - cpu.quad_loss) <= 1e-3 * cpu.quad_loss
    assert bool(torch.isfinite(r.lut).all())


def _uniform_problem(gen, bits, M, K, G, sym, permuted):
    codes = torch.randint(0, 2**bits, (M, K), generator=gen, device="cuda",
                          dtype=torch.int32)
    scales = torch.rand((M, G), generator=gen, device="cuda") * 0.003 + 0.001
    zeros = None if sym else torch.randint(
        0, 2**bits, (M, G), generator=gen, device="cuda").float()
    g_idx = None
    if permuted:
        gs = -(-K // G)
        g_idx = (torch.randperm(K, generator=gen, device="cuda") // gs).to(
            torch.int32)
    return pack_int_rows(codes, bits), scales, zeros, g_idx


def _assert_within_ulp(got, exact):
    """got against a float64 sum of the same products. bf16: one ulp plus
    1e-6 of the output scale (a float32 sum rounded once). f32: 1e-5 of the
    output scale (float32 sums in another order)."""
    scale = float(exact.abs().max())
    err = (got.double() - exact).abs()
    if got.dtype == torch.bfloat16:
        mag = exact.abs().clamp_min(1e-30)
        tol = torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-6 * scale
    else:
        tol = torch.full_like(exact, 1e-5 * scale)
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("B", [1, 3, 8, 33, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", ["seq", "perm", "sym", "odd"])
def test_uniform_matmul_matches_plain(gen, bits, B, dtype, groups):
    """Kernel 5 at every g_idx kind: the weight rounded to x's type as the
    plain version rounds it, the sum within one ulp of the float64 sum.
    "odd" is a width of 9 words (unaligned) with one group."""
    M = 72
    K, G = (1024, 8) if groups != "odd" else (9 * pack_factor(bits), 1)
    packed, scales, zeros, g_idx = _uniform_problem(
        gen, bits, M, K, G, sym=groups == "sym", permuted=groups == "perm")
    x = torch.randn((B, K), generator=gen, device="cuda").to(dtype)
    before = uniform_matmul.launches
    got = uniform_matmul(x, packed, scales, zeros, g_idx, bits)
    assert uniform_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, M)
    w = dequantize_uniform(packed, scales, zeros, g_idx, bits, K).to(dtype)
    _assert_within_ulp(got, x.double() @ w.double().T)
    plain = uniform_matmul_reference(x, packed, scales, zeros, g_idx, bits)
    torch.testing.assert_close(got.float(), plain.float(), rtol=1e-2,
                               atol=1e-2 * float(plain.abs().max()))


@pytest.mark.parametrize("bits,K,G", [(4, 1024, 8), (4, 1024, 1), (8, 1024, 8),
                                      (3, 1024, 8), (2, 2048, 16), (8, 2048, 8)])
@pytest.mark.parametrize("B", [1, 3, 8, 33, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sym", [True, False])
def test_uniform_a8_matmul_matches_plain(gen, bits, K, G, B, dtype, sym):
    """Kernel 6 against its plain version: the same int8 activations, exact
    integer dots per group against float32 sums of the same products;
    within 1e-5 of the output scale plus one ulp of x's type."""
    M = 72
    packed, scales, zeros, _ = _uniform_problem(gen, bits, M, K, G, sym,
                                                permuted=False)
    x = torch.randn((B, K), generator=gen, device="cuda").to(dtype)
    before = (uniform_a8_matmul.launches, uniform_matmul.launches)
    got = uniform_a8_matmul(x, packed, scales, zeros, None, bits)
    assert (uniform_a8_matmul.launches, uniform_matmul.launches) == \
        (before[0] + 1, before[1])
    plain = uniform_a8_reference(x, packed, scales, zeros, None, bits)
    assert got.dtype == dtype and got.shape == (B, M)
    scale = float(plain.float().abs().max())
    ulp = 2.0**-7 if dtype == torch.bfloat16 else 2.0**-23
    torch.testing.assert_close(got.float(), plain.float(), rtol=ulp,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("bits,K,M", [(4, 512, 8), (4, 72, 4), (8, 36, 8)])
@pytest.mark.parametrize("B", [1, 5])
def test_uniform_a8_matmul_few_rows_unaligned_width(gen, bits, K, M, B):
    """At most 8 output rows the gate admits planes that are no multiple of
    128 words (one group): a partial chunk, and for widths of 9 words the
    kernel's unaligned byte loads."""
    packed, scales, zeros, _ = _uniform_problem(gen, bits, M, K, 1, False,
                                                permuted=False)
    x = torch.randn((B, K), generator=gen, device="cuda")
    before = uniform_a8_matmul.launches
    got = uniform_a8_matmul(x, packed, scales, zeros, None, bits)
    assert uniform_a8_matmul.launches == before + 1
    plain = uniform_a8_reference(x, packed, scales, zeros, None, bits)
    torch.testing.assert_close(got, plain, rtol=1e-5,
                               atol=1e-5 * float(plain.abs().max()))


def test_uniform_a8_gated_out_runs_kernel5(gen):
    """A permuted g_idx (and a 64-column group) fails the a8 gate: the JAX
    function returns the full-precision product there, so this one launches
    kernel 5 and not kernel 6."""
    for permuted, K, G in ((True, 1024, 8), (False, 1024, 16)):
        packed, scales, zeros, g_idx = _uniform_problem(
            gen, 4, 64, K, G, sym=False, permuted=permuted)
        x = torch.randn((4, K), generator=gen, device="cuda")
        before = (uniform_a8_matmul.launches, uniform_matmul.launches)
        got = uniform_a8_matmul(x, packed, scales, zeros, g_idx, 4)
        assert (uniform_a8_matmul.launches, uniform_matmul.launches) == \
            (before[0], before[1] + 1)
        plain = uniform_matmul_reference(x, packed, scales, zeros, g_idx, 4)
        torch.testing.assert_close(got, plain, rtol=1e-5,
                                   atol=1e-5 * float(plain.abs().max()))


def _w8_problem(gen, M, Kp):
    w8 = torch.randint(-127, 128, (M, Kp), generator=gen, device="cuda",
                       dtype=torch.int32).to(torch.int8)
    scale = torch.rand((M, 1), generator=gen, device="cuda") * 3e-4 + 1e-4
    return w8, scale


@pytest.mark.parametrize("K,Kp", [(1024, 1024), (1000, 1024), (72, 72)])
@pytest.mark.parametrize("B", [1, 3, 8, 33, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8_matmul_matches_plain(gen, K, Kp, B, dtype):
    """Kernel 7: the weight rounded to x's type as the plain version rounds
    it, the sum within one ulp of the float64 sum; x zero-padded past K."""
    M = 72
    w8, scale = _w8_problem(gen, M, Kp)
    x = torch.randn((B, K), generator=gen, device="cuda").to(dtype)
    before = w8_matmul.launches
    got = w8_matmul(x, w8, scale)
    assert w8_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, M)
    w = (w8.float() * scale)[:, :K].to(dtype)
    _assert_within_ulp(got, x.double() @ w.double().T)
    plain = w8_matmul_reference(x, w8, scale)
    torch.testing.assert_close(got.float(), plain.float(), rtol=1e-2,
                               atol=1e-2 * float(plain.abs().max()))


@pytest.mark.parametrize("K,Kp,M", [(1024, 1024, 72), (1000, 1024, 72),
                                    (72, 72, 8), (2048, 2048, 136)])
@pytest.mark.parametrize("B", [1, 3, 8, 33, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_matmul_matches_plain(gen, K, Kp, M, B, dtype):
    """Kernel 8 equals its plain version bit for bit: the same int8
    activations (IEEE division, ties to even), an exact integer dot on both
    sides, and the same two float products in the same order."""
    w8, scale = _w8_problem(gen, M, Kp)
    x = torch.randn((B, K), generator=gen, device="cuda").to(dtype)
    before = (w8a8_matmul.launches, w8_matmul.launches)
    got = w8a8_matmul(x, w8, scale)
    assert (w8a8_matmul.launches, w8_matmul.launches) == \
        (before[0] + 1, before[1])
    torch.testing.assert_close(got, w8a8_reference(x, w8, scale), rtol=0,
                               atol=0)


def test_w8a8_gated_out_runs_kernel7(gen):
    """K' no multiple of 128 with more than 8 rows fails the w8a8 gate: the
    full-precision product through kernel 7."""
    w8, scale = _w8_problem(gen, 16, 72)
    x = torch.randn((2, 72), generator=gen, device="cuda")
    before = (w8a8_matmul.launches, w8_matmul.launches)
    got = w8a8_matmul(x, w8, scale)
    assert (w8a8_matmul.launches, w8_matmul.launches) == \
        (before[0], before[1] + 1)
    torch.testing.assert_close(got, w8_matmul_reference(x, w8, scale),
                               rtol=1e-5, atol=1e-6)


def test_uniform_and_w8_kernels_reject_what_they_cannot_run(gen):
    packed, scales, _, _ = _uniform_problem(gen, 4, 8, 256, 2, True, False)
    with pytest.raises(TypeError):
        uniform_matmul(torch.randn((1, 256), device="cuda").half(), packed,
                       scales, None, None, 4)
    with pytest.raises(ValueError):
        uniform_matmul(torch.randn((1, 128), device="cuda"), packed, scales,
                       None, None, 4)
    w8, scale = _w8_problem(gen, 8, 64)
    with pytest.raises(ValueError):
        w8_matmul(torch.randn((1, 128), device="cuda"), w8, scale)


# ------------------------------------------------------- kernels 9-12
# The fused W8A8 kernels and their plain versions compute the same
# operations in the same order, except float32 sums (rmsnorm's mean of
# squares, attention scores and p . v) and rsqrt/exp, which differ in their
# last bits. An int8 activation then flips by one code where its value sits
# within those bits of a rounding tie; a flip moves an output by at most
# sx * max|w| (about max|h| / 127 of one weight), about 1e-3 of the outputs'
# largest magnitude. Kernels 9-11 (one layer) are held to one bf16 ulp plus
# 5e-3 of max|plain|, and so is kernel 12, over layers whose o and down
# scales are a tenth of the others' (each layer adds a tenth of the
# residual's size, as in a trained model). With every projection at full
# scale the random model is chaotic: each flip moves the next layer's
# activations and flips more codes, and the plain version alone, given norm
# weights two float32 ulps larger, moves by 2.5% relative L2 after three
# layers.

from ganq_tpu_torch.ops.fused_attention import (fused_qkv_rope_plain,
                                                fused_qkv_rope_w8a8)
from ganq_tpu_torch.ops.fused_layer import (attn_half_decode_w8a8,
                                            attn_half_plain)
from ganq_tpu_torch.ops.fused_mlp import (fused_mlp_plain, fused_mlp_tile,
                                          fused_mlp_w8a8)
from ganq_tpu_torch.ops.megastep import megastep_decode_w8a8, megastep_plain


def _close(got, plain, rel, what):
    err = (got.float() - plain.float()).abs()
    big = torch.maximum(got.float().abs(), plain.float().abs()).clamp_min(1e-30)
    tol = torch.exp2(torch.floor(torch.log2(big)) - 7) \
        + rel * plain.float().abs().max()
    assert bool(torch.isfinite(got.float()).all()), what
    assert bool((err <= tol).all()), \
        f"{what}: max err {float(err.max()):.3e}, worst err/tol " \
        f"{float((err / tol).max()):.2f}"


def _w8(gen, M, K):
    w8 = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                       dtype=torch.int32).to(torch.int8)
    scale = torch.rand((M, 1), generator=gen, device="cuda") * 3e-4 + 1e-4
    return w8, scale


def _norm_w(gen, H):
    return torch.rand(H, generator=gen, device="cuda") + 0.5


@pytest.mark.parametrize("H,Hp,I,Ip", [(256, 256, 1536, 1536),
                                       (512, 640, 1024, 1152),
                                       (3072, 3072, 8192, 8192)])
@pytest.mark.parametrize("B", [1, 3, 8, 33, 64])
@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_mlp_matches_plain(gen, H, Hp, I, Ip, B, fold, dtype):
    if fold and Hp != H:
        pytest.skip("the folded norm needs an unpadded gateup")
    gu, gs = _w8(gen, 2 * I, Hp)
    dn, ds = _w8(gen, H, Ip)
    x = torch.randn((B, H), generator=gen, device="cuda").to(dtype)
    nw = _norm_w(gen, H) if fold else None
    before = fused_mlp_w8a8.launches
    got = fused_mlp_w8a8(x, gu, gs, dn, ds, norm_w=nw)
    assert fused_mlp_w8a8.launches == before + 1
    plain = fused_mlp_plain(x, gu, gs, dn, ds, norm_w=nw)
    torch.cuda.synchronize()
    assert fused_mlp_tile(I, Hp) in (256, 512, 1024)
    _close(got, plain, 5e-3, f"fused_mlp H={H} I={I} B={B}")


def _rope(gen, d):
    ang = torch.rand(d // 2, generator=gen, device="cuda") * 6.2831853
    return torch.cos(ang), torch.sin(ang)


@pytest.mark.parametrize("q_dim,kv_dim,d", [(3072, 1024, 128), (256, 128, 128),
                                            (512, 128, 64)])
@pytest.mark.parametrize("B", [1, 5, 8, 64])
@pytest.mark.parametrize("rd,inter", [(None, False), (None, True), (64, False)])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_qkv_rope_matches_plain(gen, q_dim, kv_dim, d, B, rd, inter,
                                      bias):
    rd = d if rd is None else rd
    H = 2 * q_dim if q_dim < 1024 else 3072
    Dqkv = q_dim + 2 * kv_dim
    w, s = _w8(gen, Dqkv, H)
    b = torch.randn(Dqkv, generator=gen, device="cuda") * 0.1 if bias else None
    cos, sin = _rope(gen, rd)
    x = torch.randn((B, H), generator=gen, device="cuda").to(torch.bfloat16)
    nw = _norm_w(gen, H)
    args = (x, nw, w, s, b, cos, sin, q_dim, kv_dim, d, rd, inter)
    before = fused_qkv_rope_w8a8.launches
    got = fused_qkv_rope_w8a8(*args)
    assert fused_qkv_rope_w8a8.launches == before + 1
    plain = fused_qkv_rope_plain(*args)
    torch.cuda.synchronize()
    _close(got, plain, 5e-3, f"fused_qkv_rope B={B} d={d} rd={rd}")


def _attn_problem(gen, B, q_dim, kv_dim, H, T, pos):
    d = 128
    Dqkv = q_dim + 2 * kv_dim
    qkv, qs = _w8(gen, Dqkv, H)
    ow, osc = _w8(gen, H, q_dim)
    kc = torch.randn((B, T, kv_dim // d, d), generator=gen, device="cuda") * 0.5
    vc = torch.randn((B, T, kv_dim // d, d), generator=gen, device="cuda") * 0.5
    kc[:, pos:] = 23.0                 # never attended
    vc[:, pos:] = -7.0
    x = torch.randn((B, H), generator=gen, device="cuda").to(torch.bfloat16)
    return (x, _norm_w(gen, H), qkv, qs, None, ow.T.contiguous(),
            osc.reshape(1, -1), *_rope(gen, d),
            kc.to(torch.bfloat16), vc.to(torch.bfloat16))


@pytest.mark.parametrize("q_dim,kv_dim,H", [(3072, 1024, 3072),
                                            (512, 128, 256)])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("T,pos", [(512, 0), (512, 3), (512, 300),
                                   (384, 383), (384, 129)])
def test_attn_half_matches_plain(gen, q_dim, kv_dim, H, B, T, pos):
    args = _attn_problem(gen, B, q_dim, kv_dim, H, T, pos)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=128, rotary_dim=128,
              scale=1.0 / math.sqrt(128))
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    before = attn_half_decode_w8a8.launches
    y, kn, vn = attn_half_decode_w8a8(*args, pos_t, **kw)
    assert attn_half_decode_w8a8.launches == before + 1
    py, pk, pv = attn_half_plain(*args, pos, **kw)
    torch.cuda.synchronize()
    _close(kn, pk, 5e-3, "attn_half k_new")
    _close(vn, pv, 5e-3, "attn_half v_new")
    _close(y, py, 5e-3, f"attn_half y B={B} T={T} pos={pos}")


def _megapack(gen, L, H, q_dim, kv_dim, I):
    Dqkv = q_dim + 2 * kv_dim

    def stack(f):
        return torch.stack([f() for _ in range(L)])

    mp = {"attn_norm": stack(lambda: _norm_w(gen, H).reshape(1, H)),
          "mlp_norm": stack(lambda: _norm_w(gen, H).reshape(1, H)),
          "qkv_bias": stack(lambda: torch.randn((1, Dqkv), generator=gen,
                                                device="cuda") * 0.05)}
    for key, (M, K) in (("qkv", (Dqkv, H)), ("o_t", (q_dim, H)),
                        ("gateup", (2 * I, H)), ("down_t", (I, H))):
        w = [_w8(gen, M, K) for _ in range(L)]
        mp["down_t" if key == "down_t" else f"{key}_w8"] = torch.stack(
            [a for a, _ in w])
        if key == "qkv":
            mp["qkv_scale"] = torch.stack([s for _, s in w])
        elif key == "gateup":
            mp["gateup_scale"] = torch.stack([s for _, s in w])
    mp["o_t_scale"] = stack(lambda: torch.rand((1, H), generator=gen,
                                               device="cuda") * 3e-5 + 1e-5)
    mp["down_scale"] = stack(lambda: torch.rand((1, H), generator=gen,
                                                device="cuda") * 3e-5 + 1e-5)
    return mp


@pytest.mark.parametrize("L,H,q_dim,kv_dim,I", [(2, 256, 256, 128, 1536),
                                                (3, 3072, 3072, 1024, 8192)])
@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("T,pos", [(64, 0), (64, 50), (512, 300)])
def test_megastep_matches_plain(gen, L, H, q_dim, kv_dim, I, B, T, pos):
    mp = _megapack(gen, L, H, q_dim, kv_dim, I)
    Hkv = kv_dim // 128
    kc = (torch.randn((L, B * Hkv, T, 128), generator=gen, device="cuda")
          * 0.5).to(torch.bfloat16)
    vc = (torch.randn((L, B * Hkv, T, 128), generator=gen, device="cuda")
          * 0.5).to(torch.bfloat16)
    kc[:, :, pos:] = 23.0
    vc[:, :, pos:] = -7.0
    x = torch.randn((B, H), generator=gen, device="cuda").to(torch.bfloat16)
    cos, sin = _rope(gen, 128)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=128, rotary_dim=128,
              scale=1.0 / math.sqrt(128))
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    before = megastep_decode_w8a8.launches
    y, kn, vn = megastep_decode_w8a8(x, mp, kc, vc, pos_t, cos, sin, **kw)
    assert megastep_decode_w8a8.launches == before + 1
    py, pk, pv = megastep_plain(x, mp, kc, vc, pos, cos, sin, **kw)
    torch.cuda.synchronize()
    _close(kn, pk, 5e-3, "megastep k_new")
    _close(vn, pv, 5e-3, "megastep v_new")
    _close(y, py, 5e-3, f"megastep y L={L} B={B} pos={pos}")


# ------------------------------------------------ kernels 13 and 14
from ganq_tpu_torch.ops.megastep4 import (_mlp_tile4, _qkv_tile4,
                                          megastep4_decode, megastep4_plain)
from ganq_tpu_torch.ops.megastep_lowbit import (_mlp_plan,
                                                megastep_lowbit_decode,
                                                megastep_lowbit_plain)


def _grouped_pack(gen, L, H, q_dim, kv_dim, I, bits, kmajor, gs=128):
    """Random whole-step operands in the layouts of kernel 13's megapack4
    (``kmajor``) or kernel 14's megapack_lowbit: any byte is a valid code
    byte. The o and down scales are a tenth of the others' (residual-
    dominated layers, as trained models are), so that an int8 activation
    flipped at a rounding tie does not snowball through the layers."""
    Dqkv = q_dim + 2 * kv_dim
    F = 2 if bits == 4 else 1
    ti = _mlp_tile4(I) if kmajor else _mlp_plan(I, bits, H)[0]
    gtp = -(-(ti // gs) // 8) * 8
    unit = 16.0 if bits == 4 else 1.0

    def codes(*shape):
        return torch.randint(-128, 128, (L, *shape), generator=gen,
                             device="cuda", dtype=torch.int32).to(torch.int8)

    def scales(*shape, lo=1e-4):
        return ((torch.rand((L, *shape), generator=gen, device="cuda") * 3
                 + 1) * lo * unit).to(torch.bfloat16)

    mp = {"attn_norm": torch.rand((L, 1, H), generator=gen, device="cuda")
          + 0.5,
          "mlp_norm": torch.rand((L, 1, H), generator=gen, device="cuda")
          + 0.5,
          "qkv_bias": torch.randn((L, 1, Dqkv), generator=gen, device="cuda")
          * 0.05,
          "qkv_s": scales(H // gs, Dqkv), "o_s": scales(q_dim // gs, H,
                                                        lo=1e-5),
          "gu_s": scales(H // gs, 2 * I),
          "dn_s": scales(I // ti * gtp, H, lo=1e-5)}
    if kmajor:
        mp.update(qkv_p4=codes(Dqkv // 2, H), o_p4=codes(q_dim, H // 2),
                  gu_p4=codes(I, H), dn_p4=codes(I, H // 2))
    else:
        mp.update(qkv_pk=codes(Dqkv // F, H), o_pk=codes(H // F, q_dim),
                  gu_pk=codes(2 * I // F, H), dn_pk=codes(H // F, I))
    return mp


def _grouped_step(gen, L, H, kv_dim, B, T, pos):
    Hkv = kv_dim // 128
    kc = (torch.randn((L, B * Hkv, T, 128), generator=gen, device="cuda")
          * 0.5).to(torch.bfloat16)
    vc = (torch.randn((L, B * Hkv, T, 128), generator=gen, device="cuda")
          * 0.5).to(torch.bfloat16)
    for b, p in enumerate(pos):                     # never attended
        kc[:, b * Hkv:(b + 1) * Hkv, p:] = 23.0
        vc[:, b * Hkv:(b + 1) * Hkv, p:] = -7.0
    x = torch.randn((B, H), generator=gen, device="cuda").to(torch.bfloat16)
    return x, kc, vc


_GROUPED_SHAPES = [(2, 256, 256, 128, 512), (2, 3072, 3072, 1024, 8192)]


@pytest.mark.parametrize("L,H,q_dim,kv_dim,I", _GROUPED_SHAPES)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B", [1, 2, 8, 9, 64])
@pytest.mark.parametrize("T,pos0", [(64, 0), (64, 50), (512, 300)])
def test_megastep_lowbit_matches_plain(gen, L, H, q_dim, kv_dim, I, bits, B,
                                       T, pos0):
    mp = _grouped_pack(gen, L, H, q_dim, kv_dim, I, bits, False)
    pos = [(pos0 + 7 * b) % (T - 1) if pos0 else 0 for b in range(B)]
    x, kc, vc = _grouped_step(gen, L, H, kv_dim, B, T, pos)
    cos, sin = _rope(gen, 128)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=128, rotary_dim=128,
              scale=1.0 / math.sqrt(128), bits=bits)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    before = megastep_lowbit_decode.launches
    y, kn, vn = megastep_lowbit_decode(x, mp, kc, vc, pos_t, cos, sin, **kw)
    assert megastep_lowbit_decode.launches == before + 1
    py, pk, pv = megastep_lowbit_plain(x, mp, kc, vc, pos, cos, sin, **kw)
    torch.cuda.synchronize()
    what = f"megastep_lowbit bits={bits} H={H} B={B} pos={pos0}"
    _close(kn, pk, 5e-3, what + " k_new")
    _close(vn, pv, 5e-3, what + " v_new")
    _close(y, py, 5e-3, what + " y")


@pytest.mark.parametrize("L,H,q_dim,kv_dim,I", _GROUPED_SHAPES)
@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("T,pos0", [(64, 0), (64, 50), (512, 300)])
def test_megastep4_matches_plain(gen, L, H, q_dim, kv_dim, I, B, T, pos0):
    assert _qkv_tile4(q_dim + 2 * kv_dim, 128)
    mp = _grouped_pack(gen, L, H, q_dim, kv_dim, I, 4, True)
    pos = [(pos0 + 7 * b) % (T - 1) if pos0 else 0 for b in range(B)]
    x, kc, vc = _grouped_step(gen, L, H, kv_dim, B, T, pos)
    cos, sin = _rope(gen, 128)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=128, rotary_dim=128,
              scale=1.0 / math.sqrt(128))
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    before = megastep4_decode.launches
    y, kn, vn = megastep4_decode(x, mp, kc, vc, pos_t, cos, sin, **kw)
    assert megastep4_decode.launches == before + 1
    py, pk, pv = megastep4_plain(x, mp, kc, vc, pos, cos, sin, **kw)
    torch.cuda.synchronize()
    what = f"megastep4 H={H} B={B} pos={pos0}"
    _close(kn, pk, 5e-3, what + " k_new")
    _close(vn, pv, 5e-3, what + " v_new")
    _close(y, py, 5e-3, what + " y")


# the smoke's random operands (chip_smoke.py phase 3)
from chip_smoke import _moe_pack, _zp_ao_operands


@pytest.mark.parametrize("L,H,q_dim,kv_dim,I", _GROUPED_SHAPES)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B", [1, 9, 64])
@pytest.mark.parametrize("zp,ao", [(True, False), (False, True),
                                   (True, True)])
def test_megastep_lowbit_zero_points_actorder_match_plain(
        gen, L, H, q_dim, kv_dim, I, bits, B, zp, ao):
    """Kernel 14 with zero points (``*_sz``) and/or act-order column orders
    (``ap_*``) against its plain version: at the plain cases' tolerance
    (one bf16 ulp plus 5e-3 of the largest output) without zero points,
    and with them 1e-2: an int8 activation that flips at a rounding tie
    in one layer also moves its group's activation sum by one, which adds
    +-sz (up to a quarter of 2^bits scale steps) to every row of the next
    product, as the JAX tests widen their asym bound
    (``tests/test_megastep_lowbit.py:709-712``)."""
    mp = _zp_ao_operands(gen, _grouped_pack(gen, L, H, q_dim, kv_dim, I,
                                            bits, False),
                         L, H, q_dim, bits, zp, ao)
    T, pos0 = 64, 50
    pos = [(pos0 + 7 * b) % (T - 1) for b in range(B)]
    x, kc, vc = _grouped_step(gen, L, H, kv_dim, B, T, pos)
    cos, sin = _rope(gen, 128)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=128, rotary_dim=128,
              scale=1.0 / math.sqrt(128), bits=bits)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    before = megastep_lowbit_decode.launches
    y, kn, vn = megastep_lowbit_decode(x, mp, kc, vc, pos_t, cos, sin, **kw)
    assert megastep_lowbit_decode.launches == before + 1
    py, pk, pv = megastep_lowbit_plain(x, mp, kc, vc, pos, cos, sin, **kw)
    torch.cuda.synchronize()
    what = f"megastep_lowbit zp={zp} ao={ao} bits={bits} H={H} B={B}"
    rel = 1e-2 if zp else 5e-3
    _close(kn, pk, rel, what + " k_new")
    _close(vn, pv, rel, what + " v_new")
    _close(y, py, rel, what + " y")


# ------------------------------------------------------------- kernel 15
from ganq_tpu_torch.models.transformer import moe_slots
from ganq_tpu_torch.ops.moe_expert import moe_expert_decode, moe_expert_plain


@pytest.mark.parametrize("E,H,I,bits,B", [
    (E, H, I, bits, B) for E, H, I in ((4, 256, 512), (8, 512, 8192))
    for bits in (4, 8) for B in (1, 3, 8, 32)] + [
    (8, 4096, 14336, bits, B) for bits in (4, 8) for B in (1, 32)])
def test_moe_expert_matches_plain(gen, E, H, I, bits, B):
    """Kernel 15 against its plain version (run on the card) on routed
    slots (top-2 of random routing, zero-weight padding slots where B * 2 <
    E), up to Mixtral-8x7B's widths (I = 14336: 7 tiles at 8 bits, 4 at 4
    bits)."""
    mp = _moe_pack(gen, E, H, I, bits)
    x = (torch.randn((B, H), generator=gen, device="cuda") * 0.5).to(
        torch.bfloat16)
    logits = torch.randn((B, E), generator=gen, device="cuda")
    probs = torch.softmax(logits, dim=-1)
    sel = probs >= torch.topk(probs, 2, dim=-1).values[:, -1:]
    gated = torch.where(sel, probs, 0.0)
    gated = gated / gated.sum(-1, keepdim=True)
    slot_ids, wts = moe_slots(gated, 2)
    before = moe_expert_decode.launches
    y = moe_expert_decode(x, mp, slot_ids, wts, bits=bits)
    assert moe_expert_decode.launches == before + 1
    py = moe_expert_plain(x, mp, slot_ids, wts, bits=bits)
    torch.cuda.synchronize()
    _close(y, py, 5e-3, f"moe_expert E={E} I={I} bits={bits} B={B}")


def test_moe_expert_rejects_what_it_cannot_run(gen):
    mp = _moe_pack(gen, 4, 256, 512, 4)
    x = torch.zeros((33, 256), device="cuda", dtype=torch.bfloat16)
    ids = torch.zeros(4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="B <= 32"):
        moe_expert_decode(x, mp, ids, torch.zeros((33, 4), device="cuda"))
    with pytest.raises(ValueError, match="wts"):
        moe_expert_decode(x[:2], mp, ids, torch.zeros((3, 4), device="cuda"))
