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
