"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped without a GPU. On a machine with one (and without
JAX, which the root conftest imports) run it as

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Shapes go beyond the serving path's: every bit width, f32 and bf16
activations, padded K, ragged batch tiles, GQA ratios 1/4/32, head dims 64
and 128, and positions at tile edges; for the S-step kernels ragged m and n
(n not a multiple of the 128-column block) and codebooks of 4 to 256
entries; for the uniform and int8 kernels every bit width, symmetric and
asymmetric zeros, sequential and permuted ``g_idx``, batches 1 to 1023
(the decode, tile and split paths of kernels 5-8), and output widths that
are no multiple of the row tiles.
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
@pytest.mark.parametrize("B", [1, 2, 3, 8, 9, 16, 17, 33, 128, 512, 1023])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1100, 72, 8192, 14336])
def test_lut_matmul_matches_plain(gen, bits, B, dtype, K):
    """f32: float32 sums in another order, 1e-5 of the output scale. bf16:
    within one ulp plus 1e-6 of the output scale of the float64 sum (a
    float32 sum rounded once), as kernel 7 is held. bf16 x runs the decode
    path up to 8 rows (16 where it splits no K; split over blocks at K' =
    14336 with 8 rows, whose x slice does not fit beside the rings) and the
    tensor-core tile beyond (split over blocks here, M = 72 leaving the SMs
    idle; no tensor-core chain longer than 2048 columns at K' = 8192 and
    14336, Llama-3.1-8B's down); f32 x the GEMV. K = 1100 packs to a
    padded width; K = 72, and 1100 at 2 bits, to widths that are no
    multiple of 16 words (the GEMV for every x)."""
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
        _assert_within_ulp(got, exact)


@pytest.mark.parametrize("B", [1, 8, 17, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1100, 72, 8192])
def test_lut_matmul_8bit_matches_plain(gen, B, dtype, K):
    """8-bit codes (256-entry codebooks) at the tolerances of
    test_lut_matmul_matches_plain: the GEMV up to 16 token rows and for f32
    x, the 64-row tile beyond (K split to 2048 columns a block at K' =
    8192). K = 1100 packs to a padded width, K = 72 to one that is no
    multiple of 16 words (the GEMV for every x); M = 72 is no multiple of
    the tile's 64 rows."""
    bits, M = 8, 72
    pf = pack_factor(bits)
    align = 128 * pf if K > 128 * pf else pf
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
        _assert_within_ulp(got, exact)


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
    """A cache of at most 128 rows is one span: one block per (row, kv
    head), which writes its output directly."""
    B, hq, hkv, d, T = 2, 16, 4, 64, 96
    q = torch.randn((B, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((B, T, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, T, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    got = flash_decode_attention(q, k, v, pos, 0.125)
    _assert_flash_close(q, k, v, pos, 0.125, got)


@pytest.mark.parametrize("pos", [0, 127, 128, 255, 256, 4095])
@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 64), (16, 4, 128), (8, 1, 80)])
def test_flash_decode_long_cache(gen, pos, B, hq, hkv, d):
    """A cache of 4096 rows (32 spans of 128 keys) at span edges: one span
    (pos 0, 127), two (128, 255), three (256) and all 32 (4095), where the
    last span block of each (row, kv head) to finish combines; blocks past
    pos read nothing, so poisoning those rows changes nothing. d = 80 pads
    the head dimension to the mma's 16 with zeros."""
    T = 4096
    q = torch.randn((B, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((B, T, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, T, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    got = flash_decode_attention(q, k, v, pos_t, scale)
    _assert_flash_close(q, k, v, pos, scale, got)
    k[:, pos + 1:] = float("nan")
    v[:, pos + 1:] = float("nan")
    for _ in range(2):   # the arrival counters are back at zero
        again = flash_decode_attention(q, k, v, pos_t, scale)
        torch.testing.assert_close(again, got, atol=0, rtol=0)


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


# (33, 130), (200, 384), (64, 257): m below and across the row tiles (128
# rows a block of kernel 3, 16 of kernel 4), n ragged against the 128- and
# 16-column blocks, one K chunk; (300, 890): several K chunks, kernel 3's
# serial schedule, n not a multiple of 4 (the scalar paths); (1000, 1101):
# the same on the overlapped schedule; (2048, 8192): Llama-3.2-1B's down
# projection
SSTEP_SHAPES = [(33, 130), (200, 384), (64, 257), (300, 890), (1000, 1101),
                (2048, 8192)]


@pytest.mark.parametrize("m,n", SSTEP_SHAPES)
@pytest.mark.parametrize("V", [4, 8, 16, 256])
def test_s_step_blocked_kernel_matches_plain(gen, m, n, V):
    W, L, T, H = _sstep_problem(gen, m, n, V)
    before = s_step_blocked_kernel.launches
    got = s_step_blocked_kernel(W, L, T)
    assert s_step_blocked_kernel.launches == before + 1
    assert got[0].dtype == torch.int32 and got[0].shape == (m, n)
    _assert_sstep_close(W, T, H, got, s_step_blocked(W, L, T))


@pytest.mark.parametrize("m,n", SSTEP_SHAPES)
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


# output width M: 72; 204, no multiple of the 8-row decode tiles or the
# 64-row tiles (the last tile's rows past M are read from row M - 1 and
# never stored); 512, a k/v linear, whose 64 decode row tiles at B = 1
# leave the card short of blocks, so K is split over blocks and a second
# launch adds the partial sums in order
_UNIFORM_M = [72, 204, 512]


def _split_scratch(B, M, width, bits):
    """The partial-sum scratch (floats) kernels 5 (bf16 x) and 6 plan for
    a shape: nonzero where they split K over blocks."""
    import ctypes

    from ganq_tpu_torch.ops import cuda_lib

    return (cuda_lib.function("uniform_matmul", "ganq_uniform_matmul_scratch",
                              [ctypes.c_int] * 5)(B, M, width, bits, 1),
            cuda_lib.function("uniform_matmul",
                              "ganq_uniform_a8_matmul_scratch",
                              [ctypes.c_int] * 4)(B, M, width, bits))


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("B", [1, 3, 8, 16, 33, 128, 512, 1023])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", ["seq", "perm", "sym", "odd"])
@pytest.mark.parametrize("M", _UNIFORM_M)
def test_uniform_matmul_matches_plain(gen, bits, B, dtype, groups, M):
    """Kernel 5 at every g_idx kind: the weight rounded to x's type as the
    plain version rounds it, the sum within one ulp of the float64 sum.
    "odd" is a width of 9 words (unaligned) with one group. B <= 8 with bf16
    x runs the decode path (split over K at M = 512, K = 2048), B >= 9 the
    tensor-core tile path ("perm" with zero points included); float32 x
    the GEMV up to 40 rows, the CUDA-core tile beyond; "odd" the GEMV."""
    K, G = (1024, 8) if M != 512 else (2048, 16)
    if groups == "odd":
        K, G = 9 * pack_factor(bits), 1
    packed, scales, zeros, g_idx = _uniform_problem(
        gen, bits, M, K, G, sym=groups == "sym", permuted=groups == "perm")
    if M == 512 and B == 1 and bits in (4, 8) and groups != "odd":
        assert _split_scratch(B, M, packed.shape[1], bits)[0] > 0
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


@pytest.mark.parametrize("K", [8192, 14336])
@pytest.mark.parametrize("B", [1, 8, 9, 128, 512, 1023])
@pytest.mark.parametrize("bits", [4, 8])
def test_uniform_matmul_long_rows(gen, K, B, bits):
    """Kernel 5 with bf16 x over the long rows of Llama-3.1-8B's down
    projection and beyond Llama-3.2-1B's (K' 8192, 14336, 128-column
    groups): within one ulp plus 1e-6 of the output scale of the float64
    sum, the bound kernel 7 is held to, on the decode path (B <= 8) and
    the tensor-core tile path."""
    M = 136
    packed, scales, zeros, g_idx = _uniform_problem(
        gen, bits, M, K, K // 128, sym=False, permuted=False)
    x = torch.randn((B, K), generator=gen, device="cuda").to(torch.bfloat16)
    got = uniform_matmul(x, packed, scales, zeros, g_idx, bits)
    w = dequantize_uniform(packed, scales, zeros, g_idx, bits, K).to(
        torch.bfloat16)
    _assert_within_ulp(got, x.double() @ w.double().T)


@pytest.mark.parametrize("bits,K,G", [(4, 1024, 8), (4, 1024, 1), (8, 1024, 8),
                                      (3, 1024, 8), (2, 2048, 16), (8, 2048, 8),
                                      (4, 2048, 16)])
@pytest.mark.parametrize("B", [1, 3, 8, 16, 33, 128, 512, 1023])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("M", _UNIFORM_M)
def test_uniform_a8_matmul_matches_plain(gen, bits, K, G, B, dtype, sym, M):
    """Kernel 6 against its plain version: the same int8 activations, exact
    integer dots per group against float32 sums of the same products;
    within 1e-5 of the output scale plus one ulp of x's type. At M = 512,
    K = 2048 and B = 1 the decode path splits K over blocks; B = 1023
    ends in a ragged tile of token rows."""
    packed, scales, zeros, _ = _uniform_problem(gen, bits, M, K, G, sym,
                                                permuted=False)
    if M == 512 and K == 2048 and B == 1 and bits in (4, 8):
        assert _split_scratch(B, M, packed.shape[1], bits)[1] > 0
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


def _w8_scratch(B, M, Kp, x_bf16):
    """The scratch bytes kernels 7 and 8 plan for a shape: kernel 7's is
    nonzero where it splits K over blocks; kernel 8's holds x8 and sx, and
    the partial sums where it splits K."""
    import ctypes

    from ganq_tpu_torch.ops import cuda_lib

    return tuple(cuda_lib.function("w8_matmul", sym, [ctypes.c_int] * 4)(
        B, M, Kp, x_bf16) for sym in ("ganq_w8_matmul_scratch",
                                      "ganq_w8a8_matmul_scratch"))


# (K, K'): K' = 14336 is Llama-3.1-8B's down projection
_W8_KKP = [(1024, 1024), (1000, 1024), (72, 72), (8192, 8192),
           (14336, 14336)]
_W8_B = [1, 3, 8, 9, 33, 128, 512, 1023]
_W8_M = [8, 72, 136, 512]


@pytest.mark.parametrize("K,Kp", _W8_KKP)
@pytest.mark.parametrize("B", _W8_B)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", _W8_M)
def test_w8_matmul_matches_plain(gen, K, Kp, B, dtype, M):
    """Kernel 7: the weight rounded to x's type as the plain version rounds
    it, the sum within one ulp of the float64 sum; x zero-padded past K.
    bf16 x runs the decode path up to 8 rows (16 where it splits no K) and
    the tensor-core tile beyond (K split over blocks at M = 512, K' =
    8192); float32 x the GEMV
    up to 40 rows and the CUDA-core tile beyond; K' = 72 (no multiple of
    16) the GEMV."""
    w8, scale = _w8_problem(gen, M, Kp)
    if dtype == torch.bfloat16 and (M, Kp, B) == (512, 8192, 128):
        assert _w8_scratch(B, M, Kp, 1)[0] > 0
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


@pytest.mark.parametrize("kernel", ["w8", "w8a8"])
def test_w8_decode_splits_long_rows(gen, kernel):
    """At 8 token rows the decode path splits K over blocks where the staged
    x would not fit beside the weight rings (K' = 28672, Llama-3.1-70B's
    down: kernel 7's bf16 slice and kernel 8's int8 one) and adds the
    partial sums in a second launch."""
    B, M, K = 8, 72, 28672
    w8, scale = _w8_problem(gen, M, K)
    x = torch.randn((B, K), generator=gen, device="cuda").to(torch.bfloat16)
    scratch = _w8_scratch(B, M, K, 1)
    if kernel == "w8":
        assert scratch[0] > 0
        got = w8_matmul(x, w8, scale)
        _assert_within_ulp(got, x.double() @ (w8.float() * scale).to(
            torch.bfloat16).double().T)
    else:
        assert scratch[1] > B * K + 4 * B   # x8, sx and the partial sums
        torch.testing.assert_close(w8a8_matmul(x, w8, scale),
                                   w8a8_reference(x, w8, scale), rtol=0,
                                   atol=0)


@pytest.mark.parametrize("K,Kp,M", [
    (K, Kp, M) for K, Kp in _W8_KKP for M in _W8_M
    if Kp % 128 == 0 or M <= 8] + [(2048, 2048, 136)])
@pytest.mark.parametrize("B", _W8_B)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_matmul_matches_plain(gen, K, Kp, M, B, dtype):
    """Kernel 8 equals its plain version bit for bit: the same int8
    activations (sx as XLA forms it, an IEEE quotient, ties to even), an
    exact integer dot on both sides (split over blocks or not), and the
    same two float products in the same order. K' = 72 passes the gate at
    M <= 8 only (the GEMV)."""
    w8, scale = _w8_problem(gen, M, Kp)
    x_bf16 = int(dtype == torch.bfloat16)
    if (B, M, Kp) == (128, 512, 8192):   # x8, sx and K-split partial sums
        assert _w8_scratch(B, M, Kp, x_bf16)[1] > B * Kp + 2 * B * M * 4
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
from ganq_tpu_torch.ops.uniform_matmul import INV127, row_scale
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


def _rows_where_quotient_differs(gen, n, K):
    """n float32 rows of K N(0, 1) values whose max|x| / 127 (the IEEE
    quotient) differs in the last bit from max|x| * fl(1/127), the scale
    every quantization point forms."""
    rows = []
    while sum(len(r) for r in rows) < n:
        x = torch.randn((256, K), generator=gen, device="cuda")
        m = x.abs().amax(dim=1, keepdim=True)
        differ = (m / torch.full_like(m, 127.0)) != row_scale(m)
        rows.append(x[differ[:, 0]])
    return torch.cat(rows)[:n].contiguous()


def _capture_launch(monkeypatch):
    """The tensors of the next W8A8Args launches, by field name."""
    from ganq_tpu_torch.ops import w8a8_args

    seen = []
    real = w8a8_args.launch

    def spy(library, symbol, what, tensors, device, **scalars):
        seen.append(tensors)
        return real(library, symbol, what, tensors, device, **scalars)

    monkeypatch.setattr(w8a8_args, "launch", spy)
    return seen


@pytest.mark.parametrize("point", ["k6", "k8", "k9-15 rows", "k9-15 tiles",
                                   "k11-14 attention out"])
def test_quantization_points_form_the_product(gen, monkeypatch, point):
    """Every CUDA int8-activation point forms its scale as jitted JAX does,
    max|x| * fl(1/127) (a8_quant.cuh sx_of / sa_of), on rows where the IEEE
    quotient differs from it, and codes from an IEEE quotient. Kernel 6 and
    8's quantization launch (a8_quant.cuh), the x rows of kernels 9-15
    (row_norm_quant, seen through kernel 10's sx), their activation tiles
    (tile_scale, through kernel 9's codes) and the attention outputs of
    kernels 11-14 (sa_of, through kernel 11's residual)."""
    if point in ("k6", "k8", "k9-15 rows"):
        K = 1024
        x = _rows_where_quotient_differs(gen, 16, K)
        want = row_scale(x.abs().amax(dim=1, keepdim=True))[:, 0]
        B = x.shape[0]
        if point == "k6":
            import ctypes

            from ganq_tpu_torch.ops import cuda_lib

            packed, scales, zeros, _ = _uniform_problem(gen, 4, 64, K, 8,
                                                        False, False)
            x8 = torch.empty((B, K), dtype=torch.int8, device="cuda")
            sx = torch.empty((B,), dtype=torch.float32, device="cuda")
            sumx = torch.empty((B, 8), dtype=torch.int32, device="cuda")
            out = torch.empty((B, 64), dtype=torch.float32, device="cuda")
            part = torch.empty(1 << 20, dtype=torch.float32, device="cuda")
            fn = cuda_lib.function(
                "uniform_matmul", "ganq_uniform_a8_matmul",
                [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
            cuda_lib.check(fn(
                x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                zeros.data_ptr(), x8.data_ptr(), sx.data_ptr(),
                sumx.data_ptr(), out.data_ptr(), part.data_ptr(), B, 64,
                packed.shape[1], 8, 4, 0,
                torch.cuda.current_stream().cuda_stream), "k6")
        elif point == "k8":
            import ctypes

            from ganq_tpu_torch.ops import cuda_lib

            w8, scale = _w8_problem(gen, 64, K)
            scratch = torch.empty(_w8_scratch(B, 64, K, 0)[1],
                                  dtype=torch.uint8, device="cuda")
            out = torch.empty((B, 64), dtype=torch.float32, device="cuda")
            fn = cuda_lib.function(
                "w8_matmul", "ganq_w8a8_matmul",
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
            cuda_lib.check(fn(
                x.data_ptr(), w8.data_ptr(), scale.data_ptr(),
                scratch.data_ptr(), out.data_ptr(), B, 64, K, 0,
                torch.cuda.current_stream().cuda_stream), "k8")
            x8 = scratch[:B * K].view(torch.int8).reshape(B, K)
            off = -(-B * K // 16) * 16
            sx = scratch[off:off + 4 * B].view(torch.float32)
        else:
            seen = _capture_launch(monkeypatch)
            w, s = _w8(gen, 512, K)
            fused_qkv_rope_w8a8(x, None, w, s, None, None, None, 256, 128,
                                128, 0, fold_norm=False)
            x8, sx = seen[-1]["x8"], seen[-1]["sx"]
        torch.cuda.synchronize()
        assert torch.equal(sx, want), point
        codes = torch.clamp(torch.round(x / want[:, None]), -127, 127)
        assert torch.equal(x8.float(), codes), point
    elif point == "k9-15 tiles":
        seen = _capture_launch(monkeypatch)
        H, I, B = 256, 1536, 64
        gu, gs = _w8(gen, 2 * I, H)
        dn, ds = _w8(gen, H, I)
        x = torch.randn((B, H), generator=gen, device="cuda")
        fused_mlp_w8a8(x, gu, gs, dn, ds)
        t = seen[-1]
        torch.cuda.synchronize()
        ng = t["amax"].shape[1]
        m = t["amax"].view(torch.float32).repeat_interleave(I // ng, dim=1)
        sa = row_scale(m)
        assert bool(((m / torch.full_like(m, 127.0)) != sa).any())
        codes = torch.clamp(torch.round(t["act_a"] / sa), -127, 127)
        assert torch.equal(t["a8"].float(), codes)
    else:
        seen = _capture_launch(monkeypatch)
        differ = 0
        for pos in range(12):
            args = _attn_problem(gen, 8, 512, 128, 256, 64, pos + 1)
            x = args[0].float()
            y, _, _ = attn_half_decode_w8a8(
                x, *args[1:], pos + 1, q_dim=512, kv_dim=128, head_dim=128,
                rotary_dim=128, scale=1.0 / math.sqrt(128))
            t = seen[-1]
            torch.cuda.synchronize()
            m = torch.clamp(t["attn_amax"].reshape(8, 1).amax(dim=1,
                                                               keepdim=True),
                            min=1e-12)
            sa = m * torch.full_like(m, INV127)
            differ += int(((m / torch.full_like(m, 127.0)) != sa).sum())
            want = x + (t["o32"].float() * sa) * t["o_t_scale"].reshape(1, -1)
            assert torch.equal(y, want)
        assert differ > 0


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


@pytest.mark.parametrize("kernel", ["w4p", "w8p", "k13"])
@pytest.mark.parametrize("B", [1, 9, 16])
@pytest.mark.parametrize("pos0", [0, 1, 127, 128, 129, 300])
def test_megastep_attention_block_edges(gen, kernel, B, pos0):
    """Kernels 14 ("w4p", "w8p") and 13 where the attention's flash blocks
    (Tb = 128 over a 512-key cache) split: histories of 0, 1, Tb - 1, Tb
    and Tb + 1 keys and one that ends inside its third block (300), slot b
    at pos0 + b, so a batch crosses the edges too; B = 9 and 16 are the
    first batches of two token groups (kernel 13, which takes 8 at most,
    runs 8). Against the plain version at the tolerance of
    test_megastep_lowbit_matches_plain; cache rows at and past each slot's
    position hold values that would show if read."""
    L, H, q_dim, kv_dim, I = _GROUPED_SHAPES[0]
    k13 = kernel == "k13"
    B = min(B, 8) if k13 else B
    bits = 8 if kernel == "w8p" else 4
    mp = _grouped_pack(gen, L, H, q_dim, kv_dim, I, bits, k13)
    pos = [pos0 + b for b in range(B)]
    x, kc, vc = _grouped_step(gen, L, H, kv_dim, B, 512, pos)
    cos, sin = _rope(gen, 128)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=128, rotary_dim=128,
              scale=1.0 / math.sqrt(128))
    if not k13:
        kw["bits"] = bits
    kernel_fn = megastep4_decode if k13 else megastep_lowbit_decode
    plain_fn = megastep4_plain if k13 else megastep_lowbit_plain
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    y, kn, vn = kernel_fn(x, mp, kc, vc, pos_t, cos, sin, **kw)
    py, pk, pv = plain_fn(x, mp, kc, vc, pos, cos, sin, **kw)
    torch.cuda.synchronize()
    what = f"{kernel} B={B} pos={pos0}"
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


def _lm_operands(gen, V, H):
    """Random operands of kernel 14's fold (``mega_lm_operands``' layout):
    int8 lm_head rows, float32 row scales in [1e-4, 4e-4) as vocabulary
    tiles, final norm weights in [0.5, 1.5)."""
    w8, scale = _w8(gen, V, H)
    tv = next(c for c in (4096, 2048, 1024, 512, 256, 128) if V % c == 0)
    return {"w8": w8, "scale": scale.reshape(V // tv, tv),
            "norm": _norm_w(gen, H)}


@pytest.mark.parametrize("L,H,q_dim,kv_dim,I", _GROUPED_SHAPES)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B", [1, 9, 64])
@pytest.mark.parametrize("V,zp_ao", [(384, False), (32000, False),
                                     (384, True)])
def test_megastep_lowbit_lm_fold_matches_plain(gen, L, H, q_dim, kv_dim, I,
                                               bits, B, V, zp_ao):
    """Kernel 14 with the trailing-unembed fold (``zp_ao``: on a pack with
    zero points and act-order, ``megastep_lowbit_lm_opt.cu``): y, k and v
    equal the same launch's without the fold bit for bit; the vocab phase equals its plain
    version on the kernel's own int8 rows exactly (max_abs_err 0: an exact
    integer dot, then two float32 products); those rows are the plain
    version's of the kernel's float32 residual but for codes at a rounding
    tie (the block sum's order against torch's mean: at most one code, on
    at most 1% of them; sx within 4 float32 ulps, rsqrtf rounding within
    2); so the logits are within 5e-3 of the largest of the plain fold of
    the kernel's own residual (a code flipped at a tie moves a logit by at
    most 127 sx scale). The layers against the plain step:
    ``test_megastep_lowbit_matches_plain``."""
    from ganq_tpu_torch.ops.fused_attention import rms_rows
    from ganq_tpu_torch.ops.megastep_lowbit import (lm_fold_plain,
                                                    lm_vocab_plain)
    from ganq_tpu_torch.ops.uniform_matmul import quantize_rows

    mp = _zp_ao_operands(gen, _grouped_pack(gen, L, H, q_dim, kv_dim, I,
                                            bits, False),
                         L, H, q_dim, bits, zp_ao, zp_ao)
    lm = _lm_operands(gen, V, H)
    T, pos0 = 64, 50
    pos = [(pos0 + 7 * b) % (T - 1) for b in range(B)]
    x, kc, vc = _grouped_step(gen, L, H, kv_dim, B, T, pos)
    cos, sin = _rope(gen, 128)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=128, rotary_dim=128,
              scale=1.0 / math.sqrt(128), bits=bits)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    rows = {}
    before = megastep_lowbit_decode.launches
    y, kn, vn, lg = megastep_lowbit_decode(x.float(), mp, kc, vc, pos_t, cos,
                                           sin, lm=lm, fold_rows=rows, **kw)
    assert megastep_lowbit_decode.launches == before + 1
    y0, kn0, vn0 = megastep_lowbit_decode(x.float(), mp, kc, vc, pos_t, cos,
                                          sin, **kw)
    torch.cuda.synchronize()
    what = f"lm fold bits={bits} H={H} B={B} V={V} zp_ao={zp_ao}"
    assert lg.shape == (B, V) and lg.dtype == torch.float32
    for g, w in ((y, y0), (kn, kn0), (vn, vn0)):
        assert torch.equal(g, w), what
    assert torch.equal(lg, lm_vocab_plain(rows["x8"], rows["sx"], lm)), what
    x8p, sxp = quantize_rows(rms_rows(y, lm["norm"], 1e-5))
    dx = (rows["x8"].float() - x8p).abs()
    assert float(dx.max()) <= 1 and float(dx.mean()) <= 1e-2, what
    torch.testing.assert_close(rows["sx"], sxp[:, 0], rtol=4.8e-7, atol=0)
    _close(lg, lm_fold_plain(y, lm, 1e-5), 5e-3, what + " logits")


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


# --------------------------------------------- kernel 14's EoRA epilogue
from chip_smoke import _lora_operands


@pytest.mark.parametrize("L,H,q_dim,kv_dim,I", _GROUPED_SHAPES)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B", [1, 9, 64])
@pytest.mark.parametrize("zp,ao,V", [(False, False, 0), (True, True, 0),
                                     (False, False, 384),
                                     (True, True, 384)])
def test_megastep_lowbit_lora_matches_plain(gen, L, H, q_dim, kv_dim, I,
                                            bits, B, zp, ao, V):
    """Kernel 14 with the EoRA epilogue (``megastep_lowbit_lora*.cu``),
    with and without zero points and act-order and the lm fold (``V``),
    against its plain version. Layer 0's k and v see only the q epilogue
    on exact int8 products: within one bf16 ulp plus 1e-3 of the largest.
    Everything else within one bf16 ulp plus 1e-2 of the largest, the
    zero-point cases' bound: the rank-r dots sum in another order than
    torch's, so a later int8 activation at a rounding tie may flip by one
    code (``test_megastep_lowbit_zero_points_actorder_match_plain``). The
    adapters move y and layer 0's k by more than twice that."""
    from ganq_tpu_torch.ops.megastep_lowbit import _LORA_KEYS, lm_fold_plain

    mp = _zp_ao_operands(gen, _grouped_pack(gen, L, H, q_dim, kv_dim, I,
                                            bits, False),
                         L, H, q_dim, bits, zp, ao)
    mp = _lora_operands(gen, mp, L, H, q_dim, kv_dim, I, 16)
    lm = _lm_operands(gen, V, H) if V else None
    T, pos0 = 64, 50
    pos = [(pos0 + 7 * b) % (T - 1) for b in range(B)]
    x, kc, vc = _grouped_step(gen, L, H, kv_dim, B, T, pos)
    cos, sin = _rope(gen, 128)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=128, rotary_dim=128,
              scale=1.0 / math.sqrt(128), bits=bits)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    before = megastep_lowbit_decode.launches
    got = megastep_lowbit_decode(x.float(), mp, kc, vc, pos_t, cos, sin,
                                 lm=lm, **kw)
    assert megastep_lowbit_decode.launches == before + 1
    py, pk, pv = megastep_lowbit_plain(x.float(), mp, kc, vc, pos, cos, sin,
                                       **kw)
    bare = megastep_lowbit_decode(
        x.float(), {k: v for k, v in mp.items() if k not in _LORA_KEYS}, kc,
        vc, pos_t, cos, sin, **kw)
    torch.cuda.synchronize()
    what = f"megastep_lowbit lora zp={zp} ao={ao} bits={bits} H={H} B={B}"
    _close(got[1][0], pk[0], 1e-3, what + " layer 0 k_new")
    _close(got[2][0], pv[0], 1e-3, what + " layer 0 v_new")
    _close(got[1], pk, 1e-2, what + " k_new")
    _close(got[2], pv, 1e-2, what + " v_new")
    _close(got[0], py, 1e-2, what + " y")
    for g, p, n in ((bare[0], py, "y"), (bare[1][0], pk[0], "layer 0 k")):
        moved = float((g.float() - p.float()).abs().max())
        assert moved > 2e-2 * float(p.float().abs().max()), f"{what} {n}"
    if V:
        _close(got[3], lm_fold_plain(got[0], lm, 1e-5), 5e-3,
               what + " logits")


def test_megastep_lowbit_lora_refuses_a_partial_launch(gen):
    """A LORA launch without every EoRA operand, and a launch of the
    kernels without the epilogue with one, are cudaErrorInvalidValue."""
    from ganq_tpu_torch.ops import megastep_lowbit as mlb
    from ganq_tpu_torch.ops import w8a8_args

    L, H, q_dim, kv_dim, I = _GROUPED_SHAPES[0]
    mp = _lora_operands(gen, _grouped_pack(gen, L, H, q_dim, kv_dim, I, 4,
                                           False),
                        L, H, q_dim, kv_dim, I, 8)
    x, kc, vc = _grouped_step(gen, L, H, kv_dim, 1, 64, [5])
    cos, sin = _rope(gen, 128)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=128, rotary_dim=128,
              scale=1.0 / math.sqrt(128), bits=4)
    captured = {}

    def capture(library, symbol, what, tensors, device, **scalars):
        captured.update(tensors=tensors, device=device, scalars=scalars)

    real = w8a8_args.launch
    w8a8_args.launch = capture
    try:
        mlb.megastep_lowbit_decode(x, mp, kc, vc, 5, cos, sin, **kw)
    finally:
        w8a8_args.launch = real
    t, dev, sc = captured["tensors"], captured["device"], captured["scalars"]
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        real("megastep_lowbit_lora", "ganq_megastep_lowbit_lora", "k14",
             dict(t, lb_d=None), dev, **sc)
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        real("megastep_lowbit", "ganq_megastep_lowbit", "k14", t, dev, **sc)
    real("megastep_lowbit_lora", "ganq_megastep_lowbit_lora", "k14", t, dev,
         **sc)
    torch.cuda.synchronize()


@pytest.mark.parametrize("B", [1, 9])
def test_megastep_lowbit_lora_rank_not_a_multiple_of_8(gen, B):
    """A rank that is no multiple of 8 (12): the B products read their rows
    element by element; against the plain version as
    ``test_megastep_lowbit_lora_matches_plain``."""
    L, H, q_dim, kv_dim, I = _GROUPED_SHAPES[0]
    mp = _lora_operands(gen, _grouped_pack(gen, L, H, q_dim, kv_dim, I, 4,
                                           False), L, H, q_dim, kv_dim, I, 12)
    T, pos0 = 64, 50
    pos = [(pos0 + 7 * b) % (T - 1) for b in range(B)]
    x, kc, vc = _grouped_step(gen, L, H, kv_dim, B, T, pos)
    cos, sin = _rope(gen, 128)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=128, rotary_dim=128,
              scale=1.0 / math.sqrt(128), bits=4)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    got = megastep_lowbit_decode(x.float(), mp, kc, vc, pos_t, cos, sin, **kw)
    py, pk, pv = megastep_lowbit_plain(x.float(), mp, kc, vc, pos, cos, sin,
                                       **kw)
    torch.cuda.synchronize()
    what = f"megastep_lowbit lora r=12 B={B}"
    _close(got[1][0], pk[0], 1e-3, what + " layer 0 k_new")
    _close(got[1], pk, 1e-2, what + " k_new")
    _close(got[2], pv, 1e-2, what + " v_new")
    _close(got[0], py, 1e-2, what + " y")


# ------------------------------- kernel 14's qk-norm and bias operands
from chip_smoke import _arch_operands


@pytest.mark.parametrize("L,H,q_dim,kv_dim,I", _GROUPED_SHAPES)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B", [1, 9, 64])
@pytest.mark.parametrize("qkn,bias,zpao,r,V", [
    (True, False, False, 0, 0), (False, True, False, 0, 0),
    (True, True, True, 0, 0), (True, False, False, 16, 384),
    (False, True, True, 16, 384)])
def test_megastep_lowbit_arch_matches_plain(gen, L, H, q_dim, kv_dim, I,
                                            bits, B, qkn, bias, zpao, r, V):
    """Kernel 14 with qwen3's qk-norm rows and the o/gate-up/down biases
    (``megastep_lowbit_arch*.cu``), alone and with zero points, act-order,
    the EoRA epilogue (rank ``r``) and the lm fold (``V``), against its
    plain version: within one bf16 ulp plus 1e-2 of the largest, the bound
    of the cases with zero points (an int8 activation at a rounding tie may
    flip by one code: the norm's rsqrt and sums are rounded in another
    order than torch's). The biases move y, and the qk-norm layer 0's k,
    by more than twice that (the qk-norm alone moves y less: the random
    layers' o scales are a tenth of the others')."""
    from ganq_tpu_torch.ops.megastep_lowbit import _ARCH_KEYS, lm_fold_plain

    mp = _zp_ao_operands(gen, _grouped_pack(gen, L, H, q_dim, kv_dim, I,
                                            bits, False),
                         L, H, q_dim, bits, zpao, zpao)
    if r:
        mp = _lora_operands(gen, mp, L, H, q_dim, kv_dim, I, r)
    mp = _arch_operands(gen, mp, L, H, q_dim, kv_dim, I, qkn, bias)
    lm = _lm_operands(gen, V, H) if V else None
    T, pos0 = 64, 50
    pos = [(pos0 + 7 * b) % (T - 1) for b in range(B)]
    x, kc, vc = _grouped_step(gen, L, H, kv_dim, B, T, pos)
    cos, sin = _rope(gen, 128)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=128, rotary_dim=128,
              scale=1.0 / math.sqrt(128), bits=bits)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    before = megastep_lowbit_decode.launches
    got = megastep_lowbit_decode(x.float(), mp, kc, vc, pos_t, cos, sin,
                                 lm=lm, **kw)
    assert megastep_lowbit_decode.launches == before + 1
    py, pk, pv = megastep_lowbit_plain(x.float(), mp, kc, vc, pos, cos, sin,
                                       **kw)
    bare = megastep_lowbit_decode(
        x.float(), {k: v for k, v in mp.items() if k not in _ARCH_KEYS}, kc,
        vc, pos_t, cos, sin, **kw)
    torch.cuda.synchronize()
    what = (f"megastep_lowbit arch qkn={qkn} bias={bias} zp/ao={zpao} r={r} "
            f"bits={bits} H={H} B={B}")
    _close(got[1], pk, 1e-2, what + " k_new")
    _close(got[2], pv, 1e-2, what + " v_new")
    _close(got[0], py, 1e-2, what + " y")
    for g, p, n in (((bare[0], py, "y"),) if bias else ()) + (
            ((bare[1][0], pk[0], "layer 0 k"),) if qkn else ()):
        moved = float((g.float() - p.float()).abs().max())
        assert moved > 2e-2 * float(p.float().abs().max()), f"{what} {n}"
    if V:
        _close(got[3], lm_fold_plain(got[0], lm, 1e-5), 5e-3,
               what + " logits")


@pytest.mark.parametrize("rd,inter", [(128, True), (64, False), (64, True),
                                      (0, False)])
def test_megastep_lowbit_qk_norm_rope_layouts(gen, rd, inter):
    """The qk-norm pass ropes each head itself: interleaved pairs, a
    partial rotary width and no rope, against the plain version (bounds
    as ``test_megastep_lowbit_arch_matches_plain``)."""
    L, H, q_dim, kv_dim, I = _GROUPED_SHAPES[0]
    mp = _arch_operands(gen, _grouped_pack(gen, L, H, q_dim, kv_dim, I, 8,
                                           False),
                        L, H, q_dim, kv_dim, I, True, False)
    pos = [50, 9]
    x, kc, vc = _grouped_step(gen, L, H, kv_dim, 2, 64, pos)
    cos, sin = _rope(gen, 128)
    half = rd // 2
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=128, rotary_dim=rd,
              interleaved=inter, scale=1.0 / math.sqrt(128), bits=8)
    c, s = (cos[:half], sin[:half]) if rd else (None, None)
    got = megastep_lowbit_decode(x.float(), mp, kc, vc,
                                 torch.tensor(pos, dtype=torch.int32,
                                              device="cuda"), c, s, **kw)
    py, pk, pv = megastep_lowbit_plain(x.float(), mp, kc, vc, pos, c, s,
                                       **kw)
    torch.cuda.synchronize()
    what = f"qk-norm rope rd={rd} interleaved={inter}"
    _close(got[1], pk, 1e-2, what + " k_new")
    _close(got[2], pv, 1e-2, what + " v_new")
    _close(got[0], py, 1e-2, what + " y")


def test_megastep_lowbit_arch_refuses_a_partial_launch(gen):
    """An ARCH launch with one bias of three, or with the qk-norm rows but
    no scratch, and a launch of the kernels without the ARCH operands with
    one of them, are cudaErrorInvalidValue."""
    from ganq_tpu_torch.ops import megastep_lowbit as mlb
    from ganq_tpu_torch.ops import w8a8_args

    L, H, q_dim, kv_dim, I = _GROUPED_SHAPES[0]
    mp = _arch_operands(gen, _grouped_pack(gen, L, H, q_dim, kv_dim, I, 4,
                                           False),
                        L, H, q_dim, kv_dim, I, True, True)
    x, kc, vc = _grouped_step(gen, L, H, kv_dim, 1, 64, [5])
    cos, sin = _rope(gen, 128)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=128, rotary_dim=128,
              scale=1.0 / math.sqrt(128), bits=4)
    captured = {}

    def capture(library, symbol, what, tensors, device, **scalars):
        captured.update(tensors=tensors, device=device, scalars=scalars)

    real = w8a8_args.launch
    w8a8_args.launch = capture
    try:
        mlb.megastep_lowbit_decode(x, mp, kc, vc, 5, cos, sin, **kw)
    finally:
        w8a8_args.launch = real
    t, dev, sc = captured["tensors"], captured["device"], captured["scalars"]
    for broken in (dict(t, gu_bias=None), dict(t, qkv_f=None)):
        with pytest.raises(RuntimeError, match="CUDA error 1 "):
            real("megastep_lowbit_arch", "ganq_megastep_lowbit_arch", "k14",
                 broken, dev, **sc)
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        real("megastep_lowbit", "ganq_megastep_lowbit", "k14", t, dev, **sc)
    real("megastep_lowbit_arch", "ganq_megastep_lowbit_arch", "k14", t, dev,
         **sc)
    torch.cuda.synchronize()


# ------------------------------------------------ kernel 14's gemma operands
from chip_smoke import _gemma_operands


def _gemma_cfg(family, L, H, q_dim, kv_dim, I, window):
    """A Gemma 2 (softcap 5, alternate windows) or Gemma 3 (dual rope, q/k
    norms) config at a grouped test shape, a sliding then a full layer."""
    import dataclasses

    from ganq_tpu_torch.models import synthetic

    base = (synthetic.gemma2_27b_config(L) if family == "g2" else
            synthetic.gemma3_27b_config(L, layer_types=[
                "sliding_attention", "full_attention"] * (L // 2)))
    return dataclasses.replace(
        base, hidden_size=H, intermediate_size=I,
        num_attention_heads=q_dim // 128, num_key_value_heads=kv_dim // 128,
        sliding_window=window,
        attn_softcap=5.0 if family == "g2" else None)


@pytest.mark.parametrize("L,H,q_dim,kv_dim,I", _GROUPED_SHAPES)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B", [1, 9, 64])
@pytest.mark.parametrize("family,zpao,r,V", [
    ("g2", False, 0, 0), ("g3", False, 0, 0), ("g3", True, 16, 384),
    ("g2", True, 0, 384)])
def test_megastep_lowbit_gemma_matches_plain(gen, L, H, q_dim, kv_dim, I,
                                             bits, B, family, zpao, r, V):
    """Kernel 14 with gemma's operands (``megastep_lowbit_gemma.cu``):
    sandwich norms, a window of 24 on the first layer (the slots sit at
    positions up to 63), Gemma 2's softcap or Gemma 3's dual rope and q/k
    norms, gelu-tanh and rms_offset 1, alone and with zero points,
    act-order, the EoRA epilogue (rank ``r``, a runtime flag there) and the
    lm fold (``V``), against its plain version within one bf16 ulp plus
    3.5e-2 of the largest (``ganq_tpu``'s range-relative bound of its gemma
    tests: rms_offset 1 norms and gelu-tanh amplify a flipped int8 code).
    Without the windows the step moves by more than that."""
    from ganq_tpu_torch.ops.megastep_lowbit import lm_fold_plain

    cfg = _gemma_cfg(family, L, H, q_dim, kv_dim, I, 24)
    mp = _zp_ao_operands(gen, _grouped_pack(gen, L, H, q_dim, kv_dim, I,
                                            bits, False),
                         L, H, q_dim, bits, zpao, zpao)
    if r:
        mp = _lora_operands(gen, mp, L, H, q_dim, kv_dim, I, r)
    gkw = _gemma_operands(gen, mp, cfg, L)
    T = 64
    gkw["windows"] = torch.tensor([cfg.layer_window(i) or T
                                   for i in range(L)], dtype=torch.int32,
                                  device="cuda")
    lm = _lm_operands(gen, V, H) if V else None
    pos = [(50 + 7 * b) % (T - 1) for b in range(B)]
    x, kc, vc = _grouped_step(gen, L, H, kv_dim, B, T, pos)
    cos, sin = _rope(gen, 128)
    if "rope_sel" in gkw:
        lc, ls = _rope(gen, 128)
        cos = torch.stack([cos.expand(B, 64), lc.expand(B, 64)])
        sin = torch.stack([sin.expand(B, 64), ls.expand(B, 64)])
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=128, rotary_dim=128,
              scale=cfg.attn_scale, bits=bits, rms_offset=1.0,
              act="gelu_tanh", eps=1e-6)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    before = megastep_lowbit_decode.launches
    got = megastep_lowbit_decode(x.float(), mp, kc, vc, pos_t, cos, sin,
                                 lm=lm, **kw, **gkw)
    assert megastep_lowbit_decode.launches == before + 1
    py, pk, pv = megastep_lowbit_plain(x.float(), mp, kc, vc, pos, cos, sin,
                                       **kw, **gkw)
    full = megastep_lowbit_decode(
        x.float(), mp, kc, vc, pos_t, cos, sin, **kw,
        **{k: v for k, v in gkw.items() if k != "windows"})
    torch.cuda.synchronize()
    what = (f"megastep_lowbit gemma {family} zp/ao={zpao} r={r} V={V} "
            f"bits={bits} H={H} B={B}")
    _close(got[1], pk, 3.5e-2, what + " k_new")
    _close(got[2], pv, 3.5e-2, what + " v_new")
    _close(got[0], py, 3.5e-2, what + " y")
    if max(pos) >= 24:
        moved = float((full[0].float() - py.float()).abs().max())
        assert moved > 3.5e-2 * float(py.float().abs().max()), what
    if V:
        _close(got[3], lm_fold_plain(got[0], lm, 1e-6, 1.0), 5e-3,
               what + " logits")


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B", [1, 9])
def test_megastep_lowbit_gemma_window_inside_a_block(gen, bits, B):
    """A sliding window of 100 at positions 300 + 7 b over a 512-key cache
    (Tb = 128): the first key read, 201 + 7 b, lies inside a flash block,
    which the kernel's first item reads from there to the block's end, so
    that the later blocks and their running maxima are those of a walk from
    key 0 (the plain version's); Gemma 2's softcap on, at the gemma test's
    tolerance."""
    L, H, q_dim, kv_dim, I = _GROUPED_SHAPES[0]
    T, window = 512, 100
    cfg = _gemma_cfg("g2", L, H, q_dim, kv_dim, I, window)
    mp = _grouped_pack(gen, L, H, q_dim, kv_dim, I, bits, False)
    gkw = _gemma_operands(gen, mp, cfg, L)
    gkw["windows"] = torch.tensor([cfg.layer_window(i) or T
                                   for i in range(L)], dtype=torch.int32,
                                  device="cuda")
    pos = [300 + 7 * b for b in range(B)]
    x, kc, vc = _grouped_step(gen, L, H, kv_dim, B, T, pos)
    cos, sin = _rope(gen, 128)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=128, rotary_dim=128,
              scale=cfg.attn_scale, bits=bits, rms_offset=1.0,
              act="gelu_tanh", eps=1e-6)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    got = megastep_lowbit_decode(x.float(), mp, kc, vc, pos_t, cos, sin,
                                 **kw, **gkw)
    py, pk, pv = megastep_lowbit_plain(x.float(), mp, kc, vc, pos, cos, sin,
                                       **kw, **gkw)
    torch.cuda.synchronize()
    what = f"megastep_lowbit gemma window bits={bits} B={B}"
    _close(got[1], pk, 3.5e-2, what + " k_new")
    _close(got[2], pv, 3.5e-2, what + " v_new")
    _close(got[0], py, 3.5e-2, what + " y")


def test_megastep_lowbit_gemma_refuses_a_partial_launch(gen):
    """The GEMMA source refuses one sandwich norm without the other, and
    the other kernel-14 sources refuse every gemma operand (a call the
    wrapper would never make)."""
    from ganq_tpu_torch.ops import w8a8_args

    L, H, q_dim, kv_dim, I = _GROUPED_SHAPES[0]
    cfg = _gemma_cfg("g2", L, H, q_dim, kv_dim, I, 24)
    mp = _grouped_pack(gen, L, H, q_dim, kv_dim, I, 4, False)
    gkw = _gemma_operands(gen, mp, cfg, L)
    x, kc, vc = _grouped_step(gen, L, H, kv_dim, 1, 64, [40])
    cos, sin = _rope(gen, 128)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=128, rotary_dim=128,
              bits=4, **gkw)
    with pytest.raises(ValueError, match="pa_norm and pm_norm"):
        megastep_lowbit_decode(x.float(), {k: v for k, v in mp.items()
                                           if k != "pm_norm"}, kc, vc, 40,
                               cos, sin, **kw)
    real = w8a8_args.launch
    for lib in ("megastep_lowbit", "megastep_lowbit_arch"):
        def other(library, symbol, what, tensors, dev, **scalars):
            real(lib, f"ganq_{lib}", what, tensors, dev, **scalars)

        w8a8_args.launch = other
        try:
            with pytest.raises(RuntimeError):
                megastep_lowbit_decode(x.float(), mp, kc, vc, 40, cos, sin,
                                       **kw)
        finally:
            w8a8_args.launch = real


# -------------------------------------- kernel 14's "w3", "w2" and "wl8"
from chip_smoke import _grouped_pack as _smoke_pack

# 3-bit planes (8 row blocks of 128-lane fields) need hidden, q_dim and the
# tiles to be multiples of 1024: a small shape and Llama-3.2-3B's widths
_LOWBIT3_SHAPES = [(2, 1024, 1024, 512, 1024), (2, 3072, 3072, 1024, 8192)]


@pytest.mark.parametrize("L,H,q_dim,kv_dim,I", _LOWBIT3_SHAPES)
@pytest.mark.parametrize("variant", ["w3", "w2", "wl8"])
@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("ops", ["none", "zp_ao", "lm", "lora", "qkn_bias",
                                 "gemma", "all"])
def test_megastep_lowbit_w3_w2_wl8_match_plain(gen, L, H, q_dim, kv_dim, I,
                                               variant, B, ops):
    """Kernel 14's "w3"/"w2" (``megastep_lowbit_w3w2.cu``; with any optional
    operand ``megastep_lowbit_w3w2_ext.cu``) and "wl8"
    (``megastep_lowbit_walsh.cu``, the Walsh planes and coefficient rows)
    against their plain version, alone and with each operand family of
    ``ganq_tpu``'s gates at these bits: zero points with act-order (the
    uniform variants only: lut artifacts have none), the lm fold (V = 384),
    the EoRA epilogue (rank 16), qwen3's qk-norm rows with o/gate-up/down
    biases, gemma 2's sandwich norms, window (24) and softcap (gelu-tanh,
    rms_offset 1), and all of them together; within one bf16 ulp plus 1e-2
    of the largest (3.5e-2 with gemma's operands: ``ganq_tpu``'s gemma
    bound), the zero-point bound of the other kernel-14 cases. Each call is
    one launch of the source ``kernel_library`` names."""
    from ganq_tpu_torch.ops.megastep_lowbit import (kernel_library,
                                                    lm_fold_plain)

    walsh = 7 if variant == "wl8" else 0
    bits = 2 if variant == "w2" else 3
    if walsh and ops in ("zp_ao", "all"):
        pytest.skip("lut artifacts carry no zero points or act-order")
    zpao = ops in ("zp_ao", "all")
    mp = _zp_ao_operands(gen, _smoke_pack(gen, L, H, q_dim, kv_dim, I, bits,
                                          False, walsh=bool(walsh)),
                         L, H, q_dim, bits, zpao, zpao)
    if ops in ("lora", "all"):
        mp = _lora_operands(gen, mp, L, H, q_dim, kv_dim, I, 16)
    if ops in ("qkn_bias", "all"):
        mp = _arch_operands(gen, mp, L, H, q_dim, kv_dim, I, True, True)
    gemma = ops in ("gemma", "all")
    T = 64
    gkw, kw = {}, dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=128,
                       rotary_dim=128, scale=1.0 / math.sqrt(128), bits=bits,
                       walsh=walsh)
    if gemma:
        cfg = _gemma_cfg("g2", L, H, q_dim, kv_dim, I, 24)
        qk = mp.pop("qk_nm", None)
        gkw = _gemma_operands(gen, mp, cfg, L)
        if qk is not None:
            mp["qk_nm"] = qk
        gkw["windows"] = torch.tensor([cfg.layer_window(i) or T
                                       for i in range(L)], dtype=torch.int32,
                                      device="cuda")
        kw.update(scale=cfg.attn_scale, rms_offset=1.0, act="gelu_tanh",
                  eps=1e-6)
    lm = _lm_operands(gen, 384, H) if ops in ("lm", "all") else None
    pos = [(50 + 7 * b) % (T - 1) for b in range(B)]
    x, kc, vc = _grouped_step(gen, L, H, kv_dim, B, T, pos)
    cos, sin = _rope(gen, 128)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    before = dict(megastep_lowbit_decode.by_source)
    got = megastep_lowbit_decode(x.float(), mp, kc, vc, pos_t, cos, sin,
                                 lm=lm, **kw, **gkw)
    lib = kernel_library(mp, lm is not None, gemma, bits, walsh)
    assert lib == ("megastep_lowbit_walsh" if walsh else
                   "megastep_lowbit_w3w2" + ("" if ops == "none" else "_ext"))
    assert megastep_lowbit_decode.by_source[lib] == before.get(lib, 0) + 1
    py, pk, pv = megastep_lowbit_plain(x.float(), mp, kc, vc, pos, cos, sin,
                                       **kw, **gkw)
    torch.cuda.synchronize()
    rel = 3.5e-2 if gemma else 1e-2
    what = f"megastep_lowbit {variant} {ops} H={H} B={B}"
    _close(got[1], pk, rel, what + " k_new")
    _close(got[2], pv, rel, what + " v_new")
    _close(got[0], py, rel, what + " y")
    if lm is not None:
        _close(got[3], lm_fold_plain(got[0], lm, kw.get("eps", 1e-5),
                                     kw.get("rms_offset", 0.0)), 5e-3,
               what + " logits")
