"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped without a GPU. On a machine with one (and without
JAX, which the root conftest imports) run it as

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Shapes go beyond the serving path's: every bit width, f32 and bf16
activations, padded K, ragged batch tiles, GQA ratios 1/4/32, head dims 64
and 128, and positions at tile edges.
"""

import math

import pytest
import torch

from ganq_tpu_torch.ops.fused_attention import (
    flash_decode_attention, flash_decode_reference, flash_decode_split_bound,
    flash_decode_split_reference)
from ganq_tpu_torch.ops.lut_matmul import lut_matmul, lut_matmul_reference
from ganq_tpu_torch.ops.packing import pack_factor, pack_int_rows

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
