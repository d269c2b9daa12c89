#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ganq_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. environment: torch / CUDA versions and the card's name and power limit;
   no CUDA device is an error.
2. build: compile every kernel of the port from ganq_tpu_torch/csrc with
   nvcc (one process per source, all at once) into build/, and the exact
   k-means library with g++.
3. kernels: each kernel against its plain PyTorch version on the card, at the
   Llama-3.2-1B shapes its path gives it, with its time, the plain
   version's time, one PyTorch library call's time (or, for the S-step, a
   float32 matmul of the same operation count as a yardstick) and the least
   time the card could take (bytes over 3.35 TB/s, or operations over 989
   TFLOP/s in bf16, 1979 TOP/s in int8 and 67 TFLOP/s in float32). Kernels
   5-8 (uniform and int8 linears) run at batch 1, 8 and 512; their library
   yardstick is a bf16 matmul on the dequantized weight. Kernels 9-12 (the
   fused W8A8 MLP, norm + qkv + rope, attention half and whole decode step)
   run at the Llama-3.2-3B shapes, batch 1 and 8 (and 64 for 9 and 10);
   the group-scaled whole decode steps, kernel 14 ("w4p" and "w8p") at
   batch 1, 8 and 64 and kernel 13 at batch 1 and 8, over 28 Llama-3.2-3B
   layers.
4. serving path: a random-weight Llama-3.2-1B at its published widths, made
   a 4-bit GANQ ``lut`` model, saved with the port's checkpoint writer,
   loaded with ``GanqModel.load`` (default device: the card) and asked four
   requests through ``generate`` (the engine's stacked layout fuses q/k/v
   and gate/up rows); the kernels' launch counters must match the path's
   expected launches exactly.
5. reference check: one teacher-forced decode step through the "cuda" and
   the "reference" backends on the card; the logits must agree.
6. quantize path: a dense random-weight model at Llama-3.2-1B's published
   widths (depth ``QUANTIZE_LAYERS``) written as a safetensors
   directory, ``GanqModel.load(dir, qcfg)``, ``quantize`` on 16 random token
   rows of 512 (the README recipe, 5 GANQ iterations, exact k-means init),
   ``save``, ``GanqModel.load`` on the card and two ``generate`` requests.
   The blocked S-step kernel must have run once per module and iteration
   (plus each fallback pass), every module's loss and codebook must be
   finite, and the saved checkpoint must reproduce the fake-quantized
   weights and logits. The same path then runs at 2 layers with
   ``solver_backend="pallas"``, which must launch the per-column kernel
   instead.
7. GPTQ path: the same dense start at depth ``GPTQ_LAYERS``, quantized with
   ``QuantizeConfig()`` (GPTQ W4 g128, desc_act), saved in the GPTQ v1
   layout, loaded (auto backend "cuda_a8") and asked two requests: the
   permuted g_idx sends every linear to kernel 5. Then desc_act=False at 2
   layers, served by "cuda_a8" (kernel 6) and by "cuda" (kernel 5).
8. optimize() path: phase 4's checkpoint recoded by ``optimize("w8")``
   (on "cuda_a8" the stacked layout's fused W8A8 MLP, kernel 9, and kernel
   8 for qkv and o; kernel 7 under "cuda") and ``optimize()`` (uniform
   8-bit, kernel 6); then an
   affine-codebook ``lut`` model, which the engine certifies into uniform
   4-bit linears (kernel 5). Llama-3.2-1B's head_dim of 64 keeps every
   request of phases 7 and 8 off the JAX engine's whole-step megasteps.
9. stacked int8 path: a random 4-bit ``lut`` model at Llama-3.2-3B's
   published widths (28 layers, head_dim 128), saved, loaded,
   ``optimize("w8")``, and five requests on "cuda_a8" with the default
   layout: the whole-step megastep (kernel 12) at batch 1 and 8, the fused
   MLP (kernel 9) layer by layer at batch 16, the attention half (kernel 11)
   with ``GANQ_MEGASTEP=0 GANQ_FUSED_LAYER=1``, the fused qkv + rope (kernel
   10) with ``GANQ_FUSED_QKV=1``; decode ms per step against
   ``layout="perlayer"``. Then the same checkpoint's ``optimize()`` (the
   quick start's default: uniform 8-bit, 128-column groups) through kernel
   14's "w8p" variant at batch 1, 8, 16 and 64, and a symmetric uniform W4
   g128 model (saved as GPTQ v1, loaded) through "w4p" at batch 1 and 16
   and through kernel 13 (``GANQ_W4_PLANE=0``) at batch 1 and 8: one
   whole-step launch per decode step, decode ms per step against
   ``layout="perlayer"``.
Each run of phases 7-9 sets the launch counters to 0, must match its
expected launches exactly (``expected_launches``, the port's routing, which
is the JAX package's), and holds a teacher-forced decode step against the
reference backend.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12           # dense int8 tensor-core peak
F32_FLOPS_PER_S = 67e12            # float32 outside the tensor cores
QUANTIZE_LAYERS = 16               # depth of the quantize path (see PERF.md)
PALLAS_PATH_LAYERS = 2             # depth of its solver_backend="pallas" run
GPTQ_LAYERS = 16                   # depth of the GPTQ path (see PERF.md)
GPTQ_SIDE_LAYERS = 2               # depth of its desc_act=False runs
L2_FLUSH_BYTES = 100 * 2**20       # rotate inputs past the 50 MB L2
LLAMA_1B_LINEARS = {"q/o": (2048, 2048), "k/v": (512, 2048),
                    "gate/up": (8192, 2048), "down": (2048, 8192)}


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ helpers
def time_ms(fn, arg_sets, iters: int) -> float:
    """Mean device time of one call of fn: ``iters`` calls, cycling through
    ``arg_sets`` so inputs come cold from memory as they do in a decode
    step, are captured in one CUDA graph and the graph's replay is timed
    with CUDA events, so the host's launch cost does not hide in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the capture stream
        for i in range(3):
            fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int, cap: int = 256) -> int:
    return max(1, min(cap, math.ceil(L2_FLUSH_BYTES / max(nbytes, 1))))


def bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def event_ms(fn, args, iters: int) -> float:
    """Mean device time of one call of fn(*args) over ``iters`` calls, timed
    with CUDA events after a warm-up call (for calls of a millisecond and
    more, where the host's launches run ahead of the device)."""
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    mag = t.float().abs().clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


# ------------------------------------------------------------------ phases
def phase_environment() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    return smi


def phase_build() -> None:
    from ganq_tpu_torch.ops import cuda_lib

    from ganq_tpu_torch.ops import kmeans_exact

    t0 = time.time()
    logs = cuda_lib.build_all()
    log(f"build: {sorted(logs)} in {time.time() - t0:.1f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")
    t0 = time.time()
    kmeans_exact.build()
    log(f"build: exact k-means (g++) in {time.time() - t0:.1f} s")


def check_lut_matmul(gen) -> dict:
    from ganq_tpu_torch.ops.lut_matmul import lut_matmul, lut_matmul_reference
    from ganq_tpu_torch.ops.packing import pack_int_rows, unpack_int_rows

    bits = 4
    worst = 0.0
    rows = {}
    for label, (M, K) in LLAMA_1B_LINEARS.items():
        wbytes = M * K * bits // 8
        n = copies_for(wbytes)
        weights = []
        for _ in range(n):
            lut = torch.sort(torch.randn((M, 16), generator=gen, device="cuda")
                             * 0.006, dim=1).values.to(torch.bfloat16)
            idx = torch.randint(0, 16, (M, K), generator=gen, device="cuda",
                                dtype=torch.int32)
            weights.append((lut, pack_int_rows(idx, bits)))
        dense = [torch.take_along_dim(
            lut.float(), unpack_int_rows(p, bits, K).long(), dim=1
        ).to(torch.bfloat16) for lut, p in weights[:copies_for(2 * M * K)]]
        for B in (1, 8, 512):
            x = torch.randn((B, K), generator=gen, device="cuda").to(torch.bfloat16)
            lut, packed = weights[0]
            got = lut_matmul(x, lut, packed, bits)
            plain = lut_matmul_reference(x, lut, packed, bits)
            torch.cuda.synchronize()
            err = (got.float() - plain.float()).abs()
            tol = (torch.maximum(bf16_ulp(got), bf16_ulp(plain))
                   + 2e-5 * plain.float().abs().max())
            if not bool((err <= tol).all()):
                raise AssertionError(
                    f"lut_matmul {label} B={B}: max |kernel - plain| = "
                    f"{float(err.max()):.3e} exceeds one bf16 ulp")
            lib = torch.matmul(x, dense[0].T)
            if not torch.allclose(lib.float(), plain.float(), rtol=2e-2,
                                  atol=2e-2 * float(plain.float().abs().max())):
                raise AssertionError(f"library yardstick disagrees at {label}")
            iters = max(2 * n, 30)
            args = [(x, lu, p, bits) for lu, p in weights]
            k_ms = time_ms(lut_matmul, args, iters)
            p_ms = time_ms(lut_matmul_reference, args, max(len(args), 10))
            l_ms = time_ms(lambda xx, w: torch.matmul(xx, w.T),
                           [(x, w) for w in dense], iters)
            nbytes = B * K * 2 + M * 16 * 2 + wbytes + B * M * 2
            b_ms, b_by = bound(nbytes, 2.0 * B * M * K)
            worst = max(worst, float(err.max()))
            rows[(label, B)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                    bound_ms=b_ms, bound_by=b_by,
                                    max_abs_err=float(err.max()))
            log(f"lut_matmul bits=4 {label} M={M} K={K} B={B}: "
                f"max_abs_err={float(err.max()):.3e} (tol: 1 bf16 ulp + 2e-5 "
                f"of max|out|) kernel_ms={k_ms:.5f} plain_ms={p_ms:.5f} "
                f"library_ms={l_ms:.5f} bound_ms={b_ms:.5f} ({b_by}) "
                f"bound_share={b_ms / k_ms:.3f}")
        del weights, dense
    entry = dict(rows[("down", 1)])
    entry.update(name="lut_matmul", max_abs_err=worst,
                 shape="bits=4 M=2048 K=8192 B=1 (down projection, decode)")
    return entry


def check_flash_decode(gen) -> dict:
    import torch.nn.functional as F

    from ganq_tpu_torch.ops.fused_attention import (
        flash_decode_attention, flash_decode_reference,
        flash_decode_split_bound, flash_decode_split_reference)

    Hq, Hkv, d, T = 32, 8, 64, 2048
    scale = 1.0 / math.sqrt(d)
    worst = 0.0
    rows = {}
    for B in (1, 8):
        for pos in (0, 300, T - 1):
            n = copies_for(2 * B * (pos + 1) * Hkv * d * 2, cap=64)
            caches = [(torch.randn((B, T, Hkv, d), generator=gen, device="cuda")
                       .to(torch.bfloat16),
                       torch.randn((B, T, Hkv, d), generator=gen, device="cuda")
                       .to(torch.bfloat16)) for _ in range(n)]
            q = torch.randn((B, Hq, d), generator=gen, device="cuda").to(torch.bfloat16)
            pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
            k, v = caches[0]
            got = flash_decode_attention(q, k, v, pos_t, scale)
            split = flash_decode_split_reference(q, k, v, pos_t, scale)
            plain = flash_decode_reference(q, k, v, pos_t, scale)
            torch.cuda.synchronize()
            err = (got.float() - split.float()).abs()
            tol = flash_decode_split_bound(q, k, v, pos, scale, got, split)
            if not bool((err <= tol).all()):
                raise AssertionError(
                    f"flash_decode B={B} pos={pos}: |kernel - split version| "
                    f"= {float(err.max()):.3e} exceeds its bound by "
                    f"{float((err / tol).max()):.2f}x")
            err_plain = float((got.float() - plain.float()).abs().max())

            def library(qq, kk, vv):
                return F.scaled_dot_product_attention(
                    qq[:, :, None], kk[:, :pos + 1].transpose(1, 2),
                    vv[:, :pos + 1].transpose(1, 2), scale=scale,
                    enable_gqa=True)

            iters = max(2 * n, 30)
            args = [(q, kk, vv, pos_t, scale) for kk, vv in caches]
            k_ms = time_ms(flash_decode_attention, args, iters)
            p_ms = time_ms(flash_decode_reference, args, max(n, 10))
            l_ms = time_ms(library, [(q, kk, vv) for kk, vv in caches], iters)
            nbytes = 2 * B * Hq * d * 2 + 2 * B * (pos + 1) * Hkv * d * 2
            b_ms, b_by = bound(nbytes, 4.0 * B * Hq * (pos + 1) * d)
            worst = max(worst, float(err.max()))
            rows[(B, pos)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                  bound_ms=b_ms, bound_by=b_by,
                                  max_abs_err=float(err.max()))
            log(f"flash_decode B={B} Hq={Hq} Hkv={Hkv} d={d} T={T} pos={pos}: "
                f"max_abs_err={float(err.max()):.3e} against the split version "
                f"(tol: 1 bf16 ulp + 2^-7 max p|v| + 3e-5 sum p|v|, mean "
                f"{float(tol.mean()):.3e}, worst err/tol "
                f"{float((err / tol).max()):.2f}); {err_plain:.3e} against the "
                f"float32 softmax; kernel_ms={k_ms:.5f} plain_ms={p_ms:.5f} "
                f"library_ms={l_ms:.5f} bound_ms={b_ms:.5f} ({b_by}) "
                f"bound_share={b_ms / k_ms:.3f}")
            del caches
    entry = dict(rows[(1, T - 1)])
    entry.update(name="flash_decode", max_abs_err=worst,
                 shape="B=1 Hq=32 Hkv=8 d=64 T=2048 pos=2047")
    return entry


SSTEP_CASES = [(label, m, n, 16) for label, (m, n) in LLAMA_1B_LINEARS.items()] \
    + [("q/o", 2048, 2048, 8), ("q/o", 2048, 2048, 4), ("small", 256, 512, 256)]


def check_s_step(gen) -> list:
    """Kernels 3 and 4 against their plain versions at the Llama-3.2-1B
    shapes (V = 16), V = 8 and 4 on q/o and V = 256 on a small shape. W and
    sorted codebooks of std 0.02, H = X^T X / 2n from a seeded X, L its GANQ
    factor. Held to: index agreement >= 0.999, Werr within 1e-4 (abs and
    rel) where the indices agree, quad loss tr(E H E^T) within 1e-5
    relative of the plain version's."""
    from ganq_tpu_torch.core.backend import full_f32_matmul
    from ganq_tpu_torch.ops.ganq_solver import (s_step, s_step_blocked,
                                                s_step_blocked_kernel,
                                                s_step_kernel)
    from ganq_tpu_torch.quant.ganq import quad_loss
    from ganq_tpu_torch.quant.preamble import _ganq_L

    kernels = {"s_step_blocked": (s_step_blocked_kernel, s_step_blocked),
               "s_step": (s_step_kernel, s_step)}
    rows = {name: {} for name in kernels}
    for label, m, n, V in SSTEP_CASES:
        W = torch.randn((m, n), generator=gen, device="cuda") * 0.02
        X = torch.randn((2 * n, n), generator=gen, device="cuda")
        with full_f32_matmul():
            H = X.T @ X / (2 * n)
        del X
        L = _ganq_L(H)
        T = torch.sort(torch.randn((m, V), generator=gen, device="cuda"),
                       dim=1).values * 0.02
        for name, (kernel, plain) in kernels.items():
            Q, E = kernel(W, L, T)
            Qp, Ep = plain(W, L, T)
            torch.cuda.synchronize()
            same = Q == Qp
            agree = float(same.float().mean())
            werr_err = float((E[same] - Ep[same]).abs().max())
            loss = float(quad_loss(W, torch.take_along_dim(T, Q.long(), dim=1), H))
            ref = float(quad_loss(W, torch.take_along_dim(T, Qp.long(), dim=1), H))
            loss_rel = abs(loss - ref) / abs(ref)
            if (agree < 0.999 or not torch.allclose(E[same], Ep[same], rtol=1e-4,
                                                    atol=1e-4)
                    or loss_rel > 1e-5):
                raise AssertionError(
                    f"{name} {label} m={m} n={n} V={V}: agreement {agree:.6f}, "
                    f"max |dWerr| {werr_err:.3e}, quad loss rel {loss_rel:.3e}")
            slow = name == "s_step" or n > 4096
            k_ms = event_ms(kernel, (W, L, T), 2 if slow else 5)
            p_ms = event_ms(plain, (W, L, T), 1)
            B = torch.randn((n, n // 2), generator=gen, device="cuda")
            with full_f32_matmul():
                y_ms = event_ms(torch.matmul, (W, B), 5)
            del B
            flops = m * n * (n - 1) + 3 * m * n * V
            nbytes = 4 * (3 * m * n + n * n + m * V)
            b_ms, b_by = bound(nbytes, flops, F32_FLOPS_PER_S)
            rows[name][(label, V)] = dict(
                ms=k_ms, plain_ms=p_ms, yardstick_ms=y_ms, bound_ms=b_ms,
                bound_by=b_by, agreement=agree, max_abs_err=werr_err,
                quad_loss_rel=loss_rel)
            log(f"{name} {label} m={m} n={n} V={V}: agreement={agree:.6f} "
                f"max|dWerr| where agreeing={werr_err:.3e} quad_loss_rel="
                f"{loss_rel:.3e} (tol 0.999 / 1e-4 / 1e-5) kernel_ms={k_ms:.4f} "
                f"plain_ms={p_ms:.4f} yardstick_f32_matmul_ms={y_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}) bound_share={b_ms / k_ms:.3f}")
        del W, H, L, T
    entries = []
    for name, by_case in rows.items():
        entry = dict(by_case[("down", 16)])
        entry.update(name=name, library_ms=None,
                     agreement=min(r["agreement"] for r in by_case.values()),
                     max_abs_err=max(r["max_abs_err"] for r in by_case.values()),
                     shape="m=2048 n=8192 V=16 (down projection)")
        entries.append(entry)
    return entries


def _within_ulp(got, plain, what, rel=2e-5):
    """|kernel - plain| within one bf16 ulp of either plus ``rel`` of
    max|plain| (both round a float32 sum once; the float32 sums run in
    another order; for the fused W8A8 kernels, 5e-3 also covers an int8
    activation that those last bits flip by one code at a rounding tie,
    PERF.md, PR 4). Returns the largest error."""
    err = (got.float() - plain.float()).abs()
    tol = (torch.maximum(bf16_ulp(got), bf16_ulp(plain))
           + rel * plain.float().abs().max())
    if not bool(torch.isfinite(got.float()).all()) or not bool(
            (err <= tol).all()):
        raise AssertionError(f"{what}: max |kernel - plain| = "
                             f"{float(err.max()):.3e}, worst err/tol "
                             f"{float((err / tol).max()):.2f}")
    return float(err.max())


def _linear_rows(name, kernel, plain, make, nbytes_of, ops_per_s, gen,
                 widths=((4, "bits=4 g128"),)):
    """Kernel, plain version and the library yardstick (a bf16 matmul on
    the dequantized weight: the full-precision product) at the Llama-3.2-1B
    shapes, batch 1, 8 and 512. ``make(M, K, bits)`` -> (args without x,
    bf16 weight [M, K], weight bytes). Returns the rows and the worst
    error."""
    rows, worst = {}, 0.0
    for bits, tag in widths:
        for label, (M, K) in LLAMA_1B_LINEARS.items():
            first = make(M, K, bits)
            n = copies_for(first[2])
            weights = [first] + [make(M, K, bits) for _ in range(n - 1)]
            dense = [w[1] for w in weights[:copies_for(2 * M * K)]]
            for B in (1, 8, 512):
                x = torch.randn((B, K), generator=gen,
                                device="cuda").to(torch.bfloat16)
                args0 = weights[0][0]
                got = kernel(x, *args0)
                ref = plain(x, *args0)
                torch.cuda.synchronize()
                err = _within_ulp(got, ref, f"{name} {tag} {label} B={B}")
                iters = max(2 * n, 30)
                k_ms = time_ms(kernel, [(x, *w[0]) for w in weights], iters)
                p_ms = time_ms(plain, [(x, *w[0]) for w in weights],
                               max(n, 10))
                l_ms = time_ms(lambda xx, w: torch.matmul(xx, w.T),
                               [(x, w) for w in dense], iters)
                nbytes = B * K * 2 + nbytes_of(M, K, bits) + B * M * 2
                b_ms, b_by = bound(nbytes, 2.0 * B * M * K, ops_per_s)
                worst = max(worst, err)
                rows[(bits, label, B)] = dict(
                    ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                    bound_by=b_by, max_abs_err=err)
                log(f"{name} {tag} {label} M={M} K={K} B={B}: "
                    f"max_abs_err={err:.3e} (tol: 1 bf16 ulp + 2e-5 of "
                    f"max|out|) kernel_ms={k_ms:.5f} plain_ms={p_ms:.5f} "
                    f"library_ms={l_ms:.5f} bound_ms={b_ms:.5f} ({b_by}) "
                    f"bound_share={b_ms / k_ms:.3f}")
            del weights, dense
    return rows, worst


def check_uniform_kernels(gen) -> list:
    """Kernels 5 (``uniform_matmul``) and 6 (``uniform_a8_matmul``) on
    symmetric codes with 128-column groups: 4 bits for both, and 8 bits for
    kernel 6 (the ``optimize()`` recode). The library yardstick computes the
    full-precision product, not the a8 one."""
    from ganq_tpu_torch.ops.packing import pack_int_rows
    from ganq_tpu_torch.ops.uniform_matmul import (
        dequantize_uniform, uniform_a8_matmul, uniform_a8_reference,
        uniform_matmul, uniform_matmul_reference)

    def make(M, K, bits):
        codes = torch.randint(0, 2**bits, (M, K), generator=gen, device="cuda",
                              dtype=torch.int32)
        scales = (torch.rand((M, K // 128), generator=gen, device="cuda")
                  * 0.003 + 0.001) * min(1.0, 16.0 / 2**bits)
        packed = pack_int_rows(codes, bits)
        w = dequantize_uniform(packed, scales, None, None, bits,
                               K).to(torch.bfloat16)
        return (packed, scales, None, None, bits), w, M * K * bits // 8

    def nbytes_of(M, K, bits):
        return M * K * bits // 8 + M * (K // 128) * 4

    entries = []
    for name, kernel, plain, widths, peak in (
            ("uniform_matmul", uniform_matmul, uniform_matmul_reference,
             ((4, "bits=4 g128"),), BF16_FLOPS_PER_S),
            ("uniform_a8_matmul", uniform_a8_matmul, uniform_a8_reference,
             ((4, "bits=4 g128"), (8, "bits=8 g128")), INT8_OPS_PER_S)):
        rows, worst = _linear_rows(name, kernel, plain, make, nbytes_of, peak,
                                   gen, widths)
        entry = dict(rows[(4, "down", 1)])
        entry.update(name=name, max_abs_err=worst,
                     shape="bits=4 g128 M=2048 K=8192 B=1 (down, decode)")
        entries.append(entry)
    return entries


def check_w8_kernels(gen) -> list:
    """Kernels 7 (``w8_matmul``) and 8 (``w8a8_matmul``) on per-row int8
    weights (the ``optimize("w8")`` recode). Kernel 8 and its plain version
    quantize x alike and sum integers exactly: they are expected to agree
    bit for bit, and are held to the same bound as the others."""
    from ganq_tpu_torch.ops.w8_matmul import (w8_matmul, w8_matmul_reference,
                                              w8a8_matmul, w8a8_reference)

    def make(M, K, bits):
        w8 = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.int8)
        scale = torch.rand((M, 1), generator=gen, device="cuda") * 3e-4 + 1e-4
        w = (w8.float() * scale).to(torch.bfloat16)
        return (w8, scale), w, M * K

    def nbytes_of(M, K, bits):
        return M * K + M * 4

    entries = []
    for name, kernel, plain, peak in (
            ("w8_matmul", w8_matmul, w8_matmul_reference, BF16_FLOPS_PER_S),
            ("w8a8_matmul", w8a8_matmul, w8a8_reference, INT8_OPS_PER_S)):
        rows, worst = _linear_rows(name, kernel, plain, make, nbytes_of, peak,
                                   gen, ((8, "int8 per-row"),))
        entry = dict(rows[(8, "down", 1)])
        entry.update(name=name, max_abs_err=worst,
                     shape="int8 M=2048 K=8192 B=1 (down, decode)")
        entries.append(entry)
    return entries


FUSED_POS = 160                    # decode position of the attention kernels


def _l3b_widths():
    """(H, I, q_dim, kv_dim, head_dim, layers) of Llama-3.2-3B."""
    from ganq_tpu_torch.models import synthetic

    cfg = synthetic.llama_3_2_3b_config()
    return (cfg.hidden_size, cfg.intermediate_size, cfg.q_dim, cfg.kv_dim,
            cfg.head_dim, cfg.num_hidden_layers)


def _w8_pair(gen, M, K):
    w8 = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                       dtype=torch.int32).to(torch.int8)
    scale = torch.rand((M, 1), generator=gen, device="cuda") * 3e-4 + 1e-4
    return w8, scale


def check_fused_w8a8(gen) -> list:
    """Kernels 9 (fused MLP), 10 (norm + qkv + rope) and 11 (attention half)
    at the Llama-3.2-3B shapes against their plain versions (one bf16 ulp
    plus 5e-3 of max|plain|). Yardstick (no single PyTorch call computes
    these W8A8 functions; library_ms is null): the same products in full
    precision with bf16 ``torch.matmul`` on the dequantized weights (and
    ``scaled_dot_product_attention`` for kernel 11)."""
    import torch.nn.functional as F

    from ganq_tpu_torch.ops.fused_attention import (fused_qkv_rope_plain,
                                                    fused_qkv_rope_w8a8)
    from ganq_tpu_torch.ops.fused_layer import (attn_half_decode_w8a8,
                                                attn_half_plain)
    from ganq_tpu_torch.ops.fused_mlp import (fused_mlp_plain, fused_mlp_tile,
                                              fused_mlp_w8a8)

    H, I, q_dim, kv_dim, d, _ = _l3b_widths()
    Dqkv = q_dim + 2 * kv_dim
    Hkv, Hq = kv_dim // d, q_dim // d
    entries = []

    def norm_w():
        return torch.rand(H, generator=gen, device="cuda") + 0.5

    def rope():
        ang = torch.rand(d // 2, generator=gen, device="cuda") * 6.2831853
        return torch.cos(ang), torch.sin(ang)

    # kernel 9: x -> norm -> gate/up -> act -> tile quant -> down -> + x
    mlps = [(*_w8_pair(gen, 2 * I, H), *_w8_pair(gen, H, I), norm_w())
            for _ in range(copies_for(3 * I * H))]
    dense = [(((g.float() * gs).to(torch.bfloat16)),
              (dn.float() * ds).to(torch.bfloat16)) for g, gs, dn, ds, _ in mlps[:1]]
    rows = {}
    for B in (1, 8, 64):
        x = torch.randn((B, H), generator=gen, device="cuda").to(torch.bfloat16)
        g, gs, dn, ds, nw = mlps[0]
        got = fused_mlp_w8a8(x, g, gs, dn, ds, norm_w=nw)
        plain = fused_mlp_plain(x, g, gs, dn, ds, norm_w=nw)
        torch.cuda.synchronize()
        err = _within_ulp(got, plain, f"fused_mlp B={B}", 5e-3)
        args = [(x, *m[:4], "silu", 1024, m[4]) for m in mlps]
        k_ms = time_ms(fused_mlp_w8a8, args, max(2 * len(args), 20))
        p_ms = event_ms(fused_mlp_plain, args[0], 3)
        gw, dw = dense[0]

        def yard(xx, gw=gw, dw=dw):
            gu = torch.matmul(xx, gw.T)
            return torch.matmul(F.silu(gu[:, :I]) * gu[:, I:], dw.T)

        y_ms = time_ms(yard, [(x,)], 20)
        b_ms, b_by = bound(B * H * 2 * 2 + 3 * I * H + (2 * I + 2 * H) * 4,
                           2.0 * B * 3 * I * H, INT8_OPS_PER_S)
        rows[B] = dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                       yardstick_ms=y_ms, bound_ms=b_ms, bound_by=b_by,
                       max_abs_err=err)
        log(f"fused_mlp_w8a8 H={H} I={I} ti={fused_mlp_tile(I, H)} B={B}: "
            f"max_abs_err={err:.3e} (tol 1 bf16 ulp + 5e-3 of max|plain|) "
            f"kernel_ms={k_ms:.5f} plain_ms={p_ms:.5f} "
            f"yardstick_bf16_ms={y_ms:.5f} bound_ms={b_ms:.5f} ({b_by}) "
            f"bound_share={b_ms / k_ms:.3f}")
    del mlps, dense
    entry = dict(rows[1])
    entry.update(name="fused_mlp_w8a8",
                 max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                 shape="H=3072 I=8192 ti=512 B=1 (Llama-3.2-3B MLP, decode)")
    entries.append(entry)

    # kernel 10: x -> norm -> int8 -> qkv + bias -> rope
    qkvs = [(*_w8_pair(gen, Dqkv, H), norm_w()) for _ in range(copies_for(Dqkv * H))]
    cos, sin = rope()
    wd = (qkvs[0][0].float() * qkvs[0][1]).to(torch.bfloat16)
    rows = {}
    for B in (1, 8, 64):
        x = torch.randn((B, H), generator=gen, device="cuda").to(torch.bfloat16)
        w, s, nw = qkvs[0]
        kw = (q_dim, kv_dim, d, d)
        got = fused_qkv_rope_w8a8(x, nw, w, s, None, cos, sin, *kw)
        plain = fused_qkv_rope_plain(x, nw, w, s, None, cos, sin, *kw)
        torch.cuda.synchronize()
        err = _within_ulp(got, plain, f"fused_qkv_rope B={B}", 5e-3)
        args = [(x, q[2], q[0], q[1], None, cos, sin, *kw) for q in qkvs]
        k_ms = time_ms(fused_qkv_rope_w8a8, args, max(2 * len(args), 30))
        p_ms = event_ms(fused_qkv_rope_plain, args[0], 3)
        y_ms = time_ms(lambda xx: torch.matmul(xx, wd.T), [(x,)], 30)
        b_ms, b_by = bound(B * H * 2 + Dqkv * H + Dqkv * 4 + B * Dqkv * 2,
                           2.0 * B * Dqkv * H, INT8_OPS_PER_S)
        rows[B] = dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                       yardstick_ms=y_ms, bound_ms=b_ms, bound_by=b_by,
                       max_abs_err=err)
        log(f"fused_qkv_rope_w8a8 H={H} Dqkv={Dqkv} B={B}: max_abs_err="
            f"{err:.3e} (tol 1 bf16 ulp + 5e-3 of max|plain|) "
            f"kernel_ms={k_ms:.5f} plain_ms={p_ms:.5f} "
            f"yardstick_bf16_ms={y_ms:.5f} bound_ms={b_ms:.5f} ({b_by}) "
            f"bound_share={b_ms / k_ms:.3f}")
    del qkvs
    entry = dict(rows[1])
    entry.update(name="fused_qkv_rope_w8a8",
                 max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                 shape="H=3072 Dqkv=5120 B=1 (Llama-3.2-3B qkv, decode)")
    entries.append(entry)

    # kernel 11: the attention half at position FUSED_POS
    T, pos = 2048, FUSED_POS
    halves = [(*_w8_pair(gen, Dqkv, H), _w8_pair(gen, H, q_dim), norm_w())
              for _ in range(copies_for((Dqkv + q_dim) * H))]
    ow0 = halves[0][2]
    wq = (halves[0][0].float() * halves[0][1]).to(torch.bfloat16)
    wo = (ow0[0].float() * ow0[1]).to(torch.bfloat16)
    rows = {}
    for B in (1, 8):
        x = torch.randn((B, H), generator=gen, device="cuda").to(torch.bfloat16)
        kc = (torch.randn((B, T, Hkv, d), generator=gen, device="cuda")
              * 0.5).to(torch.bfloat16)
        vc = (torch.randn((B, T, Hkv, d), generator=gen, device="cuda")
              * 0.5).to(torch.bfloat16)
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=d, rotary_dim=d,
                  scale=1.0 / math.sqrt(d))

        def args_of(h, p):
            w, s, (ow, osc), nw = h
            return (x, nw, w, s, None, ow.T.contiguous(), osc.reshape(1, -1),
                    cos, sin, kc, vc, p)

        a0 = args_of(halves[0], pos_t)
        got = attn_half_decode_w8a8(*a0, **kw)
        plain = attn_half_plain(*args_of(halves[0], pos), **kw)
        torch.cuda.synchronize()
        err = max(_within_ulp(g, p, f"attn_half B={B}", 5e-3)
                  for g, p in zip(got, plain))
        kargs = [args_of(h, pos_t) for h in halves]
        k_ms = time_ms(lambda *a: attn_half_decode_w8a8(*a, **kw), kargs,
                       max(2 * len(kargs), 20))
        p_ms = event_ms(lambda *a: attn_half_plain(*a, **kw),
                        args_of(halves[0], pos), 3)

        def yard(xx):
            qkv = torch.matmul(xx, wq.T)
            q = qkv[:, :q_dim].reshape(B, Hq, 1, d)
            o = F.scaled_dot_product_attention(
                q, kc[:, :pos + 1].transpose(1, 2),
                vc[:, :pos + 1].transpose(1, 2), enable_gqa=True)
            return xx + torch.matmul(o.reshape(B, q_dim), wo.T)

        y_ms = time_ms(yard, [(x,)], 20)
        nbytes = ((Dqkv + q_dim) * H + 2 * B * pos * kv_dim * 2
                  + 2 * B * H * 2 + 2 * B * kv_dim * 2)
        b_ms, b_by = bound(nbytes, 2.0 * B * (Dqkv + q_dim) * H,
                           INT8_OPS_PER_S)
        rows[B] = dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                       yardstick_ms=y_ms, bound_ms=b_ms, bound_by=b_by,
                       max_abs_err=err)
        log(f"attn_half_decode_w8a8 H={H} Hq={Hq} Hkv={Hkv} pos={pos} B={B}: "
            f"max_abs_err={err:.3e} (tol 1 bf16 ulp + 5e-3 of max|plain|) "
            f"kernel_ms={k_ms:.5f} plain_ms={p_ms:.5f} yardstick_bf16_ms="
            f"{y_ms:.5f} bound_ms={b_ms:.5f} ({b_by}) "
            f"bound_share={b_ms / k_ms:.3f}")
        del kc, vc
    del halves
    entry = dict(rows[1])
    entry.update(name="attn_half_decode_w8a8",
                 max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                 shape=f"H=3072 Hq=24 Hkv=8 pos={pos} B=1 (Llama-3.2-3B)")
    entries.append(entry)
    return entries


def _spread_close(got, plain, nudged, what):
    """Relative L2 of kernel - plain within twice the plain version's own
    spread (its output with norm weights 2^-22 larger, two float32 ulps)
    plus one bf16 ulp (2^-8): over many layers an int8 activation flipped
    by last-bit differences moves the next layer's activations and flips
    more codes, in the plain version as in the kernel (PERF.md, PR 4).
    Returns (max error, relative L2, spread)."""
    p = plain.float()
    rel = float((got.float() - p).norm() / p.norm().clamp_min(1e-30))
    spread = float((nudged.float() - p).norm() / p.norm().clamp_min(1e-30))
    if not bool(torch.isfinite(got.float()).all()) or rel > 2 * spread + 2**-8:
        raise AssertionError(f"{what}: rel_l2 {rel:.3e} against the plain "
                             f"version's spread {spread:.3e}")
    return float((got.float() - p).abs().max()), rel, spread


def check_megastep(gen) -> dict:
    """Kernel 12 over the 28 layers of Llama-3.2-3B (random megapack, decode
    position FUSED_POS) against its plain version, within twice the plain
    version's own spread under a two-ulp nudge (``_spread_close``). The o
    and down scales are a tenth of the others', so that each layer adds a
    tenth of the residual's size, as in a trained model; even so the plain
    version moves by ~2% relative L2 over 28 layers under the nudge (11%
    with every projection at full scale; PERF.md, PR 4). Timed with CUDA
    events over eager calls (one cooperative launch of milliseconds); no
    yardstick: the per-layer path on a model is timed in phase 9."""
    from ganq_tpu_torch.ops.megastep import megastep_decode_w8a8, megastep_plain

    H, I, q_dim, kv_dim, d, L = _l3b_widths()
    Dqkv = q_dim + 2 * kv_dim
    Hkv = kv_dim // d

    def stack(f):
        return torch.stack([f() for _ in range(L)])

    mp = {"attn_norm": stack(lambda: (torch.rand(H, generator=gen, device="cuda")
                                      + 0.5).reshape(1, H)),
          "mlp_norm": stack(lambda: (torch.rand(H, generator=gen, device="cuda")
                                     + 0.5).reshape(1, H)),
          "qkv_bias": torch.zeros((L, 1, Dqkv), device="cuda")}
    for key, (M, K) in (("qkv", (Dqkv, H)), ("o_t", (q_dim, H)),
                        ("gateup", (2 * I, H)), ("down_t", (I, H))):
        pairs = [_w8_pair(gen, M, K) for _ in range(L)]
        mp["down_t" if key == "down_t" else f"{key}_w8"] = torch.stack(
            [w for w, _ in pairs])
        if key in ("qkv", "gateup"):
            mp[f"{key}_scale"] = torch.stack([s for _, s in pairs])
        del pairs
    for key in ("o_t_scale", "down_scale"):
        mp[key] = stack(lambda: torch.rand((1, H), generator=gen,
                                           device="cuda") * 3e-5 + 1e-5)
    T, pos = 2048, FUSED_POS
    ang = torch.rand(d // 2, generator=gen, device="cuda") * 6.2831853
    cos, sin = torch.cos(ang), torch.sin(ang)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=d, rotary_dim=d,
              scale=1.0 / math.sqrt(d))
    rows = {}
    for B in (1, 8):
        kc = (torch.randn((L, B * Hkv, T, d), generator=gen, device="cuda")
              * 0.5).to(torch.bfloat16)
        vc = (torch.randn((L, B * Hkv, T, d), generator=gen, device="cuda")
              * 0.5).to(torch.bfloat16)
        x = torch.randn((B, H), generator=gen, device="cuda").to(
            torch.bfloat16)
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        got = megastep_decode_w8a8(x, mp, kc, vc, pos_t, cos, sin, **kw)
        plain = megastep_plain(x, mp, kc, vc, pos, cos, sin, **kw)
        nudged = megastep_plain(
            x, dict(mp, attn_norm=mp["attn_norm"] * (1 + 2**-22),
                    mlp_norm=mp["mlp_norm"] * (1 + 2**-22)),
            kc, vc, pos, cos, sin, **kw)
        torch.cuda.synchronize()
        errs = [_spread_close(g, p, q, f"megastep {n} B={B}")
                for n, g, p, q in zip(("y", "k_new", "v_new"), got, plain,
                                      nudged)]
        k_ms = event_ms(lambda: megastep_decode_w8a8(x, mp, kc, vc, pos_t,
                                                     cos, sin, **kw), (), 10)
        p_ms = event_ms(lambda: megastep_plain(x, mp, kc, vc, pos, cos, sin,
                                               **kw), (), 2)
        nbytes = (L * (Dqkv + q_dim + 3 * I) * H + 2 * L * B * pos * kv_dim * 2
                  + L * (4 * H + 3 * Dqkv + 2 * I) * 4 + 2 * B * H * 2
                  + 2 * L * B * kv_dim * 2)
        b_ms, b_by = bound(nbytes, 2.0 * B * L * (Dqkv + q_dim + 3 * I) * H,
                           INT8_OPS_PER_S)
        rows[B] = dict(ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                       bound_by=b_by, max_abs_err=max(e[0] for e in errs),
                       rel_l2=max(e[1] for e in errs))
        log(f"megastep_decode_w8a8 L={L} H={H} pos={pos} B={B}: max_abs_err "
            f"y/k/v={[round(e[0], 5) for e in errs]} rel_l2="
            f"{[f'{e[1]:.2e}' for e in errs]} (tol 2 x the plain version's "
            f"spread {[f'{e[2]:.2e}' for e in errs]} + 2^-8) "
            f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.3f} "
            f"bound_ms={b_ms:.4f} ({b_by}) bound_share={b_ms / k_ms:.3f}")
        del kc, vc
    del mp
    torch.cuda.empty_cache()
    entry = dict(rows[1])
    entry.update(name="megastep_decode_w8a8",
                 max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                 ms_b8=rows[8]["ms"], bound_ms_b8=rows[8]["bound_ms"],
                 shape=f"L=28 H=3072 I=8192 pos={pos} B=1 (Llama-3.2-3B step)")
    return entry


def _grouped_pack(gen, L, H, q_dim, kv_dim, I, bits, kmajor, gs=128):
    """Random operands of kernel 13 (``kmajor``: megapack4's layouts) or
    kernel 14 (megapack_lowbit's) over L layers: any byte is a valid code
    byte; bf16 group scales, the o and down ones a tenth of the others'
    (residual-dominated layers, as in ``check_megastep``)."""
    from ganq_tpu_torch.ops.megastep4 import _mlp_tile4
    from ganq_tpu_torch.ops.megastep_lowbit import _mlp_plan

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
          "qkv_bias": torch.zeros((L, 1, Dqkv), device="cuda"),
          "qkv_s": scales(H // gs, Dqkv),
          "o_s": scales(q_dim // gs, H, lo=1e-5),
          "gu_s": scales(H // gs, 2 * I),
          "dn_s": scales(I // ti * gtp, H, lo=1e-5)}
    if kmajor:
        mp.update(qkv_p4=codes(Dqkv // 2, H), o_p4=codes(q_dim, H // 2),
                  gu_p4=codes(I, H), dn_p4=codes(I, H // 2))
    else:
        mp.update(qkv_pk=codes(Dqkv // F, H), o_pk=codes(H // F, q_dim),
                  gu_pk=codes(2 * I // F, H), dn_pk=codes(H // F, I))
    return mp


ZP_AO_LAYERS = 8                   # depth of kernel 14's 8B-width cases


def _zp_ao_operands(gen, mp, L, H, q_dim, bits, zp, ao):
    """Kernel 14's zero-point corrections (scale * (2^(bits-1) - zero) for
    random fractional zeros in [2^bits / 4, 3 * 2^bits / 4], float32 in
    the scales' layouts) and act-order column orders (a random permutation
    per layer) added to a random pack."""
    if zp:
        for k in ("qkv", "o", "gu", "dn"):
            s = mp[f"{k}_s"].float()
            dz = (torch.rand(s.shape, generator=gen, device="cuda") - 0.5) \
                * 0.5 * 2 ** bits
            mp[f"{k}_sz"] = (s * dz).contiguous()
    if ao:
        for k, n in (("ap_q", H), ("ap_g", H), ("ap_o", q_dim)):
            mp[k] = torch.stack([torch.randperm(n, generator=gen,
                                                device="cuda")
                                 for _ in range(L)]).to(torch.int32)
    return mp


def check_grouped_megasteps(gen) -> list:
    """Kernels 14 ("w4p" and "w8p", batch 1, 8 and 64) and 13 (batch 1 and
    8) over the 28 layers of Llama-3.2-3B (random packs, slot b at decode
    position FUSED_POS + b) against their plain versions, within twice the
    plain version's own spread under a two-ulp nudge (``_spread_close``);
    then kernel 14 with zero points ("w4p" and "w8p") and act-order ("w4p")
    over ZP_AO_LAYERS layers of Llama-3.1-8B at batch 1, 8 and 64. Timed
    with CUDA events over eager calls; the bound counts the code bytes, the
    bf16 scales (and float32 zero-point corrections, int32 column orders),
    the K/V history, norms and the rows in and out. No library call
    computes the same step; the per-layer path on a model is timed in
    phases 9 and 10."""
    from ganq_tpu_torch.models import synthetic
    from ganq_tpu_torch.ops.megastep4 import megastep4_decode, megastep4_plain
    from ganq_tpu_torch.ops.megastep_lowbit import (megastep_lowbit_decode,
                                                    megastep_lowbit_plain)

    c8 = synthetic.llama_3_1_8b_config(ZP_AO_LAYERS)
    widths = {"3b": _l3b_widths(),
              "8b": (c8.hidden_size, c8.intermediate_size, c8.q_dim,
                     c8.kv_dim, c8.head_dim, ZP_AO_LAYERS)}
    T = 256
    ang = torch.rand(64, generator=gen, device="cuda") * 6.2831853
    cos, sin = torch.cos(ang), torch.sin(ang)
    entries = []
    for name, kernel, plain, variants in (
            ("megastep_lowbit_decode", megastep_lowbit_decode,
             megastep_lowbit_plain, (
                 ("w4p", 4, (1, 8, 64), "3b", False, False),
                 ("w8p", 8, (1, 8, 64), "3b", False, False),
                 ("w4p_zp", 4, (1, 8, 64), "8b", True, False),
                 ("w8p_zp", 8, (1, 8, 64), "8b", True, False),
                 ("w4p_ao", 4, (1, 8, 64), "8b", False, True))),
            ("megastep4_decode", megastep4_decode, megastep4_plain,
             (("w4", 4, (1, 8), "3b", False, False),))):
        rows = {}
        for variant, bits, batches, model, zp, ao in variants:
            H, I, q_dim, kv_dim, d, L = widths[model]
            Dqkv = q_dim + 2 * kv_dim
            Hkv = kv_dim // d
            kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=d, rotary_dim=d,
                      scale=1.0 / math.sqrt(d))
            kmajor = variant == "w4"
            mp = _zp_ao_operands(
                gen, _grouped_pack(gen, L, H, q_dim, kv_dim, I, bits, kmajor),
                L, H, q_dim, bits, zp, ao)
            vkw = dict(kw) if kmajor else dict(kw, bits=bits)
            code_bytes = L * (Dqkv + q_dim + 3 * I) * H * bits // 8
            scale_bytes = sum(v.numel() * v.element_size()
                              for k, v in mp.items()
                              if k.endswith(("_s", "_sz")) or k[:3] == "ap_")
            for B in batches:
                pos = [FUSED_POS + b for b in range(B)]
                kc = (torch.randn((L, B * Hkv, T, d), generator=gen,
                                  device="cuda") * 0.5).to(torch.bfloat16)
                vc = (torch.randn((L, B * Hkv, T, d), generator=gen,
                                  device="cuda") * 0.5).to(torch.bfloat16)
                x = torch.randn((B, H), generator=gen, device="cuda").to(
                    torch.bfloat16)
                pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
                got = kernel(x, mp, kc, vc, pos_t, cos, sin, **vkw)
                ref = plain(x, mp, kc, vc, pos, cos, sin, **vkw)
                nudged = plain(
                    x, dict(mp, attn_norm=mp["attn_norm"] * (1 + 2**-22),
                            mlp_norm=mp["mlp_norm"] * (1 + 2**-22)),
                    kc, vc, pos, cos, sin, **vkw)
                torch.cuda.synchronize()
                errs = [_spread_close(g, p, q, f"{variant} {n} B={B}")
                        for n, g, p, q in zip(("y", "k_new", "v_new"), got,
                                              ref, nudged)]
                k_ms = event_ms(lambda: kernel(x, mp, kc, vc, pos_t, cos,
                                               sin, **vkw), (), 10)
                p_ms = (event_ms(lambda: plain(x, mp, kc, vc, pos, cos, sin,
                                               **vkw), (), 1)
                        if B == 1 else None)
                nbytes = (code_bytes + scale_bytes
                          + 2 * L * sum(pos) * kv_dim * 2
                          + L * (2 * H + Dqkv) * 4 + 2 * B * H * 2
                          + 2 * L * B * kv_dim * 2)
                b_ms, b_by = bound(nbytes, 2.0 * B * L * (Dqkv + q_dim + 3 * I)
                                   * H, INT8_OPS_PER_S)
                rows[(variant, B)] = dict(
                    ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                    bound_by=b_by, max_abs_err=max(e[0] for e in errs),
                    rel_l2=max(e[1] for e in errs))
                log(f"{name} ({variant}) L={L} H={H} pos={FUSED_POS}+b B={B}: "
                    f"max_abs_err y/k/v={[round(e[0], 5) for e in errs]} "
                    f"rel_l2={[f'{e[1]:.2e}' for e in errs]} (tol 2 x the "
                    f"plain version's spread {[f'{e[2]:.2e}' for e in errs]}"
                    f" + 2^-8) kernel_ms={k_ms:.4f} plain_ms="
                    f"{p_ms if p_ms is None else round(p_ms, 3)} "
                    f"bound_ms={b_ms:.4f} ({b_by}) "
                    f"bound_share={b_ms / k_ms:.3f}")
                del kc, vc
            del mp
            torch.cuda.empty_cache()
        first = variants[0][0]
        entry = dict(rows[(first, 1)])
        entry.update(name=name,
                     max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                     shape=f"L=28 H=3072 I=8192 pos={FUSED_POS} B=1 "
                     f"({first}, Llama-3.2-3B step)",
                     by_case={f"{v}_b{b}": {k: r[k] for k in (
                         "ms", "bound_ms", "plain_ms", "rel_l2")}
                         for (v, b), r in rows.items()})
        entries.append(entry)
    return entries


def _moe_pack(gen, E, H, I, bits, gs=128):
    """Random kernel 15 operands in moe_megapack's layouts (any byte is a
    valid code byte)."""
    from ganq_tpu_torch.ops.megastep_lowbit import _mlp_plan

    F = 2 if bits == 4 else 1
    ti = _mlp_plan(I, bits, H)[0]
    gtp = -(-(ti // gs) // 8) * 8
    unit = 16.0 if bits == 4 else 1.0

    def codes(*shape):
        return torch.randint(-128, 128, (E, *shape), generator=gen,
                             device="cuda", dtype=torch.int32).to(torch.int8)

    def scales(*shape):
        return ((torch.rand((E, *shape), generator=gen, device="cuda") * 3
                 + 1) * 1e-4 * unit).to(torch.bfloat16)

    return {"gate_pk": codes(2 * I // F, H), "gu_s": scales(H // gs, 2 * I),
            "dn_pk": codes(H // F, I), "dn_s": scales(I // ti * gtp, H)}


def check_moe_expert(gen) -> dict:
    """Kernel 15 at Mixtral-8x7B's widths (8 experts, H 4096, I 14336,
    top-2), 8-bit experts (``optimize()``'s recode) and 4-bit, batch 1, 8
    and 32, on the slots of random top-2 routing, against its plain
    version within one bf16 ulp plus 5e-3 of the largest output (an int8
    activation at a rounding tie may flip: the activation's exp differs in
    the last bit between the kernel and PyTorch). Timed by a CUDA graph of
    launches; the bound counts the code bytes and bf16 scales of the
    experts that carry routed mass (the slots past them are zero-weight
    padding), x and y. No library call computes the same function."""
    from ganq_tpu_torch.models.transformer import moe_slots
    from ganq_tpu_torch.ops.moe_expert import (moe_expert_decode,
                                               moe_expert_plain)

    E, H, I, k = 8, 4096, 14336, 2
    rows = {}
    for bits in (8, 4):
        mp = _moe_pack(gen, E, H, I, bits)
        per_expert = sum(v[0].numel() * v.element_size()
                         for v in mp.values())
        for B in (1, 8, 32):
            x = (torch.randn((B, H), generator=gen, device="cuda") * 0.5).to(
                torch.bfloat16)
            probs = torch.softmax(torch.randn((B, E), generator=gen,
                                              device="cuda") * 2, dim=-1)
            sel = probs >= torch.topk(probs, k, dim=-1).values[:, -1:]
            gated = torch.where(sel, probs, 0.0)
            gated = gated / gated.sum(-1, keepdim=True)
            slot_ids, wts = moe_slots(gated, k)
            got = moe_expert_decode(x, mp, slot_ids, wts, bits=bits)
            ref = moe_expert_plain(x, mp, slot_ids, wts, bits=bits)
            torch.cuda.synchronize()
            err = (got - ref).abs()
            tol = bf16_ulp(torch.maximum(got.abs(), ref.abs())) \
                + 5e-3 * ref.abs().max()
            if not bool(torch.isfinite(got).all()) or bool((err > tol).any()):
                raise AssertionError(f"moe_expert bits={bits} B={B}: max err "
                                     f"{float(err.max()):.3e}")
            k_ms = time_ms(lambda: moe_expert_decode(x, mp, slot_ids, wts,
                                                     bits=bits), [()], 20)
            p_ms = (event_ms(lambda: moe_expert_plain(x, mp, slot_ids, wts,
                                                      bits=bits), (), 1)
                    if B == 1 else None)
            routed = int((gated.sum(0) > 0).sum())
            b_ms, b_by = bound(routed * per_expert + B * H * (2 + 4),
                               2.0 * B * k * 3 * H * I, INT8_OPS_PER_S)
            rows[(bits, B)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                   bound_by=b_by,
                                   max_abs_err=float(err.max()))
            log(f"moe_expert_decode (kernel 15) E={E} H={H} I={I} bits={bits} "
                f"B={B} S={slot_ids.numel()} routed experts {routed}: "
                f"max_abs_err={float(err.max()):.3e} (tol 1 bf16 ulp + 5e-3 "
                f"x {float(ref.abs().max()):.3e}) kernel_ms={k_ms:.4f} "
                f"plain_ms={p_ms if p_ms is None else round(p_ms, 3)} "
                f"bound_ms={b_ms:.4f} ({b_by}) bound_share={b_ms / k_ms:.3f}")
        del mp
        torch.cuda.empty_cache()
    entry = dict(rows[(8, 1)])
    entry.update(name="moe_expert_decode", library_ms=None,
                 max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                 shape="E=8 H=4096 I=14336 top-2 bits=8 B=1 (Mixtral-8x7B "
                 "MoE layer)",
                 by_case={f"w{b}_b{B}": {x: r[x] for x in (
                     "ms", "bound_ms", "plain_ms")}
                     for (b, B), r in rows.items()})
    return entry


def phase_kernels() -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    # full-precision sums in the plain versions' and library's GEMMs
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            return [check_lut_matmul(gen), check_flash_decode(gen),
                    *check_s_step(gen), *check_uniform_kernels(gen),
                    *check_w8_kernels(gen), *check_fused_w8a8(gen),
                    check_megastep(gen), *check_grouped_megasteps(gen),
                    check_moe_expert(gen)]
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev


def phase_main_path(ckpt_dir: str):
    from ganq_tpu_torch import GanqModel, QuantizeConfig
    from ganq_tpu_torch.formats.checkpoint import save_quantized
    from ganq_tpu_torch.models import hf_import, synthetic
    from ganq_tpu_torch.ops.fused_attention import flash_decode_attention
    from ganq_tpu_torch.ops.lut_matmul import lut_matmul

    cfg = synthetic.llama_3_2_1b_config()
    t0 = time.time()
    with torch.inference_mode():
        model = synthetic.make_model(cfg, kind="lut", bits=4, seed=0,
                                     device="cuda", dtype=torch.bfloat16)
    save_quantized(ckpt_dir, hf_import.config_to_hf(cfg),
                   QuantizeConfig(bits=4, quant_method="ganq"), model)
    del model
    torch.cuda.empty_cache()
    t1 = time.time()
    q = GanqModel.load(ckpt_dir, dtype=torch.bfloat16)
    log(f"main path: built+saved 1B lut checkpoint in {t1 - t0:.1f} s, "
        f"loaded in {time.time() - t1:.1f} s on {q.device}, "
        f"backend={q.backend}")
    if q.backend != "cuda" or q.device.type != "cuda":
        raise AssertionError("GanqModel.load did not select the card")

    rng = torch.Generator().manual_seed(1)
    layers = cfg.num_hidden_layers
    # the engine's stacked layout fuses q/k/v and gate/up: 4 linears a layer
    linears = sum(len(lp.attn) + len(lp.mlp) for lp in q._get_engine().model.layers)
    if linears != 4 * layers:
        raise AssertionError(f"the engine serves {linears} linears, not the "
                             f"{4 * layers} of the fused layout")
    expected = {"lut_matmul": 0, "flash_decode": 0}

    def generate(ids, new, **kw):
        """One request through the user entry point; adds the launches the
        path must make: one LUT matmul per linear for the prompt when it has
        fewer than 1024 token rows (else the dequantize-once GEMM), and one
        per linear plus one flash decode per layer for every decode step."""
        B, S = ids.shape
        expected["lut_matmul"] += (linears if B * S < 1024 else 0) \
            + (new - 1) * linears
        expected["flash_decode"] += (new - 1) * layers
        t0 = time.time()
        out = q.generate(ids, max_new_tokens=new, **kw)
        return out, time.time() - t0

    requests = [("b1 prompt128 new64 greedy", 1, 128, 64, {}),
                ("b8 prompt256 new32 greedy", 8, 256, 32, {}),
                ("b1 prompt1100 new8 greedy (GEMM prefill)", 1, 1100, 8, {}),
                ("b1 prompt64 new32 sampled", 1, 64, 32,
                 dict(temperature=0.8, top_k=50, top_p=0.95, seed=1234))]
    lut_matmul.launches = 0
    flash_decode_attention.launches = 0
    generate(torch.randint(0, cfg.vocab_size, (1, 16), generator=rng).numpy(),
             4)                                           # warm-up request
    metrics = {}
    for name, B, S, new, kw in requests:
        ids = torch.randint(0, cfg.vocab_size, (B, S), generator=rng).numpy()
        generate(ids, 1, **kw)              # first use of this prompt shape
        _, t_prefill = generate(ids, 1, **kw)
        out, t_total = generate(ids, new, **kw)
        if out.shape != (B, new) or out.min() < 0 or out.max() >= cfg.vocab_size:
            raise AssertionError(f"{name}: bad tokens {out.shape} "
                                 f"[{out.min()}, {out.max()}]")
        if kw and not (generate(ids, new, **kw)[0] == out).all():
            raise AssertionError("seeded sampling is not reproducible")
        tok_s = B * (new - 1) / max(t_total - t_prefill, 1e-9)
        metrics[name] = dict(prefill_ms=t_prefill * 1e3, decode_tok_s=tok_s)
        log(f"request {name}: prefill_ms={t_prefill * 1e3:.2f} "
            f"total_ms={t_total * 1e3:.2f} decode_tok_s={tok_s:.1f} "
            f"first tokens {out[0, :6].tolist()}")
    launches = {"lut_matmul": lut_matmul.launches,
                "flash_decode": flash_decode_attention.launches}
    log(f"launches during generate: {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError("kernel launch counts differ from the path's")
    return q, launches, metrics


def phase_reference_check(q, what: str = "reference check",
                          batch: int = 2) -> float:
    """Teacher-force one decode step through the engine ``q`` serves with
    (its backend and model, and the megastep where its gate picks it, under
    the switches as set) and through the "reference" backend, from the same
    cache after a 128-token prompt; the relative L2 difference of the logits
    must stay below 5e-2 (bf16 activations: the paths round at different
    points, see PERF.md), and below 1e-1 on "cuda_a8", whose kernels also
    round every linear's input to int8 per token (up to 1/254 of the row's
    largest value)."""
    from ganq_tpu_torch.serve import stacked

    eng = q._get_engine()
    sp, cfg = eng.model, q.cfg
    ids = torch.randint(0, cfg.vocab_size, (batch, 128),
                        generator=torch.Generator().manual_seed(2)).cuda()
    variant = stacked.mega_enabled(cfg, sp, eng.backend, batch, eng.device)
    with torch.inference_mode():
        ck, cv = stacked.init_cache(cfg, len(sp.layers), batch, 256,
                                    eng.device)
        tok = stacked.prefill(cfg, sp, ck, cv, ids, "reference").argmax(-1)
        ck2, cv2 = ck.clone(), cv.clone()
        pos = torch.tensor(128, dtype=torch.int32, device=eng.device)
        if variant:
            mk, mv = stacked._mega_cache(ck, cv)
            a = stacked._decode_one_mega(
                cfg, sp, stacked._mega_pack_for(cfg, sp, variant), mk, mv,
                tok, pos, eng.backend, variant).float()
        else:
            a = stacked.decode_step(cfg, sp, ck, cv, tok, pos,
                                    eng.backend).float()
        b = stacked.decode_step(cfg, sp, ck2, cv2, tok, pos,
                                "reference").float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite logits")
    rel = float((a - b).norm() / b.norm())
    tol = 1e-1 if eng.backend == "cuda_a8" else 5e-2
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"{what}: teacher-forced decode step (whole-step variant {variant}), "
        f"logits {tuple(a.shape)}, rel_l2({eng.backend}, reference)={rel:.3e}"
        f" max_abs={float((a - b).abs().max()):.3e} "
        f"max|ref|={float(b.abs().max()):.3e} top1_agree={agree:.2f} "
        f"(tol rel_l2 <= {tol:g})")
    if rel > tol:
        raise AssertionError(f"{what}: {eng.backend} and reference backends "
                             "disagree")
    return rel


def _kernel_counters():
    from ganq_tpu_torch.ops.fused_attention import (flash_decode_attention,
                                                    fused_qkv_rope_w8a8)
    from ganq_tpu_torch.ops.fused_layer import attn_half_decode_w8a8
    from ganq_tpu_torch.ops.fused_mlp import fused_mlp_w8a8
    from ganq_tpu_torch.ops.ganq_solver import (s_step_blocked_kernel,
                                                s_step_kernel)
    from ganq_tpu_torch.ops.lut_matmul import lut_matmul
    from ganq_tpu_torch.ops.megastep import megastep_decode_w8a8
    from ganq_tpu_torch.ops.megastep4 import megastep4_decode
    from ganq_tpu_torch.ops.megastep_lowbit import megastep_lowbit_decode
    from ganq_tpu_torch.ops.moe_expert import moe_expert_decode
    from ganq_tpu_torch.ops.uniform_matmul import (uniform_a8_matmul,
                                                   uniform_matmul)
    from ganq_tpu_torch.ops.w8_matmul import w8_matmul, w8a8_matmul

    return {"lut_matmul": lut_matmul, "flash_decode": flash_decode_attention,
            "s_step_blocked": s_step_blocked_kernel, "s_step": s_step_kernel,
            "uniform_matmul": uniform_matmul,
            "uniform_a8_matmul": uniform_a8_matmul, "w8_matmul": w8_matmul,
            "w8a8_matmul": w8a8_matmul, "fused_mlp_w8a8": fused_mlp_w8a8,
            "fused_qkv_rope_w8a8": fused_qkv_rope_w8a8,
            "attn_half_decode_w8a8": attn_half_decode_w8a8,
            "megastep_decode_w8a8": megastep_decode_w8a8,
            "megastep4_decode": megastep4_decode,
            "megastep_lowbit_decode": megastep_lowbit_decode,
            "moe_expert_decode": moe_expert_decode}


def expected_launches(q, model, backend, B, S, new, kernel_of, variant):
    """The launches of one request on the port's routing (the JAX
    package's): per layer of the prompt (B * S token rows) one
    ``kernel_of(linear)`` per linear below 1024 rows (else the
    dequantize-once GEMM), the fused MLP (kernel 9) instead of a fused w8
    gateup/down on "cuda_a8" at up to 64 rows; per decode step the whole-step
    kernel of ``variant`` once (12 for "w8", 13 for "w4", 14 for "w4p" and
    "w8p"), else per layer the attention
    half (kernel 11, ``GANQ_FUSED_LAYER=1``, B <= 8) or the fused qkv
    (kernel 10, ``GANQ_FUSED_QKV``) or the qkv linear, one flash decode
    unless kernel 11 ran, o, and the MLP as for the prompt. A MoE layer's
    experts run the fused expert kernel (15) once for a step of at most 32
    token rows on "cuda_a8" where the layer has its pack (unless
    ``GANQ_MOE_MEGA=0``), else each expert's gate, up and down."""
    import os

    a8 = backend == "cuda_a8"
    fused_layer = os.environ.get("GANQ_FUSED_LAYER", "0") == "1"
    fused_qkv = os.environ.get("GANQ_FUSED_QKV", "0") != "0"
    moe_mega = os.environ.get("GANQ_MOE_MEGA", "") != "0"
    out = {}

    def add(k, n=1):
        out[k] = out.get(k, 0) + n

    def mlp_of(lp, rows):
        mlp = lp.mlp
        if lp.moe is not None:
            if a8 and "mega" in lp.moe and rows <= 32 and moe_mega:
                add("moe_expert_decode")
            elif rows < 1024:
                for e in lp.moe["experts"]:
                    for p in e.values():
                        add(kernel_of(p))
        elif (a8 and "gateup" in mlp and mlp["gateup"].kind == "w8"
                and mlp["down"].kind == "w8" and rows <= 64):
            add("fused_mlp_w8a8")
        elif rows < 1024:
            for p in mlp.values():
                add(kernel_of(p))

    for lp in model.layers:
        rows = B * S
        if rows < 1024:
            for p in lp.attn.values():
                add(kernel_of(p))
        mlp_of(lp, rows)
    steps = new - 1
    if variant:
        add({"w8": "megastep_decode_w8a8", "w4": "megastep4_decode",
             "w4p": "megastep_lowbit_decode",
             "w8p": "megastep_lowbit_decode"}[variant], steps)
        return out
    for _ in range(steps):
        for lp in model.layers:
            w8_mlp = ("gateup" in lp.mlp and lp.mlp["gateup"].kind == "w8"
                      and lp.mlp["down"].kind == "w8")
            if (a8 and fused_layer and B <= 8 and w8_mlp
                    and lp.o_t_w8 is not None and q.cfg.head_dim == 128):
                add("attn_half_decode_w8a8")
                add("fused_mlp_w8a8")
                continue
            for name, p in lp.attn.items():
                if name == "qkv" and a8 and fused_qkv and p.kind == "w8":
                    add("fused_qkv_rope_w8a8")
                else:
                    add(kernel_of(p))
            add("flash_decode")
            mlp_of(lp, B)
    return out


def _serve(q, requests, kernel_of, layout="auto"):
    """``q.generate`` (with ``layout``) for each (batch, prompt, new)
    request with the launch counters set to 0 just before; returns the
    counts read just after, and checks them against the path's
    (:func:`expected_launches` on the model the engine serves)."""
    from ganq_tpu_torch.serve import stacked

    counters = _kernel_counters()
    eng = q._get_engine(layout)
    expected = {k: 0 for k in counters}
    rng = np.random.default_rng(11)
    for c in counters.values():
        c.launches = 0
    for B, S, new in requests:
        variant = (stacked.mega_enabled(q.cfg, eng.model, eng.backend, B,
                                        eng.device) if eng.stacked else None)
        for k, v in expected_launches(q, eng.model, eng.backend, B, S, new,
                                      kernel_of, variant).items():
            expected[k] += v
        ids = rng.integers(0, q.cfg.vocab_size, size=(B, S))
        out = q.generate(ids, max_new_tokens=new, max_seq=S + new,
                         layout=layout)
        if out.shape != (B, new) or out.min() < 0 or out.max() >= q.cfg.vocab_size:
            raise AssertionError(f"bad tokens {out.shape}")
    launches = {k: c.launches for k, c in counters.items()}
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    return launches


def phase_quantize_path(layers: int, solver_backend: str = "auto"):
    """The README quick start on the port, at Llama-3.2-1B's widths with
    ``layers`` layers: dense safetensors directory -> GanqModel.load(dir,
    qcfg) -> quantize(16 rows of 512 tokens) -> save -> GanqModel.load on the
    card -> generate at batch 1 and 8. ``solver_backend="auto"`` runs the
    blocked S-step kernel, ``"pallas"`` the per-column one. Returns the
    kernel launch counts of the whole path (counters set to 0 just before
    it)."""
    from ganq_tpu_torch import GanqModel, QuantizeConfig
    from ganq_tpu_torch.formats.checkpoint import save_dense
    from ganq_tpu_torch.models import hf_import, synthetic
    from ganq_tpu_torch.ops.qlinear import dequantize_weight

    cfg = synthetic.llama_3_2_1b_config(layers=layers)
    qcfg = QuantizeConfig(bits=4, quant_method="ganq", act_sort="asc",
                          l_damp_style="ganq", dead="mean", ganq_iterations=5,
                          codebook_init="kmeans_exact",
                          solver_backend=solver_backend)
    rows = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(16, 512))
    counters = _kernel_counters()
    with tempfile.TemporaryDirectory() as dense_dir, \
            tempfile.TemporaryDirectory() as qdir:
        t0 = time.time()
        with torch.inference_mode():
            dense = synthetic.make_model(cfg, kind="dense", seed=5,
                                         device="cuda", dtype=torch.bfloat16)
        save_dense(dense_dir, hf_import.config_to_hf(cfg), dense)
        del dense
        torch.cuda.empty_cache()
        log(f"quantize path: wrote a dense {layers}-layer Llama-3.2-1B-width "
            f"checkpoint in {time.time() - t0:.1f} s")

        for c in counters.values():
            c.launches = 0
        t0 = time.time()
        g = GanqModel.load(dense_dir, qcfg)
        if g.device.type != "cuda":
            raise AssertionError("GanqModel.load did not select the card")
        t1 = time.time()
        qlog = g.quantize(list(rows))
        torch.cuda.synchronize()
        t_quant = time.time() - t1
        t1 = time.time()
        g.save(qdir)
        t_save = time.time() - t1
        q = GanqModel.load(qdir)
        gen_launches = {}
        outs = []
        for B, S, new in ((1, 128, 32), (8, 128, 16)):
            before = {k: c.launches for k, c in counters.items()}
            ids = rows[:B, :S]
            t1 = time.time()
            out = q.generate(ids, max_new_tokens=new, max_seq=256)
            dt = time.time() - t1
            if out.shape != (B, new) or out.min() < 0 or out.max() >= cfg.vocab_size:
                raise AssertionError(f"quantize path: bad tokens {out.shape}")
            outs.append(out)
            gen_launches[B] = {k: c.launches - before[k] for k, c in counters.items()}
            log(f"quantize path: generate batch {B} prompt {S} new {new}: "
                f"{dt * 1e3:.1f} ms, first tokens {out[0, :6].tolist()}")
        launches = {k: c.launches for k, c in counters.items()}
        t_path = time.time() - t0

        # every module: finite loss and codebook; the S-step ran through
        # kernel 3 once per iteration, plus each fallback pass
        modules = len(qlog)
        fallbacks = sum(bool(e.extra["fallback"]) for e in qlog)
        expected = modules * qcfg.ganq_iterations + fallbacks
        arts = g._quant_output.artifacts
        bad = [n for n, a in arts.items() if not bool(torch.isfinite(a.lut).all())]
        bad += [f"{e.layer}.{e.module}" for e in qlog if not math.isfinite(e.loss)]
        if modules != 7 * layers or bad:
            raise AssertionError(f"quantize path: {modules} modules, "
                                 f"non-finite: {bad}")
        ran, idle = (("s_step_blocked", "s_step") if solver_backend == "auto"
                     else ("s_step", "s_step_blocked"))
        if (launches[ran] != expected or launches[idle] != 0
                or min(gen_launches[8]["lut_matmul"],
                       gen_launches[8]["flash_decode"]) == 0):
            raise AssertionError(f"quantize path launches {launches}, "
                                 f"expected {expected} {ran} S-steps")

        # the saved checkpoint reproduces the fake-quantized weights: the
        # codebook is rounded to fp16 (2^-11 relative, 2^-25 absolute below
        # fp16's normal range) and then to bf16 (2^-8 relative), so each
        # weight stays within (2^-8 + 2^-10) |w| + 2^-24 of its value
        worst = 0.0
        for li in range(layers):
            for slot in ("attn.q", "attn.k", "attn.v", "attn.o", "mlp.gate",
                         "mlp.up", "mlp.down"):
                fake = hf_import.get_module(g.model, li, slot)["weight"].float()
                packed = dequantize_weight(hf_import.get_module(q.model, li, slot))
                ratio = (packed - fake).abs() / ((2.0**-8 + 2.0**-10) * fake.abs()
                                                 + 2.0**-24)
                worst = max(worst, float(ratio.max()))
        if worst > 1.0:
            raise AssertionError(f"saved weights differ from the fake-quantized "
                                 f"ones by {worst:.3f} of the tolerance")
        from ganq_tpu_torch.models.transformer import forward
        ids = torch.as_tensor(rows[:2, :64], device="cuda")
        with torch.inference_mode():
            a = forward(q.cfg, q.model, ids, q.backend).float()
            b = forward(g.cfg, g.model, ids, "reference").float()
        rel_l2 = float((a - b).norm() / b.norm())
        log(f"quantize path: saved weights within {worst:.3f} of the "
            f"tolerance (2^-8 + 2^-10) |w| + 2^-24 of the fake-quantized "
            f"ones; logits "
            f"of the loaded checkpoint "
            f"(cuda backend) vs the fake-quantized model: rel_l2={rel_l2:.3e} "
            f"(tol 5e-2)")
        if not bool(torch.isfinite(a).all()) or rel_l2 > 5e-2:
            raise AssertionError("loaded checkpoint disagrees with the "
                                 "fake-quantized model")

    split = {}
    for e in qlog:
        if e.layer == 0:
            for k, v in e.extra.items():
                if k != "fallback":
                    split[k] = split.get(k, 0.0) + v
    per_layer = {li: sum(e.duration for e in qlog if e.layer == li)
                 for li in range(layers)}
    log(f"quantize path ({solver_backend}): quantize {t_quant:.1f} s for "
        f"{layers} layers "
        f"({t_quant / layers:.2f} s per layer, module time per layer "
        f"{[round(v, 2) for v in per_layer.values()]}); layer 0 split (s): "
        + json.dumps({k: round(v, 4) for k, v in split.items()})
        + f"; save {t_save:.1f} s; whole path {t_path:.1f} s")
    log(f"quantize path ({solver_backend}) launches: {launches} (S-step "
        f"expected {expected}: "
        f"{modules} modules x {qcfg.ganq_iterations} iterations + "
        f"{fallbacks} fallback passes); during generate {gen_launches}")
    return launches


def phase_gptq_path(layers: int, desc_act: bool, backends=(None,)):
    """The GPTQ quick start at Llama-3.2-1B's widths with ``layers`` layers:
    dense safetensors directory -> GanqModel.load(dir, QuantizeConfig(
    desc_act=...)) (GPTQ W4, group 128, sym) -> quantize(16 rows of 512) ->
    save (GPTQ v1) -> GanqModel.load(dir, backend=b) for each b of
    ``backends`` (None: the auto choice, which must be "cuda_a8") ->
    generate at batch 1 (prompt 128 + 32) and 8 (+ 16), then a teacher-forced
    step against the reference backend. With desc_act the permuted g_idx
    sends every linear through the a8 gate's full-precision route (kernel
    5); without it the auto backend runs kernel 6, and "cuda" kernel 5.
    Returns the launch counts of each generate phase."""
    from ganq_tpu_torch import GanqModel, QuantizeConfig
    from ganq_tpu_torch.formats.checkpoint import save_dense
    from ganq_tpu_torch.models import hf_import, synthetic
    cfg = synthetic.llama_3_2_1b_config(layers=layers)
    qcfg = QuantizeConfig(desc_act=desc_act)
    if qcfg.quant_method != "gptq" or qcfg.bits != 4 or qcfg.group_size != 128:
        raise AssertionError(f"QuantizeConfig() is not GPTQ W4 g128: {qcfg}")
    rows = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(16, 512))
    results = []
    with tempfile.TemporaryDirectory() as dense_dir, \
            tempfile.TemporaryDirectory() as qdir:
        with torch.inference_mode():
            dense = synthetic.make_model(cfg, kind="dense", seed=6,
                                         device="cuda", dtype=torch.bfloat16)
        save_dense(dense_dir, hf_import.config_to_hf(cfg), dense)
        del dense
        torch.cuda.empty_cache()
        g = GanqModel.load(dense_dir, qcfg)
        t0 = time.time()
        qlog = g.quantize(list(rows))
        torch.cuda.synchronize()
        t_quant = time.time() - t0
        g.save(qdir)
        bad = [f"{e.layer}.{e.module}" for e in qlog if not math.isfinite(e.loss)]
        if len(qlog) != 7 * layers or bad:
            raise AssertionError(f"GPTQ path: {len(qlog)} modules, "
                                 f"non-finite losses: {bad}")
        split = {}
        for e in qlog:
            for k, v in e.extra.items():
                split[k] = split.get(k, 0.0) + v / layers
        per_layer = [round(sum(e.duration for e in qlog if e.layer == li), 3)
                     for li in range(layers)]
        log(f"GPTQ path (desc_act={desc_act}): quantize {t_quant:.2f} s for "
            f"{layers} layers ({t_quant / layers:.3f} s per layer; module "
            f"time per layer {per_layer}); mean split per layer (s): "
            + json.dumps({k: round(v, 4) for k, v in split.items()})
            + f"; losses {min(e.loss for e in qlog):.4g} .. "
            f"{max(e.loss for e in qlog):.4g}")
        del g
        torch.cuda.empty_cache()
        for backend in backends:
            q = GanqModel.load(qdir, dtype=torch.bfloat16, backend=backend)
            if backend is None and q.backend != "cuda_a8":
                raise AssertionError(f"GPTQ checkpoint selected {q.backend}")

            t0 = time.time()
            launches = _serve(q, ((1, 128, 32), (8, 128, 16)),
                              kernel_of_linear(q.backend))
            log(f"GPTQ path (desc_act={desc_act}) backend={q.backend}: "
                f"generate in {time.time() - t0:.2f} s, launches {launches}")
            phase_reference_check(q, f"GPTQ desc_act={desc_act} {q.backend}")
            results.append(launches)
            del q
            torch.cuda.empty_cache()
    return results


def kernel_of_linear(backend):
    """The kernel a quantized linear runs on ``backend`` below 1024 token
    rows (``ops/qlinear.apply`` and the a8 gates)."""
    from ganq_tpu_torch.ops.uniform_matmul import a8_eligible
    from ganq_tpu_torch.ops.w8_matmul import w8a8_eligible

    def kernel_of(p):
        if p.kind == "lut":
            return "lut_matmul"
        if p.kind == "w8":
            if backend == "cuda_a8" and w8a8_eligible(
                    p.in_features, p["w8"].shape[0], p["w8"].shape[1]):
                return "w8a8_matmul"
            return "w8_matmul"
        if backend == "cuda_a8" and a8_eligible(
                p.in_features, p["qweight"].shape[0], p["scales"].shape[1],
                p["g_idx"] if "g_idx" in p else None, p.bits):
            return "uniform_a8_matmul"
        return "uniform_matmul"

    return kernel_of


def phase_optimize_path(ckpt_dir: str):
    """``optimize()`` on phase 4's 16-layer lut checkpoint: "w8" under the
    auto backend (cuda_a8: the engine's stacked layout runs the fused W8A8
    MLP, kernel 9, at these batches and kernel 8 for qkv and o; Llama-3.2-1B's
    head_dim of 64 keeps it off the whole-step megastep) and under "cuda"
    (kernel 7); "auto" (uniform 8-bit: kernel 6); then a 16-layer
    ``lut_affine_sym`` model served without optimize(), which the engine
    certifies into uniform 4-bit linears (kernel 5). Each run's
    teacher-forced step is held against the reference backend. Returns the
    launch counts of each run."""
    from ganq_tpu_torch import GanqModel
    from ganq_tpu_torch.models import synthetic

    requests = ((1, 128, 16), (8, 64, 8))
    results = []
    for recode, backend, kind in (("w8", None, "w8"), ("w8", "cuda", "w8"),
                                  ("auto", None, "uniform")):
        q = GanqModel.load(ckpt_dir, dtype=torch.bfloat16)
        t0 = time.time()
        q.optimize(recode)
        torch.cuda.synchronize()
        t_opt = time.time() - t0
        kinds = {(p.kind, p.bits) for lp in q.model.layers
                 for p in list(lp.attn.values()) + list(lp.mlp.values())}
        if q.backend != "cuda_a8" or {k for k, _ in kinds} != {kind}:
            raise AssertionError(f"optimize({recode!r}): backend {q.backend}, "
                                 f"kinds {kinds}")
        if backend is not None:
            q.backend = backend
        launches = _serve(q, requests, kernel_of_linear(q.backend))
        if recode == "w8" and q.backend == "cuda_a8" and not launches[
                "fused_mlp_w8a8"]:
            raise AssertionError("optimize('w8') on cuda_a8 ran no fused MLP")
        log(f"optimize({recode!r}) in {t_opt:.2f} s -> {sorted(kinds)}, "
            f"backend {q.backend}: launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        phase_reference_check(q, f"optimize({recode!r}) {q.backend}")
        results.append(launches)
        del q
        torch.cuda.empty_cache()

    cfg = synthetic.llama_3_2_1b_config()
    with torch.inference_mode():
        model = synthetic.make_model(cfg, kind="lut_affine_sym", seed=3,
                                     device="cuda", dtype=torch.bfloat16)
    q = GanqModel(cfg, model)
    if q.backend != "cuda":
        raise AssertionError(f"lut_affine_sym model selected {q.backend}")
    served = q._get_engine().model
    kinds = {(p.kind, "zeros" in p) for lp in served.layers
             for p in list(lp.attn.values()) + list(lp.mlp.values())}
    if kinds != {("uniform", False)}:
        raise AssertionError(f"the engine did not certify the affine "
                             f"codebooks: {kinds}")
    launches = _serve(q, requests, lambda p: "uniform_matmul")
    log(f"lut_affine_sym served without optimize(): engine certified every "
        f"linear to symmetric uniform 4-bit; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    phase_reference_check(q, "certified lut_affine_sym cuda")
    results.append(launches)
    return results


def _request_env(env):
    """Set the environment switches of a request; returns the saved ones."""
    import os

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    return saved


def _restore_env(saved):
    import os

    for k, v in saved.items():
        if v is None:
            os.environ.pop(k)
        else:
            os.environ[k] = v


def _run_requests(q, label, requests, rng, want_variant=None):
    """Each (name, batch, prompt, new, env) request through ``q.generate``
    with the launch counters set to 0 just before and read just after; the
    counts must equal the path's (``expected_launches``) and, when given,
    the whole-step variant ``want_variant``; each is followed by a
    teacher-forced step against the reference backend. Returns
    {name: launches}."""
    from ganq_tpu_torch.serve import stacked

    cfg = q.cfg
    counters = _kernel_counters()
    eng = q._get_engine()
    kernel_of = kernel_of_linear(q.backend)
    out = {}
    for name, B, S, new, env in requests:
        saved = _request_env(env)
        try:
            variant = stacked.mega_enabled(cfg, eng.model, eng.backend, B,
                                           eng.device)
            if want_variant and variant != want_variant:
                raise AssertionError(f"{label} request {name}: variant "
                                     f"{variant}, not {want_variant}")
            want = expected_launches(q, eng.model, eng.backend, B, S, new,
                                     kernel_of, variant)
            ids = rng.integers(0, cfg.vocab_size, size=(B, S))
            for c in counters.values():
                c.launches = 0
            t0 = time.time()
            toks = q.generate(ids, max_new_tokens=new, max_seq=S + new)
            dt = time.time() - t0
            got = {k: c.launches for k, c in counters.items() if c.launches}
            if got != {k: v for k, v in want.items() if v}:
                raise AssertionError(f"{label} request {name}: launches "
                                     f"{got}, expected {want}")
            if (toks.shape != (B, new) or toks.min() < 0
                    or toks.max() >= cfg.vocab_size):
                raise AssertionError(f"{label} request {name}: bad tokens")
            log(f"{label} request ({name}) batch {B} prompt {S} + {new} "
                f"{env or ''}: variant {variant}, {dt * 1e3:.1f} ms, "
                f"launches {got}")
            out[name] = got
            phase_reference_check(q, f"{label} request ({name})", batch=B)
        finally:
            _restore_env(saved)
    return out


def _decode_ms(q, label, shapes, rng, env=None, layouts=("auto", "perlayer")):
    """Decode ms per step (host clock, best of two, runs in turns a, b, b,
    a): the difference between a request of ``new`` tokens and one of 1,
    over new - 1 steps, for each layout. Returns {batch: {layout: ms}}."""
    out = {}
    saved = _request_env(env or {})
    try:
        for B, S, new in shapes:
            ids = rng.integers(0, q.cfg.vocab_size, size=(B, S))
            per = {}
            for layout in layouts + layouts[::-1]:
                t0 = time.time()
                q.generate(ids, max_new_tokens=1, max_seq=S + new,
                           layout=layout)
                t1 = time.time()
                q.generate(ids, max_new_tokens=new, max_seq=S + new,
                           layout=layout)
                t2 = time.time()
                per.setdefault(layout, []).append(
                    ((t2 - t1) - (t1 - t0)) / (new - 1) * 1e3)
            out[B] = {k: min(v) for k, v in per.items()}
            log(f"{label}: decode ms per step at batch {B} (prompt {S}, "
                f"{new - 1} steps, host clock, best of 2) {env or ''}: "
                + ", ".join(f"{k} {min(v):.3f} (runs "
                            f"{[round(x, 3) for x in v]})"
                            for k, v in per.items()))
    finally:
        _restore_env(saved)
    return out


def _save_uniform_w4(cfg, ckpt, asym=False, actorder=False, seed=8):
    """A random uniform W4 g128 model at ``cfg``
    (``synthetic.make_model(kind="uniform")``) saved as a GPTQ v1
    checkpoint from artifacts of its own codes and scales: symmetric, or
    with random integer zero points in [4, 12] (``asym``, a ``sym=False``
    checkpoint) and a balanced permuted g_idx (``actorder``, a
    ``desc_act=True`` one: each layer's columns shuffled by one permutation
    per shared input, g_idx recording each column's group)."""
    from ganq_tpu_torch import QuantizeConfig
    from ganq_tpu_torch.core.config import QUANT_METHOD
    from ganq_tpu_torch.formats.checkpoint import save_quantized
    from ganq_tpu_torch.models import hf_import, synthetic
    from ganq_tpu_torch.models.registry import get_spec
    from ganq_tpu_torch.ops.packing import unpack_int_rows
    from ganq_tpu_torch.quant.looper import QuantizedModule

    qcfg = QuantizeConfig(desc_act=actorder, sym=not asym)
    gen = torch.Generator().manual_seed(seed)
    shared = {"self_attn.q_proj": "h", "self_attn.k_proj": "h",
              "self_attn.v_proj": "h", "self_attn.o_proj": "o",
              "mlp.gate_proj": "g", "mlp.up_proj": "g", "mlp.down_proj": "d"}
    with torch.inference_mode():
        model = synthetic.make_model(cfg, kind="uniform", bits=4, seed=seed,
                                     device="cuda", dtype=torch.bfloat16)
        spec = get_spec("llama")
        arts = {}
        for i in range(len(model.layers)):
            perms = {}
            for mod, slot in spec.module_slots.items():
                p = hf_import.get_module(model, i, slot)
                n = p.in_features
                scale = p["scales"].cpu()
                qidx = unpack_int_rows(p["qweight"], 4, n).to(torch.uint8).cpu()
                g_idx = torch.arange(n, dtype=torch.int32) // 128
                if actorder:
                    perm = perms.setdefault(shared[mod],
                                            torch.randperm(n, generator=gen))
                    qidx, g_idx = qidx[:, perm], g_idx[perm]
                zero = torch.full_like(scale, 8.0)
                if asym:
                    zero = torch.randint(4, 13, scale.shape, generator=gen
                                         ).to(torch.float32)
                arts[f"{spec.layers_prefix}.{i}.{mod}"] = QuantizedModule(
                    method=QUANT_METHOD.GPTQ, bits=4, group_size=128,
                    qidx=qidx, scale=scale, zero=zero, g_idx=g_idx)
    save_quantized(ckpt, hf_import.config_to_hf(cfg), qcfg, model,
                   artifacts=arts)
    del model, arts
    torch.cuda.empty_cache()


def phase_3b_path():
    """The stacked int8 path at Llama-3.2-3B's published widths (28 layers,
    head_dim 128): a random 4-bit ``lut`` model saved with the port's writer,
    ``GanqModel.load`` on the card, ``optimize("w8")`` and requests on the
    auto backend "cuda_a8" with the default layout. Each request counts its
    launches from 0 and must match the path's exactly: (a) batch 1 and (b)
    batch 8 decode through the megastep (kernel 12), one launch a step; (c)
    batch 16 layer by layer (kernels 8, 2 and 9); (d) batch 1 with
    ``GANQ_MEGASTEP=0 GANQ_FUSED_LAYER=1`` (kernel 9 in the prompt, kernels
    11 and 9 in decode); (e) batch 16 with ``GANQ_FUSED_QKV=1`` (kernel 10).
    Each is followed by a teacher-forced step against the reference
    backend. Decode ms per step at batch 1 and 8 is measured through the
    megastep and through ``layout="perlayer"`` on the same model. Then the
    same checkpoint's ``optimize()`` (uniform 8-bit, 128-column groups) is
    served through kernel 14's "w8p" variant at batch 1, 8, 16 and 64, one
    launch a decode step, and a symmetric uniform W4 g128 model (saved as
    GPTQ v1, loaded) through "w4p" at batch 1 and 16 and through kernel 13
    with ``GANQ_W4_PLANE=0`` at batch 1 and 8, with their decode ms per
    step against ``layout="perlayer"``. Returns the launch counts of every
    request (``runs``) and the decode times."""
    from ganq_tpu_torch import GanqModel, QuantizeConfig
    from ganq_tpu_torch.formats.checkpoint import save_quantized
    from ganq_tpu_torch.models import hf_import, synthetic

    cfg = synthetic.llama_3_2_3b_config()
    results = {"runs": []}
    rng = np.random.default_rng(9)
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.time()
        with torch.inference_mode():
            model = synthetic.make_model(cfg, kind="lut", bits=4, seed=7,
                                         device="cuda", dtype=torch.bfloat16)
        save_quantized(ckpt, hf_import.config_to_hf(cfg),
                       QuantizeConfig(bits=4, quant_method="ganq"), model)
        del model
        torch.cuda.empty_cache()
        t1 = time.time()
        q = GanqModel.load(ckpt, dtype=torch.bfloat16)
        t2 = time.time()
        q.optimize("w8")
        eng = q._get_engine()
        torch.cuda.synchronize()
        log(f"3B path: built+saved the 28-layer Llama-3.2-3B lut checkpoint "
            f"in {t1 - t0:.1f} s, loaded in {t2 - t1:.1f} s, optimize('w8') "
            f"and the engine's stacking and megapack in {time.time() - t2:.1f}"
            f" s; backend {q.backend}, stacked {eng.stacked}, megapack "
            f"{getattr(eng.model, 'megapack_w8', None) is not None}; device "
            f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        if q.backend != "cuda_a8" or not eng.stacked:
            raise AssertionError("the 3B w8 model is not on the stacked "
                                 "cuda_a8 path")
        q.generate(rng.integers(0, cfg.vocab_size, size=(1, 16)),
                   max_new_tokens=3, max_seq=32)                  # warm-up
        runs = _run_requests(q, "3B w8", (
            ("a", 1, 128, 32, {}), ("b", 8, 64, 16, {}), ("c", 16, 32, 8, {}),
            ("d", 1, 48, 4, {"GANQ_MEGASTEP": "0", "GANQ_FUSED_LAYER": "1"}),
            ("e", 16, 32, 4, {"GANQ_FUSED_QKV": "1"})), rng)
        results["runs"] += list(runs.values())
        results["decode_w8"] = _decode_ms(
            q, "3B w8 (kernel 12 / perlayer)", ((1, 128, 32), (8, 64, 16)),
            rng)
        del q, eng
        torch.cuda.empty_cache()

        # optimize(): uniform 8-bit, whose whole step is kernel 14's "w8p"
        t0 = time.time()
        q = GanqModel.load(ckpt, dtype=torch.bfloat16).optimize()
        q._get_engine()
        torch.cuda.synchronize()
        log(f"3B optimize(): loaded, recoded, stacked and packed in "
            f"{time.time() - t0:.1f} s; backend {q.backend}; device memory "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        q.generate(rng.integers(0, cfg.vocab_size, size=(1, 16)),
                   max_new_tokens=3, max_seq=32)                  # warm-up
        runs = _run_requests(q, "3B optimize()", (
            ("w8p_b1", 1, 128, 32, {}), ("w8p_b8", 8, 64, 16, {}),
            ("w8p_b16", 16, 32, 8, {}), ("w8p_b64", 64, 32, 8, {})), rng,
            want_variant="w8p")
        results["runs"] += list(runs.values())
        results["decode_w8p"] = _decode_ms(
            q, "3B optimize() (kernel 14 w8p / perlayer)",
            ((1, 128, 32), (8, 64, 16)), rng)
        del q
        torch.cuda.empty_cache()

    # a symmetric uniform W4 g128 model: kernel 14's "w4p", and kernel 13
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.time()
        _save_uniform_w4(cfg, ckpt)
        t1 = time.time()
        q = GanqModel.load(ckpt, dtype=torch.bfloat16)
        q._get_engine()
        torch.cuda.synchronize()
        log(f"3B sym W4: built+saved (GPTQ v1) in {t1 - t0:.1f} s, loaded, "
            f"stacked and packed in {time.time() - t1:.1f} s; backend "
            f"{q.backend}; device memory "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        if q.backend != "cuda_a8":
            raise AssertionError(f"the sym W4 model selected {q.backend}")
        q.generate(rng.integers(0, cfg.vocab_size, size=(1, 16)),
                   max_new_tokens=3, max_seq=32)                  # warm-up
        runs = _run_requests(q, "3B sym W4", (
            ("w4p_b1", 1, 128, 32, {}), ("w4p_b16", 16, 32, 8, {})), rng,
            want_variant="w4p")
        results["runs"] += list(runs.values())
        runs = _run_requests(q, "3B sym W4", (
            ("w4_b1", 1, 128, 32, {"GANQ_W4_PLANE": "0"}),
            ("w4_b8", 8, 64, 16, {"GANQ_W4_PLANE": "0"})), rng,
            want_variant="w4")
        results["runs"] += list(runs.values())
        results["decode_w4p"] = _decode_ms(
            q, "3B sym W4 (kernel 14 w4p / perlayer)",
            ((1, 128, 32), (8, 64, 16)), rng)
        results["decode_w4"] = _decode_ms(
            q, "3B sym W4 (kernel 13)", ((1, 128, 32), (8, 64, 16)), rng,
            env={"GANQ_W4_PLANE": "0"}, layouts=("auto",))
        del q
        torch.cuda.empty_cache()
    return results


EIGHT_B_LAYERS = 8                 # depth of the 8B path (see PERF.md)
MIXTRAL_LAYERS = 4                 # depth of the Mixtral path (see PERF.md)


def phase_8b_path():
    """A ``sym=False``, ``desc_act=True`` GPTQ W4 g128 checkpoint (random
    codes, integer zero points, a balanced permuted g_idx) at Llama-3.1-8B's
    published widths, EIGHT_B_LAYERS of its 32 layers, saved as GPTQ v1 and
    loaded: the engine bakes the act-order artifacts into kernel 14's pack
    and carries the zero-point corrections, and requests at batch 1 and 16
    decode through "w4p", one launch a step (their launches exact, a
    teacher-forced step against the reference backend); decode ms per step
    at batch 1 against ``layout="perlayer"``."""
    from ganq_tpu_torch import GanqModel
    from ganq_tpu_torch.models import synthetic

    cfg = synthetic.llama_3_1_8b_config(EIGHT_B_LAYERS)
    rng = np.random.default_rng(13)
    results = {}
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.time()
        _save_uniform_w4(cfg, ckpt, asym=True, actorder=True, seed=14)
        t1 = time.time()
        q = GanqModel.load(ckpt, dtype=torch.bfloat16)
        eng = q._get_engine()
        torch.cuda.synchronize()
        mp = getattr(eng.model, "megapack_lb", None)
        log(f"8B asym act-order W4: built+saved (GPTQ v1, {EIGHT_B_LAYERS} "
            f"layers) in {t1 - t0:.1f} s, loaded, stacked and packed in "
            f"{time.time() - t1:.1f} s; backend {q.backend}, stacked "
            f"{eng.stacked}, pack operands "
            f"{sorted(k for k in (mp or {}) if k[-3:] == '_sz' or k[:3] == 'ap_')}"
            f"; device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        if (q.backend != "cuda_a8" or not eng.stacked or mp is None
                or not {"qkv_sz", "ap_q", "ap_g", "ap_o"} <= set(mp)):
            raise AssertionError("the 8B asym act-order model is not on "
                                 "kernel 14's zero-point act-order path")
        q.generate(rng.integers(0, cfg.vocab_size, size=(1, 16)),
                   max_new_tokens=3, max_seq=32)                  # warm-up
        results["runs"] = list(_run_requests(q, "8B asym act-order W4", (
            ("w4p_zp_ao_b1", 1, 128, 32, {}),
            ("w4p_zp_ao_b16", 16, 32, 8, {})), rng,
            want_variant="w4p").values())
        results["decode_8b_w4p"] = _decode_ms(
            q, "8B asym act-order W4 (kernel 14 w4p / perlayer)",
            ((1, 128, 32),), rng)
        del q, eng, mp
        torch.cuda.empty_cache()
    return results


def phase_mixtral_path():
    """A random 4-bit GANQ ``lut`` model at Mixtral-8x7B's published widths
    (MIXTRAL_LAYERS of its 32 layers, 8 experts, top-2), saved with the
    port's writer (experts under the HF names, the router dense), loaded
    and ``optimize()``d: the experts recoded to uniform 8-bit and each MoE
    layer given kernel 15's pack. MoE models are served per layer: requests
    at batch 1, 8 and 32 (prompts of more than 32 token rows, so that the
    prefill runs every expert through kernel 6) decode with one kernel 15
    launch per layer per step beside kernels 6 (q/k/v/o) and 2 (attention),
    and batch 1 with ``GANQ_MOE_MEGA=0`` through the masked per-expert loop
    (kernel 6 for every expert) as the yardstick; launches exact, each
    followed by a teacher-forced step against the reference backend.
    Decode ms per step at batch 1 with and without kernel 15."""
    from ganq_tpu_torch import GanqModel, QuantizeConfig
    from ganq_tpu_torch.formats.checkpoint import save_quantized
    from ganq_tpu_torch.models import hf_import, synthetic

    cfg = synthetic.mixtral_8x7b_config(MIXTRAL_LAYERS)
    rng = np.random.default_rng(15)
    results = {}
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.time()
        with torch.inference_mode():
            model = synthetic.make_model(cfg, kind="lut", bits=4, seed=16,
                                         device="cuda", dtype=torch.bfloat16)
        save_quantized(ckpt, hf_import.config_to_hf(cfg),
                       QuantizeConfig(bits=4, quant_method="ganq"), model)
        del model
        torch.cuda.empty_cache()
        t1 = time.time()
        q = GanqModel.load(ckpt, dtype=torch.bfloat16)
        t2 = time.time()
        q.optimize()
        eng = q._get_engine()
        torch.cuda.synchronize()
        packed = [lp.moe is not None and "mega" in lp.moe
                  for lp in eng.model.layers]
        log(f"Mixtral: built+saved the {MIXTRAL_LAYERS}-layer Mixtral-8x7B "
            f"lut checkpoint in {t1 - t0:.1f} s, loaded in {t2 - t1:.1f} s, "
            f"optimize() (recode and kernel 15 packs) in "
            f"{time.time() - t2:.1f} s; backend {q.backend}, stacked "
            f"{eng.stacked}, packed layers {sum(packed)}; device memory "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        if q.backend != "cuda_a8" or eng.stacked or not all(packed):
            raise AssertionError("the Mixtral model is not on the per-layer "
                                 "cuda_a8 path with kernel 15's packs")
        q.generate(rng.integers(0, cfg.vocab_size, size=(1, 40)),
                   max_new_tokens=3, max_seq=64)                  # warm-up
        results["runs"] = list(_run_requests(q, "Mixtral", (
            ("moe_b1", 1, 64, 16, {}), ("moe_b8", 8, 16, 8, {}),
            ("moe_b32", 32, 8, 6, {}),
            ("masked_b1", 1, 64, 8, {"GANQ_MOE_MEGA": "0"})), rng).values())
        results["decode_mixtral"] = _decode_ms(
            q, "Mixtral (kernel 15)", ((1, 64, 16),), rng, layouts=("auto",))
        results["decode_mixtral_masked"] = _decode_ms(
            q, "Mixtral (GANQ_MOE_MEGA=0, masked expert loop)",
            ((1, 64, 16),), rng, env={"GANQ_MOE_MEGA": "0"},
            layouts=("auto",))
        del q, eng
        torch.cuda.empty_cache()
    return results


def main() -> int:
    t_start = time.time()
    smi = phase_environment()
    phase_build()
    kernels = phase_kernels()
    ckpt = tempfile.TemporaryDirectory()
    try:
        q, launches, _ = phase_main_path(ckpt.name)
        phase_reference_check(q)
        del q
        torch.cuda.empty_cache()
        # the default S-step (kernel 3) on the README path; then the same
        # path with solver_backend="pallas" (kernel 4) at a cut depth
        launches["s_step_blocked"] = phase_quantize_path(
            QUANTIZE_LAYERS)["s_step_blocked"]
        launches["s_step"] = phase_quantize_path(
            PALLAS_PATH_LAYERS, "pallas")["s_step"]
        # GPTQ (kernels 5 and 6), then optimize() and the engine's affine
        # certification (kernels 5-8); each run counts from 0
        runs = phase_gptq_path(GPTQ_LAYERS, desc_act=True)
        runs += phase_gptq_path(GPTQ_SIDE_LAYERS, desc_act=False,
                                backends=(None, "cuda"))
        runs += phase_optimize_path(ckpt.name)
    finally:
        ckpt.cleanup()
    # the stacked paths at Llama-3.2-3B (kernels 6 and 8-14)
    three_b = phase_3b_path()
    runs += three_b["runs"]
    # kernel 14 with zero points and act-order at Llama-3.1-8B widths, then
    # Mixtral through kernel 15 (with kernels 6 and 2 around it)
    eight_b = phase_8b_path()
    runs += eight_b["runs"]
    mixtral = phase_mixtral_path()
    runs += mixtral["runs"]
    for name in ("uniform_matmul", "uniform_a8_matmul", "w8_matmul",
                 "w8a8_matmul", "fused_mlp_w8a8", "fused_qkv_rope_w8a8",
                 "attn_half_decode_w8a8", "megastep_decode_w8a8",
                 "megastep4_decode", "megastep_lowbit_decode",
                 "moe_expert_decode"):
        launches[name] = sum(r.get(name, 0) for r in runs)
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on its paths")
    src = {"lut_matmul": ("ganq_tpu_torch/csrc/lut_matmul.cu",
                          "ganq_tpu/ops/lut_matmul.py:129"),
           "flash_decode": ("ganq_tpu_torch/csrc/flash_decode.cu",
                            "ganq_tpu/ops/fused_attention.py:343"),
           "s_step_blocked": ("ganq_tpu_torch/csrc/ganq_sstep.cu",
                              "ganq_tpu/ops/ganq_solver.py:306"),
           "s_step": ("ganq_tpu_torch/csrc/ganq_sstep.cu",
                      "ganq_tpu/ops/ganq_solver.py:142"),
           "uniform_matmul": ("ganq_tpu_torch/csrc/uniform_matmul.cu",
                              "ganq_tpu/ops/uniform_matmul.py:100"),
           "uniform_a8_matmul": ("ganq_tpu_torch/csrc/uniform_matmul.cu",
                                 "ganq_tpu/ops/uniform_matmul.py:244"),
           "w8_matmul": ("ganq_tpu_torch/csrc/w8_matmul.cu",
                         "ganq_tpu/ops/w8_matmul.py:86"),
           "w8a8_matmul": ("ganq_tpu_torch/csrc/w8_matmul.cu",
                           "ganq_tpu/ops/w8_matmul.py:146"),
           "fused_mlp_w8a8": ("ganq_tpu_torch/csrc/w8a8_fused.cu",
                              "ganq_tpu/ops/fused_mlp.py:143"),
           "fused_qkv_rope_w8a8": ("ganq_tpu_torch/csrc/w8a8_fused.cu",
                                   "ganq_tpu/ops/fused_attention.py:172"),
           "attn_half_decode_w8a8": ("ganq_tpu_torch/csrc/w8a8_fused.cu",
                                     "ganq_tpu/ops/fused_layer.py:340"),
           "megastep_decode_w8a8": ("ganq_tpu_torch/csrc/megastep_w8.cu",
                                    "ganq_tpu/ops/megastep.py:380"),
           "megastep4_decode": ("ganq_tpu_torch/csrc/megastep4.cu",
                                "ganq_tpu/ops/megastep4.py:495"),
           "megastep_lowbit_decode": (
               "ganq_tpu_torch/csrc/megastep_lowbit.cu",
               "ganq_tpu/ops/megastep_lowbit.py:1390"),
           "moe_expert_decode": ("ganq_tpu_torch/csrc/moe_expert.cu",
                                 "ganq_tpu/ops/moe_expert.py:195")}
    line = {"kernels": [
        {"name": k["name"], "route": "cuda", "source": src[k["name"]][0],
         "replaces": src[k["name"]][1], "launches": launches[k["name"]],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k["library_ms"],
         **{x: k[x] for x in ("agreement", "yardstick_ms", "ms_b8",
                              "bound_ms_b8", "by_case") if x in k},
         "shape": k["shape"]} for k in kernels]}
    log("decode ms per step (host clock): " + json.dumps(
        {k: v for d in (three_b, eight_b, mixtral) for k, v in d.items()
         if k.startswith("decode_")}))
    log(f"card: {smi}; wall {time.time() - t_start:.1f} s")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
