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
   1 (``lut`` linears), 5-6 (uniform linears) and 7-8 (int8 linears) run at
   batch 1, 8, 128 and 512; their library yardstick is a bf16 matmul on the
   dequantized weight. Kernels 9-12 (the
   fused W8A8 MLP, norm + qkv + rope, attention half and whole decode step)
   run at the Llama-3.2-3B shapes, batch 1 and 8 (and 64 for 9 and 10);
   the group-scaled whole decode steps, kernel 14 ("w4p", "w8p", "w3",
   "w2" and "wl8") at batch 1, 8 and 64 and kernel 13 at batch 1 and 8,
   over 28 Llama-3.2-3B layers.
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
10. an 8B-width asym act-order W4 GPTQ model through kernel 14 "w4p";
11. a Mixtral-8x7B-width model through kernel 15;
12. continuous batching per layer on phase 4's checkpoint (kernel 1 at a
    vector of per-slot positions), against the static engine's tokens;
13. continuous batching through kernel 14 with the trailing-unembed lm
    fold at Llama-3.1-8B widths (``phase_batching_path``: 12 requests on
    8 slots, one launch a decode step, the folded logits against the
    reference backend and the unfolded step, step ms at 1/8/16 slots,
    tokens/s), then ``GanqModel.serve(use_batching=True)`` over HTTP;
14. EoRA adapters at Llama-3.1-8B widths (``phase_eora_path``): GPTQ W4
    with adapters (``QuantizeConfig(adapter={"rank": 64})``) through kernel
    14 "w4p" with zero points, act-order and the EoRA epilogue; a ``lut``
    checkpoint's post-quant ``eora_generate`` (seconds a layer by part,
    the logits' error to the dense model with and without adapters),
    ``optimize()`` and "w8p" with the epilogue; the batching engine with the
    epilogue and the lm fold.
15. Qwen3 at Qwen3-8B widths (``phase_qwen3_path``): a dense model, GANQ
    W4 quantize (kernel 3), save ``lut``, load, ``optimize()``, requests at
    batch 1, 8 and 64 through kernel 14 "w8p" with the qk-norm rows
    ``qk_nm``, then the batching engine with them and the lm fold;
16. InternLM at InternLM-7B widths (``phase_internlm_path``): a dense
    model with q/k/v/o biases, GPTQ sym W4 g128, save (v1), load, requests
    at batch 1 and 16 through "w4p" with ``o_bias``/``gu_bias``/``dn_bias``;
17. Qwen2.5 at Qwen2.5-7B widths (``phase_qwen2_path``): a ``lut`` model
    with q/k/v biases, ``optimize()``, a batch-1 request through "w8p".
18. Gemma 3 at Gemma-3-27B widths (``phase_gemma3_path``) and 19. Gemma 2
    at Gemma-2-27B widths (``phase_gemma2_path``) through kernel 14 with
    gemma's operands.
20. "w3"/"w2" at Llama-3.1-8B widths (``phase_w3w2_path``): a GPTQ v1 W2
    checkpoint and a W3 model in memory (the GPTQ layout has no 3-bit
    form), ``GANQ_MEGASTEP=1`` requests at batch 1, 8 and 64 against
    ``layout="perlayer"``, an asym act-order W3 model, the batching engine.
21. "wl8" at Llama-3.2-3B widths (``phase_walsh_path``): dense -> GANQ
    ``bits=3`` -> ``lut`` checkpoint -> load -> "wl8"; a 28-layer random
    ``lut`` 3-bit model timed against ``layout="perlayer"`` and against
    ``optimize()`` ("w8p"); the batching engine.
Phase 3 holds the fold itself against its plain version
(``check_lm_fold``: the vocab phase bit for bit), and kernel 14's EoRA
epilogue (``check_lora``: "w8p"/"w4p" at 3B widths, zero points with
act-order and the fold at 8B widths) against its, beside the same launch
without adapters; those cases also go on a line of their own
(``{"k14_lora": ...}``) before the kernels line; and kernel 14's qk-norm
and bias instantiations (``check_arch``: "w8p"/"w4p" with ``qk_nm`` at
Qwen3-8B widths and with biases at InternLM-7B widths, and one launch of
each combination with zero points, act-order, the fold and the EoRA
epilogue), beside the same launch without those operands
(``{"k14_arch": ...}``); gemma's (``check_gemma``, ``{"k14_gemma":
...}``); and its "w3", "w2" and "wl8" variants (``check_lowbit3``: each
over 28 Llama-3.2-3B layers at batch 1, 8 and 64, then one launch with
each optional operand, ``{"k14_lowbit3": ...}``; the kernels line lists
the two new sources as entries of their own).
Each run of phases 7-21 sets the launch counters to 0 and must match its
expected launches exactly (``expected_launches``, the port's routing, which
is the JAX package's); phases 7-11 and 13-21 hold a teacher-forced decode
step against the reference backend.

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
TF32_FLOPS_PER_S = 495e12          # dense TF32 tensor-core peak
QUANTIZE_LAYERS = 2                # depth of the quantize path (see PERF.md)
PALLAS_PATH_LAYERS = 1             # depth of its solver_backend="pallas" run
GPTQ_LAYERS = 2                    # depth of the GPTQ path (see PERF.md)
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
def phase_done(name: str, t_start: float) -> None:
    """One line per phase with the wall clock since the start (the smoke's
    time budget, PERF.md)."""
    log(f"phase done: {name} at {time.time() - t_start:.1f} s")


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

    worst = 0.0
    rows = {}
    # 4 bits on every linear; 8 bits (256-entry codebooks) on down
    cases = [(4, label, M, K, (1, 8, 128, 512))
             for label, (M, K) in LLAMA_1B_LINEARS.items()]
    cases.append((8, "down", *LLAMA_1B_LINEARS["down"], (1, 128)))
    for bits, label, M, K, batches in cases:
        V = 2**bits
        wbytes = M * K * bits // 8
        n = copies_for(wbytes)
        weights = []
        for _ in range(n):
            lut = torch.sort(torch.randn((M, V), generator=gen, device="cuda")
                             * 0.006, dim=1).values.to(torch.bfloat16)
            idx = torch.randint(0, V, (M, K), generator=gen, device="cuda",
                                dtype=torch.int32)
            weights.append((lut, pack_int_rows(idx, bits)))
        dense = [torch.take_along_dim(
            lut.float(), unpack_int_rows(p, bits, K).long(), dim=1
        ).to(torch.bfloat16) for lut, p in weights[:copies_for(2 * M * K)]]
        for B in batches:
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
            nbytes = B * K * 2 + M * V * 2 + wbytes + B * M * 2
            b_ms, b_by = bound(nbytes, 2.0 * B * M * K)
            worst = max(worst, float(err.max()))
            rows[(bits, label, B)] = dict(
                ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=float(err.max()))
            log(f"lut_matmul bits={bits} {label} M={M} K={K} B={B}: "
                f"max_abs_err={float(err.max()):.3e} (tol: 1 bf16 ulp + 2e-5 "
                f"of max|out|) kernel_ms={k_ms:.5f} plain_ms={p_ms:.5f} "
                f"library_ms={l_ms:.5f} bound_ms={b_ms:.5f} ({b_by}) "
                f"bound_share={b_ms / k_ms:.3f}")
        del weights, dense
    entry = dict(rows[(4, "down", 1)])
    entry.update(name="lut_matmul", max_abs_err=worst,
                 shape="bits=4 M=2048 K=8192 B=1 (down projection, decode)",
                 by_case={f"bits8_down_b{B}": rows[(8, "down", B)]
                          for B in (1, 128)})
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
    + [("q/o", 2048, 2048, 8), ("q/o", 2048, 2048, 4), ("small", 256, 512, 256),
       ("8B down", 4096, 14336, 16)]


def check_s_step(gen) -> list:
    """Kernels 3 and 4 against their plain versions at the Llama-3.2-1B
    shapes (V = 16), V = 8 and 4 on q/o, V = 256 on a small shape and the
    Llama-3.1-8B down projection (V = 16). W and sorted codebooks of std
    0.02, H = X^T X / 2n from a seeded X, L its GANQ factor. Held to: index
    agreement >= 0.999, Werr within 1e-4 (abs and rel) where the indices
    agree, quad loss tr(E H E^T) within 1e-5 relative of the plain
    version's. Two bounds: the products' operations in float32 on the CUDA
    cores (``bound_ms``) and as three TF32 passes on the tensor cores
    (``bound_tf32_ms``, the 3xTF32 products' own)."""
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
            torch.cuda.synchronize()
            # the plain version (0.1-3 s a call) is timed on this one call
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            Qp, Ep = plain(W, L, T)
            end.record()
            torch.cuda.synchronize()
            p_ms = start.elapsed_time(end)
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
            B = torch.randn((n, n // 2), generator=gen, device="cuda")
            with full_f32_matmul():
                y_ms = event_ms(torch.matmul, (W, B), 5)
            del B
            flops = m * n * (n - 1) + 3 * m * n * V
            nbytes = 4 * (3 * m * n + n * n + m * V)
            b_ms, b_by = bound(nbytes, flops, F32_FLOPS_PER_S)
            t_ms = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)[0]
            rows[name][(label, V)] = dict(
                ms=k_ms, plain_ms=p_ms, yardstick_ms=y_ms, bound_ms=b_ms,
                bound_by=b_by, bound_tf32_ms=t_ms, agreement=agree,
                max_abs_err=werr_err, quad_loss_rel=loss_rel)
            log(f"{name} {label} m={m} n={n} V={V}: agreement={agree:.6f} "
                f"max|dWerr| where agreeing={werr_err:.3e} quad_loss_rel="
                f"{loss_rel:.3e} (tol 0.999 / 1e-4 / 1e-5) kernel_ms={k_ms:.4f} "
                f"plain_ms={p_ms:.4f} yardstick_f32_matmul_ms={y_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}, float32) bound_tf32_ms="
                f"{t_ms:.4f} (3 TF32 passes) bound_share={b_ms / k_ms:.3f}")
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
                 widths=((4, "bits=4 g128"),), batches=(1, 8, 512)):
    """Kernel, plain version and the library yardstick (a bf16 matmul on
    the dequantized weight: the full-precision product) at the Llama-3.2-1B
    shapes and each batch of ``batches``. ``make(M, K, bits)`` -> (args
    without x, bf16 weight [M, K], weight bytes). Returns the rows and the
    worst error. The x of a batch other than 1, 8 and 512 comes from a
    generator of its own: every later check draws its random inputs from
    ``gen``, and they stay the same whichever batches run here
    (``check_gemma``'s bound, twice the plain version's spread under four
    nudges, does not cover every draw of its random models: on some the
    plain version's own layers turn a last-bit difference in one slot into
    a different output, ``scripts/torch_port_gemma_draw.py``)."""
    rows, worst = {}, 0.0
    side = torch.Generator(device="cuda").manual_seed(1)
    for bits, tag in widths:
        for label, (M, K) in LLAMA_1B_LINEARS.items():
            first = make(M, K, bits)
            n = copies_for(first[2])
            weights = [first] + [make(M, K, bits) for _ in range(n - 1)]
            dense = [w[1] for w in weights[:copies_for(2 * M * K)]]
            for B in batches:
                x = torch.randn((B, K), generator=gen if B in (1, 8, 512)
                                else side, device="cuda").to(torch.bfloat16)
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
    kernel 6 (the ``optimize()`` recode), at batch 1 and 8 (the decode
    path), 128 (a typical prompt) and 512 (the tile path). The library
    yardstick computes the full-precision product, not the a8 one."""
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
                                   gen, widths, batches=(1, 8, 128, 512))
        entry = dict(rows[(4, "down", 1)])
        entry.update(name=name, max_abs_err=worst,
                     shape="bits=4 g128 M=2048 K=8192 B=1 (down, decode)")
        entries.append(entry)
    return entries


def check_w8_kernels(gen) -> list:
    """Kernels 7 (``w8_matmul``) and 8 (``w8a8_matmul``) on per-row int8
    weights (the ``optimize("w8")`` recode) at batch 1 and 8 (the decode
    path), 128 (a typical prompt) and 512 (the tile path). Kernel 8 and its
    plain version quantize x alike and sum integers exactly: they are
    expected to agree bit for bit, and are held to the same bound as the
    others."""
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
                                   gen, ((8, "int8 per-row"),),
                                   batches=(1, 8, 128, 512))
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


def _spread_close(got, plain, nudged, what, more=()):
    """Relative L2 of kernel - plain within twice the plain version's own
    spread (its output with norm weights 2^-22 larger, two float32 ulps)
    plus one bf16 ulp (2^-8): over many layers an int8 activation flipped
    by last-bit differences moves the next layer's activations and flips
    more codes, in the plain version as in the kernel (PERF.md, PR 4).
    ``more``: further nudged outputs (callables, run only where the first
    nudge leaves the kernel outside the bound), the spread their maximum:
    one nudge can miss every near-tie code that the kernel's rounding
    flips. Returns (max error, relative L2, spread)."""
    p = plain.float()
    rel = float((got.float() - p).norm() / p.norm().clamp_min(1e-30))

    def spread_of(n):
        return float((n.float() - p).norm() / p.norm().clamp_min(1e-30))

    spread = spread_of(nudged)
    for other in more:
        if rel <= 2 * spread + 2**-8:
            break
        spread = max(spread, spread_of(other()))
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


def _grouped_pack(gen, L, H, q_dim, kv_dim, I, bits, kmajor, gs=128,
                  walsh=False):
    """Random operands of kernel 13 (``kmajor``: megapack4's layouts) or
    kernel 14 (megapack_lowbit's, at 8, 4, 3 or 2 bits) over L layers: any
    byte is a valid code byte; bf16 group scales of a 2^(8 - bits) larger
    unit (codes of the same range), the o and down ones a tenth of the
    others' (residual-dominated layers, as in ``check_megastep``). With
    ``walsh`` (bits 3): megapack_walsh's 3 bit planes and, in the scales'
    slots, the float32 Walsh coefficient rows of random 8-entry codebooks
    (entries of std 0.015, the o and down ones a tenth)."""
    from ganq_tpu_torch.ops.megastep4 import _mlp_tile4
    from ganq_tpu_torch.ops.megastep_lowbit import (_mlp_plan, _plan_meta,
                                                    walsh_coef)

    Dqkv = q_dim + 2 * kv_dim
    metas, _, _, g_r = _plan_meta(bits)

    def packed(R):                     # plane rows of R output rows
        return R * len(metas) // g_r
    ti = _mlp_tile4(I) if kmajor else _mlp_plan(I, bits, H)[0]
    gtp = -(-(ti // gs) // 8) * 8
    unit = float(2 ** (8 - bits))

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
        mp.update(qkv_pk=codes(packed(Dqkv), H), o_pk=codes(packed(H), q_dim),
                  gu_pk=codes(packed(2 * I), H), dn_pk=codes(packed(H), I))
    if walsh:
        def coef(R, s=0.015):
            lut = torch.randn((L, R, 8), generator=gen, device="cuda") * s
            return walsh_coef(lut).contiguous()

        mp.update(qkv_s=coef(Dqkv), o_s=coef(H, 0.0015), gu_s=coef(2 * I),
                  dn_s=coef(H, 0.0015))
    return mp


ZP_AO_LAYERS = 4                   # depth of kernel 14's 8B-width cases


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


def _lora_operands(gen, mp, L, H, q_dim, kv_dim, I, r):
    """Kernel 14's EoRA operands (megapack_lowbit's layouts, bf16) added to
    a random pack: A [r, K] with rows of norm ~1, B with entries of 5e-2,
    so that the rank-r terms move each layer's q/k/v and residual by a few
    percent, more than the checks' tolerances."""
    Dqkv = q_dim + 2 * kv_dim

    def rnd(*shape, s):
        return (torch.randn((L, *shape), generator=gen, device="cuda")
                * s).to(torch.bfloat16)

    mp.update(la_q=rnd(r, H, s=H ** -0.5), lb_q=rnd(Dqkv, r, s=5e-2),
              la_o=rnd(r, q_dim, s=q_dim ** -0.5), lb_o=rnd(H, r, s=5e-2),
              la_g=rnd(r, H, s=H ** -0.5), lb_g=rnd(2 * I, r, s=5e-2),
              la_d=rnd(r, I, s=I ** -0.5), lb_d=rnd(H, r, s=5e-2))
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


def check_lm_fold(gen) -> dict:
    """Kernel 14 "w8p" with the trailing-unembed fold at Llama-3.1-8B's
    widths (ZP_AO_LAYERS layers, vocabulary 128256, a random int8 lm_head
    with float32 row scales and final norm weights in [0.5, 1.5)) at batch
    1, 8 and 16, slot b at position FUSED_POS + b. The vocab phase must
    equal its plain version on the kernel's own int8 rows exactly
    (``lm_vocab_plain``: max_abs_err 0); y, k, v and the logits are held
    against the whole plain step within ``_spread_close``. The fold's own
    time is the kernel's with the fold less the same launch's without it;
    its bound is the lm_head bytes (V H int8, the scales, the norm, the
    logits out) over 3.35 TB/s. Returns {batch: row}."""
    from ganq_tpu_torch.models import synthetic
    from ganq_tpu_torch.ops.megastep_lowbit import (lm_vocab_plain,
                                                    megastep_lowbit_decode,
                                                    megastep_lowbit_plain)

    c8 = synthetic.llama_3_1_8b_config(ZP_AO_LAYERS)
    H, I, q_dim, kv_dim, d, L = (c8.hidden_size, c8.intermediate_size,
                                 c8.q_dim, c8.kv_dim, c8.head_dim,
                                 ZP_AO_LAYERS)
    V = c8.vocab_size
    Dqkv, Hkv = q_dim + 2 * kv_dim, kv_dim // d
    mp = _grouped_pack(gen, L, H, q_dim, kv_dim, I, 8, False)
    w8 = torch.randint(-127, 128, (V, H), generator=gen, device="cuda",
                       dtype=torch.int32).to(torch.int8)
    tv = next(c for c in (4096, 2048, 1024, 512, 256, 128)
              if V % c == 0 and c * H <= 4 * 2**20)
    lm = {"w8": w8, "scale": (torch.rand((V // tv, tv), generator=gen,
                                         device="cuda") * 3e-4 + 1e-4),
          "norm": torch.rand(H, generator=gen, device="cuda") + 0.5}
    T = 256
    ang = torch.rand(64, generator=gen, device="cuda") * 6.2831853
    cos, sin = torch.cos(ang), torch.sin(ang)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=d, rotary_dim=d,
              scale=1.0 / math.sqrt(d), bits=8)
    code_bytes = L * (Dqkv + q_dim + 3 * I) * H
    scale_bytes = sum(v.numel() * v.element_size() for k, v in mp.items()
                      if k.endswith("_s"))
    rows = {}
    for B in (1, 8, 16):
        pos = [FUSED_POS + b for b in range(B)]
        kc = (torch.randn((L, B * Hkv, T, d), generator=gen, device="cuda")
              * 0.5).to(torch.bfloat16)
        vc = (torch.randn((L, B * Hkv, T, d), generator=gen, device="cuda")
              * 0.5).to(torch.bfloat16)
        x = torch.randn((B, H), generator=gen, device="cuda").to(
            torch.bfloat16)
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        fold_rows = {}
        got = megastep_lowbit_decode(x, mp, kc, vc, pos_t, cos, sin, lm=lm,
                                     fold_rows=fold_rows, **kw)
        torch.cuda.synchronize()
        fold_err = float((got[3] - lm_vocab_plain(
            fold_rows["x8"], fold_rows["sx"], lm)).abs().max())
        if fold_err != 0.0:
            raise AssertionError(f"lm fold B={B}: the vocab phase differs "
                                 f"from its plain version by {fold_err}")
        ref = megastep_lowbit_plain(x, mp, kc, vc, pos, cos, sin, lm=lm,
                                    **kw)
        nudged = megastep_lowbit_plain(
            x, dict(mp, attn_norm=mp["attn_norm"] * (1 + 2**-22),
                    mlp_norm=mp["mlp_norm"] * (1 + 2**-22)),
            kc, vc, pos, cos, sin, lm=lm, **kw)
        torch.cuda.synchronize()
        errs = [_spread_close(g, p, q, f"w8p+lm {n} B={B}")
                for n, g, p, q in zip(("y", "k_new", "v_new", "logits"), got,
                                      ref, nudged)]
        del ref, nudged
        k_ms = event_ms(lambda: megastep_lowbit_decode(
            x, mp, kc, vc, pos_t, cos, sin, lm=lm, **kw), (), 10)
        n_ms = event_ms(lambda: megastep_lowbit_decode(
            x, mp, kc, vc, pos_t, cos, sin, **kw), (), 10)
        p_ms = (event_ms(lambda: megastep_lowbit_plain(
            x, mp, kc, vc, pos, cos, sin, lm=lm, **kw), (), 1)
            if B == 1 else None)
        lm_bytes = V * H + V * 4 + H * 4 + B * V * 4 + B * H
        f_ms, f_by = bound(lm_bytes, 2.0 * B * V * H, INT8_OPS_PER_S)
        nbytes = (code_bytes + scale_bytes + 2 * L * sum(pos) * kv_dim * 2
                  + L * (2 * H + Dqkv) * 4 + 2 * B * H * 2
                  + 2 * L * B * kv_dim * 2 + lm_bytes)
        b_ms, b_by = bound(nbytes, 2.0 * B * (L * (Dqkv + q_dim + 3 * I)
                                              + V) * H, INT8_OPS_PER_S)
        rows[B] = dict(ms=k_ms, ms_no_fold=n_ms, fold_ms=k_ms - n_ms,
                       fold_bound_ms=f_ms, fold_bound_by=f_by, bound_ms=b_ms,
                       bound_by=b_by, plain_ms=p_ms, max_abs_err=fold_err,
                       rel_l2=max(e[1] for e in errs),
                       logits_max_abs_err=errs[3][0])
        log(f"megastep_lowbit_decode (w8p+lm) L={L} H={H} V={V} "
            f"pos={FUSED_POS}+b B={B}: vocab phase max_abs_err {fold_err} "
            f"(tol 0) against its plain version on the kernel's int8 rows; "
            f"rel_l2 y/k/v/logits={[f'{e[1]:.2e}' for e in errs]} (tol 2 x "
            f"the plain version's spread {[f'{e[2]:.2e}' for e in errs]} + "
            f"2^-8) kernel_ms={k_ms:.4f} without the fold {n_ms:.4f}: "
            f"fold_ms={k_ms - n_ms:.4f} fold_bound_ms={f_ms:.4f} ({f_by}) "
            f"plain_ms={p_ms if p_ms is None else round(p_ms, 3)} "
            f"bound_ms={b_ms:.4f} ({b_by})")
        del kc, vc
    del mp, lm, w8
    torch.cuda.empty_cache()
    return rows


EORA_RANK = 64                     # adapter rank of the EoRA cases


def check_lora(gen) -> dict:
    """Kernel 14 with the EoRA epilogue (``megastep_lowbit_lora*.cu``),
    rank EORA_RANK on every projection (``_lora_operands``), against its
    plain version within ``_spread_close`` (the spread with the A factors
    also nudged by 2^-13, about the float-order error of the kernel's
    K-term A dots): "w8p" and "w4p" over the 28
    layers of Llama-3.2-3B at batch 1, 8 and 64; at Llama-3.1-8B's widths
    (ZP_AO_LAYERS layers) "w4p" with zero points and act-order at batch 1,
    8 and 64 and "w8p" with the lm fold (vocabulary 128256) at 1, 8 and 16;
    slot b at position FUSED_POS + b. Each case is timed with CUDA events
    beside the same launch without the adapters (the kernels without the
    epilogue); its bound counts the adapters' bf16 factors with the step's
    bytes. Returns {case: row}."""
    from ganq_tpu_torch.models import synthetic
    from ganq_tpu_torch.ops.megastep_lowbit import (_LORA_KEYS,
                                                    megastep_lowbit_decode,
                                                    megastep_lowbit_plain)

    c8 = synthetic.llama_3_1_8b_config(ZP_AO_LAYERS)
    widths = {"3b": _l3b_widths(),
              "8b": (c8.hidden_size, c8.intermediate_size, c8.q_dim,
                     c8.kv_dim, c8.head_dim, ZP_AO_LAYERS)}
    T = 256
    ang = torch.rand(64, generator=gen, device="cuda") * 6.2831853
    cos, sin = torch.cos(ang), torch.sin(ang)
    rows = {}
    for variant, bits, batches, model, zpao, fold in (
            ("w8p_lora", 8, (1, 8, 64), "3b", False, False),
            ("w4p_lora", 4, (1, 8, 64), "3b", False, False),
            ("w4p_zp_ao_lora", 4, (1, 8, 64), "8b", True, False),
            ("w8p_lm_lora", 8, (1, 8, 16), "8b", False, True)):
        H, I, q_dim, kv_dim, d, L = widths[model]
        Dqkv, Hkv = q_dim + 2 * kv_dim, kv_dim // d
        mp = _lora_operands(gen, _zp_ao_operands(
            gen, _grouped_pack(gen, L, H, q_dim, kv_dim, I, bits, False),
            L, H, q_dim, bits, zpao, zpao), L, H, q_dim, kv_dim, I,
            EORA_RANK)
        bare = {k: v for k, v in mp.items() if k not in _LORA_KEYS}
        lm, lm_bytes = None, 0
        if fold:
            V = c8.vocab_size
            tv = next(c for c in (4096, 2048, 1024, 512, 256, 128)
                      if V % c == 0 and c * H <= 4 * 2**20)
            lm = {"w8": torch.randint(-127, 128, (V, H), generator=gen,
                                      device="cuda",
                                      dtype=torch.int32).to(torch.int8),
                  "scale": (torch.rand((V // tv, tv), generator=gen,
                                       device="cuda") * 3e-4 + 1e-4),
                  "norm": torch.rand(H, generator=gen, device="cuda") + 0.5}
        kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=d, rotary_dim=d,
                  scale=1.0 / math.sqrt(d), bits=bits, lm=lm)
        code_bytes = L * (Dqkv + q_dim + 3 * I) * H * bits // 8
        side_bytes = sum(v.numel() * v.element_size() for k, v in mp.items()
                         if k.endswith(("_s", "_sz")) or k[:3] == "ap_")
        lora_bytes = sum(mp[k].numel() * 2 for k in _LORA_KEYS)
        for B in batches:
            pos = [FUSED_POS + b for b in range(B)]
            kc = (torch.randn((L, B * Hkv, T, d), generator=gen,
                              device="cuda") * 0.5).to(torch.bfloat16)
            vc = (torch.randn((L, B * Hkv, T, d), generator=gen,
                              device="cuda") * 0.5).to(torch.bfloat16)
            x = torch.randn((B, H), generator=gen, device="cuda").to(
                torch.bfloat16)
            pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
            got = megastep_lowbit_decode(x, mp, kc, vc, pos_t, cos, sin, **kw)
            ref = megastep_lowbit_plain(x, mp, kc, vc, pos, cos, sin, **kw)
            # the spread: norm weights two float32 ulps larger, and the A
            # factors 1 + 2^-13 larger (about the kernel's float-order
            # error in its K-term A dots, sqrt(K) ulps)
            nudged = megastep_lowbit_plain(
                x, dict(mp, attn_norm=mp["attn_norm"] * (1 + 2**-22),
                        mlp_norm=mp["mlp_norm"] * (1 + 2**-22),
                        **{k: mp[k].float() * (1 + 2**-13)
                           for k in ("la_q", "la_o", "la_g", "la_d")}),
                kc, vc, pos, cos, sin, **kw)
            torch.cuda.synchronize()
            names = ("y", "k_new", "v_new", "logits")
            errs = [_spread_close(g, p, n_, f"{variant} {n} B={B}")
                    for n, g, p, n_ in zip(names, got, ref, nudged)]
            del ref, nudged
            k_ms = event_ms(lambda: megastep_lowbit_decode(
                x, mp, kc, vc, pos_t, cos, sin, **kw), (), 10)
            n_ms = event_ms(lambda: megastep_lowbit_decode(
                x, bare, kc, vc, pos_t, cos, sin, **kw), (), 10)
            p_ms = (event_ms(lambda: megastep_lowbit_plain(
                x, mp, kc, vc, pos, cos, sin, **kw), (), 1)
                if B == 1 else None)
            if fold:
                V = lm["w8"].shape[0]
                lm_bytes = V * H + V * 4 + H * 4 + B * V * 4 + B * H
            nbytes = (code_bytes + side_bytes + lora_bytes
                      + 2 * L * sum(pos) * kv_dim * 2
                      + L * (2 * H + Dqkv) * 4 + 2 * B * H * 2
                      + 2 * L * B * kv_dim * 2 + lm_bytes)
            ops = 2.0 * B * (L * (Dqkv + q_dim + 3 * I) * H
                             + (lm["w8"].shape[0] * H if fold else 0))
            b_ms, b_by = bound(nbytes, ops, INT8_OPS_PER_S)
            rows[(variant, B)] = dict(
                ms=k_ms, ms_no_lora=n_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, lora_mb=lora_bytes / 1e6,
                max_abs_err=max(e[0] for e in errs),
                rel_l2=max(e[1] for e in errs))
            log(f"megastep_lowbit_decode ({variant}, r={EORA_RANK}) L={L} "
                f"H={H} pos={FUSED_POS}+b B={B}: rel_l2 "
                f"{[f'{e[1]:.2e}' for e in errs]} (tol 2 x the plain "
                f"version's spread {[f'{e[2]:.2e}' for e in errs]} + 2^-8) "
                f"kernel_ms={k_ms:.4f} without adapters {n_ms:.4f} "
                f"(epilogue {k_ms - n_ms:+.4f}) plain_ms="
                f"{p_ms if p_ms is None else round(p_ms, 3)} "
                f"bound_ms={b_ms:.4f} ({b_by}; adapters "
                f"{lora_bytes / 1e6:.1f} MB)")
            del kc, vc, got
        del mp, bare, lm
        torch.cuda.empty_cache()
    return rows


ARCH_CHECK_LAYERS = 2              # depth of kernel 14's qk-norm/bias cases


def _arch_operands(gen, mp, L, H, q_dim, kv_dim, I, qkn, bias):
    """Kernel 14's architecture operands (megapack_lowbit's layouts,
    float32) added to a random pack: with ``qkn`` qwen3's ``qk_nm`` (norm
    weights in [0.75, 1.25) on the q and k lanes, the apply mask 1 there
    and 0 on the v lanes); with ``bias`` a qkv bias and o/gate-up/down
    biases of std 0.1."""
    Dqkv = q_dim + 2 * kv_dim

    def rnd(*shape, s=0.1):
        return torch.randn((L, *shape), generator=gen, device="cuda") * s

    if qkn:
        w = torch.rand((L, Dqkv), generator=gen, device="cuda") * 0.5 + 0.75
        m = torch.zeros((L, Dqkv), device="cuda")
        m[:, :q_dim + kv_dim] = 1.0
        w[:, q_dim + kv_dim:] = 1.0
        mp["qk_nm"] = torch.stack([w, m], dim=1).contiguous()
    if bias:
        mp.update(qkv_bias=rnd(1, Dqkv), o_bias=rnd(1, H),
                  gu_bias=rnd(1, 2 * I), dn_bias=rnd(1, H))
    return mp


def check_arch(gen) -> dict:
    """Kernel 14 with qwen3's qk-norm and InternLM's o/gate-up/down biases
    (the ARCH instantiations, ``megastep_lowbit_arch*.cu``) against its
    plain version within ``_spread_close`` (the spread with the qk-norm
    rows also nudged by 2^-22): "w8p" and "w4p" with ``qk_nm`` at
    Qwen3-8B's widths and with biases at InternLM-7B's, ARCH_CHECK_LAYERS
    layers each, at batch 1, 8 and 64; then one launch (batch 1) of each
    other ARCH instantiation: qk-norm with the lm fold (vocabulary 151936),
    with zero points and the fold, with the EoRA epilogue (rank
    EORA_RANK), with the epilogue and the fold, biases with zero points and
    act-order, with those and the epilogue, and qk-norm, biases, zero
    points, act-order, the epilogue and the fold together. Slot b at
    position FUSED_POS + b. Each case is timed with CUDA events beside the
    same launch without the ARCH operands (the kernels without them); its
    bound counts the qk-norm rows and biases with the step's bytes.
    Returns {case: row}."""
    from ganq_tpu_torch.models import synthetic
    from ganq_tpu_torch.ops.megastep_lowbit import (_ARCH_KEYS, _LORA_KEYS,
                                                    kernel_library,
                                                    megastep_lowbit_decode,
                                                    megastep_lowbit_plain)

    L = ARCH_CHECK_LAYERS
    cq = synthetic.qwen3_8b_config(L)
    ci = synthetic.internlm_7b_config(L)
    widths = {m: (c.hidden_size, c.intermediate_size, c.q_dim, c.kv_dim,
                  c.head_dim) for m, c in (("qwen3", cq), ("internlm", ci))}
    T = 256
    ang = torch.rand(64, generator=gen, device="cuda") * 6.2831853
    cos, sin = torch.cos(ang), torch.sin(ang)
    rows = {}
    # (case, bits, batches, widths, qk-norm, biases, zero points, act-order,
    # EoRA, fold)
    cases = [("w8p_qkn", 8, (1, 8, 64), "qwen3", 1, 0, 0, 0, 0, 0),
             ("w4p_qkn", 4, (1, 8, 64), "qwen3", 1, 0, 0, 0, 0, 0),
             ("w4p_bias", 4, (1, 8, 64), "internlm", 0, 1, 0, 0, 0, 0),
             ("w8p_bias", 8, (1, 8, 64), "internlm", 0, 1, 0, 0, 0, 0),
             ("w8p_qkn_lm", 8, (1,), "qwen3", 1, 0, 0, 0, 0, 1),
             ("w8p_qkn_zp_lm", 8, (1,), "qwen3", 1, 0, 1, 0, 0, 1),
             ("w4p_qkn_lora", 4, (1,), "qwen3", 1, 0, 0, 0, 1, 0),
             ("w8p_qkn_lora_lm", 8, (1,), "qwen3", 1, 0, 0, 0, 1, 1),
             ("w4p_bias_zp_ao", 4, (1,), "internlm", 0, 1, 1, 1, 0, 0),
             ("w4p_bias_zp_ao_lora", 4, (1,), "internlm", 0, 1, 1, 1, 1, 0),
             ("w4p_qkn_bias_zp_ao_lora_lm", 4, (1,), "qwen3", 1, 1, 1, 1, 1,
              1)]
    libs = set()
    for variant, bits, batches, model, qkn, bias, zp, ao, lora, fold in cases:
        H, I, q_dim, kv_dim, d = widths[model]
        Dqkv, Hkv = q_dim + 2 * kv_dim, kv_dim // d
        mp = _zp_ao_operands(
            gen, _grouped_pack(gen, L, H, q_dim, kv_dim, I, bits, False),
            L, H, q_dim, bits, zp, ao)
        if lora:
            _lora_operands(gen, mp, L, H, q_dim, kv_dim, I, EORA_RANK)
        _arch_operands(gen, mp, L, H, q_dim, kv_dim, I, qkn, bias)
        bare = {k: v for k, v in mp.items() if k not in _ARCH_KEYS}
        lm, lm_bytes = None, 0
        if fold:
            V = cq.vocab_size
            tv = next(c for c in (4096, 2048, 1024, 512, 256, 128)
                      if V % c == 0 and c * H <= 4 * 2**20)
            lm = {"w8": torch.randint(-127, 128, (V, H), generator=gen,
                                      device="cuda",
                                      dtype=torch.int32).to(torch.int8),
                  "scale": (torch.rand((V // tv, tv), generator=gen,
                                       device="cuda") * 3e-4 + 1e-4),
                  "norm": torch.rand(H, generator=gen, device="cuda") + 0.5}
        libs.add(kernel_library(mp, fold))
        kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=d, rotary_dim=d,
                  scale=1.0 / math.sqrt(d), bits=bits, lm=lm,
                  eps=cq.norm_eps)
        code_bytes = L * (Dqkv + q_dim + 3 * I) * H * bits // 8
        side_bytes = sum(v.numel() * v.element_size() for k, v in mp.items()
                         if k.endswith(("_s", "_sz")) or k[:3] == "ap_"
                         or k in _ARCH_KEYS or k in _LORA_KEYS)
        arch_bytes = sum(mp[k].numel() * 4 for k in _ARCH_KEYS if k in mp)
        for B in batches:
            pos = [FUSED_POS + b for b in range(B)]
            kc = (torch.randn((L, B * Hkv, T, d), generator=gen,
                              device="cuda") * 0.5).to(torch.bfloat16)
            vc = (torch.randn((L, B * Hkv, T, d), generator=gen,
                              device="cuda") * 0.5).to(torch.bfloat16)
            x = torch.randn((B, H), generator=gen, device="cuda").to(
                torch.bfloat16)
            pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
            got = megastep_lowbit_decode(x, mp, kc, vc, pos_t, cos, sin, **kw)
            ref = megastep_lowbit_plain(x, mp, kc, vc, pos, cos, sin, **kw)
            nudge = {k: mp[k] * (1 + 2**-22) for k in ("attn_norm", "mlp_norm",
                                                      "qk_nm") if k in mp}
            if lora:    # as check_lora: the A factors' float-order error
                nudge.update({k: mp[k].float() * (1 + 2**-13)
                              for k in ("la_q", "la_o", "la_g", "la_d")})
            nudged = megastep_lowbit_plain(x, dict(mp, **nudge), kc, vc, pos,
                                           cos, sin, **kw)
            torch.cuda.synchronize()
            names = ("y", "k_new", "v_new", "logits")
            errs = [_spread_close(g, p, n_, f"{variant} {n} B={B}")
                    for n, g, p, n_ in zip(names, got, ref, nudged)]
            del ref, nudged
            k_ms = event_ms(lambda: megastep_lowbit_decode(
                x, mp, kc, vc, pos_t, cos, sin, **kw), (), 10)
            n_ms = event_ms(lambda: megastep_lowbit_decode(
                x, bare, kc, vc, pos_t, cos, sin, **kw), (), 10)
            p_ms = (event_ms(lambda: megastep_lowbit_plain(
                x, mp, kc, vc, pos, cos, sin, **kw), (), 1)
                if B == 1 and len(batches) > 1 else None)
            if fold:
                V = lm["w8"].shape[0]
                lm_bytes = V * H + V * 4 + H * 4 + B * V * 4 + B * H
            nbytes = (code_bytes + side_bytes + 2 * L * sum(pos) * kv_dim * 2
                      + L * (2 * H + Dqkv) * 4 + 2 * B * H * 2
                      + 2 * L * B * kv_dim * 2 + lm_bytes)
            ops = 2.0 * B * (L * (Dqkv + q_dim + 3 * I) * H
                             + (lm["w8"].shape[0] * H if fold else 0))
            b_ms, b_by = bound(nbytes, ops, INT8_OPS_PER_S)
            rows[(variant, B)] = dict(
                ms=k_ms, ms_without=n_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, arch_kb=arch_bytes / 1e3,
                max_abs_err=max(e[0] for e in errs),
                rel_l2=max(e[1] for e in errs))
            log(f"megastep_lowbit_decode ({variant}, {model} widths) L={L} "
                f"H={H} pos={FUSED_POS}+b B={B}: rel_l2 "
                f"{[f'{e[1]:.2e}' for e in errs]} (tol 2 x the plain "
                f"version's spread {[f'{e[2]:.2e}' for e in errs]} + 2^-8) "
                f"kernel_ms={k_ms:.4f} without the qk-norm/bias operands "
                f"{n_ms:.4f} ({k_ms - n_ms:+.4f}) plain_ms="
                f"{p_ms if p_ms is None else round(p_ms, 3)} "
                f"bound_ms={b_ms:.4f} ({b_by}; qk-norm rows and biases "
                f"{arch_bytes / 1e3:.1f} KB)")
            del kc, vc, got
        del mp, bare, lm
        torch.cuda.empty_cache()
    want = {f"megastep_lowbit_arch{s}" for s in (
        "", "_opt", "_lm", "_lm_opt", "_lora", "_lora_opt", "_lora_lm",
        "_lora_lm_opt")}
    if libs != want:
        raise AssertionError(f"ARCH instantiations run {sorted(libs)}, "
                             f"not {sorted(want)}")
    return rows


GEMMA3_CHECK_LAYERS = 6            # one period of Gemma 3's 5:1 pattern
GEMMA2_CHECK_LAYERS = 2            # one of Gemma 2's sliding/full pairs


def _gemma_operands(gen, mp, cfg, L):
    """Gemma's operands of kernel 14 on a random pack at ``cfg``'s widths:
    norm weights stored as ``w - 1`` in [-0.3, 0.3) (the attention, MLP and
    sandwich norms, gemma3's q/k norms as ``qk_nm``), the per-layer
    ``windows`` (T on a full layer, filled in by the caller), ``rope_sel``
    (1 on the sliding layers of a dual-rope model) and the softcap.
    Returns the call's keyword operands."""
    H, q_dim, kv_dim = cfg.hidden_size, cfg.q_dim, cfg.kv_dim
    Dqkv = q_dim + 2 * kv_dim

    def norm(*shape):
        return (torch.rand((L, *shape), generator=gen, device="cuda") * 0.6
                - 0.3)

    mp.update(attn_norm=norm(1, H), mlp_norm=norm(1, H), pa_norm=norm(1, H),
              pm_norm=norm(1, H))
    if cfg.qk_norm:
        w = norm(Dqkv)
        m = torch.zeros((L, Dqkv), device="cuda")
        m[:, :q_dim + kv_dim] = 1.0
        w[:, q_dim + kv_dim:] = 1.0
        mp["qk_nm"] = torch.stack([w, m], dim=1).contiguous()
    kw = {}
    if cfg.rope_local_theta is not None:
        kw["rope_sel"] = torch.tensor(
            [int(cfg.layer_window(i) is not None) for i in range(L)],
            dtype=torch.int32, device="cuda")
    if cfg.attn_softcap is not None:
        kw["softcap"] = float(cfg.attn_softcap)
    return kw


def check_gemma(gen) -> dict:
    """Kernel 14 with gemma's operands (the GEMMA instantiation,
    ``megastep_lowbit_gemma.cu``) against its plain version within
    ``_spread_close`` (the norm weights, q/k and sandwich norms too, nudged
    by 2^-22; where that one nudge leaves the kernel outside the bound, the
    largest spread of three more: all down, the attention and MLP norms up,
    the sandwich and q/k norms up; the sandwich norms bring the o and down
    outputs to full scale, so an int8 code flipped at layer 0 moves every
    later layer): "w8p" and "w4p" at Gemma-3-27B's widths (GEMMA3_CHECK_LAYERS
    layers: five sliding at window 1024 and one full, dual rope, q/k norms,
    sandwich norms) and at Gemma-2-27B's (GEMMA2_CHECK_LAYERS: alternate
    windows of 4096, softcap 50, sandwich norms), gelu-tanh and rms_offset
    1, at batch 1, 8 and 64, slot b at a position past the published window
    (1100 + b and 4150 + b); then one launch (batch 1) of each other
    combination the GEMMA source serves: zero points and act-order, the lm
    fold, the EoRA epilogue (a runtime flag there) and all three. Each case
    is timed with CUDA events beside the same launch without gemma's
    operands (the kernels without them: the windows, softcap, dual rope and
    sandwich norms dropped); its bound counts the K/V rows the windows
    leave, the sandwich norms and the step's bytes. Returns {case: row}."""
    from ganq_tpu_torch.models import synthetic
    from ganq_tpu_torch.ops.megastep_lowbit import (_ARCH_KEYS, _LORA_KEYS,
                                                    _SAND_KEYS,
                                                    kernel_library,
                                                    megastep_lowbit_decode,
                                                    megastep_lowbit_plain)

    cfgs = {"g3": (synthetic.gemma3_27b_config(GEMMA3_CHECK_LAYERS), 1100,
                   1280),
            "g2": (synthetic.gemma2_27b_config(GEMMA2_CHECK_LAYERS), 4150,
                   4352)}
    rows = {}
    # (case, bits, batches, widths, zero points, act-order, EoRA, fold)
    cases = [("w8p_g3", 8, (1, 8, 64), "g3", 0, 0, 0, 0),
             ("w4p_g3", 4, (1, 8, 64), "g3", 0, 0, 0, 0),
             ("w4p_g2", 4, (1, 8, 64), "g2", 0, 0, 0, 0),
             ("w8p_g2", 8, (1, 8, 64), "g2", 0, 0, 0, 0),
             ("w4p_g2_zp_ao", 4, (1,), "g2", 1, 1, 0, 0),
             ("w8p_g3_lm", 8, (1,), "g3", 0, 0, 0, 1),
             ("w4p_g3_lora", 4, (1,), "g3", 0, 0, 1, 0),
             ("w4p_g2_zp_ao_lora_lm", 4, (1,), "g2", 1, 1, 1, 1)]
    libs = set()
    for variant, bits, batches, model, zp, ao, lora, fold in cases:
        cfg, pos0, T = cfgs[model]
        L = cfg.num_hidden_layers
        H, I, q_dim, kv_dim, d = (cfg.hidden_size, cfg.intermediate_size,
                                  cfg.q_dim, cfg.kv_dim, cfg.head_dim)
        Dqkv, Hkv = q_dim + 2 * kv_dim, kv_dim // d
        mp = _zp_ao_operands(
            gen, _grouped_pack(gen, L, H, q_dim, kv_dim, I, bits, False),
            L, H, q_dim, bits, zp, ao)
        if lora:
            _lora_operands(gen, mp, L, H, q_dim, kv_dim, I, EORA_RANK)
        gkw = _gemma_operands(gen, mp, cfg, L)
        wins = [cfg.layer_window(i) or T for i in range(L)]
        gkw["windows"] = torch.tensor(wins, dtype=torch.int32, device="cuda")
        bare = {k: v for k, v in mp.items() if k not in _SAND_KEYS}
        lm, lm_bytes = None, 0
        if fold:
            V = cfg.vocab_size - cfg.vocab_size % 4096
            tv = next(c for c in (4096, 2048, 1024, 512, 256, 128)
                      if V % c == 0 and c * H <= 4 * 2**20)
            lm = {"w8": torch.randint(-127, 128, (V, H), generator=gen,
                                      device="cuda",
                                      dtype=torch.int32).to(torch.int8),
                  "scale": (torch.rand((V // tv, tv), generator=gen,
                                       device="cuda") * 3e-4 + 1e-4),
                  "norm": torch.rand(H, generator=gen, device="cuda") * 0.6
                  - 0.3}
        libs.add(kernel_library(mp, fold, True))
        kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=d, rotary_dim=d,
                  scale=cfg.attn_scale, bits=bits, lm=lm, eps=cfg.norm_eps,
                  rms_offset=1.0, act="gelu_tanh")
        code_bytes = L * (Dqkv + q_dim + 3 * I) * H * bits // 8
        side_bytes = sum(v.numel() * v.element_size() for k, v in mp.items()
                         if k.endswith(("_s", "_sz")) or k[:3] == "ap_"
                         or k in _ARCH_KEYS or k in _LORA_KEYS
                         or k in _SAND_KEYS)
        n_tab = 2 if "rope_sel" in gkw else 1
        for B in batches:
            pos = [pos0 + b for b in range(B)]
            # the K/V rows the step reads: the window's on a sliding layer
            kv_rows = sum(min(p, w - 1) for p in pos for w in wins)
            kc = (torch.randn((L, B * Hkv, T, d), generator=gen,
                              device="cuda") * 0.5).to(torch.bfloat16)
            vc = (torch.randn((L, B * Hkv, T, d), generator=gen,
                              device="cuda") * 0.5).to(torch.bfloat16)
            x = torch.randn((B, H), generator=gen, device="cuda").to(
                torch.bfloat16)
            ang = (torch.rand((n_tab, B, d // 2), generator=gen,
                              device="cuda") * 6.2831853)
            cos, sin = torch.cos(ang), torch.sin(ang)
            if n_tab == 1:
                cos, sin = cos[0], sin[0]
            pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
            got = megastep_lowbit_decode(x, mp, kc, vc, pos_t, cos, sin,
                                         **kw, **gkw)
            ref = megastep_lowbit_plain(x, mp, kc, vc, pos, cos, sin, **kw,
                                        **gkw)
            # the weights (w - 1 stored) two float32 ulps larger: w + 1
            # moves by 2^-22 of itself (qk_nm's weight row only)
            nudge = {k: (mp[k] + 1) * (1 + 2**-22) - 1 for k in (
                "attn_norm", "mlp_norm", "pa_norm", "pm_norm")}
            if "qk_nm" in mp:
                qk = mp["qk_nm"].clone()
                qk[:, 0] = (qk[:, 0] + 1) * (1 + 2**-22) - 1
                nudge["qk_nm"] = qk
            if lora:    # as check_lora: the A factors' float-order error
                nudge.update({k: mp[k].float() * (1 + 2**-13)
                              for k in ("la_q", "la_o", "la_g", "la_d")})
            nudged = megastep_lowbit_plain(x, dict(mp, **nudge), kc, vc, pos,
                                           cos, sin, **kw, **gkw)

            def renudged(keys, sign, i):
                """Output i of the plain version with only ``keys`` of
                ``nudge`` moved, by 2^-22 up (sign 1) or down (-1)."""
                def run():
                    ops = dict(mp)
                    for k in keys:
                        ops[k] = (mp[k] + 1) * (1 + sign * 2**-22) - 1
                        if k == "qk_nm":
                            ops[k] = mp[k].clone()
                            ops[k][:, 0] = (mp[k][:, 0] + 1) * (
                                1 + sign * 2**-22) - 1
                    return megastep_lowbit_plain(x, ops, kc, vc, pos, cos,
                                                 sin, **kw, **gkw)[i]
                return run

            torch.cuda.synchronize()
            names = ("y", "k_new", "v_new", "logits")
            errs = [_spread_close(g, p, n_, f"{variant} {n} B={B}", more=(
                renudged(list(nudge), -1, i),
                renudged(["attn_norm", "mlp_norm"], 1, i),
                renudged(["pa_norm", "pm_norm"] + (
                    ["qk_nm"] if "qk_nm" in mp else []), 1, i)))
                for i, (n, g, p, n_) in enumerate(zip(names, got, ref,
                                                      nudged))]
            # the first layer whose new keys differ from the plain version's
            # (an int8 code flipped there moves every later layer)
            first = next((li for li in range(L)
                          if not torch.equal(got[1][li], ref[1][li])), None)
            del ref, nudged
            k_ms = event_ms(lambda: megastep_lowbit_decode(
                x, mp, kc, vc, pos_t, cos, sin, **kw, **gkw), (), 10)
            c1, s1 = (cos[0], sin[0]) if n_tab == 2 else (cos, sin)
            n_ms = event_ms(lambda: megastep_lowbit_decode(
                x, bare, kc, vc, pos_t, c1, s1, **kw), (), 10)
            p_ms = (event_ms(lambda: megastep_lowbit_plain(
                x, mp, kc, vc, pos, cos, sin, **kw, **gkw), (), 1)
                if B == 1 and len(batches) > 1 else None)
            if fold:
                V = lm["w8"].shape[0]
                lm_bytes = V * H + V * 4 + H * 4 + B * V * 4 + B * H
            nbytes = (code_bytes + side_bytes + 2 * kv_rows * kv_dim * 2
                      + L * (2 * H + Dqkv) * 4 + 2 * B * H * 2
                      + 2 * L * B * kv_dim * 2 + lm_bytes)
            ops = 2.0 * B * (L * (Dqkv + q_dim + 3 * I) * H
                             + (lm["w8"].shape[0] * H if fold else 0))
            b_ms, b_by = bound(nbytes, ops, INT8_OPS_PER_S)
            rows[(variant, B)] = dict(
                ms=k_ms, ms_without=n_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, kv_rows=kv_rows,
                max_abs_err=max(e[0] for e in errs),
                rel_l2=max(e[1] for e in errs))
            log(f"megastep_lowbit_decode ({variant}, "
                f"{'Gemma-3' if model == 'g3' else 'Gemma-2'}-27B widths) "
                f"L={L} H={H} pos={pos0}+b T={T} B={B}: rel_l2 "
                f"{[f'{e[1]:.2e}' for e in errs]} (tol 2 x the plain "
                f"version's spread {[f'{e[2]:.2e}' for e in errs]} + 2^-8) "
                f"kernel_ms={k_ms:.4f} without gemma's operands "
                f"{n_ms:.4f} ({k_ms - n_ms:+.4f}) plain_ms="
                f"{p_ms if p_ms is None else round(p_ms, 3)} "
                f"bound_ms={b_ms:.4f} ({b_by}; K/V rows read {kv_rows}; "
                f"first layer with other keys: {first})")
            del kc, vc, got
        del mp, bare, lm
        torch.cuda.empty_cache()
    if libs != {"megastep_lowbit_gemma"}:
        raise AssertionError(f"gemma calls run {sorted(libs)}")
    return rows


LOWBIT3_LAYERS = 28                # w3/w2/wl8 at Llama-3.2-3B: every layer
LOWBIT3_OPT_LAYERS = 2             # depth of their optional-operand cases


def _k14_call(lib, x, mp, kc, vc, pos_t, cos, sin, *, bits, walsh=0, **kw):
    """One launch of kernel 14's source ``lib`` with the wrapper's plan and
    checks, not counted: the runtime flags' cost on a pack without the
    optional operands."""
    from ganq_tpu_torch.ops import megastep_lowbit as mlb

    plan = mlb._plan_of(x, mp, kc, kw["q_dim"], kw["kv_dim"], kw["head_dim"],
                        bits, 128, 12, None, walsh)
    return mlb.launch_grouped(
        lib, f"ganq_{lib}", "megastep_lowbit_decode", x, mp,
        {"qkv": "qkv_pk", "o": "o_pk", "gu": "gu_pk", "dn": "dn_pk"}, kc, vc,
        pos_t, cos, sin, bits=bits, kmajor=False, tq=plan["tq"],
        ti=plan["ti"], gs=mlb._group_size(mp, x.shape[1], walsh),
        Tb=plan["Tb"], q_dim=kw["q_dim"], kv_dim=kw["kv_dim"],
        head_dim=kw["head_dim"], rotary_dim=kw["rotary_dim"],
        interleaved=False, eps=kw.get("eps", 1e-5),
        rms_offset=kw.get("rms_offset", 0.0), scale=kw["scale"],
        act=kw.get("act", "silu"), walsh=walsh,
        softcap=kw.get("softcap", 0.0), windows=kw.get("windows"),
        rope_sel=kw.get("rope_sel"))


def check_lowbit3(gen) -> dict:
    """Kernel 14's "w3", "w2" and "wl8" variants (``megastep_lowbit_w3w2.cu``,
    ``_w3w2_ext.cu``, ``_walsh.cu``) against their plain version within
    ``_spread_close``: each variant over the LOWBIT3_LAYERS layers of
    Llama-3.2-3B at batch 1, 8 and 64; then one launch (batch 1) with each
    optional operand over LOWBIT3_OPT_LAYERS layers of Qwen3-8B's widths:
    zero points with act-order (w3, w2), the lm fold (vocabulary 151936),
    the EoRA epilogue (rank EORA_RANK), qk-norm rows with o/gate-up/down
    biases (a combination no published model has: Qwen3 carries no
    biases), and every one of them together (w2); gemma's operands at
    Gemma-2-27B's widths through "w2" (GEMMA2_CHECK_LAYERS, past the
    window), and through "w3" and "wl8" at its head layout with hidden 4096
    (a width of no published model: neither Gemma 27B width is a multiple
    of 1024, which 3-bit planes need). Slot b at FUSED_POS + b. Each case
    is timed with CUDA events beside the same launch without its optional
    operands; the 3B "w3"/"w2" cases also beside their pack launched
    through the runtime-flag source (``_ext``: the flags' own cost). The
    bound counts the code bytes (bits / 8 a weight), the scales or
    coefficient rows, the operands and the K/V history. Returns {case:
    row}."""
    import dataclasses

    from ganq_tpu_torch.models import synthetic
    from ganq_tpu_torch.ops.megastep_lowbit import (_ARCH_KEYS, _LORA_KEYS,
                                                    _SAND_KEYS,
                                                    kernel_library,
                                                    megastep_lowbit_decode,
                                                    megastep_lowbit_plain)

    Lo = LOWBIT3_OPT_LAYERS
    cq = synthetic.qwen3_8b_config(Lo)
    g2 = synthetic.gemma2_27b_config(GEMMA2_CHECK_LAYERS)
    g2h = dataclasses.replace(g2, hidden_size=4096)
    H3, I3, q3, kv3, _, _ = _l3b_widths()
    widths = {"3b": (None, LOWBIT3_LAYERS, H3, I3, q3, kv3),
              "qwen3": (cq, Lo, cq.hidden_size, cq.intermediate_size,
                        cq.q_dim, cq.kv_dim),
              "g2": (g2, GEMMA2_CHECK_LAYERS, g2.hidden_size,
                     g2.intermediate_size, g2.q_dim, g2.kv_dim),
              "g2h": (g2h, GEMMA2_CHECK_LAYERS, 4096, g2.intermediate_size,
                      g2.q_dim, g2.kv_dim)}
    d = 128
    rows = {}
    # (case, bits, walsh, batches, widths, zero points, act-order, EoRA,
    # fold, qk-norm, biases)
    cases = [("w3", 3, 0, (1, 8, 64), "3b", 0, 0, 0, 0, 0, 0),
             ("w2", 2, 0, (1, 8, 64), "3b", 0, 0, 0, 0, 0, 0),
             ("wl8", 3, 7, (1, 8, 64), "3b", 0, 0, 0, 0, 0, 0),
             ("w3_zp_ao", 3, 0, (1,), "qwen3", 1, 1, 0, 0, 0, 0),
             ("w2_zp_ao", 2, 0, (1,), "qwen3", 1, 1, 0, 0, 0, 0),
             ("w3_lm", 3, 0, (1,), "qwen3", 0, 0, 0, 1, 0, 0),
             ("w3_lora", 3, 0, (1,), "qwen3", 0, 0, 1, 0, 0, 0),
             ("w3_qkn_bias", 3, 0, (1,), "qwen3", 0, 0, 0, 0, 1, 1),
             ("w2_zp_ao_lora_lm_qkn_bias", 2, 0, (1,), "qwen3", 1, 1, 1, 1,
              1, 1),
             ("wl8_lm", 3, 7, (1,), "qwen3", 0, 0, 0, 1, 0, 0),
             ("wl8_lora", 3, 7, (1,), "qwen3", 0, 0, 1, 0, 0, 0),
             ("wl8_qkn_bias", 3, 7, (1,), "qwen3", 0, 0, 0, 0, 1, 1),
             ("w2_g2", 2, 0, (1, 8), "g2", 0, 0, 0, 0, 0, 0),
             ("w3_g2h4096", 3, 0, (1,), "g2h", 0, 0, 0, 0, 0, 0),
             ("wl8_g2h4096", 3, 7, (1,), "g2h", 0, 0, 0, 0, 0, 0)]
    libs = set()
    for (variant, bits, walsh, batches, model, zp, ao, lora, fold, qkn,
         bias) in cases:
        cfg, L, H, I, q_dim, kv_dim = widths[model]
        Dqkv, Hkv = q_dim + 2 * kv_dim, kv_dim // d
        gemma = model in ("g2", "g2h")
        mp = _zp_ao_operands(
            gen, _grouped_pack(gen, L, H, q_dim, kv_dim, I, bits, False,
                               walsh=bool(walsh)),
            L, H, q_dim, bits, zp, ao)
        if lora:
            _lora_operands(gen, mp, L, H, q_dim, kv_dim, I, EORA_RANK)
        _arch_operands(gen, mp, L, H, q_dim, kv_dim, I, qkn, bias)
        kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=d, rotary_dim=d,
                  scale=1.0 / math.sqrt(d), bits=bits, walsh=walsh)
        pos0, T, gkw = FUSED_POS, 256, {}
        if gemma:
            gkw = _gemma_operands(gen, mp, dataclasses.replace(
                cfg, hidden_size=H), L)
            pos0, T = 4150, 4352
            wins = [cfg.layer_window(i) or T for i in range(L)]
            gkw["windows"] = torch.tensor(wins, dtype=torch.int32,
                                          device="cuda")
            kw.update(scale=cfg.attn_scale, eps=cfg.norm_eps, rms_offset=1.0,
                      act="gelu_tanh")
        else:
            wins = [T] * L
        bare = {k: v for k, v in mp.items()
                if k not in _ARCH_KEYS + _LORA_KEYS + _SAND_KEYS
                and k[-3:] != "_sz" and k[:3] != "ap_"}
        lm, lm_bytes = None, 0
        if fold:
            V = cq.vocab_size
            tv = next(c for c in (4096, 2048, 1024, 512, 256, 128)
                      if V % c == 0 and c * H <= 4 * 2**20)
            lm = {"w8": torch.randint(-127, 128, (V, H), generator=gen,
                                      device="cuda",
                                      dtype=torch.int32).to(torch.int8),
                  "scale": (torch.rand((V // tv, tv), generator=gen,
                                       device="cuda") * 3e-4 + 1e-4),
                  "norm": torch.rand(H, generator=gen, device="cuda") + 0.5}
        lib = kernel_library(mp, fold, gemma, bits, walsh)
        libs.add(lib)
        code_bytes = L * (Dqkv + q_dim + 3 * I) * H * bits // 8
        side_bytes = sum(v.numel() * v.element_size() for k, v in mp.items()
                         if k.endswith(("_s", "_sz")) or k[:3] == "ap_"
                         or k in _ARCH_KEYS + _LORA_KEYS + _SAND_KEYS)
        n_tab = 2 if "rope_sel" in gkw else 1
        for B in batches:
            pos = [pos0 + b for b in range(B)]
            kv_rows = sum(min(p, w - 1) for p in pos for w in wins)
            kc = (torch.randn((L, B * Hkv, T, d), generator=gen,
                              device="cuda") * 0.5).to(torch.bfloat16)
            vc = (torch.randn((L, B * Hkv, T, d), generator=gen,
                              device="cuda") * 0.5).to(torch.bfloat16)
            x = torch.randn((B, H), generator=gen, device="cuda").to(
                torch.bfloat16)
            ang = (torch.rand((n_tab, B, d // 2), generator=gen,
                              device="cuda") * 6.2831853)
            cos, sin = torch.cos(ang), torch.sin(ang)
            if n_tab == 1:
                cos, sin = cos[0], sin[0]
            pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
            got = megastep_lowbit_decode(x, mp, kc, vc, pos_t, cos, sin,
                                         lm=lm, **kw, **gkw)
            ref = megastep_lowbit_plain(x, mp, kc, vc, pos, cos, sin, lm=lm,
                                        **kw, **gkw)
            off = 1.0 if gemma else 0.0     # gemma stores w - 1

            def nudged_mp(sign):
                out = {k: (mp[k] + off) * (1 + sign * 2**-22) - off
                       for k in ("attn_norm", "mlp_norm") + _SAND_KEYS
                       if k in mp}
                if "qk_nm" in mp:
                    qk = mp["qk_nm"].clone()
                    qk[:, 0] = (qk[:, 0] + off) * (1 + sign * 2**-22) - off
                    out["qk_nm"] = qk
                if lora:   # as check_lora: the A factors' float-order error
                    out.update({k: mp[k].float() * (1 + sign * 2**-13)
                                for k in ("la_q", "la_o", "la_g", "la_d")})
                return dict(mp, **out)

            nudged = megastep_lowbit_plain(x, nudged_mp(1), kc, vc, pos, cos,
                                           sin, lm=lm, **kw, **gkw)

            def down(i):
                return lambda: megastep_lowbit_plain(
                    x, nudged_mp(-1), kc, vc, pos, cos, sin, lm=lm, **kw,
                    **gkw)[i]

            torch.cuda.synchronize()
            names = ("y", "k_new", "v_new", "logits")
            errs = [_spread_close(g, p, n_, f"{variant} {n} B={B}",
                                  more=(down(i),))
                    for i, (n, g, p, n_) in enumerate(zip(names, got, ref,
                                                          nudged))]
            del ref, nudged
            k_ms = event_ms(lambda: megastep_lowbit_decode(
                x, mp, kc, vc, pos_t, cos, sin, lm=lm, **kw, **gkw), (), 10)
            c1, s1 = (cos[0], sin[0]) if n_tab == 2 else (cos, sin)
            n_ms = (event_ms(lambda: megastep_lowbit_decode(
                x, bare, kc, vc, pos_t, c1, s1, **kw), (), 10)
                if bare.keys() != mp.keys() or gemma or fold else None)
            e_ms = (event_ms(lambda: _k14_call(
                "megastep_lowbit_w3w2_ext", x, mp, kc, vc, pos_t, cos, sin,
                **kw), (), 10) if model == "3b" and not walsh else None)
            p_ms = (event_ms(lambda: megastep_lowbit_plain(
                x, mp, kc, vc, pos, cos, sin, lm=lm, **kw, **gkw), (), 1)
                if B == 1 and len(batches) > 2 else None)
            if fold:
                V = lm["w8"].shape[0]
                lm_bytes = V * H + V * 4 + H * 4 + B * V * 4 + B * H
            nbytes = (code_bytes + side_bytes + 2 * kv_rows * kv_dim * 2
                      + L * (2 * H + Dqkv) * 4 + 2 * B * H * 2
                      + 2 * L * B * kv_dim * 2 + lm_bytes)
            ops = 2.0 * B * (L * (Dqkv + q_dim + 3 * I) * H
                             + (lm["w8"].shape[0] * H if fold else 0))
            b_ms, b_by = bound(nbytes, ops, INT8_OPS_PER_S)
            rows[(variant, B)] = dict(
                ms=k_ms, ms_without=n_ms, ms_ext=e_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, source=lib,
                max_abs_err=max(e[0] for e in errs),
                rel_l2=max(e[1] for e in errs))
            log(f"megastep_lowbit_decode ({variant}, {model} widths, {lib}) "
                f"L={L} H={H} pos={pos0}+b B={B}: rel_l2 "
                f"{[f'{e[1]:.2e}' for e in errs]} (tol 2 x the plain "
                f"version's spread {[f'{e[2]:.2e}' for e in errs]} + 2^-8) "
                f"kernel_ms={k_ms:.4f} without the optional operands "
                f"{n_ms} through the flags source {e_ms} plain_ms="
                f"{p_ms if p_ms is None else round(p_ms, 3)} "
                f"bound_ms={b_ms:.4f} ({b_by})")
            del kc, vc, got
        del mp, bare, lm
        torch.cuda.empty_cache()
    want = {"megastep_lowbit_w3w2", "megastep_lowbit_w3w2_ext",
            "megastep_lowbit_walsh"}
    if libs != want:
        raise AssertionError(f"w3/w2/wl8 cases run {sorted(libs)}, not "
                             f"{sorted(want)}")
    return rows


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
            entries = [check_lut_matmul(gen), check_flash_decode(gen),
                       *check_s_step(gen), *check_uniform_kernels(gen),
                       *check_w8_kernels(gen), *check_fused_w8a8(gen),
                       check_megastep(gen), *check_grouped_megasteps(gen),
                       check_moe_expert(gen)]
            # kernel 14's trailing-unembed fold joins its cases
            k14 = next(e for e in entries
                       if e["name"] == "megastep_lowbit_decode")
            for B, row in check_lm_fold(gen).items():
                k14["by_case"][f"w8p+lm_b{B}"] = {
                    k: row[k] for k in ("ms", "bound_ms", "plain_ms",
                                        "rel_l2", "ms_no_fold", "fold_ms",
                                        "fold_bound_ms", "max_abs_err")}
                k14["max_abs_err"] = max(k14["max_abs_err"],
                                         row["max_abs_err"])
            # and its EoRA epilogue, on a line of its own as well
            lora = check_lora(gen)
            for (v, B), row in lora.items():
                k14["by_case"][f"{v}_b{B}"] = {
                    k: row[k] for k in ("ms", "ms_no_lora", "bound_ms",
                                        "plain_ms", "rel_l2")}
                k14["max_abs_err"] = max(k14["max_abs_err"],
                                         row["max_abs_err"])
            k14["lora"] = {f"{v}_b{B}": row for (v, B), row in lora.items()}
            # and its qk-norm and bias instantiations, on a line of their own
            arch = check_arch(gen)
            for (v, B), row in arch.items():
                k14["by_case"][f"{v}_b{B}"] = {
                    k: row[k] for k in ("ms", "ms_without", "bound_ms",
                                        "plain_ms", "rel_l2")}
                k14["max_abs_err"] = max(k14["max_abs_err"],
                                         row["max_abs_err"])
            k14["arch"] = {f"{v}_b{B}": row for (v, B), row in arch.items()}
            # and gemma's instantiation, on a line of its own as well
            gemma = check_gemma(gen)
            for (v, B), row in gemma.items():
                k14["by_case"][f"{v}_b{B}"] = {
                    k: row[k] for k in ("ms", "ms_without", "bound_ms",
                                        "plain_ms", "rel_l2")}
                k14["max_abs_err"] = max(k14["max_abs_err"],
                                         row["max_abs_err"])
            k14["gemma"] = {f"{v}_b{B}": row for (v, B), row in gemma.items()}
            # and its "w3", "w2" and "wl8" variants: their own entries (each
            # source's 3B case at batch 1) and a line of their own
            low = check_lowbit3(gen)
            k14["lowbit3"] = {f"{v}_b{B}": row for (v, B), row in low.items()}
            for name, cases in (("megastep_lowbit_decode (w3/w2)",
                                 ("w3", "w2")),
                                ("megastep_lowbit_decode (wl8)", ("wl8",))):
                rows = {f"{v}_b{B}": r for (v, B), r in low.items()
                        if v.split("_")[0] in cases}
                first = low[(cases[0], 1)]
                entries.append(dict(
                    name=name, ms=first["ms"], plain_ms=first["plain_ms"],
                    bound_ms=first["bound_ms"], bound_by=first["bound_by"],
                    library_ms=None,
                    max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                    shape=f"L=28 H=3072 I=8192 pos={FUSED_POS} B=1 "
                    f"({cases[0]}, Llama-3.2-3B step)",
                    by_case={k: {x: r[x] for x in (
                        "ms", "ms_without", "ms_ext", "bound_ms", "plain_ms",
                        "rel_l2")} for k, r in rows.items()}))
            return entries
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


LUT8_LAYERS = 2                    # depth of the 8-bit lut model of phase 4


def lut8_served(ckpt_dir: str) -> int:
    """Phase 4's 8-bit run: a GANQ ``bits=8`` lut model (Llama-3.2-1B
    widths, LUT8_LAYERS layers, 256-entry codebooks) saved and loaded with
    the default backend, which must pick "cuda" (kernel 1 at 8 bits), one
    request through ``generate`` with kernel 1's and kernel 2's launches
    counted from 0, then the teacher-forced step against the "reference"
    backend (``phase_reference_check``). Returns kernel 1's launches."""
    from ganq_tpu_torch import GanqModel, QuantizeConfig
    from ganq_tpu_torch.formats.checkpoint import save_quantized
    from ganq_tpu_torch.models import hf_import, synthetic
    from ganq_tpu_torch.ops.fused_attention import flash_decode_attention
    from ganq_tpu_torch.ops.lut_matmul import lut_matmul

    cfg = synthetic.llama_3_2_1b_config(LUT8_LAYERS)
    with torch.inference_mode():
        model = synthetic.make_model(cfg, kind="lut", bits=8, seed=3,
                                     device="cuda", dtype=torch.bfloat16)
    save_quantized(ckpt_dir, hf_import.config_to_hf(cfg),
                   QuantizeConfig(bits=8, quant_method="ganq"), model)
    del model
    q = GanqModel.load(ckpt_dir, dtype=torch.bfloat16)
    if q.backend != "cuda" or q.device.type != "cuda":
        raise AssertionError(f"8-bit lut model: backend {q.backend} on "
                             f"{q.device}, not the card's \"cuda\"")
    linears = sum(len(lp.attn) + len(lp.mlp)
                  for lp in q._get_engine().model.layers)
    ids = torch.randint(0, cfg.vocab_size, (1, 32),
                        generator=torch.Generator().manual_seed(5)).numpy()
    new = 8
    lut_matmul.launches = 0
    flash_decode_attention.launches = 0
    out = q.generate(ids, max_new_tokens=new)
    launches = {"lut_matmul": lut_matmul.launches,
                "flash_decode": flash_decode_attention.launches}
    expected = {"lut_matmul": new * linears,
                "flash_decode": (new - 1) * LUT8_LAYERS}
    log(f"8-bit lut model ({LUT8_LAYERS} layers, backend {q.backend}): "
        f"tokens {out[0].tolist()}, launches {launches} (expected "
        f"{expected})")
    if out.shape != (1, new) or launches != expected:
        raise AssertionError("8-bit lut model: tokens or launch counts "
                             "differ from the path's")
    phase_reference_check(q, "8-bit lut reference check")
    return launches["lut_matmul"]


def phase_reference_check(q, what: str = "reference check",
                          batch: int = 2) -> float:
    """Teacher-force one decode step through the engine ``q`` serves with
    (its backend and model, and the megastep where its gate picks it, under
    the switches as set) and through the "reference" backend, from the same
    cache after a 128-token prompt; the relative L2 difference of the logits
    must stay below 5e-2 (bf16 activations: the paths round at different
    points, see PERF.md), and below 1e-1 on "cuda_a8" or through a
    whole-step kernel, which also round every linear's input to int8 per
    token (up to 1/254 of the row's largest value)."""
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
    tol = 1e-1 if eng.backend == "cuda_a8" or variant else 5e-2
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


def _k14_sources() -> dict:
    """Kernel 14's launches by source (``megastep_lowbit_decode.
    by_source``), counted beside its total."""
    from ganq_tpu_torch.ops.megastep_lowbit import megastep_lowbit_decode

    return megastep_lowbit_decode.by_source


def _by_source() -> dict:
    """The run's kernel-14 launches by source, as ``k14:<source>`` keys."""
    return {f"k14:{k}": v for k, v in _k14_sources().items() if v}


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


def _w8_mlp(lp) -> bool:
    """A layer whose MLP the fused W8A8 MLP (kernel 9) takes: fused ``w8``
    gate/up and down without adapter or bias."""
    mlp = lp.mlp
    return ("gateup" in mlp and mlp["gateup"].kind == "w8"
            and mlp["down"].kind == "w8"
            and not any(x in m for m in (mlp["gateup"], mlp["down"])
                        for x in ("lora_a", "bias")))


def expected_launches(q, model, backend, B, S, new, kernel_of, variant):
    """The launches of one request on the port's routing (the JAX
    package's): per layer of the prompt (B * S token rows) one
    ``kernel_of(linear)`` per linear below 1024 rows (else the
    dequantize-once GEMM), the fused MLP (kernel 9) instead of a fused w8
    gateup/down on "cuda_a8" at up to 64 rows; per decode step the whole-step
    kernel of ``variant`` once (12 for "w8", 13 for "w4", 14 for "w4p",
    "w3", "w2", "w8p" and "wl8"), else per layer the attention
    half (kernel 11, ``GANQ_FUSED_LAYER=1``, B <= 8) or the fused qkv
    (kernel 10, ``GANQ_FUSED_QKV``) or the qkv linear, one flash decode
    unless kernel 11 ran, o, and the MLP as for the prompt; a quantized
    lm_head once for the prompt and once a step (none where kernel 14
    folds it in). A MoE layer's
    experts run the fused expert kernel (15) once for a step of at most 32
    token rows on "cuda_a8" where the layer has its pack (unless
    ``GANQ_MOE_MEGA=0``), else each expert's gate, up and down."""
    import os

    from ganq_tpu_torch.models.transformer import attn_linears

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
        elif a8 and _w8_mlp(lp) and rows <= 64 and not q.cfg.sandwich_norm:
            add("fused_mlp_w8a8")
        elif rows < 1024:
            for p in mlp.values():
                add(kernel_of(p))

    for lp in model.layers:
        rows = B * S
        if rows < 1024:
            for p in attn_linears(lp).values():
                add(kernel_of(p))
        mlp_of(lp, rows)
    steps = new - 1
    # a quantized lm_head (full-precision kernels on "cuda_a8" too): the
    # prompt's last row, and each decode step's unless kernel 14 folds it in
    from ganq_tpu_torch.ops.qlinear import QLinear
    from ganq_tpu_torch.serve import stacked

    lm = getattr(model, "lm_head", None)
    if isinstance(lm, QLinear) and lm.kind != "dense":
        lm_kernel = kernel_of_linear("cuda" if a8 else backend)(lm)
        add(lm_kernel)
        if not (variant in stacked._LB_BITS
                and stacked.lm_fold_engages(q.cfg, model)):
            add(lm_kernel, steps)
    if variant:
        add("megastep_decode_w8a8" if variant == "w8" else
            "megastep4_decode" if variant == "w4" else
            "megastep_lowbit_decode", steps)
        return out
    cfg = q.cfg
    for _ in range(steps):
        for i, lp in enumerate(model.layers):
            if (a8 and fused_layer and B <= 8 and _w8_mlp(lp)
                    and lp.o_t_w8 is not None and q.cfg.head_dim == 128
                    and "lora_a" not in lp.attn["qkv"]
                    and not q.cfg.qk_norm):
                add("attn_half_decode_w8a8")
                add("fused_mlp_w8a8")
                continue
            for name, p in attn_linears(lp).items():
                if (name == "qkv" and a8 and fused_qkv and p.kind == "w8"
                        and "lora_a" not in p and not q.cfg.qk_norm):
                    add("fused_qkv_rope_w8a8")
                else:
                    add(kernel_of(p))
            if (cfg.attn_softcap is None and cfg.layer_window(i) is None
                    and cfg.head_dim <= 128):
                add("flash_decode")     # else the masked attention
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
            _k14_sources().clear()
            t0 = time.time()
            toks = q.generate(ids, max_new_tokens=new, max_seq=S + new)
            dt = time.time() - t0
            got = {k: c.launches for k, c in counters.items() if c.launches}
            if got != {k: v for k, v in want.items() if v}:
                raise AssertionError(f"{label} request {name}: launches "
                                     f"{got}, expected {want}")
            got.update(_by_source())
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


def _uniform_gptq(cfg, bits=4, asym=False, actorder=False, seed=8):
    """A random uniform ``bits``-bit g128 model at ``cfg``
    (``synthetic.make_model(kind="uniform")``) and the GPTQ artifacts of its
    own codes and scales: symmetric, or with random integer zero points in
    [2^bits / 4, 3 * 2^bits / 4] (``asym``, a ``sym=False`` model; for
    3 bits [2, 6]) and a
    balanced permuted g_idx (``actorder``, a ``desc_act=True`` one: each
    layer's columns shuffled by one permutation per shared input, g_idx
    recording each column's group). The model's linears are rebuilt from
    the artifacts (zero points and g_idx where they are set), so that it is
    the model GPTQ quantize leaves in memory and its checkpoint's content.
    Returns (model, artifacts)."""
    from ganq_tpu_torch.core.config import QUANT_METHOD
    from ganq_tpu_torch.models import hf_import, synthetic
    from ganq_tpu_torch.models.registry import get_spec
    from ganq_tpu_torch.ops.packing import pack_int_rows, unpack_int_rows
    from ganq_tpu_torch.ops.qlinear import QLinear
    from ganq_tpu_torch.quant.looper import QuantizedModule

    gen = torch.Generator().manual_seed(seed)
    shared = {"self_attn.q_proj": "h", "self_attn.k_proj": "h",
              "self_attn.v_proj": "h", "self_attn.o_proj": "o",
              "mlp.gate_proj": "g", "mlp.up_proj": "g", "mlp.down_proj": "d"}
    center = float(1 << (bits - 1))
    with torch.inference_mode():
        model = synthetic.make_model(cfg, kind="uniform", bits=bits,
                                     seed=seed, device="cuda",
                                     dtype=torch.bfloat16)
        spec = get_spec("llama")
        arts = {}
        for i in range(len(model.layers)):
            perms = {}
            for mod, slot in spec.module_slots.items():
                p = hf_import.get_module(model, i, slot)
                n = p.in_features
                scale = p["scales"].cpu()
                qidx = unpack_int_rows(p["qweight"], bits, n).to(
                    torch.uint8).cpu()
                g_idx = torch.arange(n, dtype=torch.int32) // 128
                if actorder:
                    perm = perms.setdefault(shared[mod],
                                            torch.randperm(n, generator=gen))
                    qidx, g_idx = qidx[:, perm], g_idx[perm]
                zero = torch.full_like(scale, center)
                if asym:
                    zero = torch.randint(1 << (bits - 2),
                                         (3 << (bits - 2)) + 1, scale.shape,
                                         generator=gen).to(torch.float32)
                arts[f"{spec.layers_prefix}.{i}.{mod}"] = QuantizedModule(
                    method=QUANT_METHOD.GPTQ, bits=bits, group_size=128,
                    qidx=qidx, scale=scale, zero=zero, g_idx=g_idx)
                arrays = {"qweight": pack_int_rows(qidx.to(torch.int32),
                                                   bits).cuda(),
                          "scales": p["scales"]}
                if asym:
                    arrays["zeros"] = zero.cuda()
                if actorder:
                    arrays["g_idx"] = g_idx.cuda()
                hf_import.set_module(model, i, slot,
                                     QLinear("uniform", arrays, bits, n))
    return model, arts


def _save_uniform(cfg, ckpt, bits=4, asym=False, actorder=False, seed=8):
    """:func:`_uniform_gptq`'s model saved as a GPTQ v1 checkpoint from its
    artifacts (2, 4 or 8 bits: the layout has no 3-bit form)."""
    from ganq_tpu_torch import QuantizeConfig
    from ganq_tpu_torch.formats.checkpoint import save_quantized
    from ganq_tpu_torch.models import hf_import

    model, arts = _uniform_gptq(cfg, bits, asym, actorder, seed)
    save_quantized(ckpt, hf_import.config_to_hf(cfg),
                   QuantizeConfig(bits=bits, desc_act=actorder, sym=not asym),
                   model, artifacts=arts)
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
    launch a decode step, and a symmetric uniform W4 g128 model of
    THREE_B_W4_LAYERS layers (saved as GPTQ v1, loaded: host work that grows
    with depth; phase 3 times kernels 13-14 at all 28) through "w4p" at
    batch 1 and 16 and through kernel 13
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
        _save_uniform(synthetic.llama_3_2_3b_config(THREE_B_W4_LAYERS), ckpt)
        t1 = time.time()
        q = GanqModel.load(ckpt, dtype=torch.bfloat16)
        q._get_engine()
        torch.cuda.synchronize()
        log(f"3B sym W4 ({THREE_B_W4_LAYERS} layers): built+saved (GPTQ v1) "
            f"in {t1 - t0:.1f} s, loaded, "
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


THREE_B_W4_LAYERS = 8              # depth of the 3B path's sym W4 model
EIGHT_B_LAYERS = 2                 # depth of the 8B path (see PERF.md)
MIXTRAL_LAYERS = 2                 # depth of the Mixtral path (see PERF.md)


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
        _save_uniform(cfg, ckpt, asym=True, actorder=True, seed=14)
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


BATCHING_LAYERS = 2                # depth of the batching path (PERF.md)


class ByteTokenizer:
    """UTF-8 bytes as token ids 0-255, and any id back as its value modulo
    256 (no downloads): enough for the server's string requests on a random
    model."""
    eos_token_id = None
    chat_template = None

    def __call__(self, text):
        return {"input_ids": list(text.encode("utf-8"))}

    def decode(self, ids):
        return bytes(i % 256 for i in ids).decode("utf-8", errors="replace")


def _batching_traffic(eng, rng, vocab, n=12, first=8):
    """``n`` seeded requests through ``eng`` (prompts of 16-256 tokens,
    16-48 new tokens, the first ``first`` submitted at once and the rest
    after the fourth step, so that freed slots take them), the launch
    counters set to 0 just before and read just after. Returns (results,
    decode steps, launches, seconds, tokens)."""
    counters = _kernel_counters()
    reqs = [(rng.integers(0, vocab, size=int(rng.integers(16, 257))),
             int(rng.integers(16, 49))) for _ in range(n)]
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    ids = {eng.submit(p, max_new_tokens=m): i for i, (p, m) in
           enumerate(reqs[:first])}
    results = {i: [] for i in range(len(reqs))}
    steps = k = 0
    while True:
        if k == 4:
            ids.update({eng.submit(p, max_new_tokens=m): first + i
                        for i, (p, m) in enumerate(reqs[first:])})
        busy = bool(eng.queue) or any(r is not None for r in eng.slot_req)
        if not busy and k > 4:
            break
        steps += busy                   # a busy step decodes every slot
        for rid, toks in eng.step().items():
            results[ids[rid]].extend(toks)
        k += 1
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    for i, (p, n) in enumerate(reqs):
        r = results[i]
        if len(r) != n or min(r) < 0 or max(r) >= vocab:
            raise AssertionError(f"batching request {i}: {len(r)} tokens of "
                                 f"{n}, range [{min(r)}, {max(r)}]")
    return results, steps, launches, dt, sum(n for _, n in reqs)


def _fold_and_residual(cfg, sp, mp, mk, mv, tok, pos, backend):
    """Kernel 14's folded "w8p" launch as ``batching._mega_decode_slots``
    makes it: (its logits, its residual unembedded in full precision)."""
    from ganq_tpu_torch.models.transformer import (_fused_act_kind, embed,
                                                   rope_tables, unembed)
    from ganq_tpu_torch.ops.megastep_lowbit import (mega_lm_operands,
                                                    megastep_lowbit_decode)
    from ganq_tpu_torch.serve import stacked

    d = cfg.head_dim
    cos, sin = rope_tables(cfg, pos[:, None])
    y, _, _, lg = megastep_lowbit_decode(
        embed(cfg, sp, tok[:, None])[:, 0, :], mp, mk, mv, pos,
        cos[:, 0, :d // 2], sin[:, 0, :d // 2], q_dim=cfg.q_dim,
        kv_dim=stacked._lb_kv_dim(cfg, mp, 8), head_dim=d, rotary_dim=d,
        eps=cfg.norm_eps, scale=1.0 / math.sqrt(d),
        act=_fused_act_kind(cfg), bits=8, lm=mega_lm_operands(cfg, sp))
    return lg, unembed(cfg, sp, y[:, None, :], backend)[:, 0, :].float()


def phase_batching_path():
    """The continuous-batching server's path at Llama-3.1-8B's published
    widths (BATCHING_LAYERS of 32 layers, untied): a random 4-bit ``lut``
    checkpoint with an 8-bit ``lut`` lm_head, saved, loaded and
    ``optimize("w8")``d (every linear and the lm_head int8 per row). A
    ``BatchingEngine`` (8 slots, max_seq 512, "cuda_a8") converts the
    layers to uniform 8-bit ("w8p") and decodes every slot at its own
    position in one kernel-14 launch a step with the lm_head folded in: 12
    seeded requests (8 at once, 4 while the first decode), their launches
    exact (one kernel 14 a decode step; per admission kernel 6 per prompt
    linear and kernel 7 for the prompt's last row through the lm_head). A
    teacher-forced step at per-slot positions holds the folded logits
    against the reference backend and against the same launch's residual
    unembedded in full precision (the fold's own rounding: its int8 final
    activations). Decode ms per step (host
    clock) at 1, 8 and 16 slots with and without the fold. Then
    ``GanqModel.serve(port=0, use_batching=True, slots=4)`` with a byte
    tokenizer answers 4 concurrent completions and a streamed chat."""
    import json as _json
    import threading
    import urllib.request

    from ganq_tpu_torch import GanqModel, QuantizeConfig
    from ganq_tpu_torch.formats.checkpoint import save_quantized
    from ganq_tpu_torch.models import hf_import, synthetic
    from ganq_tpu_torch.ops.megastep_lowbit import mega_lm_operands
    from ganq_tpu_torch.serve import batching, stacked

    cfg = synthetic.llama_3_1_8b_config(BATCHING_LAYERS)
    rng = np.random.default_rng(17)
    out = {}
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.time()
        with torch.inference_mode():
            model = synthetic.make_model(cfg, kind="lut", bits=4, seed=18,
                                         device="cuda", dtype=torch.bfloat16,
                                         lm_head_kind="lut", lm_head_bits=8)
        save_quantized(ckpt, hf_import.config_to_hf(cfg), QuantizeConfig(
            bits=4, quant_method="ganq", lm_head=True,
            dynamic={"+:lm_head": {"bits": 8}}), model)
        del model
        torch.cuda.empty_cache()
        t1 = time.time()
        # an 8-bit lut linear has no kernel of the port: the plain path
        # until optimize("w8") recodes it (ROADMAP.md queue C)
        q = GanqModel.load(ckpt, dtype=torch.bfloat16, backend="reference")
        q.optimize("w8")
        t2 = time.time()
    lm = q.model.lm_head
    if q.backend != "cuda_a8" or lm.kind != "w8":
        raise AssertionError(f"batching model: backend {q.backend}, lm_head "
                             f"{lm.kind}")
    eng = batching.BatchingEngine(q.cfg, q.model, backend=q.backend,
                                  slots=8, max_seq=512)
    torch.cuda.synchronize()
    t3 = time.time()
    fold = mega_lm_operands(q.cfg, eng._sp)
    log(f"batching: built+saved the {BATCHING_LAYERS}-layer 8B-width lut "
        f"checkpoint (8-bit lm_head) in {t1 - t0:.1f} s, loaded and "
        f"optimize('w8') in {t2 - t1:.1f} s, BatchingEngine (stack, w8p, "
        f"pack) in {t3 - t2:.1f} s: variant {eng._mega_variant}, fold "
        f"{'engaged' if fold is not None else 'off'}; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if eng._mega_variant != "w8p" or fold is None or eng.model is not None:
        raise AssertionError("the batching engine is not on kernel 14's "
                             "w8p whole step with the fold")
    kernel_of = kernel_of_linear(q.backend)
    eng.submit(rng.integers(0, cfg.vocab_size, size=20), max_new_tokens=4)
    eng.run_all()                                             # warm-up
    results, steps, launches, dt, n_tok = _batching_traffic(
        eng, rng, cfg.vocab_size)
    per_prompt = {}
    for lp in eng._sp.layers:
        for p in lp.attn.values():
            per_prompt[kernel_of(p)] = per_prompt.get(kernel_of(p), 0) + 1
        for p in lp.mlp.values():
            per_prompt[kernel_of(p)] = per_prompt.get(kernel_of(p), 0) + 1
    # the prompt's last row through the w8 lm_head at full precision
    want = {k: 12 * v for k, v in per_prompt.items()}
    want.update(megastep_lowbit_decode=steps, w8_matmul=12)
    log(f"batching traffic: 12 requests, {n_tok} tokens in {steps} decode "
        f"steps, {dt * 1e3:.1f} ms: {n_tok / dt:.1f} tokens/s (host clock, "
        f"prefills included); launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError("batching launches differ from the path's")
    out["runs"] = [launches]
    out["traffic"] = dict(requests=12, tokens=n_tok, steps=steps,
                          seconds=dt, tokens_per_s=n_tok / dt)

    # teacher-forced: two slots after 131-token prompts, a vector of
    # positions; folded against unfolded and against the reference
    # backend's per-layer step
    sp, mp = eng._sp, eng._mp
    T = 256
    with torch.inference_mode():
        ids = torch.randint(0, cfg.vocab_size, (2, 131),
                            generator=torch.Generator().manual_seed(3)).cuda()
        ck, cv = stacked.init_cache(q.cfg, len(sp.layers), 2, T, "cuda")
        lg0 = stacked.prefill(q.cfg, sp, ck, cv, ids, "reference")
        tok = lg0.argmax(-1)
        pos = torch.tensor([131, 131], dtype=torch.int32, device="cuda")
        mk, mv = stacked._mega_cache(ck, cv)
        a = batching._mega_decode_slots(q.cfg, sp, mp, mk, mv, tok, pos,
                                        "w8p", q.backend).float()
        # the same launch again, and its residual unembedded in full
        # precision (an unfolded launch may take another flash block: the
        # plan counts the fold's operands, as the JAX wrapper's does)
        lg, a0 = _fold_and_residual(q.cfg, sp, mp, mk, mv, tok, pos,
                                    q.backend)
        if not torch.equal(lg.float(), a):
            raise AssertionError("batching: the folded launch differs")
        b = stacked.decode_step(q.cfg, sp, ck, cv, tok, pos[0],
                                "reference").float()
    rel_ref = float((a - b).norm() / b.norm())
    rel_unf = float((a - a0).norm() / a0.norm())
    log(f"batching teacher-forced step (w8p, per-slot positions): logits "
        f"{tuple(a.shape)} rel_l2(fold, reference)={rel_ref:.3e} "
        f"rel_l2(fold, its residual unfolded)={rel_unf:.3e} top1 agree "
        f"{float((a.argmax(-1) == b.argmax(-1)).float().mean()):.2f} "
        f"(tol 1e-1 and 2e-2: int8 activations, and the int8 final "
        f"activations of the fold, up to 1/254 of a row's largest)")
    if (not torch.isfinite(a).all() or rel_ref > 1e-1 or rel_unf > 2e-2):
        raise AssertionError("batching: folded logits off the reference")
    out["teacher_forced"] = dict(rel_l2_reference=rel_ref,
                                 rel_l2_unfolded=rel_unf)
    del ck, cv, mk, mv

    # decode ms per step by slot count, fold on and off (host clock)
    step_ms = {}
    for S in (1, 8, 16):
        L, Hkv, d = len(sp.layers), q.cfg.num_key_value_heads, 128
        mk = torch.zeros((L, S * Hkv, 512, d), dtype=torch.bfloat16,
                         device="cuda")
        mv = torch.zeros_like(mk)
        toks = torch.randint(0, cfg.vocab_size, (S,), device="cuda")
        pos = torch.tensor([200 + 3 * i for i in range(S)], dtype=torch.int32,
                           device="cuda")
        per = {}
        for f in (True, False, False, True):
            with torch.inference_mode():
                for _ in range(2):
                    batching._mega_decode_slots(q.cfg, sp, mp, mk, mv, toks,
                                                pos, "w8p", q.backend, fold=f)
                torch.cuda.synchronize()
                t0 = time.time()
                for _ in range(10):
                    batching._mega_decode_slots(q.cfg, sp, mp, mk, mv, toks,
                                                pos, "w8p", q.backend, fold=f)
                torch.cuda.synchronize()
            per.setdefault("fold" if f else "unfolded", []).append(
                (time.time() - t0) / 10 * 1e3)
        step_ms[S] = {k: min(v) for k, v in per.items()}
        log(f"batching decode step at {S} slots (pos ~200, host clock, best "
            f"of 2, 10 steps each): fold {step_ms[S]['fold']:.3f} ms, "
            f"unfolded {step_ms[S]['unfolded']:.3f} ms")
        del mk, mv
    out["decode_batching_w8p"] = step_ms
    del eng, sp, mp
    torch.cuda.empty_cache()

    # the server: concurrent completions and a streamed chat
    q.tokenizer = ByteTokenizer()
    counters = _kernel_counters()
    for c in counters.values():
        c.launches = 0
    srv = q.serve(port=0, use_batching=True, slots=4, max_seq=512)
    try:
        srv.wait_until_ready(timeout=120)
        base = f"http://127.0.0.1:{srv.port}"

        def post(path, body):
            req = urllib.request.Request(
                base + path, data=_json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.read().decode()

        texts = [None] * 4
        t0 = time.time()

        def worker(i):
            texts[i] = _json.loads(post("/v1/completions", {
                "prompt": f"request {i}: " + "tell me a story " * (i + 1),
                "max_tokens": 24}))["choices"][0]["text"]

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        t_conc = time.time() - t0
        raw = post("/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hello there"}],
            "max_tokens": 16, "stream": True})
    finally:
        srv.shutdown()
    events = [e[len("data: "):] for e in raw.split("\n\n") if e]
    chunks = [_json.loads(e) for e in events[:-1]]
    if (any(t is None for t in texts) or events[-1] != "[DONE]"
            or chunks[0]["choices"][0]["delta"].get("role") != "assistant"):
        raise AssertionError(f"server: completions {texts}, stream tail "
                             f"{events[-1:]}")
    served = {k: c.launches for k, c in counters.items() if c.launches}
    log(f"server (use_batching, 4 slots): 4 concurrent completions in "
        f"{t_conc * 1e3:.0f} ms ({[len(t) for t in texts]} chars), a "
        f"streamed chat in {len(chunks)} chunks ending in [DONE]; launches "
        f"{served}")
    if not served.get("megastep_lowbit_decode"):
        raise AssertionError("the server's requests ran no kernel 14 step")
    out["runs"].append(served)
    del q
    torch.cuda.empty_cache()
    return out


def phase_batching_perlayer(ckpt_dir: str):
    """The batching engine's per-layer mode on phase 4's 1B ``lut``
    checkpoint (backend "cuda"; head_dim 64 keeps it off the whole step):
    every decode step runs each layer at a vector of per-slot positions
    (kernel 1 for each linear, the masked attention), 4 slots, 8 requests
    of 24-100 tokens and 12 new; launches exact (kernel 1: prompt and
    decode linears), and the greedy tokens agree with the static engine's
    on at least BATCHING_AGREE of them (the engine's flash decode and the
    masked attention round differently, and a random model's top-1
    margins are small). Returns the launches."""
    from ganq_tpu_torch import GanqModel
    from ganq_tpu_torch.serve import batching

    q = GanqModel.load(ckpt_dir, dtype=torch.bfloat16)
    eng = batching.BatchingEngine(q.cfg, q.model, backend=q.backend,
                                  slots=4, max_seq=128, prompt_buckets=(32,
                                                                         64,
                                                                         128))
    if eng._mega_variant is not None or q.backend != "cuda":
        raise AssertionError("the 1B batching engine is not per layer on "
                             "cuda")
    rng = np.random.default_rng(19)
    reqs = [rng.integers(0, q.cfg.vocab_size, size=int(n))
            for n in rng.integers(24, 101, size=8)]
    counters = _kernel_counters()
    for c in counters.values():
        c.launches = 0
    ids = {eng.submit(p, max_new_tokens=12): i for i, p in enumerate(reqs)}
    steps = 0
    got = {i: [] for i in range(len(reqs))}
    while eng.queue or any(r is not None for r in eng.slot_req):
        steps += 1
        for rid, toks in eng.step().items():
            got[ids[rid]].extend(toks)
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    # q/k/v/o and gate/up/down of every layer for each prompt and step;
    # the tied lm_head is a plain matmul on the embedding
    linears = sum(len(lp.attn) + len(lp.mlp) for lp in q.model.layers)
    want = {"lut_matmul": linears * (len(reqs) + steps)}
    agree = np.mean([a == b for i, p in enumerate(reqs)
                     for a, b in zip(got[i], q.generate(
                         p, max_new_tokens=12, max_seq=128)[0].tolist())])
    log(f"batching per layer (1B lut, 4 slots): 8 requests in {steps} "
        f"steps, launches {launches} (expected {want}); greedy tokens "
        f"agree with the static engine on {agree:.3f} (tol >= "
        f"{BATCHING_AGREE})")
    if launches != want:
        raise AssertionError("per-layer batching launches differ")
    if agree < BATCHING_AGREE:
        raise AssertionError("per-layer batching tokens off the engine's")
    del q, eng
    torch.cuda.empty_cache()
    return launches


BATCHING_AGREE = 0.5

EORA_LAYERS = 2                    # depth of the EoRA path (see PERF.md)


def _quantile_lut_model(dense, cfg, lm_bits: int = 8):
    """A 4-bit ``lut`` model of a dense one: each row's codebook the 16
    quantiles (at (i + 0.5) / 16) of its first 1024 weights, each weight
    the nearest codeword; the lm_head the same at ``lm_bits`` bits. Free
    (non-affine) codebooks, so ``optimize()`` recodes them to uniform 8-bit
    ("w8p")."""
    from ganq_tpu_torch.models.transformer import Layer, Model
    from ganq_tpu_torch.ops.qlinear import QLinear, lut_linear

    def lut_of(w, bits):
        k = 1 << bits
        parts = []
        for r0 in range(0, w.shape[0], 16384):       # bounded scratch
            wr = w[r0:r0 + 16384].float()
            srt = torch.sort(wr[:, :1024], dim=1).values
            at = ((torch.arange(k, device=w.device) + 0.5) / k
                  * srt.shape[1]).long()
            q = srt[:, at].contiguous()                      # [R, k] sorted
            idx = torch.searchsorted((q[:, 1:] + q[:, :-1]) / 2,
                                     wr.contiguous())
            parts.append(lut_linear(q, idx, bits))
        return QLinear("lut", {n: torch.cat([p[n] for p in parts])
                               for n in ("lut", "idx_packed")},
                       bits=bits, in_features=w.shape[1])

    layers = [Layer(lp.input_norm.weight, lp.post_norm.weight,
                    {n: lut_of(m["weight"], 4) for n, m in lp.attn.items()},
                    {n: lut_of(m["weight"], 4) for n, m in lp.mlp.items()})
              for lp in dense.layers]
    return Model(dense.embed_tokens.weight, dense.final_norm.weight, layers,
                 lut_of(dense.lm_head["weight"], lm_bits))


def phase_eora_path():
    """EoRA end to end at Llama-3.1-8B's published widths, EORA_LAYERS of
    its 32 layers. (a) A dense random directory, quantized with GPTQModel's
    default W4 g128 (``sym=False``, ``desc_act=True``) and an adapter of
    rank EORA_RANK on every module (``QuantizeConfig(adapter=...)``, 8
    calibration rows of 2048 tokens),
    saved (GPTQ v1 and the PEFT adapter files), loaded on the card:
    requests at batch 1 and 8 decode through kernel 14 "w4p" with zero
    points, act-order and the EoRA epilogue, one launch a step. (b) A 4-bit
    ``lut`` checkpoint of the same dense weights (quantile codebooks, an
    8-bit lm_head): ``eora_generate(dense_dir, rows, rank=EORA_RANK,
    save_adapter_to=...)``, its seconds a layer by part; the logits' error
    to the dense model with and without the adapters. (c) That checkpoint
    loaded again (the adapters attached) and ``optimize()``d: requests at
    batch 1, 8 and 16 through "w8p" with the epilogue. (d) A
    ``BatchingEngine`` on it, the lm_head int8 per row (``recode_w8``, as
    ``optimize("w8")`` makes it) so that it folds: 12 requests, one kernel
    14 launch a decode step. Launches exact throughout; each static request
    is followed by a teacher-forced step against the reference backend."""
    from ganq_tpu_torch import GanqModel, QuantizeConfig
    from ganq_tpu_torch.formats.checkpoint import save_dense, save_quantized
    from ganq_tpu_torch.models import hf_import, synthetic
    from ganq_tpu_torch.models.transformer import forward
    from ganq_tpu_torch.ops.megastep_lowbit import mega_lm_operands
    from ganq_tpu_torch.ops.qlinear import recode_w8
    from ganq_tpu_torch.serve import batching

    cfg = synthetic.llama_3_1_8b_config(EORA_LAYERS)
    rng = np.random.default_rng(19)
    # more calibration tokens than the widest input (14336): full-rank
    # covariances, as a real calibration set gives
    rows = rng.integers(0, cfg.vocab_size, size=(8, 2048))
    probe = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 64)),
                            device="cuda")
    out = {"runs": []}
    with tempfile.TemporaryDirectory() as dense_dir, \
            tempfile.TemporaryDirectory() as gdir, \
            tempfile.TemporaryDirectory() as ldir:
        t0 = time.time()
        with torch.inference_mode():
            dense = synthetic.make_model(cfg, kind="dense", seed=20,
                                         device="cuda", dtype=torch.bfloat16)
        save_dense(dense_dir, hf_import.config_to_hf(cfg), dense)
        t1 = time.time()

        # (a) GPTQ W4 (sym=False, desc_act) with adapters
        qcfg = QuantizeConfig(sym=False, desc_act=True,
                              adapter={"rank": EORA_RANK})
        g = GanqModel.load(dense_dir, qcfg)
        qlog = g.quantize(list(rows))
        torch.cuda.synchronize()
        t2 = time.time()
        g.save(gdir)
        del g
        torch.cuda.empty_cache()
        eora_s = sum(e.extra.get("eora", 0.0) for e in qlog)
        log(f"EoRA path: dense {EORA_LAYERS}-layer 8B-width directory in "
            f"{t1 - t0:.1f} s; GPTQ W4 g128 sym=False desc_act with rank-"
            f"{EORA_RANK} adapters: {t2 - t1:.1f} s for {len(qlog)} modules "
            f"({(t2 - t1) / EORA_LAYERS:.1f} s a layer, of which EoRA "
            f"{eora_s / EORA_LAYERS:.2f} s)")
        q = GanqModel.load(gdir, dtype=torch.bfloat16)
        eng = q._get_engine()
        mp = getattr(eng.model, "megapack_lb", None)
        if (q.backend != "cuda_a8" or mp is None
                or not {"la_q", "lb_d", "qkv_sz", "ap_q"} <= set(mp)
                or mp["la_q"].shape[1] != 3 * EORA_RANK):
            raise AssertionError("the GPTQ EoRA model is not on kernel 14's "
                                 "zero-point act-order EoRA path")
        q.generate(rng.integers(0, cfg.vocab_size, size=(1, 16)),
                   max_new_tokens=3, max_seq=32)                  # warm-up
        out["runs"] += list(_run_requests(q, "EoRA GPTQ W4", (
            ("w4p_zp_ao_lora_b1", 1, 128, 16, {}),
            ("w4p_zp_ao_lora_b8", 8, 64, 8, {})), rng,
            want_variant="w4p").values())
        out["decode_eora_w4p"] = _decode_ms(
            q, "EoRA GPTQ W4 (kernel 14 w4p with the epilogue)",
            ((1, 128, 16),), rng, layouts=("auto",))
        # the same teacher-forced step with the adapters taken off: how
        # much of its distance to the reference backend is the adapters'
        # (applied there to bf16 activations, in float32 in the kernel)
        for lp in q.model.layers:
            for m in list(lp.attn.values()) + list(lp.mlp.values()):
                m._buffers.pop("lora_a", None)
                m._buffers.pop("lora_b", None)
        q._engines = {}
        out["rel_l2_reference_without_adapters"] = phase_reference_check(
            q, "EoRA GPTQ W4, its adapters taken off", batch=1)
        del q, eng, mp
        torch.cuda.empty_cache()

        # (b) a lut checkpoint of the same weights, post-quant adapters
        with torch.inference_mode():
            save_quantized(ldir, hf_import.config_to_hf(cfg), QuantizeConfig(
                bits=4, quant_method="ganq", lm_head=True,
                dynamic={"+:lm_head": {"bits": 8}}),
                _quantile_lut_model(dense, cfg))
            ref = forward(cfg, dense, probe).float()
        # an 8-bit lut linear has no kernel of the port: the plain path
        # until optimize() recodes it (ROADMAP.md queue C)
        q = GanqModel.load(ldir, dtype=torch.bfloat16, backend="reference")

        def err():
            with torch.inference_mode():
                a = forward(cfg, q.model, probe).float()
            return float((a - ref).norm() / ref.norm())

        before = err()
        timings = {}
        t0 = time.time()
        done = q.eora_generate(dense_dir, list(rows), rank=EORA_RANK,
                               save_adapter_to=ldir, timings=timings)
        torch.cuda.synchronize()
        t_eora = time.time() - t0
        after = err()
        per = {k: round(v / EORA_LAYERS, 3) for k, v in timings.items()}
        log(f"EoRA path: eora_generate on the lut checkpoint: {len(done)} "
            f"modules in {t_eora:.1f} s ({t_eora / EORA_LAYERS:.2f} s a "
            f"layer; by part, s a layer: {json.dumps(per)}); logits rel_l2 "
            f"to the dense model {before:.4e} without adapters, {after:.4e} "
            f"with them")
        if len(done) != 7 * EORA_LAYERS or not after < before:
            raise AssertionError("eora_generate did not adapt every module "
                                 "or did not reduce the error")
        out["eora_generate"] = dict(s_per_layer=t_eora / EORA_LAYERS,
                                    split_s_per_layer=per,
                                    rel_l2_without=before, rel_l2_with=after)
        del q, dense, ref
        torch.cuda.empty_cache()

        # (c) load (adapters attached) -> optimize() -> "w8p" with them
        q = GanqModel.load(ldir, dtype=torch.bfloat16, backend="reference")
        q.optimize()
    eng = q._get_engine()
    mp = getattr(eng.model, "megapack_lb", None)
    if q.backend != "cuda_a8" or mp is None or "la_q" not in mp:
        raise AssertionError("the optimize()d EoRA model is not on kernel "
                             "14's w8p EoRA path")
    q.generate(rng.integers(0, cfg.vocab_size, size=(1, 16)),
               max_new_tokens=3, max_seq=32)                      # warm-up
    out["runs"] += list(_run_requests(q, "EoRA optimize()", (
        ("w8p_lora_b1", 1, 128, 16, {}), ("w8p_lora_b8", 8, 64, 8, {}),
        ("w8p_lora_b16", 16, 32, 8, {})), rng,
        want_variant="w8p").values())
    del eng, mp
    torch.cuda.empty_cache()

    # (d) continuous batching with the fold
    q.model.lm_head = recode_w8(q.model.lm_head)
    eng = batching.BatchingEngine(q.cfg, q.model, backend=q.backend,
                                  slots=8, max_seq=512)
    if (eng._mega_variant != "w8p" or "la_q" not in eng._mp
            or mega_lm_operands(q.cfg, eng._sp) is None):
        raise AssertionError("the batching engine is not on kernel 14's w8p "
                             "EoRA path with the fold")
    kernel_of = kernel_of_linear(q.backend)
    eng.submit(rng.integers(0, cfg.vocab_size, size=20), max_new_tokens=4)
    eng.run_all()                                             # warm-up
    _, steps, launches, dt, n_tok = _batching_traffic(eng, rng,
                                                      cfg.vocab_size)
    want = {}
    for lp in eng._sp.layers:
        for p in list(lp.attn.values()) + list(lp.mlp.values()):
            want[kernel_of(p)] = want.get(kernel_of(p), 0) + 12
    want.update(megastep_lowbit_decode=steps, w8_matmul=12)
    log(f"EoRA batching (w8p, epilogue and fold): 12 requests, {n_tok} "
        f"tokens in {steps} decode steps, {dt * 1e3:.1f} ms: "
        f"{n_tok / dt:.1f} tokens/s (host clock, prefills included); "
        f"launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError("EoRA batching launches differ from the path's")
    out["runs"].append(launches)
    out["batching"] = dict(tokens=n_tok, steps=steps, seconds=dt,
                           tokens_per_s=n_tok / dt)
    del q, eng
    torch.cuda.empty_cache()
    return out


ARCH_LAYERS = 2                    # depth of the InternLM/Qwen2.5 paths
QWEN3_LAYERS = 2                   # depth of the Qwen3 path (see PERF.md)


def _w8_of_dense(p):
    """A dense linear as a per-row int8 ``w8`` one (max-abs scales, as
    ``optimize("w8")`` makes a quantized lm_head), so that kernel 14 folds
    it into its steps."""
    from ganq_tpu_torch.ops.qlinear import QLinear

    w = p["weight"].float()
    scale = torch.clamp(w.abs().amax(dim=1, keepdim=True), min=1e-12) / 127.0
    w8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QLinear("w8", {"w8": w8, "scale": scale}, bits=8,
                   in_features=w.shape[1])


def _arch_pack_check(q, label, keys, variant):
    """The engine of ``q`` serves kernel 14's ``variant`` with the pack
    operands ``keys`` (qk_nm, o/gate-up/down biases)."""
    eng = q._get_engine()
    mp = getattr(eng.model, "megapack_lb", None)
    if q.backend != "cuda_a8" or mp is None or not set(keys) <= set(mp):
        raise AssertionError(f"{label}: not on kernel 14 with {keys}")
    for k in keys:
        log(f"{label}: pack operand {k} {tuple(mp[k].shape)} "
            f"max|.|={float(mp[k].abs().max()):.4g}")


def phase_qwen3_path():
    """Qwen3 end to end at Qwen3-8B's published widths, QWEN3_LAYERS of its
    36 layers: a dense random
    directory -> ``GanqModel.load(dir, qcfg)`` -> GANQ W4 quantize (the
    README recipe on 8 rows of 2048 tokens, kernel 3 once per module and
    iteration) -> save (``lut``) -> load -> ``optimize()`` (uniform 8-bit)
    -> requests at batch 1, 8 and 64 through kernel 14 "w8p" with the
    qk-norm rows ``qk_nm``, one launch a step, decode ms against
    ``layout="perlayer"``; then a ``BatchingEngine`` (4 slots, the lm_head
    int8 per row so that it folds) on 6 seeded requests, one kernel 14
    launch a decode step, and a teacher-forced folded step against the
    reference backend."""
    from ganq_tpu_torch import GanqModel, QuantizeConfig
    from ganq_tpu_torch.formats.checkpoint import save_dense
    from ganq_tpu_torch.models import hf_import, synthetic
    from ganq_tpu_torch.models.transformer import attn_linears
    from ganq_tpu_torch.ops.megastep_lowbit import mega_lm_operands
    from ganq_tpu_torch.serve import batching, stacked

    cfg = synthetic.qwen3_8b_config(QWEN3_LAYERS)
    qcfg = QuantizeConfig(bits=4, quant_method="ganq", act_sort="asc",
                          l_damp_style="ganq", dead="mean", ganq_iterations=5,
                          codebook_init="kmeans_exact")
    rng = np.random.default_rng(23)
    rows = rng.integers(0, cfg.vocab_size, size=(8, 2048))
    counters = _kernel_counters()
    out = {"runs": []}
    with tempfile.TemporaryDirectory() as dense_dir, \
            tempfile.TemporaryDirectory() as qdir:
        t0 = time.time()
        with torch.inference_mode():
            dense = synthetic.make_model(cfg, kind="dense", seed=24,
                                         device="cuda", dtype=torch.bfloat16)
        save_dense(dense_dir, hf_import.config_to_hf(cfg), dense)
        del dense
        torch.cuda.empty_cache()
        for c in counters.values():
            c.launches = 0
        t1 = time.time()
        g = GanqModel.load(dense_dir, qcfg)
        qlog = g.quantize(list(rows))
        torch.cuda.synchronize()
        t2 = time.time()
        launches = {k: c.launches for k, c in counters.items() if c.launches}
        fallbacks = sum(bool(e.extra["fallback"]) for e in qlog)
        expected = len(qlog) * qcfg.ganq_iterations + fallbacks
        bad = [f"{e.layer}.{e.module}" for e in qlog
               if not math.isfinite(e.loss)]
        if (len(qlog) != 7 * QWEN3_LAYERS or bad
                or launches.get("s_step_blocked") != expected):
            raise AssertionError(f"Qwen3 quantize: {len(qlog)} modules, "
                                 f"non-finite {bad}, launches {launches} "
                                 f"(S-steps expected {expected})")
        log(f"Qwen3 path: dense {QWEN3_LAYERS}-layer Qwen3-8B-width "
            f"directory in {t1 - t0:.1f} s; GANQ W4 quantize {t2 - t1:.1f} s "
            f"({(t2 - t1) / QWEN3_LAYERS:.1f} s a layer), launches "
            f"{launches}")
        out["runs"].append(launches)
        out["quantize_s_per_layer"] = (t2 - t1) / QWEN3_LAYERS
        g.save(qdir)
        del g
        torch.cuda.empty_cache()
        q = GanqModel.load(qdir, dtype=torch.bfloat16)
        lp0 = q.model.layers[0]
        if (not q.cfg.qk_norm or lp0.q_norm is None
                or lp0.attn["q"].kind != "lut"):
            raise AssertionError("Qwen3 checkpoint lost its q/k norms")
        q.optimize()
    _arch_pack_check(q, "Qwen3 optimize()", ("qk_nm",), "w8p")
    q.generate(rng.integers(0, cfg.vocab_size, size=(1, 16)),
               max_new_tokens=3, max_seq=32)                      # warm-up
    out["runs"] += list(_run_requests(q, "Qwen3 optimize()", (
        ("w8p_qkn_b1", 1, 128, 16, {}), ("w8p_qkn_b8", 8, 64, 8, {}),
        ("w8p_qkn_b64", 64, 32, 4, {})), rng, want_variant="w8p").values())
    out["decode_qwen3_w8p"] = _decode_ms(
        q, "Qwen3-8B widths (kernel 14 w8p with qk_nm)",
        ((1, 128, 16), (8, 64, 8), (64, 32, 8)), rng)

    # continuous batching with the fold
    q.model.lm_head = _w8_of_dense(q.model.lm_head)
    eng = batching.BatchingEngine(q.cfg, q.model, backend=q.backend,
                                  slots=4, max_seq=512)
    if (eng._mega_variant != "w8p" or "qk_nm" not in eng._mp
            or mega_lm_operands(q.cfg, eng._sp) is None):
        raise AssertionError("the Qwen3 batching engine is not on kernel "
                             "14's w8p qk-norm path with the fold")
    kernel_of = kernel_of_linear(q.backend)
    eng.submit(rng.integers(0, cfg.vocab_size, size=20), max_new_tokens=4)
    eng.run_all()                                             # warm-up
    _, steps, launches, dt, n_tok = _batching_traffic(
        eng, rng, cfg.vocab_size, n=6, first=4)
    want = {}
    for lp in eng._sp.layers:
        for p in list(attn_linears(lp).values()) + list(lp.mlp.values()):
            want[kernel_of(p)] = want.get(kernel_of(p), 0) + 6
    want.update(megastep_lowbit_decode=steps, w8_matmul=6)
    log(f"Qwen3 batching (w8p, qk_nm and the fold, 4 slots): 6 requests, "
        f"{n_tok} tokens in {steps} decode steps, {dt * 1e3:.1f} ms: "
        f"{n_tok / dt:.1f} tokens/s (host clock, prefills included); "
        f"launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError("Qwen3 batching launches differ from the path's")
    out["runs"].append(launches)
    sp, mp = eng._sp, eng._mp
    with torch.inference_mode():
        ids = torch.randint(0, cfg.vocab_size, (2, 131),
                            generator=torch.Generator().manual_seed(3)).cuda()
        ck, cv = stacked.init_cache(q.cfg, len(sp.layers), 2, 256, "cuda")
        tok = stacked.prefill(q.cfg, sp, ck, cv, ids, "reference").argmax(-1)
        pos = torch.tensor([131, 131], dtype=torch.int32, device="cuda")
        mk, mv = stacked._mega_cache(ck, cv)
        a = batching._mega_decode_slots(q.cfg, sp, mp, mk, mv, tok, pos,
                                        "w8p", q.backend).float()
        b = stacked.decode_step(q.cfg, sp, ck, cv, tok, pos[0],
                                "reference").float()
    rel = float((a - b).norm() / b.norm())
    log(f"Qwen3 batching teacher-forced folded step: rel_l2(fold, "
        f"reference)={rel:.3e} top1 agree "
        f"{float((a.argmax(-1) == b.argmax(-1)).float().mean()):.2f} "
        f"(tol 1e-1)")
    if not torch.isfinite(a).all() or rel > 1e-1:
        raise AssertionError("Qwen3 batching: folded logits off the "
                             "reference")
    out["batching"] = dict(tokens=n_tok, steps=steps, seconds=dt,
                           tokens_per_s=n_tok / dt, rel_l2_reference=rel)
    del q, eng, sp, mp, ck, cv, mk, mv
    torch.cuda.empty_cache()
    return out


def phase_internlm_path():
    """InternLM at InternLM-7B's published widths, ARCH_LAYERS of its 32
    layers, q/k/v/o biases from a seed: a dense random directory ->
    ``GanqModel.load(dir, QuantizeConfig(sym=True, desc_act=False))`` ->
    GPTQ W4 g128 (8 rows of 2048) -> save (GPTQ v1, biases beside the
    codes) -> load -> requests at batch 1 and 16 through kernel 14 "w4p"
    with ``o_bias``/``gu_bias``/``dn_bias``, one launch a step, decode ms
    against ``layout="perlayer"``."""
    from ganq_tpu_torch import GanqModel, QuantizeConfig
    from ganq_tpu_torch.formats.checkpoint import save_dense
    from ganq_tpu_torch.models import hf_import, synthetic

    cfg = synthetic.internlm_7b_config(ARCH_LAYERS)
    rng = np.random.default_rng(29)
    rows = rng.integers(0, cfg.vocab_size, size=(8, 2048))
    out = {"runs": []}
    with tempfile.TemporaryDirectory() as dense_dir, \
            tempfile.TemporaryDirectory() as qdir:
        with torch.inference_mode():
            dense = synthetic.make_model(cfg, kind="dense", seed=30,
                                         device="cuda", dtype=torch.bfloat16)
        save_dense(dense_dir, hf_import.config_to_hf(cfg), dense)
        del dense
        torch.cuda.empty_cache()
        t0 = time.time()
        g = GanqModel.load(dense_dir, QuantizeConfig(sym=True,
                                                     desc_act=False))
        g.quantize(list(rows))
        torch.cuda.synchronize()
        t1 = time.time()
        g.save(qdir)
        del g
        torch.cuda.empty_cache()
        log(f"InternLM path: GPTQ W4 g128 sym {t1 - t0:.1f} s "
            f"({(t1 - t0) / ARCH_LAYERS:.1f} s a layer)")
        q = GanqModel.load(qdir, dtype=torch.bfloat16)
    if "bias" not in q.model.layers[0].attn["o"]:
        raise AssertionError("InternLM checkpoint lost its o bias")
    _arch_pack_check(q, "InternLM GPTQ W4",
                     ("o_bias", "gu_bias", "dn_bias"), "w4p")
    q.generate(rng.integers(0, cfg.vocab_size, size=(1, 16)),
               max_new_tokens=3, max_seq=32)                      # warm-up
    out["runs"] += list(_run_requests(q, "InternLM GPTQ W4", (
        ("w4p_bias_b1", 1, 128, 16, {}), ("w4p_bias_b16", 16, 32, 8, {})),
        rng, want_variant="w4p").values())
    out["decode_internlm_w4p"] = _decode_ms(
        q, "InternLM-7B widths (kernel 14 w4p with biases)",
        ((1, 128, 16), (16, 32, 8)), rng)
    del q
    torch.cuda.empty_cache()
    return out


def phase_qwen2_path():
    """Qwen2.5 at Qwen2.5-7B's published widths, ARCH_LAYERS of its 28
    layers, q/k/v biases from a seed: a random 4-bit ``lut`` model saved,
    loaded, ``optimize()``d and asked a batch-1 request through kernel 14
    "w8p" (the biases in its qkv bias operand), one launch a step."""
    from ganq_tpu_torch import GanqModel, QuantizeConfig
    from ganq_tpu_torch.formats.checkpoint import save_quantized
    from ganq_tpu_torch.models import hf_import, synthetic

    cfg = synthetic.qwen2_5_7b_config(ARCH_LAYERS)
    rng = np.random.default_rng(31)
    out = {"runs": []}
    with tempfile.TemporaryDirectory() as d:
        with torch.inference_mode():
            model = synthetic.make_model(cfg, kind="lut", bits=4, seed=32,
                                         device="cuda", dtype=torch.bfloat16)
        save_quantized(d, hf_import.config_to_hf(cfg),
                       QuantizeConfig(bits=4, quant_method="ganq"), model)
        del model
        torch.cuda.empty_cache()
        q = GanqModel.load(d, dtype=torch.bfloat16)
        q.optimize()
    eng = q._get_engine()
    mp = getattr(eng.model, "megapack_lb", None)
    if mp is None or float(mp["qkv_bias"].abs().max()) == 0.0:
        raise AssertionError("Qwen2.5: kernel 14's pack has no qkv bias")
    log(f"Qwen2.5 optimize(): qkv_bias {tuple(mp['qkv_bias'].shape)} "
        f"max|.|={float(mp['qkv_bias'].abs().max()):.4g}")
    q.generate(rng.integers(0, cfg.vocab_size, size=(1, 16)),
               max_new_tokens=3, max_seq=32)                      # warm-up
    out["runs"] += list(_run_requests(q, "Qwen2.5 optimize()", (
        ("w8p_qkv_bias_b1", 1, 128, 16, {}),), rng,
        want_variant="w8p").values())
    out["decode_qwen2_5_w8p"] = _decode_ms(
        q, "Qwen2.5-7B widths (kernel 14 w8p, qkv biases)", ((1, 128, 16),),
        rng)
    del q, eng, mp
    torch.cuda.empty_cache()
    return out


GEMMA3_LAYERS = 6                  # depth of the Gemma-3 path (see PERF.md)
GEMMA2_LAYERS = 2                  # depth of the Gemma-2 path (see PERF.md)
GEMMA3_LONG_PROMPT = 1100          # past Gemma 3's window of 1024


def _whole_step_batching(q, label, rng, slots=4, n=6, long_prompt=0,
                         max_seq=1280, variants=("w4p", "w8p"),
                         need=("pa_norm",)):
    """``n`` seeded requests through a whole-step ``BatchingEngine`` of
    ``q`` (``slots`` slots), which must take one of kernel 14's
    ``variants`` with the pack operands ``need`` (gemma's sandwich norms
    by default): the first of ``long_prompt`` tokens (when given, so that
    its slot decodes past the window), the others of 16-256, 8-24 new
    tokens each, the launch counters set to 0 just before and read just
    after; the launches must be the path's (per prefill under 1024 rows one
    kernel per linear of the stacked layers, one kernel 14 launch a decode
    step). Returns (engine, launches, steps, seconds, tokens)."""
    from ganq_tpu_torch.models.transformer import attn_linears
    from ganq_tpu_torch.serve import batching

    eng = batching.BatchingEngine(q.cfg, q.model, backend=q.backend,
                                  slots=slots, max_seq=max_seq,
                                  prompt_buckets=(64, 256, 1152))
    if eng._mega_variant not in variants or not set(need) <= set(eng._mp):
        raise AssertionError(f"{label}: the batching engine is not on "
                             f"kernel 14 {variants} with {need}")
    V = q.cfg.vocab_size
    eng.submit(rng.integers(0, V, size=20), max_new_tokens=3)
    eng.run_all()                                             # warm-up
    lens = [int(rng.integers(16, 257)) for _ in range(n)]
    if long_prompt:
        lens[0] = long_prompt
    reqs = [(rng.integers(0, V, size=m), int(rng.integers(8, 25)))
            for m in lens]
    counters = _kernel_counters()
    for c in counters.values():
        c.launches = 0
    _k14_sources().clear()
    torch.cuda.synchronize()
    t0 = time.time()
    ids = {eng.submit(p, max_new_tokens=m): i for i, (p, m) in
           enumerate(reqs)}
    results = {i: [] for i in range(n)}
    steps = 0
    while eng.queue or any(r is not None for r in eng.slot_req):
        steps += 1
        for rid, toks in eng.step().items():
            results[ids[rid]].extend(toks)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    kernel_of = kernel_of_linear(q.backend)
    short = sum(1 for m in lens if m <= 256)      # buckets under 1024 rows
    want = {}
    for lp in eng._sp.layers:
        for p in list(attn_linears(lp).values()) + list(lp.mlp.values()):
            want[kernel_of(p)] = want.get(kernel_of(p), 0) + short
    want["megastep_lowbit_decode"] = steps     # one launch a busy step
    n_tok = sum(len(r) for r in results.values())
    for i, (_, m) in enumerate(reqs):
        r = results[i]
        if len(r) != m or min(r) < 0 or max(r) >= V:
            raise AssertionError(f"{label} request {i}: {len(r)} tokens of "
                                 f"{m}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want} ({steps} steps)")
    launches.update(_by_source())
    log(f"{label} ({eng._mega_variant}, {slots} slots): {n} requests "
        f"(prompts {lens}), {n_tok} tokens in {steps} steps, "
        f"{dt * 1e3:.1f} ms: {n_tok / dt:.1f} tokens/s (host clock, prefills "
        f"included); launches {launches}")
    return eng, launches, steps, dt, n_tok


def _gemma_teacher_forced(q, eng, label, prompt):
    """One decode step of the batching engine's whole-step kernel after a
    ``prompt``-token prefill (2 slots, position ``prompt``: past the
    window) against the stacked layers on the reference backend from the
    same cache; relative L2 of the logits within 1e-1 (int8 activations,
    ``phase_reference_check``'s bound on "cuda_a8")."""
    from ganq_tpu_torch.serve import batching, stacked

    sp, mp, cfg = eng._sp, eng._mp, q.cfg
    with torch.inference_mode():
        ids = torch.randint(0, cfg.vocab_size, (2, prompt),
                            generator=torch.Generator().manual_seed(3)).cuda()
        ck, cv = stacked.init_cache(cfg, len(sp.layers), 2, prompt + 64,
                                    "cuda")
        tok = stacked.prefill(cfg, sp, ck, cv, ids, "reference").argmax(-1)
        pos = torch.tensor([prompt, prompt], dtype=torch.int32,
                           device="cuda")
        mk, mv = stacked._mega_cache(ck, cv)
        a = batching._mega_decode_slots(cfg, sp, mp, mk, mv, tok, pos,
                                        eng._mega_variant, q.backend).float()
        b = stacked.decode_step(cfg, sp, ck, cv, tok, pos[0],
                                "reference").float()
    rel = float((a - b).norm() / b.norm())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"{label}: teacher-forced whole step at position {prompt}: "
        f"rel_l2(kernel 14, reference)={rel:.3e} top1 agree {agree:.2f} "
        f"(tol 1e-1)")
    if not torch.isfinite(a).all() or rel > 1e-1:
        raise AssertionError(f"{label}: whole-step logits off the reference")
    return rel


def phase_gemma3_path():
    """Gemma 3 at Gemma-3-27B's published widths, GEMMA3_LAYERS of its 62
    layers (one period of the 5:1 sliding:full pattern): a random 4-bit
    ``lut`` model with q/k and sandwich norms from a seed -> save -> load
    -> ``optimize()`` (uniform 8-bit) -> requests at batch 1, 8 and 64
    through kernel 14 "w8p" with ``qk_nm``, dual rope, windows and sandwich
    norms, one launch a step, each held against the reference backend;
    then a ``BatchingEngine`` (4 slots) on 6 seeded requests, one of
    GEMMA3_LONG_PROMPT tokens so that its slot decodes past the window, and
    a teacher-forced whole step there against the reference backend."""
    from ganq_tpu_torch import GanqModel, QuantizeConfig
    from ganq_tpu_torch.formats.checkpoint import save_quantized
    from ganq_tpu_torch.models import hf_import, synthetic

    cfg = synthetic.gemma3_27b_config(GEMMA3_LAYERS)
    rng = np.random.default_rng(41)
    out = {"runs": []}
    with tempfile.TemporaryDirectory() as d:
        with torch.inference_mode():
            model = synthetic.make_model(cfg, kind="lut", bits=4, seed=42,
                                         device="cuda", dtype=torch.bfloat16)
        save_quantized(d, hf_import.config_to_hf(cfg),
                       QuantizeConfig(bits=4, quant_method="ganq"), model)
        del model
        torch.cuda.empty_cache()
        q = GanqModel.load(d, dtype=torch.bfloat16)
        lp0 = q.model.layers[0]
        if (q.cfg != cfg or lp0.post_attn_norm is None or lp0.q_norm is None
                or lp0.attn["q"].kind != "lut"):
            raise AssertionError("the Gemma 3 checkpoint lost its config "
                                 "or norms")
        q.optimize()
    _arch_pack_check(q, "Gemma 3 optimize()", ("qk_nm", "pa_norm",
                                               "pm_norm"), "w8p")
    q.generate(rng.integers(0, cfg.vocab_size, size=(1, 16)),
               max_new_tokens=3, max_seq=32)                      # warm-up
    out["runs"] += list(_run_requests(q, "Gemma 3 optimize()", (
        ("w8p_g3_b1", 1, 128, 16, {}), ("w8p_g3_b8", 8, 64, 8, {}),
        ("w8p_g3_b64", 64, 32, 4, {})), rng, want_variant="w8p").values())
    out["decode_gemma3_w8p"] = _decode_ms(
        q, "Gemma-3-27B widths (kernel 14 w8p with gemma's operands)",
        ((1, 128, 16), (8, 64, 8)), rng)
    eng, launches, steps, dt, n_tok = _whole_step_batching(
        q, "Gemma 3 batching", rng, long_prompt=GEMMA3_LONG_PROMPT)
    out["runs"].append(launches)
    rel = _gemma_teacher_forced(q, eng, "Gemma 3 batching",
                                GEMMA3_LONG_PROMPT)
    out["batching"] = dict(tokens=n_tok, steps=steps, seconds=dt,
                           tokens_per_s=n_tok / dt, rel_l2_reference=rel)
    del q, eng
    torch.cuda.empty_cache()
    return out


def phase_gemma2_path():
    """Gemma 2 at Gemma-2-27B's published widths, GEMMA2_LAYERS of its 46
    layers (a sliding and a full layer): a dense random directory (sandwich
    norms from a seed) -> ``GanqModel.load(dir, QuantizeConfig(sym=True,
    desc_act=False))`` -> GPTQ W4 g128 (8 rows of 2048) -> save (GPTQ v1)
    -> load -> requests at batch 1 and 16 through kernel 14 "w4p" with the
    softcap, windows and sandwich norms, one launch a step, each held
    against the reference backend; the final logit softcap checked on the
    unembed."""
    import dataclasses

    from ganq_tpu_torch import GanqModel, QuantizeConfig
    from ganq_tpu_torch.formats.checkpoint import save_dense
    from ganq_tpu_torch.models import hf_import, synthetic
    from ganq_tpu_torch.models.transformer import unembed

    cfg = synthetic.gemma2_27b_config(GEMMA2_LAYERS)
    rng = np.random.default_rng(43)
    rows = rng.integers(0, cfg.vocab_size, size=(8, 2048))
    out = {"runs": []}
    with tempfile.TemporaryDirectory() as dense_dir, \
            tempfile.TemporaryDirectory() as qdir:
        with torch.inference_mode():
            dense = synthetic.make_model(cfg, kind="dense", seed=44,
                                         device="cuda", dtype=torch.bfloat16)
        save_dense(dense_dir, hf_import.config_to_hf(cfg), dense)
        del dense
        torch.cuda.empty_cache()
        t0 = time.time()
        g = GanqModel.load(dense_dir, QuantizeConfig(sym=True,
                                                     desc_act=False))
        g.quantize(list(rows))
        torch.cuda.synchronize()
        t1 = time.time()
        g.save(qdir)
        del g
        torch.cuda.empty_cache()
        log(f"Gemma 2 path: GPTQ W4 g128 sym {t1 - t0:.1f} s "
            f"({(t1 - t0) / GEMMA2_LAYERS:.1f} s a layer)")
        q = GanqModel.load(qdir, dtype=torch.bfloat16)
    if q.cfg != cfg or q.model.layers[1].post_mlp_norm is None:
        raise AssertionError("the Gemma 2 checkpoint lost its config or "
                             "sandwich norms")
    _arch_pack_check(q, "Gemma 2 GPTQ W4", ("pa_norm", "pm_norm"), "w4p")
    q.generate(rng.integers(0, cfg.vocab_size, size=(1, 16)),
               max_new_tokens=3, max_seq=32)                      # warm-up
    out["runs"] += list(_run_requests(q, "Gemma 2 GPTQ W4", (
        ("w4p_g2_b1", 1, 128, 16, {}), ("w4p_g2_b16", 16, 32, 8, {})),
        rng, want_variant="w4p").values())
    out["decode_gemma2_w4p"] = _decode_ms(
        q, "Gemma-2-27B widths (kernel 14 w4p with gemma's operands)",
        ((1, 128, 16), (16, 32, 8)), rng)
    # the unembed of the served model with its final norm weight 100 (w - 1
    # stored), so that raw logits pass the cap
    from ganq_tpu_torch.models.transformer import Model

    sp = q._get_engine().model
    with torch.inference_mode():
        h = torch.randn((2, 1, cfg.hidden_size), generator=torch.Generator(
            ).manual_seed(5)).cuda().to(torch.bfloat16)
        big = Model(sp.embed_tokens.weight,
                    torch.full_like(sp.final_norm.weight, 99.0), [],
                    sp.lm_head)
        capped = unembed(cfg, big, h).float()
        raw = unembed(dataclasses.replace(cfg, logit_softcap=None), big,
                      h).float()
    cap = cfg.logit_softcap
    want = cap * torch.tanh(raw / cap)
    err = float((capped - want).abs().max())
    log(f"Gemma 2 final logit softcap {cap}: max|raw|="
        f"{float(raw.abs().max()):.2f} max|capped|="
        f"{float(capped.abs().max()):.2f}, max|capped - cap tanh(raw / "
        f"cap)|={err:.3e} (tol 0.25, two bf16 ulps at 30)")
    if (float(raw.abs().max()) <= cap or float(capped.abs().max()) > cap
            or err > 0.25):
        raise AssertionError("Gemma 2: the final logit softcap is not "
                             "applied")
    del q, sp, big
    torch.cuda.empty_cache()
    return out


LOWBIT_PATH_LAYERS = 2             # depth of the 8B W3/W2 path (PERF.md)
WALSH_QUANTIZE_LAYERS = 2          # depth of the GANQ-3 quantize path
WALSH_SPEED_LAYERS = 28            # depth of the 3B "wl8" timing model
MEGA_ON = {"GANQ_MEGASTEP": "1"}   # the whole step on a non-a8 backend


def phase_w3w2_path():
    """Kernel 14's "w3" and "w2" at Llama-3.1-8B's published widths
    (huggingface.co/meta-llama/Llama-3.1-8B: hidden 4096, intermediate
    14336, head_dim 128; LOWBIT_PATH_LAYERS of its 32 layers): a random
    symmetric W2 g128 model saved as a GPTQ v1 checkpoint and loaded, and
    a random symmetric W3 g128 model served from memory as GPTQ ``bits=3``
    quantize leaves it (the GPTQ v1 layout has no 3-bit form in either
    package: ``gptq_compat`` packs 2, 4 and 8 bits). Both select backend
    "cuda"; with ``GANQ_MEGASTEP=1`` (as in ganq_tpu, the whole step
    engages off "cuda_a8" only when asked) requests at batch 1, 8 and 64
    decode through one kernel-14 launch a step (launches exact, a
    teacher-forced step against the reference backend each), and decode ms
    per step is timed against ``layout="perlayer"`` (kernel 5 at 3 and 2
    bits). Then an asymmetric act-order W3 model (GPTQModel's default
    layout: integer zero points, a balanced permuted g_idx) at batch 1
    through "w3" with its zero points and column orders, and the batching
    engine on the symmetric W3 model: 4 slots, 6 requests."""
    from ganq_tpu_torch import GanqModel
    from ganq_tpu_torch.models import synthetic

    cfg = synthetic.llama_3_1_8b_config(LOWBIT_PATH_LAYERS)
    rng = np.random.default_rng(21)
    results = {"runs": []}
    for bits in (2, 3):
        variant, t0 = f"w{bits}", time.time()
        if bits == 2:
            with tempfile.TemporaryDirectory() as ckpt:
                _save_uniform(cfg, ckpt, bits=2, seed=22)
                q = GanqModel.load(ckpt, dtype=torch.bfloat16)
        else:
            q = GanqModel(cfg, _uniform_gptq(cfg, 3, seed=23)[0])
        label = f"8B sym W{bits} g128"
        log(f"{label}: built ({'GPTQ v1 checkpoint' if bits == 2 else 'in memory'}, "
            f"{LOWBIT_PATH_LAYERS} layers) in {time.time() - t0:.1f} s; "
            f"backend {q.backend}")
        if q.backend != "cuda" or not q._get_engine().stacked:
            raise AssertionError(f"{label}: not stacked on backend cuda")
        saved = _request_env(MEGA_ON)
        try:
            q.generate(rng.integers(0, cfg.vocab_size, size=(1, 16)),
                       max_new_tokens=3, max_seq=32)                # warm-up
        finally:
            _restore_env(saved)
        results["runs"] += list(_run_requests(q, label, (
            (f"{variant}_b1", 1, 64, 16, MEGA_ON),
            (f"{variant}_b8", 8, 64, 8, MEGA_ON),
            (f"{variant}_b64", 64, 32, 4, MEGA_ON)), rng,
            want_variant=variant).values())
        results[f"decode_8b_{variant}"] = _decode_ms(
            q, f"{label} (kernel 14 {variant} / perlayer)",
            ((1, 64, 16), (8, 64, 16), (64, 32, 8)), rng, env=MEGA_ON)
        if bits == 3:
            saved = _request_env(MEGA_ON)
            try:
                _, launches, *_ = _whole_step_batching(
                    q, f"{label} batching", rng, slots=4, n=6, max_seq=320,
                    variants=("w3",), need=())
            finally:
                _restore_env(saved)
            results["runs"].append(launches)
        del q
        torch.cuda.empty_cache()
    q = GanqModel(cfg, _uniform_gptq(cfg, 3, asym=True, actorder=True,
                                     seed=24)[0])
    results["runs"] += list(_run_requests(
        q, "8B asym act-order W3", (("w3_zp_ao_b1", 1, 64, 16, MEGA_ON),),
        rng, want_variant="w3").values())
    mp = q._get_engine().model.megapack_lb
    if not {"qkv_sz", "ap_q", "ap_g", "ap_o"} <= set(mp):
        raise AssertionError("the asym act-order W3 model is not on kernel "
                             "14's zero-point act-order operands")
    del q, mp
    torch.cuda.empty_cache()
    return results


def _lut3_model(cfg, layers_seed=31):
    """A random 3-bit ``lut`` model at ``cfg`` (8-entry codebooks) saved
    with the port's checkpoint writer and loaded: returns (GanqModel,
    seconds to build and save, seconds to load)."""
    from ganq_tpu_torch import GanqModel, QuantizeConfig
    from ganq_tpu_torch.formats.checkpoint import save_quantized
    from ganq_tpu_torch.models import hf_import, synthetic

    t0 = time.time()
    with tempfile.TemporaryDirectory() as ckpt:
        with torch.inference_mode():
            model = synthetic.make_model(cfg, kind="lut", bits=3,
                                         seed=layers_seed, device="cuda",
                                         dtype=torch.bfloat16)
        save_quantized(ckpt, hf_import.config_to_hf(cfg),
                       QuantizeConfig(bits=3), model)
        del model
        torch.cuda.empty_cache()
        t1 = time.time()
        q = GanqModel.load(ckpt, dtype=torch.bfloat16)
        t2 = time.time()
    return q, t1 - t0, t2 - t1


def phase_walsh_path():
    """Kernel 14's "wl8" (exact 8-entry codebooks at 3 bits a weight) at
    Llama-3.2-3B's published widths (huggingface.co/meta-llama/
    Llama-3.2-3B): (a) the real path: a dense random model of
    WALSH_QUANTIZE_LAYERS layers, GANQ ``bits=3`` quantize (16 rows of
    512, as phase 6), saved as a ``lut`` checkpoint, loaded without
    ``optimize()`` and asked greedy requests with ``GANQ_MEGASTEP=1``
    through "wl8" (launches exact, teacher-forced against the reference
    backend); (b) speed: a random 3-bit ``lut`` model of WALSH_SPEED_LAYERS
    layers saved and loaded, decode ms per step at batch 1, 8 and 64
    through "wl8" against ``layout="perlayer"`` (kernel 1 at 3 bits) and
    against the same checkpoint after ``optimize()`` ("w8p", the int8
    recode); (c) the batching engine on "wl8": 4 slots, 6 requests."""
    from ganq_tpu_torch import GanqModel, QuantizeConfig
    from ganq_tpu_torch.formats.checkpoint import save_dense
    from ganq_tpu_torch.models import hf_import, synthetic

    rng = np.random.default_rng(31)
    results = {"runs": []}
    # (a) dense -> GANQ bits=3 -> lut checkpoint -> load -> "wl8"
    cfg = synthetic.llama_3_2_3b_config(WALSH_QUANTIZE_LAYERS)
    qcfg = QuantizeConfig(bits=3, quant_method="ganq", act_sort="asc",
                          l_damp_style="ganq", dead="mean",
                          ganq_iterations=5, codebook_init="kmeans_exact")
    rows = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             size=(16, 512))
    with tempfile.TemporaryDirectory() as dense_dir, \
            tempfile.TemporaryDirectory() as qdir:
        t0 = time.time()
        with torch.inference_mode():
            dense = synthetic.make_model(cfg, kind="dense", seed=6,
                                         device="cuda", dtype=torch.bfloat16)
        save_dense(dense_dir, hf_import.config_to_hf(cfg), dense)
        del dense
        torch.cuda.empty_cache()
        g = GanqModel.load(dense_dir, qcfg)
        t1 = time.time()
        qlog = g.quantize(list(rows))
        torch.cuda.synchronize()
        t2 = time.time()
        g.save(qdir)
        del g
        torch.cuda.empty_cache()
        q = GanqModel.load(qdir)
        kinds = {(p.kind, p.bits, p["lut"].shape[-1]) for lp in q.model.layers
                 for p in list(lp.attn.values()) + list(lp.mlp.values())}
        log(f"GANQ-3 path: {len(qlog)} modules quantized in {t2 - t1:.1f} s "
            f"({(t2 - t1) / WALSH_QUANTIZE_LAYERS:.1f} s a layer), saved "
            f"(lut) and loaded: kinds {sorted(kinds)}, backend {q.backend}")
        if kinds != {("lut", 3, 8)} or q.backend != "cuda":
            raise AssertionError("the GANQ-3 checkpoint is not a 3-bit "
                                 "8-entry lut model on backend cuda")
        results["runs"] += list(_run_requests(q, "GANQ-3 lut (3B widths)", (
            ("wl8_b1", 1, 128, 16, MEGA_ON),
            ("wl8_b8", 8, 128, 8, MEGA_ON)), rng,
            want_variant="wl8").values())
        results["quantize_s_per_layer"] = (t2 - t1) / WALSH_QUANTIZE_LAYERS
        del q
        torch.cuda.empty_cache()
    # (b) speed at full depth, against perlayer and optimize() ("w8p")
    cfg = synthetic.llama_3_2_3b_config(WALSH_SPEED_LAYERS)
    q, t_build, t_load = _lut3_model(cfg)
    log(f"3B lut3 ({WALSH_SPEED_LAYERS} layers): built and saved in "
        f"{t_build:.1f} s, loaded in {t_load:.1f} s")
    shapes = ((1, 64, 16), (8, 64, 16), (64, 32, 8))
    saved = _request_env(MEGA_ON)
    try:
        q.generate(rng.integers(0, cfg.vocab_size, size=(1, 16)),
                   max_new_tokens=3, max_seq=32)                    # warm-up
    finally:
        _restore_env(saved)
    results["runs"] += list(_run_requests(q, "3B lut3", (
        ("wl8_3b_b1", 1, 64, 8, MEGA_ON),), rng,
        want_variant="wl8").values())
    results["decode_3b_wl8"] = _decode_ms(
        q, "3B lut3 (kernel 14 wl8 / perlayer: kernel 1 at 3 bits)", shapes,
        rng, env=MEGA_ON)
    # (c) the batching engine on "wl8"
    saved = _request_env(MEGA_ON)
    try:
        _, launches, *_ = _whole_step_batching(
            q, "3B lut3 batching", rng, slots=4, n=6, max_seq=320,
            variants=("wl8",), need=())
    finally:
        _restore_env(saved)
    results["runs"].append(launches)
    t0 = time.time()
    q.optimize()
    torch.cuda.synchronize()
    log(f"3B lut3 optimize() in {time.time() - t0:.1f} s -> backend "
        f"{q.backend}")
    results["runs"] += list(_run_requests(q, "3B lut3 optimize()", (
        ("w8p_3b_b1", 1, 64, 8, MEGA_ON),), rng,
        want_variant="w8p").values())
    results["decode_3b_w8p"] = _decode_ms(
        q, "3B lut3 after optimize() (kernel 14 w8p)", shapes, rng,
        env=MEGA_ON, layouts=("auto",))
    del q
    torch.cuda.empty_cache()
    return results


def main() -> int:
    t_start = time.time()
    smi = phase_environment()
    phase_build()
    kernels = phase_kernels()
    phase_done("kernels (phase 3)", t_start)
    ckpt = tempfile.TemporaryDirectory()
    try:
        q, launches, _ = phase_main_path(ckpt.name)
        phase_reference_check(q)
        del q
        torch.cuda.empty_cache()
        lut8 = tempfile.TemporaryDirectory()
        try:
            launches["lut_matmul"] += lut8_served(lut8.name)
        finally:
            lut8.cleanup()
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
        # continuous batching per layer on the same checkpoint (kernel 1)
        runs.append(phase_batching_perlayer(ckpt.name))
    finally:
        ckpt.cleanup()
    phase_done("1B paths (phases 4-8, 12)", t_start)
    # the stacked paths at Llama-3.2-3B (kernels 6 and 8-14)
    three_b = phase_3b_path()
    phase_done("3B path (phase 9)", t_start)
    runs += three_b["runs"]
    # kernel 14 with zero points and act-order at Llama-3.1-8B widths, then
    # Mixtral through kernel 15 (with kernels 6 and 2 around it)
    eight_b = phase_8b_path()
    phase_done("8B path (phase 10)", t_start)
    runs += eight_b["runs"]
    mixtral = phase_mixtral_path()
    phase_done("Mixtral path (phase 11)", t_start)
    runs += mixtral["runs"]
    # continuous batching through kernel 14 with the lm fold, and the server
    batching_run = phase_batching_path()
    phase_done("batching path (phase 13)", t_start)
    runs += batching_run["runs"]
    # EoRA: quantize with adapters, post-quant adapters, kernel 14's
    # epilogue in the static engine and the batching engine
    eora = phase_eora_path()
    phase_done("EoRA path (phase 14)", t_start)
    runs += eora["runs"]
    # Qwen3 (kernel 14 with qk_nm), InternLM (its biases), Qwen2.5 (qkv
    # biases)
    qwen3 = phase_qwen3_path()
    phase_done("Qwen3 path (phase 15)", t_start)
    runs += qwen3["runs"]
    internlm = phase_internlm_path()
    phase_done("InternLM path (phase 16)", t_start)
    runs += internlm["runs"]
    qwen2 = phase_qwen2_path()
    phase_done("Qwen2.5 path (phase 17)", t_start)
    runs += qwen2["runs"]
    # Gemma 3 (kernel 14 with qk_nm, dual rope, windows, sandwich norms)
    # and Gemma 2 (softcap, windows, sandwich norms; GPTQ W4)
    gemma3 = phase_gemma3_path()
    phase_done("Gemma 3 path (phase 18)", t_start)
    runs += gemma3["runs"]
    gemma2 = phase_gemma2_path()
    phase_done("Gemma 2 path (phase 19)", t_start)
    runs += gemma2["runs"]
    # kernel 14's "w3"/"w2" (8B widths) and "wl8" (3B widths, GANQ-3)
    w3w2 = phase_w3w2_path()
    phase_done("W3/W2 path (phase 20)", t_start)
    runs += w3w2["runs"]
    walsh = phase_walsh_path()
    phase_done("GANQ-3 wl8 path (phase 21)", t_start)
    runs += walsh["runs"]
    # kernel 14's w3/w2 and wl8 sources, by their launches in phases 20-21
    for name, srcs in (("megastep_lowbit_decode (w3/w2)",
                        ("megastep_lowbit_w3w2", "megastep_lowbit_w3w2_ext")),
                       ("megastep_lowbit_decode (wl8)",
                        ("megastep_lowbit_walsh",))):
        launches[name] = sum(r.get(f"k14:{x}", 0) for r in runs for x in srcs)
        if any(sum(r.get(f"k14:{x}", 0) for r in runs) == 0 for x in srcs):
            raise AssertionError(f"{name}: a source of {srcs} never "
                                 "launched on its paths")
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
           "megastep_lowbit_decode (w3/w2)": (
               "ganq_tpu_torch/csrc/megastep_lowbit_w3w2.cu",
               "ganq_tpu/ops/megastep_lowbit.py:1390"),
           "megastep_lowbit_decode (wl8)": (
               "ganq_tpu_torch/csrc/megastep_lowbit_walsh.cu",
               "ganq_tpu/ops/megastep_lowbit.py:1390"),
           "moe_expert_decode": ("ganq_tpu_torch/csrc/moe_expert.cu",
                                 "ganq_tpu/ops/moe_expert.py:195")}
    line = {"kernels": [
        {"name": k["name"], "route": "cuda", "source": src[k["name"]][0],
         "replaces": src[k["name"]][1], "launches": launches[k["name"]],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k["library_ms"],
         **{x: k[x] for x in ("agreement", "yardstick_ms", "bound_tf32_ms",
                              "ms_b8", "bound_ms_b8", "by_case") if x in k},
         "shape": k["shape"]} for k in kernels]}
    log("decode ms per step (host clock): " + json.dumps(
        {k: v for d in (three_b, eight_b, mixtral, batching_run, eora,
                        qwen3, internlm, qwen2, gemma3, gemma2, w3w2, walsh)
         for k, v in d.items() if k.startswith("decode_")}))
    log("GANQ-3 path: " + json.dumps({"quantize_s_per_layer":
                                      walsh["quantize_s_per_layer"]}))
    log("Gemma 3 path: " + json.dumps({"batching": gemma3["batching"]}))
    log("Qwen3 path: " + json.dumps({k: qwen3[k] for k in (
        "quantize_s_per_layer", "batching")}))
    log("batching: " + json.dumps({k: batching_run[k] for k in (
        "traffic", "teacher_forced")}))
    log("EoRA path: " + json.dumps({k: eora[k] for k in (
        "eora_generate", "batching", "rel_l2_reference_without_adapters")}))
    log(f"card: {smi}; wall {time.time() - t_start:.1f} s")
    k14 = next(k for k in kernels if k["name"] == "megastep_lowbit_decode")
    log(json.dumps({"k14_lora": k14["lora"]}))
    log(json.dumps({"k14_arch": k14["arch"]}))
    log(json.dumps({"k14_gemma": k14["gemma"]}))
    log(json.dumps({"k14_lowbit3": k14["lowbit3"]}))
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
