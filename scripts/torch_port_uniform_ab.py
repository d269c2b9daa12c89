#!/usr/bin/env python3
"""Time kernels 1 (``lut_matmul``), 2 (``flash_decode_attention``), 5
(``uniform_matmul``), 6 (``uniform_a8_matmul``), 7 (``w8_matmul``) and 8
(``w8a8_matmul``) for the port found at a checkout root, to compare two
builds of them on one card.

    python3 scripts/torch_port_uniform_ab.py ROOT [--batches 1,8,128,512]
        [--x-dtype bf16|float32] [--kernels k1,k1w8,k2,k5,k6,k7,k8] [--eager]
        [--step] [--check] [--profile]

ROOT is a checkout of the repository (``.`` or, for the parent commit, a
``git archive`` of it unpacked under ``build/``); its kernel sources build
into ROOT/build. The cases are ``chip_smoke.py``'s at the Llama-3.2-1B
linears: kernel 1 on 4-bit ``lut`` codes with a sorted random bf16
codebook a row (``check_lut_matmul``), and with ``k1w8`` on 8-bit codes
(256-entry codebooks); kernels 5-6 on symmetric codes with
128-column groups, kernel 5 at 4 bits and kernel 6 at 4 and 8 bits
(``check_uniform_kernels``); kernels 7-8 on per-row int8 weights
(``check_w8_kernels``), and kernel 7 also on the Llama-3.1-8B lm_head
(128256 x 4096) at one token row; kernel 2 at the smoke's flash-decode
cases (Hq 32, Hkv 8, d 64, T 2048; B 1 and 8 at pos 0, 300 and 2047,
``check_flash_decode``; the library there is
``scaled_dot_product_attention`` over keys 0..pos). x is in ``--x-dtype``
(the a8 kernels quantize it either way; kernel 2's q is bf16), at each
batch; each time is the CUDA-graph replay
of ``chip_smoke.time_ms`` over rotating weight copies (cold from memory),
and the library matmul on the dequantized weight (in x's type) is timed
beside it. ``--eager`` adds each case's time per call in an eager loop of
wrapper calls on one weight (host clock: the wrapper's host cost where it
exceeds the kernel's). ``--step`` adds the per-layer decode step of two
models at Llama-3.2-1B widths, 4 layers (``chip_smoke._decode_ms``, host
clock, ``layout="perlayer"``, 47 steps at batch 1 and 8): an asymmetric
act-order W4 model on backend "cuda" (every linear through kernel 5) and
a symmetric W4 one on "cuda_a8" (kernel 6). ``--check`` adds each case's largest
difference from its plain version. ``--profile`` adds the device microseconds a
call spends in each kernel it launches (``torch.profiler`` over eager
calls on one weight, warm in L2 where it fits). A variant of a path
threshold or plan is measured on a copy of the tree with that one change,
given as its ROOT. Prints one line ``TIMING {json}``: per case the kernel ms,
the library ms and the bound ms (and ``eager_ms``), per step model its ms
by batch. Run the two roots in turns in one call (parent, change, change,
parent): host and card differ between calls.
"""
import argparse
import json
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--batches", default="1,8,128,512")
    ap.add_argument("--x-dtype", default="bf16", choices=("bf16", "float32"))
    ap.add_argument("--kernels", default="k5,k6")
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, args.root)

    import torch

    import chip_smoke as cs
    import torch.nn.functional as F

    from ganq_tpu_torch.ops import cuda_lib
    from ganq_tpu_torch.ops.fused_attention import (
        flash_decode_attention, flash_decode_split_reference)
    from ganq_tpu_torch.ops.lut_matmul import lut_matmul, lut_matmul_reference
    from ganq_tpu_torch.ops.packing import pack_int_rows, unpack_int_rows
    from ganq_tpu_torch.ops.uniform_matmul import (dequantize_uniform,
                                                   uniform_a8_matmul,
                                                   uniform_matmul)
    from ganq_tpu_torch.ops.uniform_matmul import (uniform_a8_reference,
                                                   uniform_matmul_reference)
    from ganq_tpu_torch.ops.w8_matmul import (w8_matmul, w8_matmul_reference,
                                              w8a8_matmul, w8a8_reference)

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    kernels = args.kernels.split(",")
    cuda_lib.build_all(
        [src for src, ks in (("lut_matmul", ("k1", "k1w8")),
                             ("flash_decode", ("k2",)),
                             ("uniform_matmul", ("k5", "k6")),
                             ("w8_matmul", ("k7", "k8")))
         if any(k in kernels for k in ks)])
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = [int(b) for b in args.batches.split(",")]
    xt = torch.bfloat16 if args.x_dtype == "bf16" else torch.float32

    def eager_ms(fn, a, iters=300):
        fn(*a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*a)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    def kernel_us(fn, a, iters=20):
        """Device microseconds a call spends in each kernel it launches
        (torch.profiler over ``iters`` eager calls, by kernel name)."""
        from torch.profiler import ProfilerActivity, profile

        fn(*a)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn(*a)
            torch.cuda.synchronize()
        us = {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = ev.cuda_time_total
            if t > 0:
                us[ev.key[:60]] = t / iters
        return us

    def make(M, K, bits):
        codes = torch.randint(0, 2**bits, (M, K), generator=gen,
                              device="cuda", dtype=torch.int32)
        scales = (torch.rand((M, K // 128), generator=gen, device="cuda")
                  * 0.003 + 0.001) * min(1.0, 16.0 / 2**bits)
        packed = pack_int_rows(codes, bits)
        return (packed, scales, None, None, bits)

    def dense_uniform(w, M, K, bits):
        return dequantize_uniform(w[0], w[1], None, None, bits, K)

    def make_w8(M, K, bits):
        w8 = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.int8)
        scale = torch.rand((M, 1), generator=gen, device="cuda") * 3e-4 + 1e-4
        return (w8, scale)

    def dense_w8(w, M, K, bits):
        return w[0].float() * w[1]

    def make_lut(M, K, bits):
        lut = torch.sort(torch.randn((M, 2**bits), generator=gen,
                                     device="cuda") * 0.006,
                         dim=1).values.to(torch.bfloat16)
        idx = torch.randint(0, 2**bits, (M, K), generator=gen, device="cuda",
                            dtype=torch.int32)
        return (lut, pack_int_rows(idx, bits), bits)

    def dense_lut(w, M, K, bits):
        return torch.take_along_dim(w[0].float(), unpack_int_rows(
            w[1], bits, K).long(), dim=1)

    lm_head = {"lm_head": (128256, 4096)}

    out = {"root": args.root, "x_dtype": args.x_dtype}
    with torch.inference_mode():
        linears = cs.LLAMA_1B_LINEARS
        for name, kernel, bits, peak, mk, dense_of, shapes, bs in (
                ("k1", lut_matmul, 4, cs.BF16_FLOPS_PER_S, make_lut,
                 dense_lut, linears, batches),
                ("k1w8", lut_matmul, 8, cs.BF16_FLOPS_PER_S, make_lut,
                 dense_lut, linears, batches),
                ("k5", uniform_matmul, 4, cs.BF16_FLOPS_PER_S, make,
                 dense_uniform, linears, batches),
                ("k6", uniform_a8_matmul, 4, cs.INT8_OPS_PER_S, make,
                 dense_uniform, linears, batches),
                ("k6", uniform_a8_matmul, 8, cs.INT8_OPS_PER_S, make,
                 dense_uniform, linears, batches),
                ("k7", w8_matmul, 8, cs.BF16_FLOPS_PER_S, make_w8, dense_w8,
                 linears, batches),
                ("k7", w8_matmul, 8, cs.BF16_FLOPS_PER_S, make_w8, dense_w8,
                 lm_head, [1]),
                ("k8", w8a8_matmul, 8, cs.INT8_OPS_PER_S, make_w8, dense_w8,
                 linears, batches)):
            if name not in kernels:
                continue
            for label, (M, K) in shapes.items():
                n = cs.copies_for(M * K * bits // 8)
                weights = [mk(M, K, bits) for _ in range(n)]
                dense = [dense_of(w, M, K, bits).to(xt)
                         for w in weights[:cs.copies_for(2 * M * K)]]
                for B in bs:
                    x = torch.randn((B, K), generator=gen,
                                    device="cuda").to(xt)
                    iters = max(2 * n, 30)
                    k_ms = cs.time_ms(kernel, [(x, *w) for w in weights],
                                      iters)
                    l_ms = cs.time_ms(lambda xx, w: torch.matmul(xx, w.T),
                                      [(x, w) for w in dense], iters)
                    wbytes = (M * K + M * 4 if name in ("k7", "k8") else
                              M * K * bits // 8 + M * 2**bits * 2
                              if name.startswith("k1") else
                              M * K * bits // 8 + M * (K // 128) * 4)
                    nbytes = (B * K + B * M) * x.element_size() + wbytes
                    b_ms, _ = cs.bound(nbytes, 2.0 * B * M * K, peak)
                    out[f"{name}_w{bits}_{label}_B{B}"] = dict(
                        ms=k_ms, library_ms=l_ms, bound_ms=b_ms)
                    if args.eager:
                        out[f"{name}_w{bits}_{label}_B{B}"]["eager_ms"] = (
                            eager_ms(kernel, (x, *weights[0])))
                    if args.check:
                        plain = {lut_matmul: lut_matmul_reference,
                                 uniform_matmul: uniform_matmul_reference,
                                 uniform_a8_matmul: uniform_a8_reference,
                                 w8_matmul: w8_matmul_reference,
                                 w8a8_matmul: w8a8_reference}[kernel]
                        got = kernel(x, *weights[0]).float()
                        ref = plain(x, *weights[0]).float()
                        out[f"{name}_w{bits}_{label}_B{B}"]["max_abs_err"] = (
                            float((got - ref).abs().max()))
                    if args.profile:
                        out[f"{name}_w{bits}_{label}_B{B}"]["kernel_us"] = (
                            kernel_us(kernel, (x, *weights[0])))
                del weights, dense
                torch.cuda.empty_cache()
        if "k2" in kernels:
            Hq, Hkv, d, T = 32, 8, 64, 2048
            scale = 1.0 / d**0.5
            for B in (1, 8):
                for pos in (0, 300, T - 1):
                    n = cs.copies_for(2 * B * (pos + 1) * Hkv * d * 2, cap=64)
                    caches = [tuple(torch.randn(
                        (B, T, Hkv, d), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
                        for _ in range(n)]
                    q = torch.randn((B, Hq, d), generator=gen,
                                    device="cuda").to(torch.bfloat16)
                    pos_t = torch.tensor(pos, dtype=torch.int32,
                                         device="cuda")

                    def library(qq, kk, vv, pos=pos):
                        return F.scaled_dot_product_attention(
                            qq[:, :, None], kk[:, :pos + 1].transpose(1, 2),
                            vv[:, :pos + 1].transpose(1, 2), scale=scale,
                            enable_gqa=True)

                    iters = max(2 * n, 30)
                    a = [(q, kk, vv, pos_t, scale) for kk, vv in caches]
                    k_ms = cs.time_ms(flash_decode_attention, a, iters)
                    l_ms = cs.time_ms(library, [(q, kk, vv)
                                                for kk, vv in caches], iters)
                    nbytes = 2 * B * Hq * d * 2 + 2 * B * (pos + 1) * Hkv * d * 2
                    b_ms, _ = cs.bound(nbytes, 4.0 * B * Hq * (pos + 1) * d)
                    key = f"k2_B{B}_pos{pos}"
                    out[key] = dict(ms=k_ms, library_ms=l_ms, bound_ms=b_ms)
                    if args.eager:
                        out[key]["eager_ms"] = eager_ms(flash_decode_attention,
                                                        a[0])
                    if args.check:
                        got = flash_decode_attention(*a[0]).float()
                        ref = flash_decode_split_reference(*a[0]).float()
                        out[key]["max_abs_err"] = float((got - ref).abs().max())
                    if args.profile:
                        out[key]["kernel_us"] = kernel_us(flash_decode_attention,
                                                          a[0])
                    del caches
                    torch.cuda.empty_cache()
        if args.step:
            import numpy as np

            from ganq_tpu_torch import GanqModel
            from ganq_tpu_torch.models import synthetic

            cfg = synthetic.llama_3_2_1b_config(4)
            for tag, backend, model in (
                    ("k5_actorder_w4", "cuda", cs._uniform_gptq(
                        cfg, 4, asym=True, actorder=True, seed=8)[0]),
                    ("k6_sym_w4", "cuda_a8", synthetic.make_model(
                        cfg, kind="uniform", bits=4, seed=9))):
                q = GanqModel(cfg, model, backend=backend)
                q.generate(np.zeros((1, 8), dtype=np.int64),
                           max_new_tokens=2, max_seq=16,
                           layout="perlayer")                   # warm-up
                ms = cs._decode_ms(q, f"{tag} per-layer step", (
                    (1, 32, 48), (8, 32, 48)), np.random.default_rng(3),
                    layouts=("perlayer",))
                out[f"step_{tag}"] = {B: v["perlayer"]
                                      for B, v in ms.items()}
                del q, model
                torch.cuda.empty_cache()
    print("TIMING", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
