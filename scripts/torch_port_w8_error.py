#!/usr/bin/env python3
"""Kernel 7's summation error at long rows (``w8_matmul``, bf16 x), beside
two library sums of the same exact products, to tell a fault of the kernel
from float32 rounding.

    python3 scripts/torch_port_w8_error.py ROOT [--kp 8192,14336]
        [--m 72,136,512] [--batch 1023]

ROOT is a checkout of the repository (``.``, or a copy of the tree with
one change to the plan, such as the K split held to 1). For each K' and M
the inputs are drawn as ``tests/test_torch_cuda_kernels.py::_w8_problem``
draws them (int8 weights, per-row scales in [1e-4, 4e-4), x ~ N(0, 1) in
bf16, from seed 0). Each product is held against the float64 sum of x
times the weights rounded to bf16: "kernel" (kernel 7; its K split is read
from ``ganq_w8_matmul_scratch``), "cublas_bf16" (``torch.matmul`` in bf16
on the tensor cores, reduced-precision reductions off) and "cublas_f32"
(``torch.matmul`` in float32 with TF32 off, on the CUDA cores), each
rounded to bf16. Per product: the largest error, the largest excess over
one bf16 ulp of the exact value as a fraction of the output's scale (max
|exact|; the card tests hold it to 1e-6) and the outputs past that bound.
Prints one line ``ERRORS {json}``.
"""
import argparse
import ctypes
import json
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--kp", default="8192,14336")
    ap.add_argument("--m", default="72,136,512")
    ap.add_argument("--batch", type=int, default=1023)
    args = ap.parse_args()
    sys.path.insert(0, args.root)

    import torch

    from ganq_tpu_torch.ops import cuda_lib
    from ganq_tpu_torch.ops.w8_matmul import w8_matmul

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    scratch = cuda_lib.function("w8_matmul", "ganq_w8_matmul_scratch",
                                [ctypes.c_int] * 4)
    B = args.batch

    def measure(got, exact):
        scale = float(exact.abs().max())
        err = (got.double() - exact).abs()
        ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(1e-30)))
                         - 7)
        return {"max_err": float(err.max()),
                "excess_over_ulp": float((err - ulp).max()) / scale,
                "past_bound": int((err > ulp + 1e-6 * scale).sum()),
                "scale": scale}

    out = {"root": args.root, "batch": B}
    for Kp in (int(k) for k in args.kp.split(",")):
        for M in (int(m) for m in args.m.split(",")):
            gen = torch.Generator(device="cuda").manual_seed(0)
            w8 = torch.randint(-127, 128, (M, Kp), generator=gen,
                               device="cuda", dtype=torch.int32).to(torch.int8)
            s = torch.rand((M, 1), generator=gen, device="cuda") * 3e-4 + 1e-4
            x = torch.randn((B, Kp), generator=gen,
                            device="cuda").to(torch.bfloat16)
            w = (w8.float() * s).to(torch.bfloat16)
            exact = x.double() @ w.double().T
            nsplit = scratch(B, M, Kp, 1) // (B * M * 4)
            out[f"Kp{Kp}_M{M}"] = {
                "kernel_nsplit": max(1, nsplit),
                "kernel": measure(w8_matmul(x, w8, s), exact),
                "cublas_bf16": measure(x @ w.T, exact),
                "cublas_f32": measure((x.float() @ w.float().T).to(
                    torch.bfloat16), exact)}
            torch.cuda.synchronize()
    print("ERRORS " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
