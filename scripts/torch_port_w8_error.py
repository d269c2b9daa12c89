#!/usr/bin/env python3
"""The summation error of kernel 7 (``w8_matmul``) or kernel 1
(``lut_matmul``, 4-bit codes) with bf16 x at long rows, beside two library
sums of the same exact products, to tell a fault of the kernel from float32
rounding.

    python3 scripts/torch_port_w8_error.py ROOT [--kernel k7|k1]
        [--kp 8192,14336] [--m 72,136,512] [--batch 1023]

ROOT is a checkout of the repository (``.``, or a copy of the tree with
one change to the plan, such as the K split held to 1). For each K' and M
the inputs are drawn from seed 0: for kernel 7 as
``tests/test_torch_cuda_kernels.py::_w8_problem`` draws them (int8
weights, per-row scales in [1e-4, 4e-4)), for kernel 1 as ``_lut_problem``
does (a sorted N(0, 1) bf16 codebook a row, uniform codes); x ~ N(0, 1) in
bf16. Each product is held against the float64 sum of x times the weights
rounded to bf16: "kernel" (its K split over blocks is read from
``ganq_w8_matmul_scratch`` or ``ganq_lut_matmul_scratch``, where ROOT has
it), "cublas_bf16" (``torch.matmul`` in bf16
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
    ap.add_argument("--kernel", default="k7", choices=("k7", "k1"))
    ap.add_argument("--kp", default="8192,14336")
    ap.add_argument("--m", default="72,136,512")
    ap.add_argument("--batch", type=int, default=1023)
    args = ap.parse_args()
    sys.path.insert(0, args.root)

    import torch

    from ganq_tpu_torch.ops import cuda_lib
    from ganq_tpu_torch.ops.lut_matmul import lut_matmul
    from ganq_tpu_torch.ops.packing import pack_int_rows, unpack_int_rows
    from ganq_tpu_torch.ops.w8_matmul import w8_matmul

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    B = args.batch

    def splits(M, Kp):
        """Blocks along K of the kernel's plan at this shape (None where
        ROOT's library has no scratch entry)."""
        lib, sym, shape = (("w8_matmul", "ganq_w8_matmul_scratch", (B, M, Kp,
                                                                    1))
                           if args.kernel == "k7" else
                           ("lut_matmul", "ganq_lut_matmul_scratch",
                            (B, M, Kp // 8, 4, 1)))
        try:
            fn = cuda_lib.function(lib, sym, [ctypes.c_int] * len(shape))
        except AttributeError:
            return None
        return max(1, fn(*shape) // (B * M * 4))

    def measure(got, exact):
        scale = float(exact.abs().max())
        err = (got.double() - exact).abs()
        ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(1e-30)))
                         - 7)
        return {"max_err": float(err.max()),
                "excess_over_ulp": float((err - ulp).max()) / scale,
                "past_bound": int((err > ulp + 1e-6 * scale).sum()),
                "scale": scale}

    out = {"root": args.root, "kernel": args.kernel, "batch": B}
    for Kp in (int(k) for k in args.kp.split(",")):
        for M in (int(m) for m in args.m.split(",")):
            gen = torch.Generator(device="cuda").manual_seed(0)
            if args.kernel == "k7":
                w8 = torch.randint(-127, 128, (M, Kp), generator=gen,
                                   device="cuda",
                                   dtype=torch.int32).to(torch.int8)
                s = torch.rand((M, 1), generator=gen,
                               device="cuda") * 3e-4 + 1e-4
                w = (w8.float() * s).to(torch.bfloat16)
                run = (w8_matmul, (w8, s))
            else:
                lut = torch.sort(torch.randn((M, 16), generator=gen,
                                             device="cuda"),
                                 dim=1).values.to(torch.bfloat16)
                packed = pack_int_rows(torch.randint(
                    0, 16, (M, Kp), generator=gen, device="cuda",
                    dtype=torch.int32), 4)
                w = torch.take_along_dim(lut, unpack_int_rows(
                    packed, 4, Kp).long(), dim=1)
                run = (lut_matmul, (lut, packed, 4))
            x = torch.randn((B, Kp), generator=gen,
                            device="cuda").to(torch.bfloat16)
            exact = x.double() @ w.double().T
            out[f"Kp{Kp}_M{M}"] = {
                "kernel_nsplit": splits(M, Kp),
                "kernel": measure(run[0](x, *run[1]), exact),
                "cublas_bf16": measure(x @ w.T, exact),
                "cublas_f32": measure((x.float() @ w.float().T).to(
                    torch.bfloat16), exact)}
            torch.cuda.synchronize()
    print("ERRORS " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
