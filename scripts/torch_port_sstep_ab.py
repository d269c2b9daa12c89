#!/usr/bin/env python3
"""Time kernels 3 (``s_step_blocked_kernel``) and 4 (``s_step_kernel``), the
GANQ S-step, for the port found at a checkout root, to compare two builds
of them on one card.

    python3 scripts/torch_port_sstep_ab.py ROOT [--kernels k3,k4]
        [--cases down,8B-down,...] [--check] [--profile] [--quantize LAYERS]

ROOT is a checkout of the repository (``.`` or, for the parent commit, a
``git archive`` of it unpacked under ``build/``); its kernel sources build
into ROOT/build. The cases are ``chip_smoke.SSTEP_CASES``: the
Llama-3.2-1B linears at V = 16, q/o at V = 8 and 4, 256 x 512 at V = 256,
and the Llama-3.1-8B down projection (4096 x 14336, V = 16); W, L and T
are drawn as ``check_s_step`` draws them. Each time is the mean device
time of eager calls between CUDA events (``chip_smoke.event_ms``). With
``--check``, each case's index agreement, largest |dWerr| where the
indices agree and quad-loss difference against the plain version (the
smoke's bounds: 0.999 / 1e-4 / 1e-5). With ``--profile``, the device ms a
call spends in each kernel it launches (``torch.profiler``): kernel 3's
trailing products apart from its walks. ``--quantize N`` then runs the
smoke's phase 6 (GANQ on an N-layer Llama-3.2-1B-width model, solver
"auto") and reports its layer-0 split. Prints one line ``TIMING {json}``.
Run the two roots in turns in one call (parent, change, change, parent):
host and card differ between calls.
"""
import argparse
import io
import json
import re
import sys
from contextlib import redirect_stdout

CASES = [("q/o", 2048, 2048, 16), ("k/v", 512, 2048, 16),
         ("gate/up", 8192, 2048, 16), ("down", 2048, 8192, 16),
         ("q/o", 2048, 2048, 8), ("q/o", 2048, 2048, 4),
         ("small", 256, 512, 256), ("8B-down", 4096, 14336, 16)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--kernels", default="k3,k4")
    ap.add_argument("--cases", default="")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--quantize", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, args.root)

    import torch

    import chip_smoke as cs
    from ganq_tpu_torch.core.backend import full_f32_matmul
    from ganq_tpu_torch.ops import cuda_lib
    from ganq_tpu_torch.ops.ganq_solver import (s_step, s_step_blocked,
                                                s_step_blocked_kernel,
                                                s_step_kernel)
    from ganq_tpu_torch.quant.ganq import quad_loss
    from ganq_tpu_torch.quant.preamble import _ganq_L

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    cuda_lib.build_all(["ganq_sstep"])
    kernels = {k: v for k, v in
               (("k3", (s_step_blocked_kernel, s_step_blocked)),
                ("k4", (s_step_kernel, s_step)))
               if k in args.kernels.split(",")}
    wanted = set(args.cases.split(",")) if args.cases else None
    gen = torch.Generator(device="cuda").manual_seed(0)

    def kernel_ms(fn, a, iters=3):
        """Device ms a call spends in each kernel it launches."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn(*a)
            torch.cuda.synchronize()
        ms = {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = ev.cuda_time_total
            if t > 0:
                ms[ev.key[:50]] = t / iters / 1e3
        return ms

    out = {"root": args.root, "cases": {}}
    for label, m, n, V in CASES:
        if wanted and label not in wanted:
            continue
        W = torch.randn((m, n), generator=gen, device="cuda") * 0.02
        X = torch.randn((2 * n, n), generator=gen, device="cuda")
        with full_f32_matmul():
            H = X.T @ X / (2 * n)
        del X
        L = _ganq_L(H)
        T = torch.sort(torch.randn((m, V), generator=gen, device="cuda"),
                       dim=1).values * 0.02
        for name, (kernel, plain) in kernels.items():
            first = cs.event_ms(kernel, (W, L, T), 1)
            iters = max(2, min(20, int(400 / max(first, 1e-3))))
            row = {"ms": cs.event_ms(kernel, (W, L, T), iters), "iters": iters}
            if args.check:
                Q, E = kernel(W, L, T)
                Qp, Ep = plain(W, L, T)
                same = Q == Qp
                loss = float(quad_loss(W, torch.take_along_dim(T, Q.long(), 1), H))
                ref = float(quad_loss(W, torch.take_along_dim(T, Qp.long(), 1), H))
                row.update(agreement=float(same.float().mean()),
                           max_abs_err=float((E[same] - Ep[same]).abs().max()),
                           quad_loss_rel=abs(loss - ref) / abs(ref))
                del Q, E, Qp, Ep
            if args.profile:
                row["by_kernel_ms"] = kernel_ms(kernel, (W, L, T))
            out["cases"][f"{name} {label} {m}x{n} V={V}"] = row
            print(f"{name} {label} {m}x{n} V={V}: {json.dumps(row)}",
                  flush=True)
        del W, L, T, H
        torch.cuda.empty_cache()

    if args.quantize:
        buf = io.StringIO()
        with redirect_stdout(buf):
            cs.phase_quantize_path(args.quantize)
        text = buf.getvalue()
        split = re.search(r"layer 0 split \(s\): (\{[^}]*\})", text)
        out["quantize_layer0_split_s"] = json.loads(split.group(1)) if split else None
        per_layer = re.search(r"quantize ([0-9.]+) s for", text)
        out["quantize_s"] = float(per_layer.group(1)) if per_layer else None
        print(text, flush=True)
    print("TIMING " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
