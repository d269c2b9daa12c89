#!/usr/bin/env python3
"""Where the time of the port's whole-step kernels (kernels 12, 13, 14) and
of the fused expert kernel (kernel 15) goes.

    python3 scripts/torch_port_megastep_profile.py [--layers 28] [--pos 160]
        [--kernels 12,13,14,15]

On one NVIDIA GPU: builds instrumented copies of
``ganq_tpu_torch/csrc/megastep_w8.cu`` (kernel 12) and of the group-scaled
kernel of ``csrc/megastep_grouped.cuh`` with the entry points of
``megastep4.cu`` (kernel 13) and ``megastep_lowbit.cu`` (kernel 14) into
``build/profile/`` (block 0 reads the global timer after every grid barrier
of the layer loop), runs one decode step at Llama-3.2-3B's widths (random
operands, ``--layers`` layers, K/V history of ``--pos`` keys) at batch 1
and 8 (kernel 12 and 13), and 1, 8 and 64 (kernel 14's "w4p" and "w8p"),
and prints the microseconds of each phase summed over the layers (each
phase's time includes the barrier after it), then the cost of a grid
barrier alone (a cooperative launch of the same grid size that only
synchronises). The instrumented builds are profiling copies; the port always
runs the sources as they are. Kernel 15 (``csrc/moe_expert.cu``, four
launches a call) runs alone at Mixtral-8x7B's widths (8 experts, hidden
4096, intermediate 14336, top-2 routing of random logits), 8- and 4-bit
experts at batch 1 and 8: its time per call (a CUDA graph of 20 calls,
timed with CUDA events) and each launch's device time
(``torch.profiler``).
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = {
    "w8": ["mlp residual", "attn norm", "qkv+rope", "attention", "o product",
           "o residual", "mlp norm", "gate/up", "down"],
    "grouped": ["layer entry", "attn norm", "qkv+rope", "attention",
                "attn int8", "o product", "mlp norm", "gate/up", "act int8",
                "down"]}
_TAIL = """
extern "C" int prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
__global__ void __launch_bounds__(kThreads, 2) sync_only(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}
extern "C" int sync_bench(int n, int blocks, void* stream) {
  void* params[] = {&n};
  return (int)cudaLaunchCooperativeKernel((void*)sync_only, dim3(blocks),
                                          dim3(kThreads), params, 0,
                                          (cudaStream_t)stream);
}
"""


def _instrument(src: str, phases, slots: int) -> str:
    """Stamp the global timer after each grid barrier of the layer loop
    (indented 4 spaces) and before the loop."""
    count = [0]

    def stamp(m):
        count[0] += 1
        return (m.group(0) + "\n    if (blockIdx.x == 0 && threadIdx.x == 0) "
                f"g_prof[l * {slots} + {count[0]}] = gtime();")

    src = re.sub(r"(?m)^    grid\.sync\(\);", stamp, src)
    if count[0] != len(phases):
        raise RuntimeError(f"found {count[0]} grid barriers per layer, the "
                           f"profile names {len(phases)} phases")
    return src.replace(
        "  for (int l = 0; l < a.L; ++l) {\n",
        "  if (blockIdx.x == 0 && threadIdx.x == 0) g_prof[0] = gtime();\n"
        "  for (int l = 0; l < a.L; ++l) {\n", 1)


def build(kind: str, max_layers: int) -> ctypes.CDLL:
    """An instrumented copy of kernel 12 (``kind`` "w8") or of the
    group-scaled kernel with the entry points of kernels 13 and 14
    ("grouped")."""
    from ganq_tpu_torch.ops import cuda_lib

    csrc = ROOT / "ganq_tpu_torch/csrc"
    phases = PHASES[kind]
    slots = len(phases) + 1
    head = (f'#include "{csrc}/w8a8_fused.cuh"\n'
            f"__device__ unsigned long long g_prof[{max_layers * slots + 1}];\n"
            "__device__ __forceinline__ unsigned long long gtime() {\n"
            "  unsigned long long t;\n"
            '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
            "  return t;\n}\n")
    if kind == "w8":
        src = (csrc / "megastep_w8.cu").read_text().replace(
            '#include "w8a8_fused.cuh"', head)
        src = _instrument(src, phases, slots)
    else:
        src = _instrument((csrc / "megastep_grouped.cuh").read_text().replace(
            '#include "w8a8_fused.cuh"', head).replace("#pragma once", ""),
            phases, slots)
        for entry in ("megastep4.cu", "megastep_lowbit.cu"):
            src += (csrc / entry).read_text().replace(
                '#include "megastep_grouped.cuh"', "")
    out = cuda_lib.BUILD_DIR / "profile"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"megastep_{kind}_profile.cu", \
        out / f"libmegastep_{kind}_profile.so"
    cu.write_text(src + _TAIL)
    res = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                          str(so), str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    return ctypes.CDLL(str(so))


def _report(lib, phases, layers: int, label: str) -> None:
    slots = len(phases) + 1
    buf = (ctypes.c_ulonglong * (layers * slots + 1))()
    if lib.prof_read(buf):
        raise RuntimeError("cudaMemcpyFromSymbol failed")
    per, prev = [0.0] * len(phases), buf[0]
    for li in range(layers):
        for p in range(len(phases)):
            cur = buf[li * slots + p + 1]
            per[p] += (cur - prev) / 1e3
            prev = cur
    print(f"{label}: {sum(per):.1f} us from the first barrier to the last; "
          "per phase (us, summed over layers, each with its barrier): "
          + ", ".join(f"{n} {v:.1f}" for n, v in zip(phases, per)),
          flush=True)


def moe_profile(gen) -> None:
    """Kernel 15 alone at Mixtral-8x7B's widths: ms a call and per launch."""
    from torch.profiler import ProfilerActivity, profile

    from ganq_tpu_torch.models.transformer import moe_slots
    from ganq_tpu_torch.ops.moe_expert import moe_expert_decode

    import chip_smoke

    E, H, I, k = 8, 4096, 14336, 2
    for bits in (8, 4):
        mp = chip_smoke._moe_pack(gen, E, H, I, bits)
        for B in (1, 8):
            x = torch.randn((B, H), generator=gen, device="cuda").to(
                torch.bfloat16)
            probs = torch.softmax(torch.randn((B, E), generator=gen,
                                              device="cuda") * 2, dim=-1)
            sel = probs >= torch.topk(probs, k, dim=-1).values[:, -1:]
            gated = torch.where(sel, probs, 0.0)
            slot_ids, wts = moe_slots(gated / gated.sum(-1, keepdim=True), k)

            def call():
                return moe_expert_decode(x, mp, slot_ids, wts, bits=bits)

            ms = chip_smoke.time_ms(call, [()], 20)
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
            parts = []
            for evt in prof.key_averages():
                t = getattr(evt, "device_time_total",
                            getattr(evt, "cuda_time_total", 0))
                if t:
                    parts.append(f"{evt.key[:40]} {t / 5 / 1e3:.4f} ms")
            print(f"kernel 15 (moe_expert_decode) E={E} H={H} I={I} "
                  f"bits={bits} batch {B}, {int((gated.sum(0) > 0).sum())} "
                  f"routed experts: {ms:.4f} ms a call; per launch: "
                  + ("; ".join(parts) or "no device time in the profile"))
        del mp
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--pos", type=int, default=160)
    ap.add_argument("--kernels", default="12,13,14,15")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from ganq_tpu_torch.ops import cuda_lib
    from ganq_tpu_torch.ops.megastep import megastep_decode_w8a8
    from ganq_tpu_torch.ops.megastep4 import megastep4_decode
    from ganq_tpu_torch.ops.megastep_lowbit import megastep_lowbit_decode

    import chip_smoke

    kernels = {int(k) for k in args.kernels.split(",")}
    libs = {}
    if 12 in kernels:
        libs["w8"] = build("w8", args.layers)
    if kernels & {13, 14}:
        libs["grouped"] = build("grouped", args.layers)
    symbols = {"ganq_megastep_w8": "w8", "ganq_megastep4": "grouped",
               "ganq_megastep_lowbit": "grouped"}
    gen = torch.Generator(device="cuda").manual_seed(0)
    L, H, I, q_dim, kv_dim, d = args.layers, 3072, 8192, 3072, 1024, 128
    Dqkv, Hkv = q_dim + 2 * kv_dim, kv_dim // d
    ang = torch.rand(d // 2, generator=gen, device="cuda") * 6.2831853
    cos, sin = torch.cos(ang), torch.sin(ang)
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=d, rotary_dim=d,
              scale=1.0 / math.sqrt(d))
    real = cuda_lib.function

    def profiled(name, symbol, argtypes):
        if symbols.get(symbol) not in libs:
            return real(name, symbol, argtypes)
        fn = getattr(libs[symbols[symbol]], symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    cuda_lib.function = profiled
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())

    def step(kind, label, fn, mp, batches, T, **extra):
        for B in batches:
            kc = (torch.randn((L, B * Hkv, T, d), generator=gen,
                              device="cuda") * 0.5).to(torch.bfloat16)
            vc = torch.randn_like(kc, dtype=torch.float32).to(torch.bfloat16)
            x = torch.randn((B, H), generator=gen, device="cuda").to(
                torch.bfloat16)
            pos = torch.tensor(args.pos, dtype=torch.int32, device="cuda")
            for _ in range(3):
                fn(x, mp, kc, vc, pos, cos, sin, **kw, **extra)
            torch.cuda.synchronize()
            _report(libs[kind], PHASES[kind], L,
                    f"{label}, batch {B}, {L} layers, pos {args.pos}")
            del kc, vc

    if 12 in kernels:
        def stack(f):
            return torch.stack([f() for _ in range(L)])

        mp = {"attn_norm": stack(lambda: torch.ones((1, H), device="cuda")),
              "mlp_norm": stack(lambda: torch.ones((1, H), device="cuda")),
              "qkv_bias": torch.zeros((L, 1, Dqkv), device="cuda")}
        for key, (M, K) in (("qkv", (Dqkv, H)), ("o_t", (q_dim, H)),
                            ("gateup", (2 * I, H)), ("down_t", (I, H))):
            pairs = [chip_smoke._w8_pair(gen, M, K) for _ in range(L)]
            mp["down_t" if key == "down_t" else f"{key}_w8"] = torch.stack(
                [w for w, _ in pairs])
            if key in ("qkv", "gateup"):
                mp[f"{key}_scale"] = torch.stack([s for _, s in pairs])
        for key in ("o_t_scale", "down_scale"):
            mp[key] = stack(lambda: torch.rand((1, H), generator=gen,
                                               device="cuda") * 3e-5 + 1e-5)
        step("w8", "kernel 12 (w8)", megastep_decode_w8a8, mp, (1, 8), 2048)
        del mp
    if 14 in kernels:
        for bits in (4, 8):
            mp = chip_smoke._grouped_pack(gen, L, H, q_dim, kv_dim, I, bits,
                                          False)
            step("grouped", f"kernel 14 ({'w4p' if bits == 4 else 'w8p'})",
                 megastep_lowbit_decode, mp, (1, 8, 64), 256, bits=bits)
            del mp
    if 13 in kernels:
        mp = chip_smoke._grouped_pack(gen, L, H, q_dim, kv_dim, I, 4, True)
        step("grouped", "kernel 13 (w4)", megastep4_decode, mp, (1, 8), 256)
        del mp
    cuda_lib.function = real
    if 15 in kernels:
        moe_profile(gen)
    if not libs:
        return 0
    lib = next(iter(libs.values()))
    blocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for n in (10, 1000):
        lib.sync_bench(n, blocks, ctypes.c_void_p(stream))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if lib.sync_bench(n, blocks, ctypes.c_void_p(stream)):
            raise RuntimeError("cooperative launch failed")
        end.record()
        torch.cuda.synchronize()
        print(f"{n} grid barriers over {blocks} blocks: "
              f"{start.elapsed_time(end) * 1e3 / n:.3f} us each")
    return 0


if __name__ == "__main__":
    sys.exit(main())
