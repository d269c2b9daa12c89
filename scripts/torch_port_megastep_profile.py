#!/usr/bin/env python3
"""Where the time of the port's whole-step W8A8 kernel (kernel 12) goes.

    python3 scripts/torch_port_megastep_profile.py [--layers 28] [--pos 160]

On one NVIDIA GPU: builds an instrumented copy of
``ganq_tpu_torch/csrc/megastep_w8.cu`` into ``build/`` (block 0 reads the
global timer after every grid barrier), runs one decode step at
Llama-3.2-3B's widths (random megapack, ``--layers`` layers, K/V history of
``--pos`` keys) at batch 1 and 8, and prints the microseconds of each phase
summed over the layers (each phase's time includes the barrier after it),
then the cost of a grid barrier alone (a cooperative launch of the same grid
size that only synchronises). The instrumented build is a profiling copy;
the port always runs the source as it is.
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

PHASES = ["mlp residual", "attn norm", "qkv+rope", "attention", "o product",
          "o residual", "mlp norm", "gate/up", "down"]

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


def build(max_layers: int) -> ctypes.CDLL:
    from ganq_tpu_torch.ops import cuda_lib

    slots = len(PHASES) + 1
    src = (ROOT / "ganq_tpu_torch/csrc/megastep_w8.cu").read_text()
    src = src.replace('#include "w8a8_fused.cuh"', (
        f'#include "{ROOT}/ganq_tpu_torch/csrc/w8a8_fused.cuh"\n'
        f"__device__ unsigned long long g_prof[{max_layers * slots + 1}];\n"
        "__device__ __forceinline__ unsigned long long gtime() {\n"
        "  unsigned long long t;\n"
        '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
        "  return t;\n}\n"))
    count = [0]

    def stamp(m):
        count[0] += 1
        return (m.group(0) + "\n    if (blockIdx.x == 0 && threadIdx.x == 0) "
                f"g_prof[l * {slots} + {count[0]}] = gtime();")

    src = re.sub(r"    grid\.sync\(\);", stamp, src)
    if count[0] != len(PHASES):
        raise RuntimeError(f"found {count[0]} grid barriers per layer, the "
                           f"profile names {len(PHASES)} phases")
    src = src.replace(
        "  for (int l = 0; l < a.L; ++l) {\n",
        "  if (blockIdx.x == 0 && threadIdx.x == 0) g_prof[0] = gtime();\n"
        "  for (int l = 0; l < a.L; ++l) {\n", 1)
    out = cuda_lib.BUILD_DIR / "profile"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "megastep_w8_profile.cu", out / "libmegastep_w8_profile.so"
    cu.write_text(src + _TAIL)
    res = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                          str(so), str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    return ctypes.CDLL(str(so))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--pos", type=int, default=160)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from ganq_tpu_torch.ops import cuda_lib
    from ganq_tpu_torch.ops.megastep import megastep_decode_w8a8

    import chip_smoke

    lib = build(args.layers)
    slots = len(PHASES) + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    L, H, I, q_dim, kv_dim, d = args.layers, 3072, 8192, 3072, 1024, 128
    Dqkv, Hkv = q_dim + 2 * kv_dim, kv_dim // d

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
    ang = torch.rand(d // 2, generator=gen, device="cuda") * 6.2831853
    kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=d, rotary_dim=d,
              scale=1.0 / math.sqrt(d))
    real = cuda_lib.function

    def profiled(name, symbol, argtypes):
        if symbol != "ganq_megastep_w8":
            return real(name, symbol, argtypes)
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    cuda_lib.function = profiled
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for B in (1, 8):
        kc = (torch.randn((L, B * Hkv, 2048, d), generator=gen, device="cuda")
              * 0.5).to(torch.bfloat16)
        vc = torch.randn_like(kc, dtype=torch.float32).to(torch.bfloat16)
        x = torch.randn((B, H), generator=gen, device="cuda").to(torch.bfloat16)
        pos = torch.tensor(args.pos, dtype=torch.int32, device="cuda")
        for _ in range(3):
            megastep_decode_w8a8(x, mp, kc, vc, pos, torch.cos(ang),
                                 torch.sin(ang), **kw)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (L * slots + 1))()
        if lib.prof_read(buf):
            raise RuntimeError("cudaMemcpyFromSymbol failed")
        per, prev = [0.0] * len(PHASES), buf[0]
        for li in range(L):
            for p in range(len(PHASES)):
                cur = buf[li * slots + p + 1]
                per[p] += (cur - prev) / 1e3
                prev = cur
        print(f"batch {B}, {L} layers, pos {args.pos}: "
              f"{sum(per):.1f} us from the first barrier to the last; per "
              "phase (us, summed over layers, each with its barrier): "
              + ", ".join(f"{n} {v:.1f}" for n, v in zip(PHASES, per)))
        del kc, vc
    cuda_lib.function = real
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
