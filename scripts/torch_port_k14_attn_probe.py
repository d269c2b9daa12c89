#!/usr/bin/env python3
"""Stamp the card's global timer at the stages of kernel 14's attention
phase, to see where a layer's attention time goes.

    python3 scripts/torch_port_k14_attn_probe.py [--batches 1,8] [--layer 3]

Builds a copy of ``csrc/megastep_lowbit.cu`` whose attention items write
``%globaltimer`` at each stage (item start, K landed, scores, the block's
max, the running max known, V landed, p . v written, the combine's start
and end) for the grid's blocks 0 and B Hkv (the first items of block
indices j = 0 and j = 1 of the unit (row 0, kv head 0)), and the time the
attention's grid barrier was passed, in layer ``--layer`` of a "w4p" step
at Llama-3.2-3B widths (28 layers, ``chip_smoke._grouped_pack``), position
160 + b, at each batch (B Hkv must stay below the grid's blocks). Prints
microseconds from the phase's start, per stage. Needs a CUDA device.
"""

import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ganq_tpu_torch.ops import cuda_lib  # noqa: E402

CSRC = ROOT / "ganq_tpu_torch" / "csrc"
# (source text, stage); the stamp goes after the text for stages 2 and 5
# (a wait and its barrier), before it otherwise
MARKS = [
    ("  int nj = 1;                  // blocks of the longest row\n", 0),
    ("    __syncthreads();                          // the last item's smem "
     "is read\n", 1),
    ("    cp_async_wait<1>();                       // K landed\n"
     "    __syncthreads();\n", 2),
    ("    // the block's max per head, published; and the current token's "
     "score\n", 3),
    ("    // p = exp(s - m_j) rounded to bf16 for p . v; l_j sums the "
     "unrounded p\n", 4),
    ("    cp_async_wait<0>();                       // V landed\n"
     "    __syncthreads();\n", 5),
    ("    // the last item of the unit to arrive combines\n", 6),
    ("    float amax = 0.f;\n", 7),
    ("    amax = block_max(amax, red);\n", 8),
]
NAMES = ["phase start", "item top", "K landed", "scores done", "max known",
         "V landed", "pv written", "combine start", "combine done"]
BARRIER = ("    gphase_attention<ARCH, GEMMA>(a, l, smem, pos_s);\n"
           "    grid.sync();\n")


def build(layer: int) -> ctypes.CDLL:
    src = (CSRC / "megastep_grouped.cuh").read_text().replace("#pragma once",
                                                               "")
    for text, k in MARKS:
        if src.count(text) != 1:
            raise SystemExit(f"marker not found once: {text!r}")
        stamp = (f"    if (threadIdx.x == 0 && l == {layer} && (blockIdx.x == 0"
                 " || blockIdx.x == BG)) g_att[(blockIdx.x == BG) * 16 + "
                 f"{k}] = gtime();\n")
        src = src.replace(text, (text + stamp) if k in (2, 5)
                          else (stamp + text))
    if src.count(BARRIER) != 1:
        raise SystemExit("attention barrier not found once")
    src = src.replace(BARRIER, BARRIER + (
        f"    if (threadIdx.x == 0 && l == {layer} && blockIdx.x == 0) "
        "g_att[15] = gtime();\n"))
    head = (f'#include "{CSRC}/w8a8_fused.cuh"\n'
            "__device__ unsigned long long g_att[32];\n"
            "__device__ __forceinline__ unsigned long long gtime() {\n"
            "  unsigned long long t;\n"
            '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
            "  return t;\n}\n")
    src = head + src.replace('#include "w8a8_fused.cuh"', "")
    src += (CSRC / "megastep_lowbit.cu").read_text().replace(
        '#include "megastep_grouped.cuh"', "")
    src += ('\nextern "C" int probe_read(unsigned long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, g_att, sizeof(g_att));\n"
            "}\n"
            'extern "C" int probe_clear() {\n'
            "  unsigned long long z[32] = {0};\n"
            "  return (int)cudaMemcpyToSymbol(g_att, z, sizeof(z));\n"
            "}\n")
    out = cuda_lib.BUILD_DIR / "attn_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(src)
    res = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS,
                          f"-I{CSRC}", "-o", str(out / "libprobe.so"),
                          str(out / "probe.cu")], capture_output=True,
                         text=True)
    if res.returncode:
        raise SystemExit(res.stdout + res.stderr)
    return ctypes.CDLL(str(out / "libprobe.so"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="1,8")
    ap.add_argument("--layer", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    H, I, q_dim, kv_dim, d, L = cs._l3b_widths()
    Hkv = kv_dim // d
    lib = build(args.layer)
    real = cuda_lib.function

    def function(name, symbol, argtypes):
        if symbol != "ganq_megastep_lowbit":
            return real(name, symbol, argtypes)
        f = getattr(lib, symbol)
        f.argtypes, f.restype = argtypes, ctypes.c_int
        return f

    cuda_lib.function = function
    from ganq_tpu_torch.ops.megastep_lowbit import megastep_lowbit_decode

    gen = torch.Generator(device="cuda").manual_seed(0)
    mp = cs._grouped_pack(gen, L, H, q_dim, kv_dim, I, 4, False)
    ang = torch.rand(64, generator=gen, device="cuda") * 6.2831853
    cos, sin = torch.cos(ang), torch.sin(ang)
    for B in (int(b) for b in args.batches.split(",")):
        kc = (torch.randn((L, B * Hkv, 256, d), generator=gen,
                          device="cuda") * 0.5).to(torch.bfloat16)
        vc = kc.clone()
        x = torch.randn((B, H), generator=gen,
                        device="cuda").to(torch.bfloat16)
        pos = torch.tensor([160 + b for b in range(B)], dtype=torch.int32,
                           device="cuda")
        if lib.probe_clear():
            raise RuntimeError("probe_clear failed")
        with torch.inference_mode():
            for _ in range(3):
                megastep_lowbit_decode(x, mp, kc, vc, pos, cos, sin,
                                       q_dim=q_dim, kv_dim=kv_dim,
                                       head_dim=d, rotary_dim=d,
                                       scale=1 / math.sqrt(d), bits=4)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 32)()
        if lib.probe_read(buf):
            raise RuntimeError("probe_read failed")
        t0 = buf[0]

        def us(v, t0=t0):
            return f"{(v - t0) / 1e3:.2f}" if v else "-"

        print(f"kernel 14 w4p attention, 3B, B={B}, layer {args.layer}, pos "
              "160: us from the phase's start (globaltimer)")
        for label, off in (("block 0 (j = 0)", 0),
                           (f"block {B * Hkv} (j = 1)", 16)):
            print(label + ": " + ", ".join(f"{n} {us(buf[off + k])}"
                                           for k, n in enumerate(NAMES)))
        print(f"attention barrier passed {us(buf[15])}")
        del kc, vc
    return 0


if __name__ == "__main__":
    sys.exit(main())
