#!/usr/bin/env python3
"""Time kernels 14 ("w8p" and "w4p", without the lm fold, and "w8p" with
qwen3's qk-norm rows) and 13 (sym W4, K-major o and down) for the port
found at a checkout root, to compare two builds of it on one card.

    python3 scripts/torch_port_k14_ab.py ROOT

ROOT is a checkout of the repository (``.`` or, for the parent commit, a
``git archive`` of it unpacked under ``build/``); its kernels build into
ROOT/build (the three sources it times). Random packs at Llama-3.2-3B
widths (28 layers, ``chip_smoke._grouped_pack``; the qk-norm case adds
``chip_smoke._arch_operands``), slots at positions 160 + b, batch 1, 8 and
64 (kernel 13: 1 and 8, its limit); each case is the best of three
CUDA-event means over 20 launches. Prints one line ``TIMING {json}``. Run
the two roots in turns in one call (parent, change, change, parent): host
and card differ between calls.
"""

import json
import math
import sys

ROOT = sys.argv[1] if len(sys.argv) > 1 else "."
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ganq_tpu_torch.ops import cuda_lib  # noqa: E402
from ganq_tpu_torch.ops.megastep4 import megastep4_decode  # noqa: E402
from ganq_tpu_torch.ops.megastep_lowbit import megastep_lowbit_decode  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    cuda_lib.build_all(("megastep_lowbit", "megastep_lowbit_arch",
                        "megastep4"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    H, I, q_dim, kv_dim, d, L = cs._l3b_widths()
    Hkv = kv_dim // d
    ang = torch.rand(d // 2, generator=gen, device="cuda") * 6.2831853
    cos, sin = torch.cos(ang), torch.sin(ang)
    out = {"root": ROOT}
    with torch.inference_mode():
        for name, bits, qkn in (("w8p", 8, False), ("w4p", 4, False),
                                ("w8p_qkn", 8, True), ("k13", 4, False)):
            k13 = name == "k13"
            mp = cs._grouped_pack(gen, L, H, q_dim, kv_dim, I, bits, k13)
            if qkn:
                cs._arch_operands(gen, mp, L, H, q_dim, kv_dim, I, True,
                                  False)
            kw = dict(q_dim=q_dim, kv_dim=kv_dim, head_dim=d, rotary_dim=d,
                      scale=1 / math.sqrt(d))
            if not k13:
                kw["bits"] = bits
            fn = megastep4_decode if k13 else megastep_lowbit_decode
            for B in (1, 8) if k13 else (1, 8, 64):
                kc = (torch.randn((L, B * Hkv, 256, d), generator=gen,
                                  device="cuda") * 0.5).to(torch.bfloat16)
                vc = kc.clone()
                x = torch.randn((B, H), generator=gen, device="cuda").to(
                    torch.bfloat16)
                pos = torch.tensor([160 + b for b in range(B)],
                                   dtype=torch.int32, device="cuda")
                out[f"{name}_b{B}"] = min(cs.event_ms(
                    lambda: fn(x, mp, kc, vc, pos, cos, sin, **kw), (), 20)
                    for _ in range(3))
                del kc, vc
            del mp
            torch.cuda.empty_cache()
    print("TIMING", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
