#!/usr/bin/env python3
"""Where a decode step's time goes in the PyTorch port, on one NVIDIA GPU.

    python3 scripts/torch_port_decode_profile.py [--layers 16] [--batch 1]
        [--prompt 128] [--steps 32]

Builds a random-weight Llama-3.2-1B (published widths, 4-bit ``lut``
linears) on the card, prefills a prompt through the "cuda" backend, then
measures the decode step three ways:

1. eager: host clock around ``--steps`` eager decode steps, synchronised at
   the end (what ``GanqModel.generate`` runs today);
2. graph: the same step captured once in a CUDA graph and replayed, timed
   with CUDA events (the device's time for a step without the host's launch
   cost);
3. profile: ``torch.profiler`` over a few eager steps: device time by kernel
   name, and the share of the window in which the device ran a kernel.

It also prints the least time a step could take: the bytes it must read (the
packed weights and codebooks, the bf16 tied lm_head, the KV cache up to the
position) over 3.35 TB/s. Ends with one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ganq_tpu_torch.models import synthetic  # noqa: E402
from ganq_tpu_torch.serve import engine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet


def step_bytes(cfg, batch: int, pos: int, bits: int) -> int:
    """Bytes one decode step must read: packed codes and bf16 codebooks of
    every linear, the bf16 tied embedding as lm_head, K and V up to pos."""
    h, q, kv, it = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                    cfg.intermediate_size)
    shapes = [(q, h), (kv, h), (kv, h), (h, q), (it, h), (it, h), (h, it)]
    per_layer = sum(m * k * bits // 8 + m * (1 << bits) * 2 for m, k in shapes)
    kv_bytes = 2 * batch * (pos + 1) * kv * 2
    return cfg.num_hidden_layers * (per_layer + kv_bytes) + cfg.vocab_size * h * 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)

    cfg = synthetic.llama_3_2_1b_config(layers=args.layers)
    B, S, n = args.batch, args.prompt, args.steps
    dev = torch.device("cuda")
    with torch.inference_mode():
        model = synthetic.make_model(cfg, kind="lut", bits=4, seed=0, device=dev)
        cache = engine.init_cache(cfg, B, S + 4 * n + 16, dev)
        ids = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
        tok = engine.prefill(cfg, model, cache, ids, "cuda").argmax(-1)
        pos = torch.tensor(S, dtype=torch.int32, device=dev)

        def eager_steps(count: int) -> None:
            nonlocal tok
            for _ in range(count):
                tok = engine.decode_step(cfg, model, cache, tok, pos,
                                         "cuda").argmax(-1)
                pos.add_(1)

        eager_steps(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager_steps(n)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3 / n

        # the same step in a CUDA graph: static token and position buffers
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            eager_steps(2)
        torch.cuda.current_stream().wait_stream(side)
        static_tok = tok.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_next = engine.decode_step(cfg, model, cache, static_tok,
                                             pos, "cuda").argmax(-1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            graph.replay()
            static_tok.copy_(static_next)
            pos.add_(1)
        end.record()
        torch.cuda.synchronize()
        graph_ms = start.elapsed_time(end) / n
        tok = static_tok.clone()
        del graph

        from torch.profiler import ProfilerActivity, profile
        prof_steps = 4
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eager_steps(prof_steps)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
    by_kernel = defaultdict(float)
    counts = defaultdict(int)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name] += evt.time_range.elapsed_us()
            counts[evt.name] += 1
    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    pos_mid = S + 2 + n + 2 + n + prof_steps // 2
    bound_ms = step_bytes(cfg, B, pos_mid, 4) / HBM_BYTES_PER_S * 1e3
    print(f"decode step, batch {B}, position ~{pos_mid}, {cfg.num_hidden_layers}"
          f" layers: eager {eager_ms:.4f} ms/step (host clock), graph "
          f"{graph_ms:.4f} ms/step (device, CUDA events), bound "
          f"{bound_ms:.4f} ms (bytes)", flush=True)
    if busy_us:
        print(f"profile over {prof_steps} eager steps: kernels busy "
              f"{busy_us / window_us:.3f} of the window, "
              f"{sum(counts.values()) / prof_steps:.0f} kernels per step")
        for name, us in top:
            print(f"  {us / prof_steps:9.2f} us/step  x{counts[name] // prof_steps:4d}"
                  f"  {name[:100]}")
    else:
        print("profile: torch.profiler recorded no device time (not measured)")
    print(json.dumps({
        "card": smi, "batch": B, "layers": cfg.num_hidden_layers,
        "position": pos_mid, "eager_ms_per_step": eager_ms,
        "graph_ms_per_step": graph_ms, "bound_ms_per_step": bound_ms,
        "eager_tok_s": B * 1e3 / eager_ms, "graph_tok_s": B * 1e3 / graph_ms,
        "device_busy_share": busy_us / window_us if busy_us else None,
        "kernels_per_step": sum(counts.values()) / prof_steps if busy_us else None,
        "top_kernels_us_per_step": {k[:80]: v / prof_steps for k, v in top}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
