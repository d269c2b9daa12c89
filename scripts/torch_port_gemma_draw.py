#!/usr/bin/env python3
"""Kernel 14's gemma instantiation on the draw of ``chip_smoke.py``'s
``check_gemma`` that the check's float32 spread does not cover, taken apart.

    python3 scripts/torch_port_gemma_draw.py [--seeds 101,102,103]

The smoke's kernel phase is replayed with its generator (seed 0) up to
``check_gemma``, with ``check_uniform_kernels``' batch-128 inputs drawn from
the shared generator too (that is the draw: every later check's inputs
move). ``check_gemma`` then runs with kernel 14's wrapper recording the
inputs of the "w4p" Gemma-3-27B batch-64 call. On those inputs:

- determinism: three kernel launches, compared bit for bit;
- the full-depth error of y against the plain version, with the spread of
  each of the check's four nudges, and the slots (rows) it sits in;
- by depth: the kernel and the plain version over the first d layers, each
  with the plain version's own spread under the check's first nudge;
- by layer: layer l alone, kernel and plain version on the same input (the
  plain version's hidden state after layers 0..l-1), against the spread
  of that one layer: a layer of the port that is wrong shows here on its
  own, where a code flipped by a last-bit difference stays within it;
- the plain version's own amplification: its layers d..L-1 run from the
  kernel's hidden state after layers 0..d-1 and from its own (both in
  x's type), the two compared with each other, with the kernel's whole
  step and with the plain version's whole step (whose state between
  layers stays float32: rounding it once to x's type is a perturbation
  of the plain version alone), per step and in the worst slot, whose
  hidden state is described by depth (max |h| over its RMS).

Then ``check_gemma`` runs on fresh generators (``--seeds``, building only
its kernel where ``--fresh-only``) and reports the first case outside its
bound; that case is taken apart the same way. Writes
chiprun_out/gemma_draw.json and prints its summary.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def rel(a, b):
    b = b.float()
    return float((a.float() - b).norm() / b.norm().clamp_min(1e-30))


def analyze(call, decode, plain, log, layers=True):
    """Take apart one recorded kernel-14 call (see the module docstring)."""
    import torch

    x, mp, kc, vc, pos_t, cos, sin, kw = call
    pos = pos_t.tolist()
    L = mp["qkv_pk"].shape[0]
    out = {"B": x.shape[0], "L": L}

    def nudged(ops, keys, sign=1):
        ops = dict(ops)
        for k in keys:
            if k == "qk_nm":
                ops[k] = ops[k].clone()
                ops[k][:, 0] = (ops[k][:, 0] + 1) * (1 + sign * 2**-22) - 1
            else:
                ops[k] = (ops[k] + 1) * (1 + sign * 2**-22) - 1
        return ops

    norms = ["attn_norm", "mlp_norm", "pa_norm", "pm_norm"] + (
        ["qk_nm"] if "qk_nm" in mp else [])
    nudges = {"all_up": (norms, 1), "all_down": (norms, -1),
              "attn_mlp_up": (["attn_norm", "mlp_norm"], 1),
              "sandwich_qk_up": (norms[2:], 1)}

    def part(a, b):
        ops = {k: (v[a:b] if torch.is_tensor(v) and v.dim()
                   and v.shape[0] == L else v) for k, v in mp.items()}
        kwl = {k: (v[a:b] if k in ("windows", "rope_sel") and v is not None
                   else v) for k, v in kw.items()}
        return ops, kc[a:b].contiguous(), vc[a:b].contiguous(), kwl

    def slot_rel(a, b):
        return ((a.float() - b.float()).norm(dim=1)
                / b.float().norm(dim=1).clamp_min(1e-30))

    runs = [decode(x, mp, kc, vc, pos_t, cos, sin, **kw) for _ in range(3)]
    out["deterministic"] = all(
        torch.equal(r[i], runs[0][i]) for r in runs[1:] for i in range(3))
    got = runs[0]
    ref = plain(x, mp, kc, vc, pos, cos, sin, **kw)
    out["full"] = {"rel_y": rel(got[0], ref[0]), "rel_k": rel(got[1], ref[1]),
                   "rel_v": rel(got[2], ref[2])}
    for name, (keys, sign) in nudges.items():
        n = plain(x, nudged(mp, keys, sign), kc, vc, pos, cos, sin, **kw)
        out["full"][f"spread_y_{name}"] = rel(n[0], ref[0])
    per_slot = slot_rel(got[0], ref[0])
    top = torch.argsort(per_slot, descending=True)[:6].tolist()
    worst = top[0]
    out["worst_slots"] = {
        int(b): {"rel_y": float(per_slot[b]), "first_layer_other_k": next(
            (li for li in range(L)
             if not torch.equal(got[1][li, b], ref[1][li, b])), None)}
        for b in top}
    out["slots_rel_y_above_1e-2"] = int((per_slot > 1e-2).sum())
    log(f"full depth: {out['full']}; deterministic {out['deterministic']}; "
        f"worst slots {out['worst_slots']}")

    # the states after layers 0..d-1 (in x's type), the kernel's and plain's
    ys_k, ys_p = [x], [x]
    for d in range(1, L):
        ops, kcd, vcd, kwd = part(0, d)
        ys_k.append(decode(x, ops, kcd, vcd, pos_t, cos, sin, **kwd)[0])
        ys_p.append(plain(x, ops, kcd, vcd, pos, cos, sin, **kwd)[0])
    out["amplification"] = []
    for d in range(1, L):
        ops, kcd, vcd, kwd = part(d, L)
        h = plain(ys_k[d], ops, kcd, vcd, pos, cos, sin, **kwd)[0]
        q = plain(ys_p[d], ops, kcd, vcd, pos, cos, sin, **kwd)[0]
        yp = ys_p[d][worst].float()
        row = {"d": d,
               "state_rel": rel(ys_k[d], ys_p[d]),
               "state_rel_worst_slot": float(slot_rel(ys_k[d], ys_p[d])[worst]),
               "worst_slot_state_max_over_rms": float(
                   yp.abs().max() / yp.pow(2).mean().sqrt().clamp_min(1e-30)),
               "plain_from_kernel_state_vs_from_own": rel(h, q),
               "worst_slot": float(slot_rel(h, q)[worst]),
               "kernel_step_vs_plain_from_kernel_state": rel(got[0], h),
               "plain_from_own_rounded_state_vs_plain_step": rel(q, ref[0]),
               "worst_slot_rounded": float(slot_rel(q, ref[0])[worst])}
        out["amplification"].append(row)
        log(f"from depth {d}: {row}")
    del runs, ref, ys_k, ys_p
    if not layers:
        return out

    out["by_depth"] = []
    for d in range(1, L + 1):
        ops, kcd, vcd, kwd = part(0, d)
        g = decode(x, ops, kcd, vcd, pos_t, cos, sin, **kwd)
        p = plain(x, ops, kcd, vcd, pos, cos, sin, **kwd)
        n = plain(x, nudged(ops, norms), kcd, vcd, pos, cos, sin, **kwd)
        row = {"depth": d, "rel_y": rel(g[0], p[0]),
               "spread_y": rel(n[0], p[0]),
               "k_elems_other": int((g[1] != p[1]).sum())}
        out["by_depth"].append(row)
        log(f"depth {d}: {row}")

    out["by_layer"] = []
    xl = x
    for li in range(L):
        ops, kcl, vcl, kwl = part(li, li + 1)
        g = decode(xl, ops, kcl, vcl, pos_t, cos, sin, **kwl)
        p = plain(xl, ops, kcl, vcl, pos, cos, sin, **kwl)
        spreads = {}
        for name, (keys, sign) in nudges.items():
            n = plain(xl, nudged(ops, keys, sign), kcl, vcl, pos, cos, sin,
                      **kwl)
            spreads[name] = rel(n[0], p[0])
        row = {"layer": li, "window": int(kwl["windows"][0]),
               "rel_y": rel(g[0], p[0]), "rel_k": rel(g[1], p[1]),
               "rel_v": rel(g[2], p[2]),
               "max_slot_rel_y": float(slot_rel(g[0], p[0]).max()),
               "k_elems_other": int((g[1] != p[1]).sum()),
               "spread_y": spreads,
               "within_check_bound": rel(g[0], p[0])
               <= 2 * max(spreads.values()) + 2**-8}
        out["by_layer"].append(row)
        log(f"layer {li} alone: {row}")
        xl = p[0]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="101,102,103")
    ap.add_argument("--fresh-only", action="store_true")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from ganq_tpu_torch.ops import cuda_lib
    from ganq_tpu_torch.ops import megastep_lowbit as mlb

    cs.phase_environment()
    t0 = time.time()
    if args.fresh_only:
        cuda_lib.build_all(("megastep_lowbit_gemma",))
    else:
        cuda_lib.build_all()
    cs.log(f"build in {time.time() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False

    decode = mlb.megastep_lowbit_decode
    plain = mlb.megastep_lowbit_plain
    seen = {}

    def recording(x, mp, kc, vc, pos_t, cos, sin, **kw):
        seen["last"] = (x, mp, kc, vc, pos_t, cos, sin, kw)
        if (kw.get("bits") == 4 and x.shape[0] == 64
                and kw.get("rope_sel") is not None and "call" not in seen):
            seen["call"] = seen["last"]
        return decode(x, mp, kc, vc, pos_t, cos, sin, **kw)

    # the wrapper counts its launches on the module's name
    recording.launches, recording.by_source = 0, {}

    def check(gen):
        """check_gemma on ``gen`` through ``recording``: its message or
        "passed"."""
        mlb.megastep_lowbit_decode = recording
        try:
            cs.check_gemma(gen)
            return "passed"
        except AssertionError as e:
            return str(e)
        finally:
            mlb.megastep_lowbit_decode = decode

    out = {}
    with torch.inference_mode():
        if not args.fresh_only:
            gen = torch.Generator(device="cuda").manual_seed(0)
            cs.check_lut_matmul(gen)
            cs.check_flash_decode(gen)
            cs.check_s_step(gen)
            # the batch-128 rows from the shared generator as well
            real = torch.Generator
            torch.Generator = lambda device=None: type(
                "Shared", (), {"manual_seed": staticmethod(lambda s: gen)})()
            try:
                cs.check_uniform_kernels(gen)
            finally:
                torch.Generator = real
            for fn in (cs.check_w8_kernels, cs.check_fused_w8a8,
                       cs.check_megastep, cs.check_grouped_megasteps,
                       cs.check_moe_expert, cs.check_lm_fold, cs.check_lora,
                       cs.check_arch):
                fn(gen)
            out["check_gemma"] = check(gen)
            cs.log(f"check_gemma on the draw: {out['check_gemma']}")
            out["draw"] = analyze(seen.pop("call"), decode, plain, cs.log)
            seen.clear()
            torch.cuda.empty_cache()

        out["fresh_seeds"] = {}
        for s in [int(v) for v in args.seeds.split(",") if v]:
            msg = check(torch.Generator(device="cuda").manual_seed(s))
            out["fresh_seeds"][s] = {"check_gemma": msg}
            cs.log(f"check_gemma, generator seed {s}: {msg}")
            if msg != "passed":
                out["fresh_seeds"][s].update(analyze(
                    seen["last"], decode, plain, cs.log, layers=False))
            seen.clear()
            torch.cuda.empty_cache()

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "gemma_draw.json"), "w") as f:
        json.dump(out, f, indent=1)
    print("GEMMA_DRAW", json.dumps(
        {"check_gemma": out.get("check_gemma"),
         "fresh_seeds": {s: v["check_gemma"]
                         for s, v in out["fresh_seeds"].items()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
