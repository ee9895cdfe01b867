#!/usr/bin/env python3
"""Kernel 5's backward tile walk at latent 256 on each of several tile
plans, timed at every level of chip_smoke.py's wide airfoil (phase 29:
latent 256, four tail layers).

    python3 bwd_plan_sweep.py [--plans 32x16,16x32,...] [--reps 20]

A plan TRxKS is TR slots a tile and KS weight rows a staged slab
(`csrc/edge_bwd_tiles.cuh`'s `Plan<256, TR, KS>`, the walk's `Wide`).
Each plan's library is `csrc/fused_gmp_bwd.cu` built from a copy of the
sources whose `Wide` is that plan (all `nvcc`s at once, under the
git-ignored build directory), launched through the package's own wrapper
(`fused_gmp.win_bwd_launch`, its plan table set to the one plan). Per
plan and dtype it prints the blocks per SM the walk reaches, the device
ms of one call at each level (the profiler's, as level_times.py reads
it), their sum over the 15 launches of a train step, and checks the
outputs against the package's own kernel 5 on the same inputs: dpre and
dxj bit for bit (a row does not depend on the plan), dW, db and dwf8
within 1e-5 of their RMS (the order in which a block's tiles add into
its partial does). Plans whose shared memory does not fit a block are
listed and skipped. The last line is a JSON object of every figure.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

import torch

import chip_smoke as cs
import level_times as lt

PLANS = "32x16,32x8,16x16,16x32,16x64,8x16,8x32,8x64"
C, LAYERS = 256, 4


def build_plans(plans):
    """Compile kernel 5's source once per plan (TR, KS), all at once:
    {plan: library name}."""
    from bsms_gnn_tpu_torch.ops.kernels import build

    procs = {}
    for tr, ks in plans:
        name = f"fused_gmp_bwd_{tr}x{ks}"
        src = os.path.join(build.BUILD_DIR, f"sweep_{tr}x{ks}")
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.CSRC, src)
        path = os.path.join(src, "edge_bwd_tiles.cuh")
        with open(path) as f:
            text = f.read()
        text, n = re.subn(r"using Wide = Plan<256, \d+, \d+>;",
                          f"using Wide = Plan<256, {tr}, {ks}>;", text)
        if n != 1:
            raise RuntimeError("edge_bwd_tiles.cuh: no `Wide` plan to set")
        with open(path, "w") as f:
            f.write(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", build._lib_path(name),
               os.path.join(src, "fused_gmp_bwd.cu")]
        procs[(tr, ks)] = (name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    names = {}
    for plan, (name, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for plan {plan}:\n{log}")
        names[plan] = name
    return names


def rel_err(got, want):
    err, _, rms = cs.compare(got, want)
    return err / rms if rms else err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plans", default=PLANS)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bwd_plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    from bsms_gnn_tpu_torch.ops.kernels import build, fused_gmp

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}")
    build.build_all()
    plans, skipped = [], []
    for p in args.plans.split(","):
        tr, ks = (int(v) for v in p.split("x"))
        smem = fused_gmp.walk_smem(C, tr, ks, LAYERS, "win")
        fits = smem <= fused_gmp.SMEM_MAX
        (plans if fits else skipped).append((tr, ks))
    print(f"plans {plans}; shared memory past a block at {LAYERS} tail "
          f"layers: {skipped}")
    names = build_plans(plans)
    with torch.no_grad():
        case = cs.build_case(device, wide=True)
    depth = case["hd"].depth
    kernel = fused_gmp.fused_edge_phase_win_bwd
    out = {"card": cs.card_line(),
           "skipped": [f"{a}x{b}" for a, b in skipped]}
    saved = fused_gmp.BWD_PLANS
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            shapes = cs.bwd_kernel_inputs(case, dtype, device)[
                "fused_edge_phase_win_bwd"]
            want = {where: kernel(*a) for where, a in shapes}
            key = str(dtype)[6:]
            for (tr, ks), name in names.items():
                fused_gmp.BWD_PLANS = {**saved, C: ((C, tr, ks),)}
                fused_gmp._walks.clear()
                try:
                    per, errs = {}, {}
                    for where, a in shapes:
                        def call(a=a):
                            return fused_gmp.win_bwd_launch(
                                "sweep", name, fused_gmp._BWD_FN, *a)
                        got = call()
                        w = want[where]
                        cs.require(torch.equal(got[0], w[0])
                                   and torch.equal(got[1], w[1]),
                                   f"plan {tr}x{ks} {where} {key}: dpre or "
                                   f"dxj differs from kernel 5's")
                        errs[where] = max(rel_err(g, v) for g, v in
                                          zip(got[2:], w[2:]))
                        cs.require(errs[where] <= 1e-4,
                                   f"plan {tr}x{ks} {where} {key}: weight "
                                   f"gradients off by {errs[where]:.2e}")
                        per[int(where.split()[1])] = lt.device_ms(
                            call, reps=args.reps)
                    fill = next(iter(fused_gmp._walks.values()))
                finally:
                    fused_gmp.BWD_PLANS = saved
                    fused_gmp._walks.clear()
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                step = sum(ms * (2 if l < depth else 1)
                           for l, ms in per.items())
                out[f"{tr}x{ks} {key}"] = {
                    "blocks_per_sm": fill // sms, "levels": per,
                    "step_ms": step,
                    "worst_weight_grad_err": max(errs.values())}
                print(f"plan {tr}x{ks} {key}: {fill // sms} blocks per SM; "
                      + ", ".join(f"L{l} {ms:.5f}" for l, ms in per.items())
                      + f" ms; the 15 launches of a step {step:.4f} ms; dpre, "
                      f"dxj bit for bit kernel 5's, weight gradients within "
                      f"{max(errs.values()):.1e} of rms")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
