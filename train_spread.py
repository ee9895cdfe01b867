#!/usr/bin/env python3
"""How far the f32 train step of chip_smoke.py's `cylinder` path lands from
the plain path, over many runs of the plain path, in the measures that
`chip_smoke.TRAIN_TOL` holds.

    python3 train_spread.py

Builds the kernels and the `cylinder` case as chip_smoke.py does, then:
1. the step through the kernels twice (the kernels are deterministic, so
   the two agree exactly);
2. the step through the plain versions DRAWS times (their `index_add_`
   sums with atomics, in another order each run): each draw against the
   kernels and against the first draw, as (worst largest error, worst RMS
   error) of a parameter's gradient relative to its RMS, with the parameter
   and the share of that gradient's difference that falls in its largest
   row or column (near 1: one ReLU unit of one slot took the other side);
3. a faulty control: the residual gathers' backward with kernel 9's sender
   form swapped for its receiver form, against every plain draw.

Prints one line per draw and, last, a JSON summary. Needs one CUDA card.
"""

from __future__ import annotations

import json
import sys

import torch

import chip_smoke as cs

DRAWS = 24


def worst(grads, want):
    """(worst max error, worst RMS error, its parameter, the share of that
    parameter's squared difference in its largest row or column)."""
    rel, _ = cs.grad_errors(grads, want)
    wmax = max(r[0] for r in rel)
    _, wrms, name = max(rel, key=lambda r: r[1])
    d = (grads[name] - want[name]).double().square()
    share = 0.0
    if d.dim() == 2 and d.sum() > 0:
        share = float(max(d.sum(0).max(), d.sum(1).max()) / d.sum())
    return wmax, wrms, name, share


def main() -> int:
    if not torch.cuda.is_available():
        print("train_spread: no CUDA device", file=sys.stderr)
        return 1
    from bsms_gnn_tpu_torch.ops import scatter
    from bsms_gnn_tpu_torch.ops.kernels import build

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}")
    build.build_all()
    with torch.no_grad():
        case = cs.build_cylinder_case(device)
    sim, hd, mask = case["sim"], case["hd"], case["mask"]
    node_in, tar = case["train_frames"]
    tol_loss, tol_max, tol_rms = cs.TRAIN_TOL[torch.float32]

    def step():
        return cs.step_grads(sim, hd, node_in, tar, mask, None)[1]

    kern = step()
    rel, _ = cs.grad_errors(step(), kern)
    again = max(max(r[0], r[1]) for r in rel)
    print(f"kernels against themselves: worst error {again:.3e} of rms")

    plain, vs_kern, vs_first = [], [], []
    for i in range(DRAWS):
        with cs.plain_path():
            plain.append(step())
        vs_kern.append(worst(kern, plain[-1]))
        vs_first.append(worst(plain[-1], plain[0]))
        print(f"draw {i:2d}: kernels vs plain max {vs_kern[-1][0]:.3e} rms "
              f"{vs_kern[-1][1]:.3e} ({vs_kern[-1][2]}, share "
              f"{vs_kern[-1][3]:.3f}); plain vs draw 0 max "
              f"{vs_first[-1][0]:.3e} rms {vs_first[-1][1]:.3e} "
              f"({vs_first[-1][2]}, share {vs_first[-1][3]:.3f})")

    saved = scatter.segment_sum_accum_send_raw
    scatter.segment_sum_accum_send_raw = scatter.segment_sum_accum_raw
    try:
        faulty = step()
    finally:
        scatter.segment_sum_accum_send_raw = saved
    control = [worst(faulty, p) for p in plain]
    caught = all(c[0] > tol_max or c[1] > tol_rms for c in control)
    print(f"control (kernel 9's sender form swapped for its receiver form) "
          f"vs plain: smallest worst max {min(c[0] for c in control):.3e}, "
          f"smallest worst rms {min(c[1] for c in control):.3e} "
          f"(TRAIN_TOL max {tol_max:.1e}, rms {tol_rms:.1e}); "
          f"{'caught' if caught else 'MISSED'} by every draw")

    summary = {
        "card": cs.card_line(), "draws": DRAWS,
        "kernels_vs_kernels": again,
        "kernels_vs_plain_max": max(v[0] for v in vs_kern),
        "kernels_vs_plain_rms": max(v[1] for v in vs_kern),
        "plain_vs_plain_max": max(v[0] for v in vs_first),
        "plain_vs_plain_rms": max(v[1] for v in vs_first),
        "within_train_tol": sum(v[0] <= tol_max and v[1] <= tol_rms
                                for v in vs_kern),
        "control_min_max": min(c[0] for c in control),
        "control_min_rms": min(c[1] for c in control),
        "control_caught": caught,
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
