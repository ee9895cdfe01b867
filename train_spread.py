#!/usr/bin/env python3
"""How far the f32 train step of one of chip_smoke.py's paths lands from
the plain path, over many runs of the plain path, in the measures that
`chip_smoke.TRAIN_TOL` holds.

    python3 train_spread.py [--case cylinder|auto|wide] [--draws N]

Builds the kernels and the case as chip_smoke.py does (`cylinder`: phase
10's variable meshes; `auto`: phase 26's 5k airfoil on `window="auto"`;
`wide`: phase 29's airfoil at latent 256 with four tail layers), then:
1. the step through the kernels twice (the kernels are deterministic, so
   the two agree exactly);
2. the step through the plain versions twice under PyTorch's
   deterministic algorithms (`chip_smoke.deterministic`: `index_add_` sums
   each row in a fixed order), which agree exactly, against the kernels;
3. the step through the plain versions N times as the package runs them
   (their `index_add_` sums with atomics, in another order each run): each
   draw against the kernels, against the first draw and against the
   deterministic one, as (worst largest error, worst RMS error) of a
   parameter's gradient relative to its RMS, with the parameter and the
   share of that gradient's difference that falls in its largest row or
   column (near 1: one ReLU unit of one slot took the other side);
4. on `cylinder`, a faulty control: the residual gathers' backward with
   kernel 9's sender form swapped for its receiver form, against every
   plain draw and the deterministic one; on `wide`, two: kernel 5's dpre
   rounded to bf16 in the f32 step (the rounding of the bf16 mode where
   f32 keeps it exact), and kernel 5 in its bf16 mode in the f32 step
   (`chip_smoke.kernel5_fault`), against the same and against the
   kernels' own step (the fault alone);
5. the deterministic plain step on the frame with its state columns moved
   up by one ulp, against the deterministic step on the frame as it is:
   how far rounding alone moves each gradient;
6. the gradients the kernels move furthest from the deterministic step
   (RMS error over RMS), each beside the most the plain draws and the
   nudged frame move it.

Each comparison is also read as the median over the gradients of the RMS
error over RMS (`median`), which a few ill-conditioned gradients do not
move. Prints one line per draw and, last, a JSON summary. Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

import chip_smoke as cs

DRAWS = 24
CASES = ("cylinder", "auto", "wide")


def worst(grads, want):
    """(worst max error, worst RMS error, its parameter, the share of that
    parameter's squared difference in its largest row or column, the
    median RMS error)."""
    rel, _ = cs.grad_errors(grads, want)
    wmax = max(r[0] for r in rel)
    _, wrms, name = max(rel, key=lambda r: r[1])
    d = (grads[name] - want[name]).double().square()
    share = 0.0
    if d.dim() == 2 and d.sum() > 0:
        share = float(max(d.sum(0).max(), d.sum(1).max()) / d.sum())
    return wmax, wrms, name, share, float(np.median([r[1] for r in rel]))


def rms_errs(grads, want):
    """{parameter: RMS error over RMS} of every gradient with a nonzero
    reference."""
    return {k: r for _, r, k in cs.grad_errors(grads, want)[0]}


def build(case_name, device):
    """(sim, hd, node_in, target, mask) of the case's checked train step."""
    with torch.no_grad():
        if case_name == "cylinder":
            case = cs.build_cylinder_case(device)
            node_in, tar = case["train_frames"]
        else:
            case = cs.build_case(device, auto=case_name == "auto",
                                 wide=case_name == "wide")
            node_in, tar = case["node_in"], cs.train_target(case)
    return case["sim"], case["hd"], node_in, tar, case["mask"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=CASES, default="cylinder")
    ap.add_argument("--draws", type=int, default=DRAWS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_spread: no CUDA device", file=sys.stderr)
        return 1
    from bsms_gnn_tpu_torch.ops import scatter
    from bsms_gnn_tpu_torch.ops.kernels import build as kbuild

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}; case {args.case}")
    kbuild.build_all()
    sim, hd, node_in, tar, mask = build(args.case, device)
    tol_loss, tol_max, tol_rms = cs.TRAIN_TOL[torch.float32]

    def step(frame=None):
        frame = node_in if frame is None else frame
        return cs.step_grads(sim, hd, frame, tar, mask, None)[1]

    kern = step()
    rel, _ = cs.grad_errors(step(), kern)
    again = max(max(r[0], r[1]) for r in rel)
    print(f"kernels against themselves: worst error {again:.3e} of rms")

    warned = set()
    with cs.plain_path(), cs.deterministic(warned):
        det, det2 = step(), step()
        # The frame's state columns one ulp up (out_dim of them lead).
        n_state = sim.cfg.out_dim
        nudged = node_in.clone()
        nudged[:, :n_state] = torch.nextafter(
            node_in[:, :n_state], torch.full_like(node_in[:, :n_state],
                                                   float("inf")))
        nudge = step(nudged)
    rel, _ = cs.grad_errors(det2, det)
    det_again = max(max(r[0], r[1]) for r in rel)
    vs_det = worst(kern, det)
    vs_nudge = worst(nudge, det)
    print(f"deterministic plain against itself: worst error "
          f"{det_again:.3e} of rms; kernels vs deterministic plain max "
          f"{vs_det[0]:.3e} rms {vs_det[1]:.3e} ({vs_det[2]}, share "
          f"{vs_det[3]:.3f}) median {vs_det[4]:.3e}; ops that warned: "
          f"{sorted(warned)}")
    print(f"the frame one ulp up, deterministic plain vs deterministic "
          f"plain: max {vs_nudge[0]:.3e} rms {vs_nudge[1]:.3e} "
          f"({vs_nudge[2]}, share {vs_nudge[3]:.3f}) median "
          f"{vs_nudge[4]:.3e}")

    plain, vs_kern, vs_first, det_vs = [], [], [], []
    for i in range(args.draws):
        with cs.plain_path():
            plain.append(step())
        vs_kern.append(worst(kern, plain[-1]))
        vs_first.append(worst(plain[-1], plain[0]))
        det_vs.append(worst(plain[-1], det))
        print(f"draw {i:2d}: kernels vs plain max {vs_kern[-1][0]:.3e} rms "
              f"{vs_kern[-1][1]:.3e} ({vs_kern[-1][2]}, share "
              f"{vs_kern[-1][3]:.3f}); plain vs draw 0 max "
              f"{vs_first[-1][0]:.3e} rms {vs_first[-1][1]:.3e} "
              f"({vs_first[-1][2]}, share {vs_first[-1][3]:.3f}); "
              f"plain vs deterministic max {det_vs[-1][0]:.3e} rms "
              f"{det_vs[-1][1]:.3e} median {det_vs[-1][4]:.3e}")

    # The gradients the kernels move furthest, beside the draws and the
    # nudged frame.
    k_errs, n_errs = rms_errs(kern, det), rms_errs(nudge, det)
    d_errs = [rms_errs(p, det) for p in plain]
    print("the gradients the kernels move furthest from the deterministic "
          "step (RMS error over RMS: kernels; most of a plain draw; the "
          "frame one ulp up):")
    for k in sorted(k_errs, key=k_errs.get, reverse=True)[:12]:
        print(f"  {k}: {k_errs[k]:.3e}; {max(e[k] for e in d_errs):.3e}; "
              f"{n_errs[k]:.3e}")

    summary = {
        "card": cs.card_line(), "case": args.case, "draws": args.draws,
        "kernels_vs_kernels": again,
        "deterministic_vs_deterministic": det_again,
        "kernels_vs_deterministic_max": vs_det[0],
        "kernels_vs_deterministic_rms": vs_det[1],
        "kernels_vs_deterministic_median": vs_det[4],
        "nudged_vs_deterministic_max": vs_nudge[0],
        "nudged_vs_deterministic_rms": vs_nudge[1],
        "nudged_vs_deterministic_median": vs_nudge[4],
        "deterministic_warned": sorted(warned),
        "kernels_vs_plain_max": max(v[0] for v in vs_kern),
        "kernels_vs_plain_rms": max(v[1] for v in vs_kern),
        "kernels_vs_plain_median": max(v[4] for v in vs_kern),
        "plain_vs_plain_max": max(v[0] for v in vs_first),
        "plain_vs_plain_rms": max(v[1] for v in vs_first),
        "plain_vs_plain_median": max(v[4] for v in vs_first),
        "plain_vs_deterministic_max": max(v[0] for v in det_vs),
        "plain_vs_deterministic_rms": max(v[1] for v in det_vs),
        "plain_vs_deterministic_median": max(v[4] for v in det_vs),
        "within_train_tol": sum(v[0] <= tol_max and v[1] <= tol_rms
                                for v in vs_kern),
    }
    controls = []
    if args.case == "cylinder":
        controls.append(("kernel 9's sender form swapped for its receiver "
                         "form", scatter, "segment_sum_accum_send_raw",
                         scatter.segment_sum_accum_raw, ""))
    elif args.case == "wide":
        for kind, what in (("dpre", "kernel 5's dpre rounded to bf16 in the "
                                    "f32 step"),
                           ("bf16", "kernel 5 in its bf16 mode in the f32 "
                                    "step")):
            controls.append((what, *cs.kernel5_fault(kind), f"_{kind}"))
    for what, mod, attr, fault, key in controls:
        saved = getattr(mod, attr)
        setattr(mod, attr, fault)
        try:
            faulty = step()
        finally:
            setattr(mod, attr, saved)
        control = [worst(faulty, p) for p in plain + [det]]
        own = worst(faulty, kern)
        caught = all(c[0] > tol_max or c[1] > tol_rms for c in control)
        print(f"control ({what}) vs plain: smallest worst max "
              f"{min(c[0] for c in control):.3e}, smallest worst rms "
              f"{min(c[1] for c in control):.3e}, smallest median "
              f"{min(c[4] for c in control):.3e} (TRAIN_TOL max "
              f"{tol_max:.1e}, rms {tol_rms:.1e}); "
              f"{'caught' if caught else 'MISSED'} by every draw and the "
              f"deterministic step; against the kernels' own step (the "
              f"fault alone): max {own[0]:.3e} rms {own[1]:.3e} median "
              f"{own[4]:.3e}")
        summary.update({f"control{key}_min_max": min(c[0] for c in control),
                        f"control{key}_min_rms": min(c[1] for c in control),
                        f"control{key}_min_median": min(c[4]
                                                        for c in control),
                        f"control{key}_vs_kernels_rms": own[1],
                        f"control{key}_vs_kernels_median": own[4],
                        f"control{key}_caught": caught})
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
