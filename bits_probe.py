#!/usr/bin/env python3
"""Kernels 1-10's outputs at latent 128 on chip_smoke.py's seeded inputs
(the 5k airfoil's and the 16k surface's first two shapes of each kernel,
f32 and bf16, forward and backward), saved from one checkout and compared
with another's element for element: which outputs are bit for bit the
same, and how far the others move. Also whether kernel 10 gives kernel
3's bits on kernel 8's aggregate (the surface's level 0), in each.

    python3 bits_probe.py ROOT OUT.pt        # on the card, per checkout
    python3 bits_probe.py --compare A.pt B.pt

ROOT is the checkout whose `chip_smoke.py` and package are imported (its
kernels built there). Needs one CUDA card to save; the comparison runs
anywhere.
"""

import sys

import torch


def save(root, out):
    sys.path.insert(0, root)
    import chip_smoke as cs
    from bsms_gnn_tpu_torch.ops.kernels import build

    build.build_all()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    saved = {}
    with torch.no_grad():
        for label, make in (("airfoil", cs.build_case),
                            ("surface", cs.build_surface_case)):
            case = make(dev)
            for dtype in (torch.float32, torch.bfloat16):
                for inputs in (cs.kernel_inputs, cs.bwd_kernel_inputs):
                    for name, shapes in inputs(case, dtype, dev).items():
                        fn = cs.kernel_modules()[name][0]
                        for where, args in shapes[:2]:
                            got = fn(*args)
                            got = got if isinstance(got, tuple) else (got,)
                            saved[f"{label} {name} {where} {dtype}"] = [
                                g.cpu() for g in got]
            if label == "surface":
                fns = cs.kernel_modules()
                agg, node, seg = (fns[k][0] for k in (
                    "fused_aggregate_node_phase", "fused_node_phase",
                    "segment_sum"))
                lvl = case["hd"].levels[0]
                g = torch.Generator().manual_seed(1400)
                f = torch.randn(lvl.n_pad_edges, 128, generator=g).to(dev)
                x = torch.randn(lvl.n_pad_nodes, 128, generator=g).to(dev)
                mlp = cs.level_gmp(case["sim"], case["hd"], 0).mlp_node
                saved["identity k3"] = [node(x, seg(lvl, f), mlp,
                                             None).cpu()]
                saved["identity k10"] = [agg(lvl, f, x, mlp, None).cpu()]
            del case
    torch.save(saved, out)
    print("saved", len(saved), "outputs to", out)


def compare(a, b):
    A, B = torch.load(a), torch.load(b)
    same = diff = 0
    for k in sorted(set(A) | set(B)):
        if k not in A or k not in B:
            print("missing", k)
            continue
        if all(torch.equal(x, y) for x, y in zip(A[k], B[k])):
            same += 1
            continue
        diff += 1
        worst = max(float((x.float() - y.float()).abs().max())
                    for x, y in zip(A[k], B[k]))
        print(f"DIFFERS {k}: max |a - b| {worst:.3e}")
    print(f"{same} bit for bit, {diff} differ")
    for n, d in ((a, A), (b, B)):
        print(n, "kernel 10 == kernel 3 on kernel 8's aggregate:",
              torch.equal(d["identity k3"][0], d["identity k10"][0]))


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        save(sys.argv[1], sys.argv[2])
