"""Per-level device times of the port's kernels on the paths that run them,
in f32 and bf16: kernel 9 (every residual sub-level of the cylinder in
both forms, on acc and in the store form, and on the forced empty one),
kernels 10 (every level of the 16k surface, pallas; and on each of its
tiles, for a port that has them) and 8 (the same surface: every level in
both forms and T0-T2's operators), and beside them, as controls, kernel
1's level form (the cylinder's shapes), kernels 2 and 7 (the 5k
airfoil's), kernels 11's forward (every level of the 16k surface on the
fused method), 12's forward (every level of the unwindowed 5k airfoil),
14 (forward and backward) at the `fused4` airfoil's gated levels, 13
(forward and backward) at every level of the flag, 12's backward at every
level of the unwindowed airfoil, kernels 3, 6, 5 and 4 at every level of
the 5k airfoil (chip_smoke.py's main path), and 11's backward at its
first shape (the flag's level 0, edge_block 512). Kernels 1, 2, 7, 8 and
9 are timed beside their library call (`index_add_`, `torch.sparse.mm`;
CUDA events). A kernel on a tile walk also prints the blocks per SM it
reaches.

Each figure is the device ms of one call (the profiler's, summed over the
CUDA kernels the call launches, so that two designs compare whatever they
launch), beside the card's bound for the call's work (chip_smoke.py's
`work` and peaks); a kernel timed at every level it runs at also gets the
sum over the launches of one train step (twice at each level above the
bottom, down and up; once at the bottom: 15 on the airfoil, 11 on the
flag, 6 for kernel 14 at levels 3-5). The inputs are chip_smoke.py's
(`kernel_inputs`, `bwd_kernel_inputs`): the same seeds give the same
values under any commit. A profile that dropped launches (it holds fewer
than the repeats times one call's) is taken again. Also the peak device
memory of one train step of the airfoil, the flag, the unwindowed
airfoil, the `fused4` airfoil, the pallas surface, the fused surface and
the cylinder (chip_smoke.py's `Trainer`, after its warmup gate) above what
the step starts with, each read after the previous path's case is freed.

    python3 level_times.py              # the port beside this script
    python3 level_times.py --root DIR   # the port of another checkout
    python3 level_times.py --paths cylinder,airfoil   # only these paths
    python3 level_times.py --batch 48 --pmax 82,264,w2   # and a batch

With `--batch B` the airfoil path also times kernels 1-7 on a batch of B
samples over its one hierarchy (chip_smoke.py's `batch_args`: sample 0
the B = 1 inputs) at every shape chip_smoke.py checks them at, each
beside the bound of B samples' work (`batch_work`) and, for kernels 1, 2
and 7, its library call at B (`batch_library_call`); with `--pmax`
kernel 6 at B again at each of those caps on its weight-gradient
partials (`node_mlp.p_max` replaced for the sweep) beside the card's
own.
The JSON line also holds a digest of each
timed call's output (`digests`), so that two checkouts' results can be
compared bit for bit.

To compare two commits on one card, unpack one (`git archive`) into a
git-ignored directory and time both in one call on the card: parent,
change, change, parent. Needs a CUDA card; prints one JSON line last.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# label → (path, kernel, whether chip_smoke's backward inputs, every level)
KERNELS = {
    "kernel 11": ("surface_fused", "fused_edge_mlp_aggregate", False, True),
    "kernel 12": ("airfoil_plain", "fused_edge_phase", False, True),
    "kernel 14 bwd": ("airfoil_fused4", "fused_edge_phase_win_k_bwd", True,
                      True),
    "kernel 13": ("flag", "fused_edge_phase_win_dyn", False, True),
    "kernel 14": ("airfoil_fused4", "fused_edge_phase_win_k", False, True),
    "kernel 12 bwd": ("airfoil_plain", "fused_edge_phase_bwd", True, True),
    "kernel 3": ("airfoil", "fused_node_phase", False, True),
    "kernel 6": ("airfoil", "fused_node_phase_bwd", True, True),
    "kernel 5": ("airfoil", "fused_edge_phase_win_bwd", True, True),
    "kernel 4": ("airfoil", "fused_edge_phase_win", False, True),
    "kernel 13 bwd": ("flag", "fused_edge_phase_win_dyn_bwd", True, True),
    "kernel 10": ("surface", "fused_aggregate_node_phase", False, True),
    "kernel 11 bwd": ("flag", "fused_edge_mlp_aggregate_bwd", True, False),
}
def segment_sum_step(where, depth):
    """Kernel 8's launches at a surface shape in one train step: three in
    each GMP's backward (twice the receiver form, once the sender form;
    two GMPs a level above the bottom, one at the bottom), two on each
    operator (its transition's forward and the other direction's
    adjoint): 57 in all."""
    if not where.startswith("level "):
        return 2
    return (2 if int(where.split()[1]) < depth else 1) * (
        1 if where.endswith("send") else 2)


def accum_step(where, depth):
    """Kernel 9's launches at a cylinder shape in one train step, at each
    residual sub-level (levels 0-2): the receiver form on acc in the down
    and up GMPs' residual edge phases, the down and up convs and their two
    adjoints (6); the store form in the backwards of the GMPs' residual
    gathers, by receivers and by senders (2 each): 30 in all. None on the
    forced empty layout, nor the sender form on acc."""
    form = " ".join(where.split()[2:]) if where.startswith("level ") else None
    return {"": 6, "store": 2, "send store": 2}.get(form, 0)


# label → (path, kernel, whether chip_smoke's backward inputs, its
# launches in a train step by shape or None): kernels timed at every shape
# chip_smoke.py lists for them, beside their bound and their library call.
SHAPES = {
    "kernel 9": ("cylinder", "segment_sum_accum", False, accum_step),
    "kernel 8": ("surface", "segment_sum", False, segment_sum_step),
    "kernel 1 level form": ("cylinder", "windowed_conv", False, None),
    "kernel 2": ("airfoil", "compact_accum", False, None),
    "kernel 7": ("airfoil", "windowed_send_sum", True, None),
}
# Paths whose train step's peak memory is read.
PEAK_PATHS = ("airfoil", "flag", "airfoil_plain", "airfoil_fused4",
              "surface", "surface_fused", "cylinder")


def device_ms(fn, reps=20, tries=5):
    """Device ms per call of `fn`: the CUDA kernels' time in a profile of
    `reps` calls, after one call outside it and one profiled call that
    counts the call's launches.
    The profiler now and then drops kernels from a window, which reads
    low: a profile whose launch count is not `reps` times the call's is
    taken again (the call's count with it), up to `tries` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        return (sum(e.count for e in kernels),
                sum((getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0))
                    for e in kernels))

    fn()
    torch.cuda.synchronize()  # the inputs' kernels, outside every profile
    for _ in range(tries):
        per_call, _ = run(1)
        launches, total = run(reps)
        if per_call > 0 and launches == reps * per_call:
            return total / reps / 1e3
        print(f"  (a profile of {reps} calls held {launches} launches, not "
              f"{reps} x {per_call}: taken again)")
    raise RuntimeError("no profile held every launch of its calls")


DIGESTS = {}


def digest(label, dtype, where, out):
    """Records a short sha256 of a call's output (a tensor or a tuple of
    them) under DIGESTS[label][dtype][where]."""
    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    DIGESTS.setdefault(label, {}).setdefault(str(dtype)[6:], {})[where] = (
        h.hexdigest()[:16])


def step_peak_mib(cs, case, device, cd):
    """MiB that one train step allocates at its peak above what it starts
    with, after the warmup gate and two updates."""
    tr = cs.make_trainer(case, device, cd)
    node_in, tar = case.get("train_frames") or (case["node_in"],
                                                cs.train_target(case))
    for _ in range(cs.TRAIN_GATE + 2):
        tr.iter(case["hd"], node_in, tar, case["mask"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    tr.iter(case["hd"], node_in, tar, case["mask"])
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 2**20


def bound_ms(cs, name, args, dtype):
    """The card's least time for the call's work, as chip_smoke.py
    computes it: max(bytes / peak rate, operations / peak rate)."""
    by, ops = cs.work(name, args, dtype)
    return max(by / cs.PEAK_BYTES_S, ops / cs.PEAK_FLOPS_S[dtype]) * 1e3


def blocks_per_sm(name, dtype):
    """The blocks per SM the tile walk of `name` reached in this process
    (`fused_gmp.walk_fill`'s cache), or None for a kernel on no walk."""
    from bsms_gnn_tpu_torch.ops.kernels import fused_gmp

    fn = f"{name}_{'bf16' if dtype == torch.bfloat16 else 'f32'}"
    fills = [v for k, v in fused_gmp._walks.items() if k[0] == fn]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return fills[0] // sms if fills else None


def time_kernel(cs, case, device, label, name, bwd, every):
    """{dtype: {"levels": {level: ms}, "bounds": {level: ms}, "step_ms":
    ms, "blocks_per_sm": n}} for a kernel timed at every level it runs at,
    else {dtype: ms} at its first shape; printed as it goes."""
    fn = cs.kernel_modules()[name][0]
    depth = case["hd"].depth
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        shapes = (cs.bwd_kernel_inputs if bwd else cs.kernel_inputs)(
            case, dtype, device)[name]
        key = str(dtype)[6:]
        if not every:
            where, args = shapes[0]
            digest(label, dtype, where, fn(*args))
            ms = out[key] = device_ms(lambda: fn(*args))
            print(f"{label} ({name}) {key}: {where} {ms:.5f} ms")
            continue
        per, bound = {}, {}
        for where, args in shapes:
            if where.startswith("level "):
                l = int(where.split()[1])
                digest(label, dtype, where, fn(*args))
                per[l] = device_ms(lambda: fn(*args))
                bound[l] = bound_ms(cs, name, args, dtype)
        step = sum(ms * (2 if l < depth else 1) for l, ms in per.items())
        launches = sum(2 if l < depth else 1 for l in per)
        per_sm = blocks_per_sm(name, dtype)
        out[key] = {"levels": {l: per[l] for l in sorted(per)},
                    "bounds": {l: bound[l] for l in sorted(per)},
                    "step_ms": step, "blocks_per_sm": per_sm}
        print(f"{label} ({name}) {key}: " + ", ".join(
            f"L{l} {per[l]:.5f}" for l in sorted(per))
            + f" ms; the {launches} launches of a step {step:.4f} ms; "
            "bounds " + ", ".join(f"{bound[l]:.5f}" for l in sorted(per))
            + ("" if per_sm is None else f"; {per_sm} blocks per SM"))
    return out


def store_call(fn, args):
    """A call of kernel 9's store form (no acc) on `args`; on a port without
    that form (its wrapper reads acc's shape) the skip-empty gathers'
    backward as it ran there: a zero fill and the call on it."""
    level, feat, _, *send = args
    try:
        fn(level, feat, None, *send)
    except AttributeError:
        n, c = level.n_pad_nodes, feat.shape[-1]
        return lambda: fn(level, feat, torch.zeros(n, c, device=feat.device),
                          *send)
    return lambda: fn(level, feat, None, *send)


def time_shapes(cs, case, device, label, name, bwd, step_launches):
    """{dtype: {"shapes": {where: ms}, "bounds": {where: ms}, "library":
    {where: ms}}} at every shape chip_smoke.py lists for the kernel (the
    library call's time by CUDA events, None where there is none); with
    `step_launches` also {"step_ms", "step_bound_ms"}: the sums over one
    train step's launches."""
    fn = cs.kernel_modules()[name][0]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        shapes = (cs.bwd_kernel_inputs if bwd else cs.kernel_inputs)(
            case, dtype, device)[name]
        key = str(dtype)[6:]
        per, bound, lib = {}, {}, {}
        for where, args in shapes:
            call = (store_call(fn, args) if where.endswith("store")
                    else functools.partial(fn, *args))
            if name != "compact_accum":  # adds onto its input in place
                digest(label, dtype, where, call())
            per[where] = device_ms(call)
            bound[where] = bound_ms(cs, name, args, dtype)
            lc = cs.library_call(name, args)
            lib[where] = None if lc is None else cs.event_ms(lc, reps=50)
        out[key] = {"shapes": per, "bounds": bound, "library": lib}
        line = f"{label} ({name}) {key}: " + ", ".join(
            f"{w} {per[w]:.5f} (bound {bound[w]:.5f}"
            + ("" if lib[w] is None else f", library {lib[w]:.5f}") + ")"
            for w in per) + " ms"
        if step_launches is not None:
            n = {w: step_launches(w, case["hd"].depth) for w in per}
            step = out[key]["step_ms"] = sum(per[w] * k for w, k in n.items())
            sb = out[key]["step_bound_ms"] = sum(bound[w] * k
                                                 for w, k in n.items())
            line += (f"; the {sum(n.values())} launches of a step {step:.4f} "
                     f"ms against {sb:.4f} ms of bound")
        print(line)
    return out


def sweep_tiles(cs, case, device):
    """Kernel 10 at every level of the pallas surface on each of its tiles
    ({dtype: {level: {tile: ms}}}), beside the wrapper's pick; None where
    the port timed has no such tiles (its kernel 10 has one design)."""
    from bsms_gnn_tpu_torch.ops.kernels import agg_node

    if not hasattr(agg_node, "TILES"):
        return None
    fn = cs.kernel_modules()["fused_aggregate_node_phase"][0]
    rule = agg_node.tile_design
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = {}
    try:
        for dtype in (torch.float32, torch.bfloat16):
            shapes = cs.kernel_inputs(case, dtype, device)[
                "fused_aggregate_node_phase"]
            key = str(dtype)[6:]
            out[key] = {}
            for where, args in shapes:
                if not where.startswith("level "):
                    continue
                ms = {}
                for tile in agg_node.TILES:
                    agg_node.tile_design = lambda n, s, tile=tile: tile
                    ms[tile] = device_ms(lambda: fn(*args))
                agg_node.tile_design = rule
                out[key][where] = ms
                print(f"kernel 10 {key} {where} by tile: " + ", ".join(
                    f"{t} {v:.5f}" for t, v in ms.items())
                    + f" ms; the rule picks {rule(args[2].shape[0], sms)}")
    finally:
        agg_node.tile_design = rule
    return out


def subwin_digests(case, device):
    """Kernel 15 on the airfoil's level 0 (its sub-window tables built
    there, x and ew from a seed), f32 and bf16: digests only (the v6
    benchmark, chip_smoke.py's, times it)."""
    from bsms_gnn_tpu_torch.ops.kernels import subwin_conv as sw

    host, lvl = case["h"].levels[0], case["hd"].levels[0]
    sub_base, send_sub, _ = sw.build_sub_tables(host)
    rows = tuple(torch.from_numpy(a).to(device)
                 for a in sw.sub_row_tables(host, send_sub))
    sb, ss = (torch.from_numpy(a).to(device) for a in (sub_base, send_sub))
    g = torch.Generator().manual_seed(15)
    ew = torch.randn(lvl.n_pad_edges, generator=g).to(device)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(lvl.n_pad_nodes, 128, generator=g).to(dtype).to(
            device)
        digest("kernel 15", dtype, "airfoil level 0",
               sw.subwin_conv(lvl, x, ew, sb, ss, rows))


def node_bwd_digests(case, device):
    """Kernel 6 at every level of the case (x, aggr and g from a seed,
    the level's node MLP), f32 and bf16: digests only. On the 16k surface
    (kernel 10's backward runs kernel 6) level 0 holds 252 tiles, the
    most of any level run at B = 1."""
    from bsms_gnn_tpu_torch.ops.kernels import node_mlp

    sim, hd = case["sim"], case["hd"]
    for l, lvl in enumerate(hd.levels):
        gmp = (sim.process.down_gmps[l] if l < hd.depth
               else sim.process.bottom_gmp)
        g = torch.Generator().manual_seed(600 + l)
        x, aggr, cot = (torch.randn(lvl.n_pad_nodes, 128, generator=g)
                        for _ in range(3))
        for dtype in (torch.float32, torch.bfloat16):
            cd = dtype if dtype == torch.bfloat16 else None
            digest("kernel 6 (node MLP)", dtype, f"level {l}",
                   node_mlp.fused_node_phase_bwd(
                       x.to(dtype).to(device), aggr.to(device), gmp.mlp_node,
                       cot.to(device), cd))


def time_batched(cs, case, device, n, pmax=()):
    """Kernels 1-7 on a batch of n samples at every shape chip_smoke.py
    checks them at ({label: {dtype: {"shapes": {where: ms}, "bounds":
    {where: ms}, "library": {where: ms}, "step_ms": ms}}}; "step_ms" sums
    the launches of one train step for the kernels timed at every level);
    then kernel 6 at n again at each cap of `pmax` ({cap: {dtype:
    {where: ms}}} under "kernel 6 pmax", each cap put in place of
    `node_mlp.p_max` for its reading)."""
    from bsms_gnn_tpu_torch.ops.kernels import node_mlp

    labels = {"windowed_rect_conv": "kernel 1", "compact_accum": "kernel 2",
              "fused_node_phase": "kernel 3",
              "fused_edge_phase_win": "kernel 4",
              "fused_edge_phase_win_bwd": "kernel 5",
              "fused_node_phase_bwd": "kernel 6",
              "windowed_send_sum": "kernel 7"}
    depth = case["hd"].depth
    out, sweep = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype)[6:]
        for name, shapes in cs.batch_inputs(case, dtype, device):
            fn = cs.kernel_modules()[name][0]
            label = f"{labels[name]} B={n}"
            per, bound, lib = {}, {}, {}
            for k, (where, args) in enumerate(shapes):
                bargs = cs.batch_args(name, args, n, 1700 + 50 * k)
                call = functools.partial(fn, *bargs)
                if name != "compact_accum":  # adds onto acc in place
                    digest(label, dtype, where, call())
                per[where] = device_ms(call)
                by, ops = cs.batch_work(name, bargs, dtype)
                bound[where] = max(by / cs.PEAK_BYTES_S,
                                   ops / cs.PEAK_FLOPS_S[dtype]) * 1e3
                lc = (cs.batch_library_call(name, bargs)
                      if dtype == torch.float32 else None)
                lib[where] = None if lc is None else cs.event_ms(lc, reps=20)
                if name == "fused_node_phase_bwd" and where == "level 0":
                    kept, tiles = node_mlp.p_max, bargs[0].numel() // (
                        128 * node_mlp.ROWS)
                    meta = (bargs[0].dtype, bargs[-1],
                            len(bargs[2].weights) - 1, device)
                    cap = node_mlp.p_max(*meta)
                    waves = node_mlp.bwd_clusters(*meta)
                    print(f"kernel 6 B={n} {key} {where}: the cap on its "
                          f"partials {cap} ({min(tiles, cap)} partials of "
                          f"{tiles} tiles; {waves} clusters at once)")
                    for cap in pmax:
                        if isinstance(cap, str):  # "wK": K whole waves
                            cap = waves * int(cap[1:])
                        node_mlp.p_max = lambda *_, cap=cap: cap
                        try:
                            ms = device_ms(call)
                        finally:
                            node_mlp.p_max = kept
                        sweep.setdefault(cap, {}).setdefault(key, {})[
                            where] = ms
                        print(f"kernel 6 B={n} {key} {where} at cap {cap} "
                              f"({min(tiles, cap)} partials of {tiles} "
                              f"tiles): {ms:.5f} ms")
                del bargs, call
            levels = {w: ms for w, ms in per.items()
                      if w.startswith("level ")}
            step = (sum(ms * (2 if int(w.split()[1]) < depth else 1)
                        for w, ms in levels.items())
                    if name in ("fused_node_phase", "fused_edge_phase_win",
                                "fused_edge_phase_win_bwd",
                                "fused_node_phase_bwd") else None)
            out.setdefault(label, {})[key] = {
                "shapes": per, "bounds": bound, "library": lib,
                "step_ms": step}
            print(f"{label} ({name}) {key}: " + ", ".join(
                f"{w} {per[w]:.5f} (bound {bound[w]:.5f}"
                + ("" if lib[w] is None else f", library {lib[w]:.5f}") + ")"
                for w in per) + " ms"
                + ("" if step is None else f"; the {2 * len(levels) - 1} "
                   f"launches of a step {step:.4f} ms"))
    if pmax:
        out["kernel 6 pmax"] = sweep
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose bsms_gnn_tpu_torch is timed")
    ap.add_argument("--paths", default=None,
                    help="comma-separated paths to time (default: all)")
    ap.add_argument("--batch", type=int, default=0,
                    help="also time kernels 1-7 on the airfoil at this batch")
    ap.add_argument("--pmax", default="",
                    help="comma-separated caps on kernel 6's partials to "
                         "time at the batch (wK: K waves of its clusters)")
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    if not torch.cuda.is_available():
        print("level_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import bsms_gnn_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(f"card: {cs.card_line()}")
    print(f"port: {os.path.dirname(bsms_gnn_tpu_torch.__file__)}")
    builds = {"airfoil": cs.build_case, "flag": cs.build_flag_case,
              "surface": cs.build_surface_case,
              "airfoil_plain": functools.partial(cs.build_case, plain=True),
              "airfoil_fused4": functools.partial(cs.build_case,
                                                  aggregation="fused4"),
              "surface_fused": functools.partial(cs.build_surface_case,
                                                 aggregation="fused"),
              "cylinder": cs.build_cylinder_case}
    if opts.paths:
        keep = opts.paths.split(",")
        unknown = set(keep) - set(builds)
        if unknown:
            ap.error(f"unknown paths {sorted(unknown)}")
        builds = {p: b for p, b in builds.items() if p in keep}
    out = {"step_peak_above_mib": {}}
    for path, build in builds.items():
        case = build(device)
        if path in PEAK_PATHS:
            peak = out["step_peak_above_mib"][path] = {
                str(dt)[6:]: step_peak_mib(
                    cs, case, device, None if dt == torch.float32 else dt)
                for dt in (torch.float32, torch.bfloat16)}
            print(f"{path} train step, peak MiB above what it starts with: "
                  + ", ".join(f"{k} {v:.1f}" for k, v in peak.items()))
        with torch.no_grad():
            for label, (p, name, bwd, every) in KERNELS.items():
                if p == path:
                    out[label] = time_kernel(cs, case, device, label, name,
                                             bwd, every)
            for label, (p, name, bwd, step) in SHAPES.items():
                if p == path:
                    out[label] = time_shapes(cs, case, device, label, name,
                                             bwd, step)
            if path == "surface":
                out["kernel 10 tiles"] = sweep_tiles(cs, case, device)
                node_bwd_digests(case, device)
            if path == "airfoil":
                subwin_digests(case, device)
            if path == "airfoil" and opts.batch:
                out.update(time_batched(
                    cs, case, device, opts.batch,
                    [v if v.startswith("w") else int(v)
                     for v in opts.pmax.split(",") if v]))
        del case
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "card": cs.card_line(), **out,
                      "digests": DIGESTS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
