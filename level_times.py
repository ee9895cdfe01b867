"""Kernels 4 (the windowed edge phase), 6 (the node phase's backward) and
5 (the edge phase's backward, beside them as a control) at every level of
the 5k airfoil, chip_smoke.py's main path, in f32 and bf16: the device ms
of one call (the profiler's, summed over the CUDA kernels the call
launches, so that two designs compare whatever they launch), and the
sum over the 15 launches of one train step (twice at each level above the
bottom, down and up; once at the bottom). The inputs are chip_smoke.py's
(`kernel_inputs`, `bwd_kernel_inputs`): the same seeds give the same values
under any commit. Also the peak device memory of one airfoil train step
(chip_smoke.py's `Trainer`, after its warmup gate) above what the step
starts with, in a process that has run nothing else on the card; and, as
controls whose code the redesign of kernels 4 and 6 leaves alone, the
chunk-walk forwards at level 0 of their own paths: kernel 12 (the
unwindowed airfoil), 11 (the surface on the fused method) and 13 (the
flag).

    python3 level_times.py              # the port beside this script
    python3 level_times.py --root DIR   # the port of another checkout

To compare two commits on one card, unpack one (`git archive`) into a
git-ignored directory and time both in one call on the card: parent,
change, change, parent. Needs a CUDA card; prints one JSON line last.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = {"kernel 4": ("fused_edge_phase_win", False),
           "kernel 6": ("fused_node_phase_bwd", True),
           "kernel 5": ("fused_edge_phase_win_bwd", True)}


def device_ms(fn, reps=20, tries=3):
    """Device ms per call of `fn`: the CUDA kernels' time in a profile of
    `reps` calls, after one call outside it. A profile that shows no device
    time (the profiler now and then drops a window's kernels) is taken
    again, up to `tries` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum((getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0))
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / reps / 1e3
    raise RuntimeError("the profiler showed no device time")


def step_peak_mib(cs, case, device, cd):
    """MiB that one train step allocates at its peak above what it starts
    with, after the warmup gate and two updates."""
    tr = cs.make_trainer(case, device, cd)
    node_in, tar = case["node_in"], cs.train_target(case)
    for _ in range(cs.TRAIN_GATE + 2):
        tr.iter(case["hd"], node_in, tar, case["mask"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    tr.iter(case["hd"], node_in, tar, case["mask"])
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 2**20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose bsms_gnn_tpu_torch is timed")
    root = os.path.abspath(ap.parse_args().root)
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
    case = cs.build_case(device)
    out = {"step_peak_above_mib": {
        str(dt)[6:]: step_peak_mib(cs, case, device,
                                   None if dt == torch.float32 else dt)
        for dt in (torch.float32, torch.bfloat16)}}
    print("airfoil train step, peak MiB above what it starts with: "
          + ", ".join(f"{k} {v:.1f}" for k, v in
                      out["step_peak_above_mib"].items()))
    with torch.no_grad():
        depth = case["hd"].depth
        for label, (name, bwd) in KERNELS.items():
            fn = cs.kernel_modules()[name][0]
            for dtype in (torch.float32, torch.bfloat16):
                inputs = (cs.bwd_kernel_inputs if bwd else cs.kernel_inputs)(
                    case, dtype, device)[name]
                per = {}
                for where, args in inputs:
                    if not where.startswith("level "):
                        continue
                    l = int(where.split()[1])
                    per[l] = device_ms(lambda: fn(*args))
                step = sum(ms * (2 if l < depth else 1)
                           for l, ms in per.items())
                key = str(dtype)[6:]
                out.setdefault(label, {})[key] = {
                    "levels": [per[l] for l in sorted(per)],
                    "step_ms": step}
                print(f"{label} ({name}) {key}: " + ", ".join(
                    f"L{l} {per[l]:.5f}" for l in sorted(per))
                    + f" ms; the 15 launches of a step {step:.4f} ms")
    controls = (("kernel 12", functools.partial(cs.build_case, plain=True),
                 "fused_edge_phase"),
                ("kernel 11", functools.partial(cs.build_surface_case,
                                                aggregation="fused"),
                 "fused_edge_mlp_aggregate"),
                ("kernel 13", cs.build_flag_case, "fused_edge_phase_win_dyn"))
    with torch.no_grad():
        for label, build, name in controls:
            case = build(device)
            fn = cs.kernel_modules()[name][0]
            for dtype in (torch.float32, torch.bfloat16):
                args = cs.kernel_inputs(case, dtype, device)[name][0][1]
                key = str(dtype)[6:]
                ms = out.setdefault(label, {})[key] = device_ms(
                    lambda: fn(*args))
                print(f"{label} ({name}) {key}: L0 {ms:.5f} ms")
            del case
            torch.cuda.empty_cache()
    print(json.dumps({"root": root, "card": cs.card_line(), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
