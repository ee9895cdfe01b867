"""Kernel 13's bf16 forward against an emulation of its own order of f32
sums, at the wide flag's levels (chip_smoke.py's phase 31 inputs: latent
256, four tail layers).

    python3 bf16_order.py --dump OUT.pt       # on the card
    python3 bf16_order.py --compare OUT.pt    # anywhere, the CPU will do

`--dump` saves, per level, kernel 13's bf16 output and its plain
version's output twice (the plain version sums the messages with
`index_add_`, whose atomics may add in another order each call).
`--compare` builds the same inputs on the CPU and computes
`kernel_order_messages`: each live slot's message in the CUDA kernel's
order of f32 sums with the plain version's rounding points, summed over
the receiver lists in list order. It prints, per level, how many rows of
the card's output equal the emulation bit for bit, and the largest and
RMS errors (over the RMS) of the card's kernel against the emulation and
against its plain version, and of the emulation against the CPU's plain
version; also the same with the hidden activations left unrounded (a
control that skips a rounding point). Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

import chip_smoke as cs
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp as fg
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp_dyn as fgd
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import round_bf16


def kernel_order_messages(tl, xwi, xj, pos, wf8, wfd, wfn, ws, bs,
                          round_hidden=True):
    """Kernel 13's bf16 messages of the live slots in the CUDA kernel's
    order of f32 sums (`csrc/edge_fwd_tiles.cuh`), NaN elsewhere: the
    front's fiber and Δ dots and every tail product an f32 sum over k in
    order (from zero) of exact products of bf16 operands (8 × 8 mantissa
    bits fit f32), the front's terms in its association, ‖Δ‖ from an f32
    fma chain and ‖Δ‖·wf_nrm added with one rounding (as nvcc contracts
    it), the LayerNorm's sums per lane and down the warp's xor butterfly
    (`ln_center`); every rounding point the plain version's. With
    `round_hidden` False the hidden activations stay unrounded (a
    control). CPU tensors."""
    rows, live = fg.sender_rows(tl)
    e = live.nonzero()[:, 0]
    recv = tl.receivers.long()[e]
    c = xwi.shape[-1]

    def fma(a, b, acc):  # a·b + acc rounded once to f32
        return (a.double() * b.double() + acc.double()).float()

    fib, w8 = round_bf16(tl.fiber_t[:, e].t()), round_bf16(wf8)
    v = torch.zeros(len(e), c)
    for k in range(8):
        v = v + fib[:, k:k + 1] * w8[k]
    v = (v + xwi.float()[rows[e]]) + xj.float()[recv]
    p = pos.float()
    d2, fd, wdr = torch.zeros(len(e)), torch.zeros(len(e), c), round_bf16(wfd)
    for k in range(pos.shape[-1]):
        dv = p[rows[e], k] - p[recv, k]
        d2 = fma(dv, dv, d2)
        fd = fd + round_bf16(dv)[:, None] * wdr[k]
    v = fma(torch.sqrt(d2)[:, None].expand(-1, c), wfn[None].expand(len(e), -1),
            v + fd)
    h = torch.relu(v)
    for l, (w, b) in enumerate(zip(ws, bs)):
        h = round_bf16(h) if round_hidden else h
        wr, acc = round_bf16(w), torch.zeros(len(e), c)
        for k in range(c):
            acc = acc + h[:, k:k + 1] * wr[k]
        h = acc + b if l == len(ws) - 1 else torch.relu(acc + b)

    def warp_sum(t):  # lane l's columns 4l + 128v .. +3, then the butterfly
        q = t.view(len(e), c // 128, 32, 4)
        s = ((q[:, 0, :, 0] + q[:, 0, :, 1]) + q[:, 0, :, 2]) + q[:, 0, :, 3]
        for v in range(1, c // 128):
            s = s + (((q[:, v, :, 0] + q[:, v, :, 1]) + q[:, v, :, 2])
                     + q[:, v, :, 3])
        while s.shape[1] > 1:
            s = s[:, :s.shape[1] // 2] + s[:, s.shape[1] // 2:]
        return s[:, 0]

    cen = h - (warp_sum(h) / c)[:, None]
    inv = 1.0 / torch.sqrt(warp_sum(cen * cen) / c + fg.LN_EPS)
    out = torch.full((tl.n_pad_edges, c), float("nan"))
    out[e] = round_bf16(cen * inv[:, None])
    return out


def list_order_sum(tl, msg):
    """out[n] = Σ msg[s] over receiver row n's `win_row_slots`, in list
    order from zero (the receiver gather's order), f32."""
    ptr, slots = tl.win_row_ptr.long(), tl.win_row_slots.long()
    lens = ptr[1:] - ptr[:-1]
    out = torch.zeros(tl.n_pad_nodes, msg.shape[-1])
    for j in range(int(lens.max()) if len(lens) else 0):
        rows = (lens > j).nonzero()[:, 0]
        out[rows] = out[rows] + msg[slots[ptr[rows] + j]]
    return out


def inputs(device):
    """(level name, kernel 13's bf16 arguments) at the wide flag's levels,
    as chip_smoke.py's phase 31 draws them."""
    case = cs.build_flag_case(device, wide=True)
    return cs.kernel_inputs(case, torch.bfloat16,
                            device)["fused_edge_phase_win_dyn"]


def errors(got, want, rows):
    d = (got[rows].float() - want[rows].float()).abs()
    rms = want[rows].float().square().mean().sqrt()
    return float(d.max() / rms), float(d.square().mean().sqrt() / rms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--dump", metavar="OUT.pt")
    mode.add_argument("--compare", metavar="OUT.pt")
    opts = ap.parse_args()
    if opts.dump:
        if not torch.cuda.is_available():
            print("bf16_order: --dump needs a CUDA device", file=sys.stderr)
            return 1
        fn, plain = cs.kernel_modules()["fused_edge_phase_win_dyn"]
        out = {}
        with torch.no_grad():
            for where, args in inputs(torch.device("cuda")):
                out[where] = {"kernel": fn(*args).cpu(),
                              "plain": plain(*args).cpu(),
                              "plain_again": plain(*args).cpu()}
        torch.save({"card": cs.card_line(), "levels": out}, opts.dump)
        print(json.dumps({"card": cs.card_line(), "levels": sorted(out)}))
        return 0
    card = torch.load(opts.compare)
    result = {"card": card["card"]}
    with torch.no_grad():
        for where, args in inputs(torch.device("cpu")):
            tl = args[0]
            plain = fgd.fused_edge_phase_win_dyn_plain(*args)
            emu = list_order_sum(tl, kernel_order_messages(*args))
            ctrl = list_order_sum(tl, kernel_order_messages(
                *args, round_hidden=False))
            k = card["levels"][where]
            rows = (plain != 0).any(-1)
            r = {"rows": int(rows.sum()),
                 "rows_equal": int((k["kernel"] == emu).all(-1)[rows].sum()),
                 "kernel_vs_emulation": errors(k["kernel"], emu, rows),
                 "kernel_vs_card_plain": errors(k["kernel"], k["plain"],
                                                rows),
                 "card_plain_repeats": bool(torch.equal(k["plain"],
                                                        k["plain_again"])),
                 "emulation_vs_cpu_plain": errors(emu, plain, rows),
                 "control_vs_cpu_plain": errors(ctrl, plain, rows)}
            result[where] = r
            print(f"{where}: {r}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
