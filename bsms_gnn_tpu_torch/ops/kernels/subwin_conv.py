"""Kernel 15: the sub-window weighted receiver conv (the "free-block
sub-window" prototype, v6).

Replaces the TPU kernel `benchmarks/v6_prototype.py::_get_v6_conv`
(`_make_v6_conv_kernel`), a benchmark that no model path runs: kernel 1's
level form (`windowed.py::windowed_conv`) over a smaller set of slots.
Each 128-slot sub-chunk u of a chunk selects its senders from K = 2
aligned 128-row blocks inside the chunk's window (`build_sub_tables`, the
two blocks that hold most of its in-window senders), instead of the whole
W-row window:

    out[n] = Σ_{covered e: recv(e)=n} ew_e · x[sub_base[chunk, u, j]·128
                                                 + send_sub[e] − j·128]

with j = send_sub[e] // 128; send_sub[e] = 256 marks a slot outside both
blocks (not covered), which adds nothing. The share of the in-window real
edges that it covers is the prototype's `covered` figure.

CUDA design (`csrc/subwin_conv.cu` on `csrc/row_gather.cuh`): kernel
1's row-ordered gather (`windowed.py`) over this function's slots, listed
per output row in slot order by `sub_row_tables`, with the sub-window row
resolved in the kernel from `sub_base` and `send_sub`: a warp per 4 rows,
16-byte row loads (8 in bf16), the sum in registers in list order and one
write per row; rows of more than 32 slots spread over a block's warps in
a fixed order. One launch, no scratch, no atomics. What bounds it on the
card: bytes (one row read per covered slot, the output written once).
The first design was kernel 1's first one, 4.4x behind
`torch.sparse.mm` on the 1M-node level for the same four reasons: one
134 KB block per SM, a serial shared-memory add per slot, a 64 KB part
per chunk summed by a second kernel, a walk over every slot.

bf16 mode follows the TPU kernel, which rounds the ew-weighted one-hot to
bf16 before its f32-accumulated dot: the weight is rounded to bf16 and its
product with the bf16 row is exact in f32.
"""

from __future__ import annotations

import numpy as np
import torch

from bsms_gnn_tpu_torch.graph.hierarchy import (
    GATHER_PIECE,
    block_chunk_ptr,
    live_row_tables,
    long_rows,
    row_tables,
)
from bsms_gnn_tpu_torch.ops.kernels import build
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import round_bf16

BN = 128
SUB = 128  # slots of a sub-chunk and rows of a sender block
K = 2  # sender blocks of a sub-chunk
_SIG = [build.P] * 7 + [build.I] * 3 + [build.P] * 2
_FN = {torch.float32: "subwin_conv_f32", torch.bfloat16: "subwin_conv_bf16"}


def build_sub_tables(level):
    """The prototype's `build_sub_tables` (`v6_prototype.py:38-77`),
    vectorised: per 128-slot sub-chunk, the K aligned 128-row sender blocks
    inside its chunk's window that hold most of its real in-window senders
    (ties as `np.argsort(cnt)[::-1][:K]` breaks them, the chosen blocks in
    ascending order; the window's first block where fewer than K blocks
    hold any), and each slot's index into them. Returns numpy arrays
    (sub_base [chunks·(edge_block/128)·K] int32, send_sub [E_pad] int32 in
    [0, K·128], K·128 = not covered, covered [E_pad] bool)."""
    be, w = level.edge_block, level.window
    s = np.asarray(level.senders).astype(np.int64)
    mask = (np.asarray(level.edge_mask) > 0) & (np.asarray(level.send_win) < w)
    e_pad = s.shape[0]
    n_cand = w // SUB
    sub = np.arange(e_pad) // SUB  # the sub-chunk of each slot
    wb = np.asarray(level.win_base).astype(np.int64)
    lo = np.repeat(wb * (w // 2) // SUB, be // SUB)  # window's first block
    sb = s // SUB
    rel = sb - lo[sub]
    ok = mask & (rel >= 0) & (rel < n_cand)
    cnt = np.zeros((len(lo), n_cand), np.int64)
    np.add.at(cnt, (sub[ok], rel[ok]), 1)
    # Row by row, the same sort as the prototype's on each row alone.
    top = np.argsort(cnt, axis=-1)[:, ::-1][:, :K]
    # Blocks with senders come first in `top` (counts descend): sorted,
    # they fill the first entries; the window's first block the rest (and
    # the entries a window of fewer than K blocks lacks).
    live = np.take_along_axis(cnt, top, -1) > 0
    top = np.pad(np.where(live, top, n_cand), ((0, 0), (0, K - top.shape[1])),
                 constant_values=n_cand)
    top = np.sort(top, axis=-1)
    base = lo[:, None] + np.where(top < n_cand, top, 0)
    send_sub = np.full(e_pad, K * SUB, np.int32)
    for j in range(K):  # a later block takes a slot both hold
        hit = mask & (sb == base[sub, j])
        send_sub[hit] = j * SUB + (s[hit] - base[sub[hit], j] * SUB)
    return (base.reshape(-1).astype(np.int32), send_sub,
            send_sub < K * SUB)


def sub_row_tables(level, send_sub):
    """The kernel's row lists on a host level (numpy arrays or CPU
    tensors) and `build_sub_tables`' send_sub: (row_ptr [n_pad + 1],
    row_slots, long) int32, the covered slots whose receiver lies in their
    chunk's block, per receiver row in slot order, and the rows split into
    pieces (`graph/hierarchy.py::long_rows`)."""
    ptr = block_chunk_ptr(np.asarray(level.recv_indptr), level.edge_block)
    row_ptr, row_slots = row_tables(np.asarray(level.receivers), ptr,
                                    level.edge_block)
    row_ptr, row_slots = live_row_tables(row_ptr, row_slots,
                                         np.asarray(send_sub) < K * SUB)
    return row_ptr, row_slots, long_rows(row_ptr)


def _check(level, x, ew, sub_base, send_sub):
    if level.window <= 0 or level.edge_block % SUB:
        raise NotImplementedError("the sub-window conv needs a windowed "
                                  "level of 128-slot sub-chunks")
    if x.dim() != 2:
        raise NotImplementedError("batch axis")
    n_pad, e_pad = level.n_pad_nodes, level.n_pad_edges
    if x.shape != (n_pad, BN) or x.dtype not in _FN:
        raise ValueError(f"x {tuple(x.shape)} {x.dtype} != ({n_pad}, {BN})")
    subs = e_pad // SUB
    if (ew.shape != (e_pad,) or send_sub.shape != (e_pad,)
            or sub_base.shape != (subs * K,)):
        raise ValueError("ew and send_sub must be [E_pad], sub_base "
                         "[E_pad / 128 · 2]")


def covered_rows(level, sub_base, send_sub):
    """(receivers, sender rows, keep): the covered slots whose receiver
    lies in their chunk's block, as the TPU kernel's one-hot takes them,
    and the mask of those slots."""
    ss = send_sub.long()
    slot = torch.arange(level.n_pad_edges, device=ss.device)
    j = torch.clamp(ss // SUB, max=K - 1)
    rows = sub_base.long()[(slot // SUB) * K + j] * SUB + ss - j * SUB
    recv = level.receivers.long()
    block = level.chunk_block.long().repeat_interleave(level.edge_block)
    keep = (ss < K * SUB) & (recv // BN == block)
    return recv[keep], rows[keep], keep


def subwin_conv_plain(level, x, ew, sub_base, send_sub, row_lists=None):
    """Kernel 15's function in plain PyTorch (index_select / index_add_);
    it needs no row lists (`row_lists`, the kernel's)."""
    subwin_conv_plain.calls += 1
    recv, rows, keep = covered_rows(level, sub_base, send_sub)
    w = ew.float()[keep]
    if x.dtype == torch.bfloat16:
        w = round_bf16(w)
    vals = x.float().index_select(0, rows) * w[:, None]
    out = torch.zeros(level.n_pad_nodes, BN, dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, recv, vals)


subwin_conv_plain.calls = 0


def subwin_conv(level, x, ew, sub_base, send_sub, row_lists=None):
    """out [n_pad, 128] f32 of the covered slots (see the module
    docstring); `sub_base` and `send_sub` from `build_sub_tables`,
    `row_lists` from `sub_row_tables`, as int32 tensors on x's device. CPU
    tensors take the plain version; CUDA tensors launch kernel 15, which
    needs `row_lists`."""
    _check(level, x, ew, sub_base, send_sub)
    if x.device.type == "cpu":
        return subwin_conv_plain(level, x, ew, sub_base, send_sub)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    if row_lists is None:
        raise ValueError("subwin_conv: the kernel needs the row lists of "
                         "sub_row_tables")
    row_ptr, row_slots, long = row_lists
    if row_ptr.shape != (level.n_pad_nodes + 1,):
        raise ValueError(f"row_ptr {tuple(row_ptr.shape)} != "
                         f"({level.n_pad_nodes + 1},)")
    build.require("subwin_conv", x.device, sub_base, send_sub, row_ptr,
                  row_slots, long)
    lib = build.library("subwin_conv", {f: _SIG for f in _FN.values()})
    x = x.contiguous()
    ew = ew.detach().float().contiguous()
    out = torch.empty(level.n_pad_nodes, BN, dtype=torch.float32,
                      device=x.device)
    err = getattr(lib, _FN[x.dtype])(
        x.data_ptr(), ew.data_ptr(), sub_base.data_ptr(),
        send_sub.data_ptr(), row_ptr.data_ptr(), row_slots.data_ptr(),
        long.data_ptr(), level.n_pad_nodes, long.numel(), GATHER_PIECE,
        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "subwin_conv")
    subwin_conv.launches += 1
    return out


subwin_conv.launches = 0
