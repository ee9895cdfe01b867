"""Kernel 1: the windowed rectangular operator application (fused level
transitions).

Replaces the TPU kernel `bsms_gnn_tpu/ops/pallas/windowed.py::
windowed_rect_conv_raw` (`_get_call` → `_make_kernel`):

    out[k] = Σ_{in-window e: recv(e)=k} ew_e · x[win_base[chunk]·W/2 + send_win[e]]

x lives in the operator's INPUT space ([n_in_pad, C]), out in its OUTPUT
space ([n_pad_nodes, C], f32). Sentinel slots (`send_win == W`) contribute
nothing; the caller adds the compact residual (`compact_resid.py`).

CUDA design (`csrc/windowed.cu` on `csrc/row_gather.cuh`): a gather
in output-row order. `to_device` lists each output row's live slots (in
window, receiver inside its chunk's block: the slots the TPU kernel's
one-hot counts) in slot order (`win_row_ptr`, `win_row_slots`). A warp
owns 4 consecutive rows and walks their lists as one range: its lanes
resolve 32 slots' rows (`win_base`, `send_win`) and weights at once, then
each lane loads 16 bytes of every listed row (8 in bf16), 4 rows (8 in
bf16) in flight, and sums in registers in list order; each row is written
once, zero where it has no slot. A row of more than 32 live slots (the
coarse levels' and transitions', `win_long`) gets a block of its own, its
32-slot pieces spread over the block's 8 warps and summed in a fixed
order. One launch, no scratch, no atomics. What bounds it on the card:
bytes (one 512-byte row, 256 in bf16, read per live slot for 256 FLOP;
the output written once); at the 5k mesh a launch moves a few MB, so its
latency dominates.

The batch axis (a shared mesh, x [B, n_in_pad, 128] → [B, n_pad_nodes,
128]): one launch whose grid's y index is the sample, each sample summed
over the same lists in the same order as a call on it alone (the rect form,
the level form and kernel 7).

Why the first design lost, 4.5x behind `torch.sparse.mm` on a
1M-node level: one thread block per edge chunk kept two 64 KB
shared-memory copies of the chunk's output block (one block per SM, too
few row loads in flight); each slot was a serial shared-memory
read-modify-write with 4-byte loads, on scattered rows since a chunk is
sorted by sender; every chunk wrote a 64 KB part that a second kernel read
back (1 GB each way there); and sentinel slots were walked too.

bf16 mode follows the TPU kernel, which rounds the ew-weighted one-hot to
bf16 before the f32-accumulated scatter dot: the weight is rounded to bf16
and the product with the bf16 row is exact in f32.

Kernel 1's level form: the same kernel over a level's own edges (the
explicit conv of bucketed hierarchies, which carry no TransOp). Replaces
`bsms_gnn_tpu/ops/pallas/windowed.py::windowed_conv_raw` (the same
`_get_call`):

    out[n] = Σ_{in-window e: recv(e)=n} ew_e · x[win_base[chunk]·W/2 + send_win[e]]

x and out live in the level's node space ([n_pad, C]); ew is the level's
`ew` (the down conv) or `ew_rev` (the up conv, `message.py:612-619`).
Out-of-window edges ride the level's residual sub-level (the caller adds
them, `ops/message.py`). The same kernel and entry point as the rect
form, so the same bound and bf16 rounding; its wrapper keeps its own
checks and launch count. An edge bucket's tail chunks (pad slots only,
owned by the last block) carry the sentinel, so no row lists them.

Kernel 7: the transposed windowed sum of a level (the sender side of the
fused edge phase's backward). Replaces `bsms_gnn_tpu/ops/pallas/
windowed.py::windowed_send_sum_raw` (`_get_send_call` →
`_make_send_kernel`):

    out[n] = Σ_{in-window e: send(e)=n} vals[e]

with the sender row `win_base[chunk]·W/2 + send_win[e]`. Its output is
indexed by sender windows, not by receiver blocks, and chunks are not
sorted by window. CUDA design (`csrc/windowed_send.cu` on
`csrc/row_gather.cuh`): kernel 1's gather in sender-row order. `to_device`
lists each sender row's in-window slots in slot order (`send_row_ptr`,
`send_row_slots`, `graph/hierarchy.py::send_row_tables`): every slot with
`send_win < W`, whatever its receiver, as the TPU kernel's one-hot tests
`send_win` alone (so not kernel 1's lists). A warp owns 4 consecutive
sender rows; the value row of a slot is the slot itself, so its chain is
row_ptr → slots → vals, with no weight; a row with no slot comes out zero,
and a row of more than 32 slots (the coarse levels', `send_long`) gets a
block of its own. One launch, no scratch, no atomics. What bounds it on
the card: bytes (each in-window slot's row read once, the output written
once); at the 5k mesh a launch moves a few MB, so its latency dominates.
The sum rounds nothing (bf16 rows add exactly into f32).

Why not a shared-memory copy of each chunk's window, summed per block by a
second kernel: one block per SM, a serial read-modify-write per slot and
10.5 MB of parts each way ran 1.8x slower than `index_add_` at the 5k
airfoil's level 0.
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.graph.hierarchy import GATHER_PIECE
from bsms_gnn_tpu_torch.ops.kernels import build

BN = 128
_SIG = [build.P] * 7 + [build.I] * 7 + [build.P] * 2
_FN = {torch.float32: "windowed_conv_f32",
       torch.bfloat16: "windowed_conv_bf16"}
_SEND_SIG = [build.P] * 4 + [build.I] * 5 + [build.P] * 2
_SEND_FN = {torch.float32: "windowed_send_sum_f32",
            torch.bfloat16: "windowed_send_sum_bf16"}
def _check(t, x, n_rows, ew, batched):
    """`t` is a windowed TransOp (rect form, x in its input space) or a
    windowed level (level form, x in its node space)."""
    if t.window <= 0:
        raise NotImplementedError("windowed conv needs a windowed operator "
                                  "or level")
    build.check_batch(x, batched)
    if x.shape[-2:] != (n_rows, BN):
        raise ValueError(f"x {tuple(x.shape)} != (..., {n_rows}, {BN})")
    if x.dtype not in _FN:
        raise ValueError(f"x dtype {x.dtype}")
    if ew.shape != (t.n_pad_edges,):
        raise ValueError(f"ew {tuple(ew.shape)} != ({t.n_pad_edges},)")


def _plain(t, x, ew):
    """Either form in plain PyTorch (index_select / index_add_ on dim -2,
    any leading dims): in bf16 the weights round to bf16, as in the
    kernel."""
    w = t.window
    sw = t.send_win.long()
    covered = sw < w
    base = t.win_base.long().repeat_interleave(t.edge_block)
    rows = torch.where(covered, base * (w // 2) + sw, 0)
    ew = ew.float()
    if x.dtype == torch.bfloat16:
        ew = ew.to(torch.bfloat16).float()
    msg = (x.float().index_select(-2, rows)
           * torch.where(covered, ew, 0.0)[:, None])
    out = torch.zeros(*x.shape[:-2], t.n_pad_nodes, x.shape[-1],
                      dtype=torch.float32, device=x.device)
    return out.index_add_(-2, t.receivers.long(), msg)


def _launch(what, t, x, ew):
    """One launch of the kernel over `t`'s live-slot rows, every sample of
    a batch in it: f32 [..., t.n_pad_nodes, 128]."""
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    build.require(what, x.device, t.send_win, t.win_base, t.win_row_ptr,
                  t.win_row_slots, t.win_long)
    if ew.dtype != torch.float32 or not ew.is_contiguous():
        raise ValueError(f"{what}: ew must be contiguous f32")
    lib = build.library("windowed", {f: _SIG for f in _FN.values()})
    x = x.contiguous()
    n_batch = x.shape[0] if x.dim() == 3 else 1
    out = torch.empty(*x.shape[:-2], t.n_pad_nodes, BN, dtype=torch.float32,
                      device=x.device)
    err = getattr(lib, _FN[x.dtype])(
        x.data_ptr(), ew.data_ptr(), t.send_win.data_ptr(),
        t.win_base.data_ptr(), t.win_row_ptr.data_ptr(),
        t.win_row_slots.data_ptr(), t.win_long.data_ptr(), t.n_pad_nodes,
        t.win_long.numel(), t.edge_block, t.window, GATHER_PIECE, n_batch,
        x.shape[-2], out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, what)
    return out


def windowed_rect_conv_plain(op, x):
    """The rect form in plain PyTorch, on any leading dims."""
    windowed_rect_conv_plain.calls += 1
    return _plain(op, x, op.ew)


windowed_rect_conv_plain.calls = 0


def windowed_rect_conv(op, x):
    """Out-space f32 [..., n_pad_nodes, 128] of the in-window entries of a
    windowed TransOp applied to x [n_in_pad, 128] or a batch [B, n_in_pad,
    128] (one launch). CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    _check(op, x, op.n_in_pad, op.ew, batched=True)
    if x.device.type == "cpu":
        return windowed_rect_conv_plain(op, x)
    out = _launch("windowed_rect_conv", op, x, op.ew)
    windowed_rect_conv.launches += 1
    return out


windowed_rect_conv.launches = 0


def windowed_conv_plain(level, x, ew):
    """Kernel 1's level form in plain PyTorch."""
    windowed_conv_plain.calls += 1
    return _plain(level, x, ew)


windowed_conv_plain.calls = 0


def windowed_conv(level, x, ew):
    """f32 [..., n_pad, 128] in-window receiver sums of ew · x[sender] over
    a windowed level's own edges, x [n_pad, 128] or a batch [B, n_pad,
    128] (one launch; a shard's ghost conv on a batch of frames) f32 or
    bf16, ew [E_pad] (`level.ew` or `level.ew_rev`). CPU tensors take the
    plain version; CUDA tensors launch kernel 1's level form. A batch on
    bucketed hierarchies runs on their union (`graph.hierarchy.union`),
    one launch over every sample's rows, since kernel 9 beside it takes
    one frame."""
    _check(level, x, level.n_pad_nodes, ew, batched=True)
    if x.device.type == "cpu":
        return windowed_conv_plain(level, x, ew)
    out = _launch("windowed_conv", level, x, ew)
    windowed_conv.launches += 1
    return out


windowed_conv.launches = 0


def _check_send(level, vals):
    if level.window <= 0:
        raise NotImplementedError("windowed send sum needs a windowed level")
    build.check_batch(vals, True)
    if vals.shape[-2:] != (level.n_pad_edges, BN):
        raise ValueError(f"vals {tuple(vals.shape)} != "
                         f"(..., {level.n_pad_edges}, {BN})")
    if vals.dtype not in _SEND_FN:
        raise ValueError(f"vals dtype {vals.dtype}")


def windowed_send_sum_plain(level, vals):
    """The same function in plain PyTorch, on any leading dims: index_add_
    of the in-window slots' rows at their sender rows."""
    windowed_send_sum_plain.calls += 1
    w = level.window
    sw = level.send_win.long()
    covered = sw < w
    base = level.win_base.long().repeat_interleave(level.edge_block)
    rows = (base * (w // 2) + sw)[covered]
    live = covered.nonzero()[:, 0]
    out = torch.zeros(*vals.shape[:-2], level.n_pad_nodes, vals.shape[-1],
                      dtype=torch.float32, device=vals.device)
    return out.index_add_(-2, rows, vals.index_select(-2, live).float())


windowed_send_sum_plain.calls = 0


def windowed_send_sum(level, vals):
    """f32 [..., n_pad, 128] sender sums of the in-window slots' rows of
    vals [E_pad, 128] or a batch [B, E_pad, 128] (one launch). CPU tensors
    take the plain version; CUDA tensors launch kernel 7."""
    _check_send(level, vals)
    if vals.device.type == "cpu":
        return windowed_send_sum_plain(level, vals)
    if vals.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {vals.device}")
    build.require("windowed_send_sum", vals.device, level.send_row_ptr,
                  level.send_row_slots, level.send_long)
    lib = build.library("windowed_send",
                        {f: _SEND_SIG for f in _SEND_FN.values()})
    vals = vals.contiguous()
    n_batch = vals.shape[0] if vals.dim() == 3 else 1
    out = torch.empty(*vals.shape[:-2], level.n_pad_nodes, BN,
                      dtype=torch.float32, device=vals.device)
    err = getattr(lib, _SEND_FN[vals.dtype])(
        vals.data_ptr(), level.send_row_ptr.data_ptr(),
        level.send_row_slots.data_ptr(), level.send_long.data_ptr(),
        level.n_pad_nodes, level.send_long.numel(), GATHER_PIECE, n_batch,
        level.n_pad_edges, out.data_ptr(),
        torch.cuda.current_stream(vals.device).cuda_stream,
    )
    build.check(err, "windowed_send_sum")
    windowed_send_sum.launches += 1
    return out


windowed_send_sum.launches = 0
