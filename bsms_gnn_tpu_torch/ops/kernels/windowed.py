"""Kernel 1: the windowed rectangular operator application (fused level
transitions).

Replaces the TPU kernel `bsms_gnn_tpu/ops/pallas/windowed.py::
windowed_rect_conv_raw` (`_get_call` → `_make_kernel`):

    out[k] = Σ_{in-window e: recv(e)=k} ew_e · x[win_base[chunk]·W/2 + send_win[e]]

x lives in the operator's INPUT space ([n_in_pad, C]), out in its OUTPUT
space ([n_pad_nodes, C], f32). Sentinel slots (`send_win == W`) contribute
nothing; the caller adds the compact residual (`compact_resid.py`).

CUDA design (`csrc/windowed.cu`): one thread block per edge chunk; each
half of its threads takes half of the chunk's slots, loads the selected
rows directly (no one-hot selection; the loads of eight slots are issued
before their adds) and adds them, scaled by their weights, into its own
shared-memory copy of the chunk's 128-row output block, one thread per
column, in slot order. The two copies are summed into a per-chunk part,
and a second kernel adds the parts of each output block in chunk order
(deterministic, no atomics; a block with no chunk comes out zero), so the
deep transitions, whose few output blocks hold many chunks, still spread
over many SMs. What bounds it on the card: bytes and latency. Each slot
reads one 512-byte row (256 in bf16) and does 256 FLOP, far under the
card's operations-per-byte line; at the 5k mesh each launch moves a few
MB, so the per-launch latency dominates.

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
owned by the last block) carry the sentinel and add nothing.

Kernel 7: the transposed windowed sum of a level (the sender side of the
fused edge phase's backward). Replaces `bsms_gnn_tpu/ops/pallas/
windowed.py::windowed_send_sum_raw` (`_get_send_call` →
`_make_send_kernel`):

    out[n] = Σ_{in-window e: send(e)=n} vals[e]

with the sender row `win_base[chunk]·W/2 + send_win[e]`. Its output is
indexed by sender windows, not by receiver blocks, and chunks are not
sorted by window. CUDA design (`csrc/windowed_send.cu`), kernel 1's
scheme turned around: one thread block per edge chunk adds each in-window
slot's row into a shared-memory copy of the chunk's W-row window, one
thread per (column, row parity), in slot order, and writes it to a part
per chunk; a second pass gives each W/2-row output block the matching
halves of the parts of the chunks whose window covers it, from host-built
tables (`send_ptr`, `send_items`, see `graph/hierarchy.py`): low halves
then high halves, each in chunk order. Deterministic, no atomics, and a
block no chunk covers comes out zero. Sentinel slots (`send_win == W`)
add nothing. What bounds it on the card: bytes (each in-window slot's row
read once, the output written once) and latency; the sum rounds nothing
(bf16 rows add exactly into f32). A first design, one thread block per
output block walking its chunks, ran the deep levels' many chunks per
block in series (PERF.md).
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.ops.kernels import build

BN = 128
_SIG = [build.P] * 7 + [build.I] * 4 + [build.P] * 3
_FN = {torch.float32: "windowed_conv_f32",
       torch.bfloat16: "windowed_conv_bf16"}
_SEND_SIG = [build.P] * 4 + [build.I] * 4 + [build.P] * 3
_SEND_FN = {torch.float32: "windowed_send_sum_f32",
            torch.bfloat16: "windowed_send_sum_bf16"}


def _check(t, x, n_rows, ew):
    """`t` is a windowed TransOp (rect form, x in its input space) or a
    windowed level (level form, x in its node space)."""
    if t.window <= 0:
        raise NotImplementedError("windowed conv needs a windowed operator "
                                  "or level")
    if x.dim() != 2:
        raise NotImplementedError("batch axis")
    if x.shape != (n_rows, BN):
        raise ValueError(f"x {tuple(x.shape)} != ({n_rows}, {BN})")
    if x.dtype not in _FN:
        raise ValueError(f"x dtype {x.dtype}")
    if ew.shape != (t.n_pad_edges,):
        raise ValueError(f"ew {tuple(ew.shape)} != ({t.n_pad_edges},)")


def _plain(t, x, ew):
    """Either form in plain PyTorch (index_select / index_add_): in bf16
    the weights round to bf16, as in the kernel."""
    w = t.window
    sw = t.send_win.long()
    covered = sw < w
    base = t.win_base.long().repeat_interleave(t.edge_block)
    rows = torch.where(covered, base * (w // 2) + sw, 0)
    ew = ew.float()
    if x.dtype == torch.bfloat16:
        ew = ew.to(torch.bfloat16).float()
    msg = x.float().index_select(0, rows) * torch.where(covered, ew, 0.0)[:, None]
    out = torch.zeros(t.n_pad_nodes, x.shape[-1], dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, t.receivers.long(), msg)


def _launch(what, t, x, ew):
    """One launch of the kernel (and its block sum) over `t`'s chunks:
    f32 [t.n_pad_nodes, 128]."""
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    build.require(what, x.device, t.send_win, t.win_base, t.receivers,
                  t.chunk_block, t.chunk_ptr)
    if ew.dtype != torch.float32 or not ew.is_contiguous():
        raise ValueError(f"{what}: ew must be contiguous f32")
    lib = build.library("windowed", {f: _SIG for f in _FN.values()})
    x = x.contiguous()
    n_chunks = t.n_pad_edges // t.edge_block
    part = torch.empty(n_chunks, BN, BN, dtype=torch.float32, device=x.device)
    out = torch.empty(t.n_pad_nodes, BN, dtype=torch.float32, device=x.device)
    err = getattr(lib, _FN[x.dtype])(
        x.data_ptr(), ew.data_ptr(), t.send_win.data_ptr(),
        t.win_base.data_ptr(), t.receivers.data_ptr(),
        t.chunk_block.data_ptr(), t.chunk_ptr.data_ptr(), n_chunks,
        t.n_pad_nodes // BN, t.edge_block, t.window, part.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, what)
    return out


def windowed_rect_conv_plain(op, x):
    """The rect form in plain PyTorch."""
    windowed_rect_conv_plain.calls += 1
    return _plain(op, x, op.ew)


windowed_rect_conv_plain.calls = 0


def windowed_rect_conv(op, x):
    """Out-space f32 [n_pad_nodes, 128] of the in-window entries of a
    windowed TransOp applied to x [n_in_pad, 128]. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    _check(op, x, op.n_in_pad, op.ew)
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
    """f32 [n_pad, 128] in-window receiver sums of ew · x[sender] over a
    windowed level's own edges, x [n_pad, 128] f32 or bf16, ew [E_pad]
    (`level.ew` or `level.ew_rev`). CPU tensors take the plain version;
    CUDA tensors launch kernel 1's level form."""
    _check(level, x, level.n_pad_nodes, ew)
    if x.device.type == "cpu":
        return windowed_conv_plain(level, x, ew)
    out = _launch("windowed_conv", level, x, ew)
    windowed_conv.launches += 1
    return out


windowed_conv.launches = 0


def _check_send(level, vals):
    if level.window <= 0:
        raise NotImplementedError("windowed send sum needs a windowed level")
    if vals.dim() != 2:
        raise NotImplementedError("batch axis")
    if vals.shape != (level.n_pad_edges, BN):
        raise ValueError(f"vals {tuple(vals.shape)} != "
                         f"({level.n_pad_edges}, {BN})")
    if vals.dtype not in _SEND_FN:
        raise ValueError(f"vals dtype {vals.dtype}")


def windowed_send_sum_plain(level, vals):
    """The same function in plain PyTorch: index_add_ of the in-window
    slots' rows at their sender rows."""
    windowed_send_sum_plain.calls += 1
    w = level.window
    sw = level.send_win.long()
    covered = sw < w
    base = level.win_base.long().repeat_interleave(level.edge_block)
    rows = (base * (w // 2) + sw)[covered]
    out = torch.zeros(level.n_pad_nodes, vals.shape[-1], dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, rows, vals[covered].float())


windowed_send_sum_plain.calls = 0


def windowed_send_sum(level, vals):
    """f32 [n_pad, 128] sender sums of the in-window slots' rows of vals
    [E_pad, 128]. CPU tensors take the plain version; CUDA tensors launch
    kernel 7."""
    _check_send(level, vals)
    if vals.device.type == "cpu":
        return windowed_send_sum_plain(level, vals)
    if vals.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {vals.device}")
    build.require("windowed_send_sum", vals.device, level.send_win,
                  level.send_ptr, level.send_items)
    lib = build.library("windowed_send",
                        {f: _SEND_SIG for f in _SEND_FN.values()})
    vals = vals.contiguous()
    n_chunks = level.n_pad_edges // level.edge_block
    f32 = dict(dtype=torch.float32, device=vals.device)
    part = torch.empty(n_chunks, level.window, BN, **f32)
    out = torch.empty(level.n_pad_nodes, BN, **f32)
    err = getattr(lib, _SEND_FN[vals.dtype])(
        vals.data_ptr(), level.send_win.data_ptr(), level.send_ptr.data_ptr(),
        level.send_items.data_ptr(), n_chunks,
        level.n_pad_nodes // (level.window // 2), level.edge_block,
        level.window, part.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(vals.device).cuda_stream,
    )
    build.check(err, "windowed_send_sum")
    windowed_send_sum.launches += 1
    return out


windowed_send_sum.launches = 0
