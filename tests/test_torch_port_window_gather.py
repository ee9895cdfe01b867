"""The host tables of kernels 1 and 15's row-ordered gather
(`csrc/row_gather.cuh`) on the CPU: the live-slot row lists
(`win_row_ptr` / `win_row_slots` of every windowed level and TransOp,
`subwin_conv.sub_row_tables` for kernel 15), the rows split into pieces
(`win_long`, `graph/hierarchy.py::long_rows`), and a sum driven by those
tables alone, in the kernel's order, against the plain versions of
`windowed_rect_conv`, `windowed_conv` and `subwin_conv`.

The layouts: `test_torch_port_interleave.py`'s Morton-ordered 2,000-node
airfoil at depth 4 (window 256, edge_block 512; its coarse levels and T3
down hold rows of more than 32 live slots), the 450-node bucketed mesh of
`test_torch_port_buckets.py` (level 0 ends in tail chunks of pad slots),
and level 0 of a Morton-ordered 4,000-node Delaunay mesh at window 512 for
kernel 15. Which slot lands on which row comes from the JAX package's own
chunk tables (`test_torch_port_hierarchy.py::_one_hot_rows`) where a JAX
layout exists.

Tolerance: the table-driven sum adds the same products as the plain
version in another order (and in bf16 both add products of bf16 values,
exact in f32): largest error 1e-6 of the output's RMS.
"""

import functools

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_buckets import WINDOW, _tail_chunks, group
from test_torch_port_hierarchy import _one_hot_rows
from test_torch_port_interleave import airfoil

from bsms_gnn_tpu_torch.data.synthetic import make_delaunay_mesh
from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels
from bsms_gnn_tpu_torch.graph.hierarchy import (
    GATHER_PIECE,
    NODE_BLOCK,
    long_rows,
    pad_levels,
    to_device,
)
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.graph.order import reorder_mesh
from bsms_gnn_tpu_torch.ops.kernels import subwin_conv as sw
from bsms_gnn_tpu_torch.ops.kernels import windowed
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import round_bf16

C, TOL = 128, 1e-6
WARPS = 8  # warps of a thread block of the gather (`row_gather.cuh`)
DELAUNAY_NODES, DELAUNAY_WINDOW = 4000, 512


def _layouts():
    """name → (JAX layout, the port's on the CPU) of every windowed level
    and TransOp of the airfoil, and the bucketed mesh's levels."""
    hj, ht, _, _ = airfoil()
    out = {f"airfoil L{l}": (a, b) for l, (a, b) in
           enumerate(zip(hj.levels, ht.levels))}
    for l, (a, b) in enumerate(zip(hj.transitions, ht.transitions)):
        out[f"airfoil T{l} down"] = (a.down_op, b.down_op)
        out[f"airfoil T{l} up"] = (a.up_op, b.up_op)
    bj, bt = group(WINDOW)[2][0]
    bd = to_device(bt, "cpu")
    for l, (a, b) in enumerate(zip(bj.levels, bd.levels)):
        out[f"bucketed L{l}"] = (a, b)
    return out


LAYOUTS = ["airfoil L0", "airfoil L3", "airfoil L4", "airfoil T0 down",
           "airfoil T0 up", "airfoil T3 down", "airfoil T3 up", "bucketed L0",
           "bucketed L1"]


@functools.lru_cache(maxsize=None)
def layouts():
    return _layouts()


@functools.lru_cache(maxsize=None)
def delaunay():
    """Level 0 of a Morton-ordered Delaunay mesh at window 512 (built
    alone, as the v6 benchmark builds its 1M-node level), on the CPU, its
    sub-window tables and the kernel's row lists."""
    pos, cells, _ = make_delaunay_mesh(DELAUNAY_NODES,
                                       np.random.default_rng(3))
    pos, cells, _, _ = reorder_mesh(pos, cells)
    pos = pos.astype(np.float64)
    levels = build_bistride_levels(to_flat_edge(cells, "tri"), 0, len(pos),
                                   pos)
    h = to_device(pad_levels(levels, 128, pos=pos, edge_block=512,
                             window=DELAUNAY_WINDOW), "cpu")
    lvl = h.levels[0]
    sub_base, send_sub, covered = sw.build_sub_tables(lvl)
    return lvl, sub_base, send_sub, covered, sw.sub_row_tables(lvl, send_sub)


def _slot_block(layout):
    """Each slot's output block, from the layout's block segments alone: a
    block's chunks start at its first receiver offset; the slots past the
    last real segment (an edge bucket's tail chunks) belong to the last
    block."""
    starts = np.asarray(layout.recv_indptr)[::NODE_BLOCK]
    block = np.searchsorted(starts, np.arange(layout.n_pad_edges),
                            side="right") - 1
    return np.minimum(block, len(starts) - 2)


def _want_lists(row, live, n_pad):
    """(ptr, slots): the slots with `live` and a row, grouped by row in
    slot order."""
    idx = np.flatnonzero(live & (row >= 0))
    slots = idx[np.argsort(row[idx], kind="stable")]
    return np.searchsorted(row[slots], np.arange(n_pad + 1)), slots


def _check_lists(ptr, slots, want_ptr, want_slots):
    assert ptr.dtype == slots.dtype == np.int32
    np.testing.assert_array_equal(ptr, want_ptr)
    np.testing.assert_array_equal(slots, want_slots)


@pytest.mark.parametrize("name", LAYOUTS)
def test_win_row_lists_hold_each_live_slot_once(name):
    """Row r lists exactly the slots the TPU kernel's one-hot adds to r
    that lie in their chunk's window, in slot order: each live slot once,
    and no sentinel, pad or out-of-block slot."""
    jl, tl = layouts()[name]
    row = _one_hot_rows(jl)
    send_win = np.asarray(tl.send_win)
    live = send_win < tl.window
    ptr, slots = tl.win_row_ptr.numpy(), tl.win_row_slots.numpy()
    _check_lists(ptr, slots, *_want_lists(row, live, tl.n_pad_nodes))
    assert (send_win[slots] < tl.window).all()
    recv = np.asarray(tl.receivers)[slots]
    np.testing.assert_array_equal(recv // NODE_BLOCK,
                                  _slot_block(tl)[slots])
    if hasattr(tl, "edge_mask"):  # levels: real edges only
        assert (np.asarray(tl.edge_mask)[slots] > 0).all()
    if name == "bucketed L0":  # the last block's tail chunks list nothing
        assert _tail_chunks(jl) > 0
        tail = np.asarray(tl.recv_indptr)[-1]
        assert (slots < tail).all()
        assert ptr[-1] - ptr[-2] == 0  # pad row n_pad − 1


def test_sub_row_lists_hold_each_covered_slot_once():
    """Kernel 15's lists: the covered slots whose receiver lies in their
    chunk's block (as `covered_rows` keeps them), by receiver in slot
    order."""
    lvl, _, send_sub, covered, (ptr, slots, long) = delaunay()
    recv = np.asarray(lvl.receivers)
    in_block = recv // NODE_BLOCK == _slot_block(lvl)
    row = np.where(in_block, recv, -1)
    _check_lists(ptr, slots, *_want_lists(row, covered, lvl.n_pad_nodes))
    assert (send_sub[slots] < sw.K * sw.SUB).all()
    assert len(slots) == covered.sum() > 0  # real slots lie in their block
    np.testing.assert_array_equal(long, long_rows(ptr))


def _pieces(ptr, long, piece=GATHER_PIECE):
    """The kernel's walk as (row, warp, [start, end)): a short row's list
    whole (its warp's walk adds it in list order); a long row's pieces of
    `piece` slots, piece q to the warp q mod 8 of the row's own block."""
    out = [(r, 0, ptr[r], ptr[r + 1])
           for r in np.setdiff1d(np.arange(len(ptr) - 1), long)]
    for r in long:
        a, b = ptr[r], ptr[r + 1]
        out += [(r, (p - a) // piece % WARPS, p, min(p + piece, b))
                for p in range(a, b, piece)]
    return out


@pytest.mark.parametrize("name", LAYOUTS + ["delaunay"])
def test_long_rows_split_into_ordered_pieces(name):
    """`win_long` lists, in row order, exactly the rows of more than 32
    live slots; the pieces of every row cover its list once, in order,
    each at most 32 slots, spread over the block's 8 warps in turn."""
    if name == "delaunay":
        ptr, _, long = delaunay()[4]
    else:
        tl = layouts()[name][1]
        ptr, long = tl.win_row_ptr.numpy(), tl.win_long.numpy()
    check_pieces(ptr, long)
    if name in ("airfoil L3", "airfoil L4", "airfoil T3 down"):
        assert len(long) > 0


def check_pieces(ptr, long):
    """`long` lists, in row order, exactly the rows of more than 32 listed
    slots; the pieces of every row cover its list once, in order, each at
    most 32 slots, spread over the block's 8 warps in turn."""
    length = np.diff(ptr)
    assert long.dtype == np.int32
    np.testing.assert_array_equal(long, np.flatnonzero(length > 32))
    pieces = _pieces(ptr, long)
    covered = np.zeros(ptr[-1], int)
    for _, _, a, b in pieces:
        covered[a:b] += 1
    assert (covered == 1).all()
    for r in long:
        mine = [(w, a, b) for row, w, a, b in pieces if row == r]
        assert [a for _, a, _ in mine] == list(range(ptr[r], ptr[r + 1], 32))
        assert mine[-1][2] == ptr[r + 1]
        assert all(b - a <= GATHER_PIECE for _, a, b in mine)
        assert [w for w, _, _ in mine] == [q % WARPS for q in range(len(mine))]


def table_sum(ptr, slots, long, input_row, x, ew):
    """The kernel's function from its tables alone, in plain PyTorch: each
    piece's products summed, the pieces into their warps' sums, the warps'
    sums into the row (f32; in bf16 ew rounded to bf16)."""
    w = ew.float()[slots]
    if x.dtype == torch.bfloat16:
        w = round_bf16(w)
    msg = x.float()[input_row[slots]] * w[:, None]
    pieces = _pieces(ptr.numpy(), long.numpy())
    piece_of = torch.zeros(len(slots), dtype=torch.long)
    for i, (_, _, a, b) in enumerate(pieces):
        piece_of[a:b] = i
    rows = torch.tensor([p[0] for p in pieces])
    warps = torch.tensor([p[1] for p in pieces])
    part = torch.zeros(len(pieces), C).index_add_(0, piece_of, msg)
    warp_sum = torch.zeros(len(ptr) - 1, WARPS, C)
    warp_sum.index_put_((rows, warps), part, accumulate=True)
    return warp_sum.sum(1)


def _assert_equal_to(got, want):
    rms = want.pow(2).mean().sqrt()
    assert got.shape == want.shape and rms > 0
    assert (got - want).abs().max() <= TOL * rms


def _window_rows(t):
    base = t.win_base.long().repeat_interleave(t.edge_block)
    return base * (t.window // 2) + t.send_win.long()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", LAYOUTS)
def test_table_sum_equals_the_plain_windowed_conv(name, dt):
    """Rect form on the TransOps, level form (ew and ew_rev) on the
    levels."""
    t = layouts()[name][1]
    g = torch.Generator().manual_seed(11)
    n_in = t.n_in_pad if " T" in name else t.n_pad_nodes
    x = torch.randn(n_in, C, generator=g).to(dt)
    if " T" in name:
        cases = [(t.ew, windowed.windowed_rect_conv_plain(t, x))]
    else:
        cases = [(ew, windowed.windowed_conv_plain(t, x, ew))
                 for ew in (t.ew, t.ew_rev)]
    for ew, want in cases:
        got = table_sum(t.win_row_ptr, t.win_row_slots.long(), t.win_long,
                        _window_rows(t), x, ew)
        _assert_equal_to(got, want)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_table_sum_equals_the_plain_subwin_conv(dt):
    lvl, sub_base, send_sub, _, (ptr, slots, long) = delaunay()
    g = torch.Generator().manual_seed(12)
    x = torch.randn(lvl.n_pad_nodes, C, generator=g).to(dt)
    ew = torch.randn(lvl.n_pad_edges, generator=g)
    sb, ss = torch.from_numpy(sub_base), torch.from_numpy(send_sub)
    _, rows, keep = sw.covered_rows(lvl, sb, ss)
    input_row = torch.zeros(lvl.n_pad_edges, dtype=torch.long)
    input_row[keep] = rows
    got = table_sum(torch.from_numpy(ptr), torch.from_numpy(slots).long(),
                    torch.from_numpy(long), input_row, x, ew)
    _assert_equal_to(got, sw.subwin_conv_plain(lvl, x, ew, sb, ss))

