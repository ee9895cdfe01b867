"""Edge-sharded graph parallelism, written out (counterpart of
`bsms_gnn_tpu/parallel/edge_shard.py`, where GSPMD shards every
edge-indexed array over the mesh's `graph` axis, replicates the node
arrays and places the collectives itself).

Each rank of the `graph` group holds every node row of every level, a
contiguous range of edge slots of each level and of each transition
operator, and its share of each level's residual (`edge_partition`,
`edge_shard`): the slot-derived tables (`recv_indptr`,
the ELL tables, `win_base` per kept chunk, the compact residuals of the
operators, and through `to_device` the row lists the kernels walk) are
rebuilt for the range, and the values that name a slot's reverse partner
(`ew_rev`) come from the whole level. The ranges

- are cut at 128-slot boundaries (two of the walks' 64-slot tiles; the
  rank's layouts take that as their `edge_block`, `win_base` repeated per
  piece), and are balanced by live slots: the in-window ones on a
  windowed layout (what kernels 4, 5 and 1 compute; the others ride the
  residual), the real ones elsewhere;
- cover every slot once over the group, so a sum over the ranks' parts is
  the one-device sum. A level's compact residual is split by twin pairs
  (`resid_part`): each rank takes an even share of the pairs, whole, in
  the order of their first rows, so each rank's part is symmetric, as
  the sender gather's backward needs (it reads each row's reverse
  twin). A residual
  sub-level (bucketed builds) is held whole by one rank (`resid_owner`,
  level l on rank l mod S). A transition operator's compact residual is
  split with its slots (receiver sums only). A level with fewer 128-slot
  pieces than ranks gives the extra ranks one piece of pad slots, which
  add nothing.

The model runs on the method `"eshard:<group>:<local>"` (`eshard_method`):
a GMP's edge part takes x through `EdgeEnter` (identity forward, its
cotangent summed over the group), sums its slots' messages, and the part
leaves through `EdgeSum` (the group's sum forward, identity backward);
the node phase runs replicated. Each conv and fused transition is the
same pair around the rank's part of a linear map, whose adjoint is the
rank's part of the adjoint. `local` is the config's method ("fusedK" is
"fused"): `ell` and `segment` run on any hierarchy; `fused` runs the
windowed routes (kernels 4, 2, 3; backward 5, 7, 6; the transitions
kernel 1's rect form and kernel 2), and raises where a level would take
v2 or v1 (their sender sums read reverse slots); `pallas` raises (kernel
10 fuses the aggregate with the node phase).

The train step (`edge_shard_train_step`) is the one-device `Trainer.iter`
with the method and two reductions: the loss's and the warmup gate's sums
over `data` only (every graph rank of a data row holds the same frames),
the edge MLPs' gradients (each rank's slots' part) over `graph`, then
every gradient over `data`. The node-side parameters' gradients are the
same on every graph rank and are not summed over it. The noise is drawn
per data rank, so a data row's graph ranks inject the same noise.
`halo.STATS` counts the collectives.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from bsms_gnn_tpu_torch.config import split_interleave
from bsms_gnn_tpu_torch.device import resolve_device
from bsms_gnn_tpu_torch.graph.hierarchy import (
    Hierarchy,
    LevelGraph,
    Transition,
    TransOp,
    _build_ell,
    _compact_resid,
    _fiber_t,
    to_device,
)
from bsms_gnn_tpu_torch.parallel import mesh
from bsms_gnn_tpu_torch.parallel.halo import (
    all_reduce,
    check_device,
    group_reduce,
    rank_noise,
)
from bsms_gnn_tpu_torch.training.trainer import Trainer

# The rank ranges' boundaries, in slots: two of the tile walks' 64-slot
# tiles, and what `_conv_fast_ok` asks of a layout's slot count.
PIECE = 128

Ranges = Tuple[Tuple[int, int], ...]


@dataclass(frozen=True)
class EdgePlan:
    """Each rank's slot range [start, stop) of every level (`levels[l][r]`)
    and of each transition's operators (`down[l][r]`, `up[l][r]`, None
    where the transition has none), and the rank that holds each level's
    residual sub-level (`resid_owner[l]`)."""

    n_shards: int
    levels: Tuple[Ranges, ...]
    down: Tuple[Optional[Ranges], ...]
    up: Tuple[Optional[Ranges], ...]
    resid_owner: Tuple[int, ...]


def piece(edge_block: int) -> int:
    """The slots a rank's range is cut at on a layout of `edge_block`."""
    return PIECE if edge_block % PIECE == 0 else edge_block


def live_slots(layout) -> np.ndarray:
    """[E_pad] bool: the slots whose work a rank's range carries: the real
    in-window slots of a windowed layout, the real slots elsewhere (an
    operator's pad slots read its last input row, a pad row)."""
    if isinstance(layout, TransOp):
        live = np.asarray(layout.senders) != layout.n_in_pad - 1
    else:
        live = np.asarray(layout.edge_mask) > 0
    if layout.window:
        live &= np.asarray(layout.send_win) < layout.window
    return live


def slot_ranges(live: np.ndarray, step: int, n_shards: int) -> Ranges:
    """n_shards contiguous ranges of the slots, cut at multiples of `step`,
    each holding about 1 / n_shards of the live slots (each at least one
    piece where there are enough)."""
    n = live.shape[0] // step
    cum = np.concatenate([[0], np.cumsum(live.reshape(n, step).sum(1))])
    bounds = [0]
    for r in range(1, n_shards):
        target = cum[-1] * r / n_shards
        b = int(np.searchsorted(cum, target))
        if b > 0 and target - cum[b - 1] <= cum[min(b, n)] - target:
            b -= 1
        lo = bounds[-1] + (1 if n >= n_shards else 0)
        hi = n - (n_shards - r) if n >= n_shards else n
        bounds.append(min(max(b, lo), hi))
    bounds.append(n)
    return tuple((a * step, b * step) for a, b in zip(bounds, bounds[1:]))


def edge_partition(h: Hierarchy, n_shards: int) -> EdgePlan:
    """The ranks' slot ranges of a built (host) hierarchy, balanced by
    live slots per level and per operator."""
    if n_shards < 1:
        raise ValueError(f"n_shards {n_shards} < 1")
    if h.samples != 1:
        raise ValueError("edge-shard a sample's hierarchy, not a union")

    def ranges(layout):
        if layout is None:
            return None
        return slot_ranges(live_slots(layout), piece(layout.edge_block),
                           n_shards)

    return EdgePlan(
        n_shards=n_shards,
        levels=tuple(ranges(lv) for lv in h.levels),
        down=tuple(ranges(t.down_op) for t in h.transitions),
        up=tuple(ranges(t.up_op) for t in h.transitions),
        resid_owner=tuple(l % n_shards for l in range(len(h.levels))))


def _cut(a, start: int, stop: int, pad: int, fill) -> np.ndarray:
    """a[start:stop] along its first axis, `pad` rows of `fill` appended."""
    part = np.asarray(a)[start:stop]
    if not pad:
        return part.copy()
    return np.concatenate(
        [part, np.full((pad,) + part.shape[1:], fill, part.dtype)])


def _window_cut(layout, start, stop, pad, step):
    """(send_win, win_base) of a range of a windowed layout, whose chunks
    become `step` slots: each chunk's window base repeated per piece."""
    send_win = _cut(layout.send_win, start, stop, pad, layout.window)
    base = np.repeat(np.asarray(layout.win_base), layout.edge_block // step)
    win_base = _cut(base, start // step, stop // step, pad // step, 0)
    return send_win, win_base


def _indptr_cut(indptr, start: int, stop: int, total: int) -> np.ndarray:
    """Each output row's first slot in the range: the blocks before it
    start at 0, those after at its end; the last entry (a pad piece, on
    the last block) is the layout's size."""
    out = np.clip(np.asarray(indptr, np.int64) - start, 0, stop - start)
    out[-1] = total
    return out.astype(np.int32)


def resid_part(cr, rank: int, n_shards: int):
    """Rank `rank`'s twin pairs of a level's compact residual `cr` (None
    where it has none): the pairs, in the order of their first rows, cut
    into n_shards even ranges. The rows keep their order (by receiver,
    then sender) and their fibers; twins and visits are rebuilt for the
    part."""
    if cr is None:
        return None
    n = cr.n_real
    first = np.minimum(np.arange(n), np.asarray(cr.twin)[:n])
    pairs, pair = np.unique(first, return_inverse=True)
    sel = np.flatnonzero(pair * n_shards // max(len(pairs), 1) == rank)
    if not sel.size:
        return None
    part = _compact_resid(cr.senders[sel], cr.receivers[sel], cr.ew[sel],
                          cr.ew_rev[sel], cr.n_pad_nodes, None,
                          symmetric=True)
    fiber = np.zeros((part.n_rows, cr.fiber.shape[-1]), cr.fiber.dtype)
    fiber[:sel.size] = cr.fiber[sel]
    return dataclasses.replace(part, fiber=fiber)


def _level_cut(lv: LevelGraph, start: int, stop: int, rank: int,
               n_shards: int, keep_resid: bool) -> LevelGraph:
    step = piece(lv.edge_block)
    pad = 0 if stop > start else step
    n_pad = lv.n_pad_nodes
    total = stop - start + pad
    senders = _cut(lv.senders, start, stop, pad, n_pad - 1)
    receivers = _cut(lv.receivers, start, stop, pad, n_pad - 1)
    edge_mask = _cut(lv.edge_mask, start, stop, pad, 0)
    rev = np.asarray(lv.reverse_perm, np.int64)
    ew_rev = (np.asarray(lv.ew)[rev] if lv.ew_rev is None
              else np.asarray(lv.ew_rev))
    # A partner slot in the range keeps its local index; one on another
    # rank is replaced by the slot itself (no route of an edge shard reads
    # it: its values ride `ew_rev`).
    rp = rev[start:stop]
    own = np.arange(start, stop)
    rp = np.where((rp >= start) & (rp < stop), rp, own) - start
    reverse_perm = np.concatenate(
        [rp, np.arange(stop - start, total)]).astype(np.int32)
    fiber = _cut(lv.fiber, start, stop, pad, 0)
    send_win = win_base = None
    if lv.window:
        send_win, win_base = _window_cut(lv, start, stop, pad, step)
    real = np.flatnonzero(edge_mask > 0)
    return dataclasses.replace(
        lv, senders=senders, receivers=receivers,
        recv_indptr=_indptr_cut(lv.recv_indptr, start, stop, total),
        recv_ell=_build_ell(receivers[real], real, n_pad, total),
        send_ell=_build_ell(senders[real], real, n_pad, total),
        edge_mask=edge_mask, reverse_perm=reverse_perm,
        ew=_cut(lv.ew, start, stop, pad, 0),
        ew_rev=_cut(ew_rev, start, stop, pad, 0), fiber=fiber,
        n_edges=int(real.size), edge_block=step, send_win=send_win,
        win_base=win_base, resid=lv.resid if keep_resid else None,
        cresid=resid_part(lv.cresid, rank, n_shards),
        fiber_t=_fiber_t(fiber),
        chunk_ptr=None, chunk_block=None)


def _op_cut(op: TransOp, start: int, stop: int) -> TransOp:
    step = piece(op.edge_block)
    pad = 0 if stop > start else step
    n_out, n_in = op.n_pad_nodes, op.n_in_pad
    total = stop - start + pad
    senders = _cut(op.senders, start, stop, pad, n_in - 1)
    receivers = _cut(op.receivers, start, stop, pad, n_out - 1)
    ew = _cut(op.ew, start, stop, pad, 0)
    real = senders != n_in - 1
    send_win = win_base = cresid = dense = None
    if op.window:
        send_win, win_base = _window_cut(op, start, stop, pad, step)
        out = real & (send_win == op.window)
        if out.any():
            # The operator's out-of-window entries in this range.
            cresid = _compact_resid(senders[out], receivers[out], ew[out],
                                    ew[out], n_out, None, symmetric=False,
                                    n_in_pad=n_in)
    if op.dense is not None:
        dense = np.zeros((n_out, n_in), np.float32)
        np.add.at(dense, (receivers[real], senders[real]),
                  ew[real].astype(np.float32))
    return dataclasses.replace(
        op, senders=senders, receivers=receivers,
        recv_indptr=_indptr_cut(op.recv_indptr, start, stop, total), ew=ew,
        edge_block=step, send_win=send_win, win_base=win_base, cresid=cresid,
        dense=dense, chunk_ptr=None, chunk_block=None)


def edge_shard(h: Hierarchy, plan: EdgePlan, rank: int) -> Hierarchy:
    """Rank `rank`'s part of the built (host) hierarchy `h` under `plan`:
    every node array whole, its ranges of edge slots (`to_device` then
    builds the tables the kernels walk)."""
    if not 0 <= rank < plan.n_shards:
        raise ValueError(f"rank {rank} of {plan.n_shards} shards")
    levels = tuple(
        _level_cut(lv, *plan.levels[l][rank], rank, plan.n_shards,
                   keep_resid=plan.resid_owner[l] == rank)
        for l, lv in enumerate(h.levels))
    transitions = tuple(
        Transition(
            pool_ids=t.pool_ids, unpool_inv=t.unpool_inv,
            down_op=None if t.down_op is None else _op_cut(
                t.down_op, *plan.down[l][rank]),
            up_op=None if t.up_op is None else _op_cut(
                t.up_op, *plan.up[l][rank]))
        for l, t in enumerate(h.transitions))
    return Hierarchy(levels=levels, transitions=transitions)


def edge_rank_hierarchy(h: Hierarchy, rank: int, n_shards: int,
                        device=None) -> Hierarchy:
    """Rank `rank`'s part of `h` under `edge_partition(h, n_shards)` on
    `device` (None: the CUDA card)."""
    device = resolve_device(device)
    return to_device(edge_shard(h, edge_partition(h, n_shards), rank), device)


def edge_shard_hierarchy(h: Hierarchy, group: str = "graph",
                         device=None) -> Hierarchy:
    """This rank's part of `h` by its place in `group` (JAX's
    `shard_hierarchy` on the mesh's `graph` axis): built once by the
    caller, then given to `edge_shard_forward` and
    `edge_shard_train_step`."""
    _require_group()
    return edge_rank_hierarchy(h, mesh.group_rank(group),
                               mesh.group_size(group), device)


def _require_group():
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized "
                           "(parallel.multihost.init_distributed)")


# -- the collectives ----------------------------------------------------------


class EdgeEnter(torch.autograd.Function):
    """Where node rows enter a rank's edge part: identity; backward: the
    group's sum of the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          ctx.group), None


class EdgeSum(torch.autograd.Function):
    """Where a rank's partial sum leaves its edge part: the group's sum;
    backward: identity (every rank holds the whole cotangent)."""

    @staticmethod
    def forward(ctx, part, group):
        return all_reduce(part.clone(memory_format=torch.contiguous_format),
                          group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def edge_part(fn, x, group: str):
    """The group's sum of `fn` (a rank's edge part: its slots' partial sum)
    of x, between `EdgeEnter` and `EdgeSum`."""
    return EdgeSum.apply(fn(EdgeEnter.apply(x, group)), group)


# -- the sharded entry points -------------------------------------------------


def eshard_method(cfg, group: str = "graph") -> str:
    """`"eshard:<group>:<local>"` of a model config, "fusedK" read as
    "fused" (as `halo.halo_method` reads it)."""
    return f"eshard:{group}:{split_interleave(cfg.aggregation)[0]}"


@torch.no_grad()
def edge_shard_forward(sim, hier: Hierarchy, node_in, node_mask,
                       group: str = "graph", device=None, compute_dtype=None):
    """The next-step prediction [..., N_pad, C] of the whole input (node_in
    [..., N_pad, C_in], node_mask [..., N_pad, 1], replicated on every
    rank of `group`) over this rank's part `hier` (`edge_shard_hierarchy`)
    on `device` (None: the CUDA card): JAX's `simulator_forward` on a
    `shard_hierarchy`-placed hierarchy. Every rank returns the same
    prediction."""
    device = resolve_device(device)
    check_device(device, None, node_in, node_mask)
    _require_group()
    return sim(hier, node_in, node_mask, compute_dtype,
               method=eshard_method(sim.cfg, group))


def edge_params(sim) -> List[bool]:
    """For each of `sim.parameters()`: whether it belongs to a GMP's edge
    MLP (its gradient is each rank's slots' part)."""
    from bsms_gnn_tpu_torch.ops.message import GMP

    edge = {id(p) for m in sim.modules() if isinstance(m, GMP)
            for p in m.mlp_edge.parameters()}
    return [id(p) in edge for p in sim.parameters()]


def edge_shard_train_step(trainer: Trainer, hier: Hierarchy, node_in,
                          node_tar, node_mask, noise=None,
                          group: str = "graph", data_group: str = "data",
                          device=None):
    """One train step of the replicated `trainer` on this rank's part
    `hier` of the hierarchy and its data row's frames (node_in [..., N_pad,
    C_in], node_tar [..., N_pad, C], node_mask [..., N_pad, 1]; with a
    `data` axis each data row its slice of the batch, `data_parallel.
    shard_batch`): `Trainer.iter` with the edge-sharded method, the sums
    over `data_group` and the gradients reduced as the module docstring
    says (JAX's `make_spmd_train_step`). `noise` is the data row's part of
    the global standard-normal draw, else a draw of `rank_noise` seeded by
    the data rank. `device` (None: the CUDA card) must be the trainer's.
    Returns the batch's loss."""
    device = resolve_device(device)
    check_device(device, trainer, node_in, node_tar, node_mask, noise)
    _require_group()
    if noise is None:
        noise = rank_noise(trainer, mesh.group_rank(data_group), node_tar)
    edge = edge_params(trainer.sim)
    sums = group_reduce(data_group)

    def grads(gs):
        group_reduce(group)([g for g, e in zip(gs, edge) if e])
        sums(gs)

    return Trainer.iter(trainer, hier, node_in, node_tar, node_mask, noise,
                        method=eshard_method(trainer.cfg.model, group),
                        reduce=sums, grad_reduce=grads)
