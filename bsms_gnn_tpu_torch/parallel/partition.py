"""Offline edge partitioning of a bi-stride hierarchy for the halo exchange
(counterpart of `bsms_gnn_tpu/parallel/partition.py`; NumPy only, and
every array of a plan equals the JAX package's bit for bit).

Each level's nodes are split over S shards; each edge belongs to the shard
that owns its receiver, so receiver sums are local; the sender rows an
edge needs from other shards form a static per-pair halo, exchanged with
one `all_to_all_single` per sender gather (`parallel/halo.py`). A coarse
node stays on the shard of the fine node it was kept from
(`assignment[l + 1] = assignment[l][kept]`), so pool and unpool are local
gathers.

Two optional layouts:
- the ghost layout (`local_layouts=True`, `_attach_ghost_layout`): a true
  `LevelGraph` per shard over the extended rows [x_loc ; halo ; pad],
  holding the shard's owned edges plus the reversed twin of each
  cross-shard one, so the one-card kernels run per shard unchanged and
  sender sums complete locally;
- replication (`replicate_floor`): the levels of at most that many nodes,
  and every deeper one, are held whole by every shard; the transition
  into the first of them sums each shard's owned rows over the group
  (`ops/pool.py::pool_nodes_boundary`).

`shard_hierarchy(plan, s)` gives shard s its own `Hierarchy` (leaf [s] of
every stacked array), which `graph.hierarchy.to_device` moves to a device
with the kernels' row tables.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from bsms_gnn_tpu_torch.graph.bistride import (
    BistrideLevels,
    smoothed_positions,
    transition_edge_weights,
)
from bsms_gnn_tpu_torch.graph.csr import CsrGraph
from bsms_gnn_tpu_torch.graph.hierarchy import (
    EDGE_BLOCK,
    NODE_BLOCK,
    Hierarchy,
    LevelGraph,
    Transition,
    _pad_level,
    layout_edge_count,
)

BALANCE_MODES = ("chunked", "opt", "cost", "nodes")


def _pad_to(n: int, multiple: int) -> int:
    return ((max(n, 0) + multiple - 1) // multiple) * multiple


@dataclass
class HaloLevel:
    """One level's per-shard local graphs. In a plan every array has the
    leading shard axis S; `shard_hierarchy` takes leaf [s] of each.

    Local node layout per shard: the shard's real nodes in global order,
    then padding; the last local row (n_loc − 1) is the pad node. Edge
    slots pad with self-loops on the pad node.

    `senders_ext` indexes the extended local table [x_loc ; halo rows]:
    values < n_loc are local senders; n_loc + t·H + h is the h-th node
    shard t ships here. `halo_send[s, d, h]` is shard s's local index of
    the h-th node it ships to shard d (pad entries point at s's pad node).

    `replicated`: every shard holds the whole level (S tiled copies of a
    one-shard build) and no halo is exchanged. `local`: the ghost layout,
    a `LevelGraph` over the extended rows whose edge-space arrays are then
    also the fields above (receivers in extended rows); `recv_clamped` is
    its receivers with the ghost slots clamped to the local pad row."""

    senders_ext: np.ndarray  # [S, E_loc] int32
    receivers: np.ndarray  # [S, E_loc] int32 (local)
    ew: np.ndarray  # [S, E_loc] f64 transition weights (pad 0)
    fiber: np.ndarray  # [S, E_loc, pos_dim + 1] f64 static edge fiber
    deg: np.ndarray  # [S, N_loc] f32 global out-degree (>= 1)
    node_mask: np.ndarray  # [S, N_loc, 1] f32
    edge_mask: np.ndarray  # [S, E_loc] f32
    halo_send: np.ndarray  # [S, S, H] int32
    n_shards: int
    halo_width: int  # H
    n_nodes: int  # the level's real nodes
    n_edges: int  # the level's real edges
    replicated: bool = False
    local: Optional[LevelGraph] = None
    recv_clamped: Optional[np.ndarray] = None  # [S, E_pad] int32

    @property
    def n_pad_nodes(self) -> int:  # local padded node count
        return self.deg.shape[-1]

    @property
    def n_pad_edges(self) -> int:
        return self.senders_ext.shape[-1]

    @property
    def window(self) -> int:
        """The ghost layout's window (0 on plain halo layouts)."""
        return 0 if self.local is None else self.local.window


@dataclass
class HaloHierarchy:
    levels: Tuple[HaloLevel, ...]
    transitions: Tuple[Transition, ...]  # per-shard local pool / unpool

    @property
    def depth(self) -> int:
        return len(self.transitions)


@dataclass
class PartitionPlan:
    """Hierarchy shards plus the level-0 node permutation for feature I/O."""

    hierarchy: HaloHierarchy
    perm: np.ndarray  # [S, N_loc0] global row of each local slot (pad → pad)
    n_global: int  # global padded row count
    n_real: int  # global real node count

    @property
    def n_shards(self) -> int:
        return self.perm.shape[0]


def _map_arrays(fn, obj):
    """`obj` (a dataclass of arrays, nested dataclasses and None) with fn
    applied to every array."""
    if obj is None:
        return None
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray):
            changes[f.name] = fn(v)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _map_arrays(fn, v)
    return dataclasses.replace(obj, **changes)


def _stack(objs):
    """Leaf-wise np.stack of same-structured dataclasses (the JAX
    package's tree_map over shards); every other field must agree."""
    first = objs[0]
    if first is None:
        if any(o is not None for o in objs):
            raise ValueError("shards differ in structure")
        return None
    changes = {}
    for f in dataclasses.fields(first):
        vs = [getattr(o, f.name) for o in objs]
        if isinstance(vs[0], np.ndarray):
            changes[f.name] = np.stack(vs)
        elif dataclasses.is_dataclass(vs[0]) or vs[0] is None:
            changes[f.name] = _stack(vs)
        elif any(v != vs[0] for v in vs):
            raise ValueError(f"shards differ in {f.name}: {vs}")
    return dataclasses.replace(first, **changes)


def _partition_level(
    edges: np.ndarray,
    n: int,
    deg_global: np.ndarray,
    ec: np.ndarray,
    lvl_pos: np.ndarray,
    assignment: np.ndarray,
    n_shards: int,
    block: int,
) -> Tuple[HaloLevel, List[np.ndarray], np.ndarray, list]:
    """One HaloLevel. Returns (level, owned-node lists, local index of each
    global node, halo lists [dest][owner] → global sender ids)."""
    s_count = np.bincount(assignment, minlength=n_shards)
    n_loc = _pad_to(int(s_count.max()) + 1, block)
    owned = [np.flatnonzero(assignment == s) for s in range(n_shards)]
    local_of = np.empty(n, np.int64)
    for s in range(n_shards):
        local_of[owned[s]] = np.arange(len(owned[s]))

    snd, rcv = edges[0], edges[1]
    e_owner = assignment[rcv]
    e_counts = np.bincount(e_owner, minlength=n_shards)
    e_loc = _pad_to(max(int(e_counts.max()), 1), block)

    # For each (dest s, owner t != s): the unique remote senders.
    halo_lists = [[np.empty(0, np.int64)] * n_shards for _ in range(n_shards)]
    for s in range(n_shards):
        es = e_owner == s
        remote = snd[es][assignment[snd[es]] != s]
        if len(remote):
            remote = np.unique(remote)
            for t in range(n_shards):
                halo_lists[s][t] = remote[assignment[remote] == t]
    h_max = max(
        (len(halo_lists[s][t]) for s in range(n_shards) for t in range(n_shards)),
        default=0,
    )
    H = max(_pad_to(h_max, 8), 8)

    halo_send = np.full((n_shards, n_shards, H), n_loc - 1, np.int32)
    ext_slot = {}  # (dest s, global g) → extended row n_loc + t·H + h
    for s in range(n_shards):
        for t in range(n_shards):
            lst = halo_lists[s][t]
            if len(lst):
                halo_send[t, s, : len(lst)] = local_of[lst].astype(np.int32)
                for h, g in enumerate(lst):
                    ext_slot[(s, int(g))] = n_loc + t * H + h

    senders_ext = np.full((n_shards, e_loc), n_loc - 1, np.int32)
    receivers = np.full((n_shards, e_loc), n_loc - 1, np.int32)
    ew = np.zeros((n_shards, e_loc), np.float64)
    p64 = np.asarray(lvl_pos, np.float64)
    d_all = p64[snd] - p64[rcv]
    fib_all = np.concatenate(
        [d_all, np.linalg.norm(d_all, axis=-1, keepdims=True)], axis=-1
    )
    fiber = np.zeros((n_shards, e_loc, fib_all.shape[-1]), np.float64)
    edge_mask = np.zeros((n_shards, e_loc), np.float32)
    for s in range(n_shards):
        es = np.flatnonzero(e_owner == s)
        # Receiver-sorted within the shard.
        es = es[np.argsort(local_of[rcv[es]], kind="stable")]
        k = len(es)
        receivers[s, :k] = local_of[rcv[es]]
        loc_snd = np.empty(k, np.int64)
        snd_s = snd[es]
        is_local = assignment[snd_s] == s
        loc_snd[is_local] = local_of[snd_s[is_local]]
        for i in np.flatnonzero(~is_local):
            loc_snd[i] = ext_slot[(s, int(snd_s[i]))]
        senders_ext[s, :k] = loc_snd
        ew[s, :k] = np.asarray(ec, np.float64)[es]
        fiber[s, :k] = fib_all[es]
        edge_mask[s, :k] = 1.0

    deg = np.ones((n_shards, n_loc), np.float32)
    node_mask = np.zeros((n_shards, n_loc, 1), np.float32)
    for s in range(n_shards):
        k = len(owned[s])
        deg[s, :k] = np.maximum(deg_global[owned[s]], 1.0)
        node_mask[s, :k, 0] = 1.0

    level = HaloLevel(
        senders_ext=senders_ext, receivers=receivers, ew=ew, fiber=fiber,
        deg=deg, node_mask=node_mask, edge_mask=edge_mask,
        halo_send=halo_send, n_shards=n_shards, halo_width=H, n_nodes=n,
        n_edges=edges.shape[1],
    )
    return level, owned, local_of, halo_lists


def _global_reverse(edges: np.ndarray, n: int) -> np.ndarray:
    """Index of each edge's reverse twin in the (symmetric) edge list."""
    snd = edges[0].astype(np.int64)
    rcv = edges[1].astype(np.int64)
    key_fwd = snd * n + rcv
    key_rev = rcv * n + snd
    order = np.argsort(key_fwd)
    pos_of_rev = np.searchsorted(key_fwd[order], key_rev)
    if not np.array_equal(key_fwd[order][pos_of_rev], key_rev):
        raise ValueError("level edge set is not symmetric")
    return order[pos_of_rev]


def _unify_ells(lvls, n_edges_meta: int):
    """Pad the shards' ELL tables to the widest (pad slot E_pad) and record
    the level's global edge count, so the shards stack."""
    e_pad = lvls[0].n_pad_edges
    kin = max(lg.recv_ell.shape[1] for lg in lvls)
    kout = max(lg.send_ell.shape[1] for lg in lvls)
    return [
        dataclasses.replace(
            lg,
            recv_ell=np.pad(lg.recv_ell,
                            ((0, 0), (0, kin - lg.recv_ell.shape[1])),
                            constant_values=e_pad),
            send_ell=np.pad(lg.send_ell,
                            ((0, 0), (0, kout - lg.send_ell.shape[1])),
                            constant_values=e_pad),
            n_edges=n_edges_meta,
        )
        for lg in lvls
    ]


def _unify_cresids(lgs, n_pad: int):
    """Pad the shards' compact residual tables to common (rows, visits)
    shapes: pad rows are inert (pad-node endpoints, zero weights and
    fiber, identity twin), pad visits repeat the last real visit's blocks
    with every receiver masked. n_real records the shards' largest."""
    crs = [lg.cresid for lg in lgs]
    if any(cr is None for cr in crs):
        return [dataclasses.replace(lg, cresid=None) for lg in lgs]
    rp_max = max(cr.n_rows for cr in crs)
    v_max = max(int(cr.visit_block.shape[0]) for cr in crs)
    v8 = -(-v_max // 8) * 8
    n_real_meta = max(cr.n_real for cr in crs)
    out = []
    for lg, cr in zip(lgs, crs):
        rp, v = cr.n_rows, int(cr.visit_block.shape[0])
        pr, pv = rp_max - rp, v_max - v
        vr = np.full((v8, 128), -1, np.int32)
        vr[:v] = np.asarray(cr.visit_recv)[:v]

        def pad1(a, val, pr=pr):
            return np.pad(np.asarray(a), (0, pr), constant_values=val)

        cr2 = dataclasses.replace(
            cr,
            senders=pad1(cr.senders, n_pad - 1).astype(np.int32),
            receivers=pad1(cr.receivers, n_pad - 1).astype(np.int32),
            ew=pad1(cr.ew, 0.0),
            ew_rev=pad1(cr.ew_rev, 0.0),
            fiber=np.pad(np.asarray(cr.fiber), ((0, pr), (0, 0))),
            twin=np.concatenate([np.asarray(cr.twin).astype(np.int32),
                                 np.arange(rp, rp_max, dtype=np.int32)]),
            visit_block=np.pad(np.asarray(cr.visit_block), (0, pv),
                               mode="edge").astype(np.int32),
            visit_cblk=np.pad(np.asarray(cr.visit_cblk), (0, pv),
                              mode="edge").astype(np.int32),
            visit_recv=vr,
            n_real=int(n_real_meta),
        )
        out.append(dataclasses.replace(lg, cresid=cr2))
    return out


def _attach_ghost_layout(
    level: HaloLevel,
    edges: np.ndarray,
    ec: np.ndarray,
    lvl_pos: np.ndarray,
    assignment: np.ndarray,
    owned: List[np.ndarray],
    local_of: np.ndarray,
    halo_lists: list,
    edge_block: int,
    window: int = 0,
) -> HaloLevel:
    """Each shard's ghost-edge `LevelGraph` (`HaloLevel.local`), stacked,
    with the level's edge-space fields rebased onto it.

    Shard s's graph lives in extended rows (rows [0, n_loc) its owned
    nodes and local pad, rows [n_loc, n_loc + S·H) the halo slots, then
    zero pad rows) and holds every owned edge plus the reversed twin of
    each cross-shard owned edge: a symmetric set, so `_pad_level` runs
    unchanged and gives the reverse edges, `ew_rev` and the window tables
    the one-card kernels read."""
    S, H = level.n_shards, level.halo_width
    n_loc = level.deg.shape[-1]
    n_ext = n_loc + S * H
    align = NODE_BLOCK
    if window:
        # The windowed layout needs n_pad % (window // 2) == 0.
        align = max(NODE_BLOCK, window // 2)
    n_ext_pad = _pad_to(n_ext + 1, align)
    snd = edges[0].astype(np.int64)
    rcv = edges[1].astype(np.int64)
    ec64 = np.asarray(ec, np.float64)
    ec_rev = ec64[_global_reverse(edges, int(assignment.shape[0]))]
    e_owner = assignment[rcv]
    p64 = np.asarray(lvl_pos, np.float64)

    shard_inputs = []
    e_layouts = [0]
    for s in range(S):
        es = np.flatnonzero(e_owner == s)
        snd_s, rcv_s = snd[es], rcv[es]
        is_local = assignment[snd_s] == s
        ext_of = np.full(assignment.shape[0], -1, np.int64)
        ext_pos = np.zeros((n_ext, p64.shape[1]), np.float64)
        o = owned[s]
        ext_pos[local_of[o]] = p64[o]
        for t in range(S):
            lst = halo_lists[s][t]
            if len(lst):
                slots = n_loc + t * H + np.arange(len(lst))
                ext_of[lst] = slots
                ext_pos[slots] = p64[lst]
        lsnd = np.where(is_local, local_of[snd_s], ext_of[snd_s])
        lrcv = local_of[rcv_s]
        cross = np.flatnonzero(~is_local)
        local_edges = np.stack([
            np.concatenate([lsnd, lrcv[cross]]),
            np.concatenate([lrcv, ext_of[snd_s[cross]]]),
        ])
        ec_local = np.concatenate([ec64[es], ec_rev[es[cross]]])
        shard_inputs.append((local_edges, ec_local, ext_pos))
        counts = np.bincount(local_edges[1], minlength=n_ext_pad)
        e_layouts.append(layout_edge_count(counts, n_ext_pad, edge_block))

    emax = max(e_layouts)
    lgs = [
        _pad_level(CsrGraph(le, n_ext), n_ext_pad, ec_l, ext_pos,
                   edge_block=edge_block, window=window, e_pad_min=emax,
                   compact=False)
        for le, ec_l, ext_pos in shard_inputs
    ]
    if window and any(lg.resid is not None for lg in lgs):
        # The out-of-window edges must stack too: every shard gets a
        # residual sub-level (maybe empty) at the largest size and the
        # compact tables, padded to the shards' largest.
        resid_emax = max(lg.resid.n_pad_edges for lg in lgs
                         if lg.resid is not None)
        lgs = [
            _pad_level(CsrGraph(le, n_ext), n_ext_pad, ec_l, ext_pos,
                       edge_block=edge_block, window=window, e_pad_min=emax,
                       resid_e_pad_min=resid_emax, force_resid=True,
                       force_cresid=True)
            for le, ec_l, ext_pos in shard_inputs
        ]
        lgs = _unify_cresids(lgs, n_ext_pad)

    n_edges_meta = int(edges.shape[1])
    lgs = _unify_ells(lgs, n_edges_meta)
    if lgs[0].resid is not None:
        resids = _unify_ells([lg.resid for lg in lgs], n_edges_meta)
        lgs = [dataclasses.replace(lg, resid=r) for lg, r in zip(lgs, resids)]
    stacked = _stack(lgs)
    recv_clamped = np.where(
        stacked.receivers < n_loc, stacked.receivers, n_loc - 1
    ).astype(np.int32)
    return dataclasses.replace(
        level,
        senders_ext=stacked.senders,
        receivers=stacked.receivers,  # extended rows (ghost slots >= n_loc)
        ew=stacked.ew,
        fiber=stacked.fiber,
        edge_mask=stacked.edge_mask,
        local=stacked,
        recv_clamped=recv_clamped,
    )


def _balanced_assignment(graphs, ids, n_shards: int) -> np.ndarray:
    """Contiguous level-0 split points that balance each shard's edge work
    over all levels: each level-l node's owned-edge count is projected onto
    its level-0 ancestor, and the S − 1 splits fall at equal increments of
    the cumulative cost."""
    n0 = graphs[0].num_nodes
    cost0 = np.ones(n0, np.float64)
    anc = np.arange(n0)
    for l, g in enumerate(graphs):
        own = np.bincount(g.flat_edges[1], minlength=g.num_nodes)
        cost0[anc] += own  # anc is injective: direct indexed add
        if l < len(ids):
            anc = anc[ids[l]]
    cum = np.cumsum(cost0)
    return np.minimum(
        ((cum - cost0 / 2) * n_shards // cum[-1]).astype(np.int64),
        n_shards - 1,
    )


def _optimize_breakpoints(
    graphs, ids, n_shards: int, level_modes, grid: int = 1024,
    sweeps: int = 3,
) -> np.ndarray:
    """Coordinate descent over contiguous level-0 split points minimizing
    Σ_l max_s load(l, s), a ghost level's load being its owned plus
    ghost-twin slots (2·owned − intra), a plain level's its owned edges;
    replicated levels are skipped. Each level's edges are binned into a
    [grid, grid] histogram of (receiver-ancestor, sender-ancestor) level-0
    bins, so each candidate's loads are 2D prefix-sum lookups."""
    n0 = graphs[0].num_nodes
    grid = min(grid, n0)
    anc = np.arange(n0)
    row_pre, box_pre, modes = [], [], []
    for l, g in enumerate(graphs):
        mode = level_modes[l]
        if mode != "skip":
            snd, rcv = g.flat_edges
            bi = anc[rcv].astype(np.int64) * grid // n0
            bj = anc[snd].astype(np.int64) * grid // n0
            h = np.bincount(bi * grid + bj, minlength=grid * grid)
            h = h.reshape(grid, grid)
            rp = np.zeros(grid + 1, np.int64)
            rp[1:] = np.cumsum(h.sum(axis=1))
            bp = np.zeros((grid + 1, grid + 1), np.int64)
            bp[1:, 1:] = h.cumsum(axis=0).cumsum(axis=1)
            row_pre.append(rp)
            box_pre.append(bp)
            modes.append(mode)
        if l < len(ids):
            anc = anc[ids[l]]

    def loads(l, lo, hi):
        owned = row_pre[l][hi] - row_pre[l][lo]
        if modes[l] != "ghost":
            return owned
        bp = box_pre[l]
        intra = bp[hi, hi] - bp[lo, hi] - bp[hi, lo] + bp[lo, lo]
        return 2 * owned - intra

    # Start: equal increments of the total load on the grid.
    total = np.zeros(grid + 1, np.float64)
    for l in range(len(row_pre)):
        total += loads(l, 0, np.arange(grid + 1))
    b = np.searchsorted(
        total, total[-1] * np.arange(1, n_shards) / n_shards
    ).astype(np.int64)
    b = np.concatenate([[0], b, [grid]])
    for k in range(1, n_shards + 1):  # strictly increasing
        b[k] = max(b[k], b[k - 1] + 1)
    b[n_shards] = grid
    for k in range(n_shards - 1, 0, -1):
        b[k] = min(b[k], b[k + 1] - 1)

    L = len(row_pre)
    for _ in range(sweeps):
        for k in range(1, n_shards):
            cand = np.arange(b[k - 1] + 1, b[k + 1])
            if len(cand) <= 1:
                continue
            obj = np.zeros(len(cand), np.float64)
            for l in range(L):
                cur = loads(l, b[:-1], b[1:])
                others = np.delete(cur, [k - 1, k])
                omax = others.max() if len(others) else 0
                lo_side = loads(l, np.full_like(cand, b[k - 1]), cand)
                hi_side = loads(l, cand, np.full_like(cand, b[k + 1]))
                obj += np.maximum(omax, np.maximum(lo_side, hi_side))
            b[k] = cand[int(np.argmin(obj))]

    bins = np.arange(n0, dtype=np.int64) * grid // n0
    return np.searchsorted(b[1:-1], bins, side="right").astype(np.int64)


def _chunked_assignment(
    graphs, ids, n_shards: int, level_modes, grid: int = 4096,
    chunks_per_shard: int = 16,
) -> np.ndarray:
    """S·M contiguous level-0 chunks of about equal total load dealt to
    shards: greedy longest-processing-time on the per-level load vectors,
    then first-improvement single-chunk moves, minimizing Σ_l max_s
    load(l, s). Ghost-twin costs are exact: per-level chunk-pair edge
    counts give each shard's intra-shard edges."""
    n0 = graphs[0].num_nodes
    grid = min(grid, n0)
    n_chunks = max(n_shards, min(n_shards * chunks_per_shard, grid // 2))
    anc = np.arange(n0)
    own_pre = []  # [L][grid + 1] prefix of receiver-bin sums
    pair = []  # [L][n_chunks, n_chunks] chunk-pair edge counts
    modes = []
    total = np.zeros(grid + 1, np.float64)
    hists = []
    for l, g in enumerate(graphs):
        mode = level_modes[l]
        if mode != "skip":
            snd, rcv = g.flat_edges
            bi = anc[rcv].astype(np.int64) * grid // n0
            bj = anc[snd].astype(np.int64) * grid // n0
            h = np.bincount(bi * grid + bj, minlength=grid * grid)
            h = h.reshape(grid, grid)
            hists.append((h, mode))
            rp = np.zeros(grid + 1, np.int64)
            rp[1:] = np.cumsum(h.sum(axis=1))
            own_pre.append(rp)
            modes.append(mode)
            total += rp * (2.0 if mode == "ghost" else 1.0)
        if l < len(ids):
            anc = anc[ids[l]]
    bounds = np.searchsorted(
        total, total[-1] * np.arange(1, n_chunks) / n_chunks
    ).astype(np.int64)
    bounds = np.concatenate([[0], bounds, [grid]])
    for k in range(1, n_chunks + 1):
        bounds[k] = max(bounds[k], bounds[k - 1] + 1)
    bounds[n_chunks] = grid
    for k in range(n_chunks - 1, 0, -1):
        bounds[k] = min(bounds[k], bounds[k + 1] - 1)

    L = len(own_pre)
    own = np.zeros((L, n_chunks), np.int64)  # edges received by chunk
    for l in range(L):
        own[l] = own_pre[l][bounds[1:]] - own_pre[l][bounds[:-1]]
    for h, mode in hists:
        if mode == "ghost":
            bp = np.zeros((grid + 1, grid + 1), np.int64)
            bp[1:, 1:] = h.cumsum(axis=0).cumsum(axis=1)
            pair.append(
                bp[np.ix_(bounds[1:], bounds[1:])]
                - bp[np.ix_(bounds[:-1], bounds[1:])]
                - bp[np.ix_(bounds[1:], bounds[:-1])]
                + bp[np.ix_(bounds[:-1], bounds[:-1])]
            )  # [a, b] = edges with receiver in a, sender in b
        else:
            pair.append(None)

    assign = np.full(n_chunks, -1, np.int64)
    own_s = np.zeros((L, n_shards), np.int64)
    intra_s = np.zeros((L, n_shards), np.int64)

    def load(l):
        if modes[l] == "ghost":
            return 2 * own_s[l] - intra_s[l]
        return own_s[l]

    def delta_intra(l, c, members):
        # intra edges chunk c adds on joining `members` (both directions
        # and its own diagonal)
        pm = pair[l]
        if pm is None or not members:
            return pm[c, c] if pm is not None else 0
        m = np.asarray(members)
        return pm[c, c] + pm[c, m].sum() + pm[m, c].sum()

    def objective():
        return sum(load(l).max() for l in range(L))

    def move(c, s, sign):
        for l in range(L):
            own_s[l, s] += sign * own[l, c]
            if modes[l] == "ghost":
                intra_s[l, s] += sign * delta_intra(l, c, members[s])

    order = np.argsort(-own.sum(axis=0))
    members = [[] for _ in range(n_shards)]
    for c in order:
        best, best_obj = 0, None
        for s in range(n_shards):
            move(c, s, 1)
            obj = objective()
            move(c, s, -1)
            if best_obj is None or obj < best_obj:
                best, best_obj = s, obj
        assign[c] = best
        move(c, best, 1)
        members[best].append(int(c))

    for _ in range(4):
        improved = False
        base = objective()
        for c in range(n_chunks):
            s0 = int(assign[c])
            if len(members[s0]) <= 1:
                continue
            members[s0].remove(c)
            move(c, s0, -1)
            best_s, best_obj = s0, base
            for s in range(n_shards):
                move(c, s, 1)
                obj = objective()
                move(c, s, -1)
                if obj < best_obj - 1e-9:
                    best_s, best_obj = s, obj
            move(c, best_s, 1)
            members[best_s].append(int(c))
            assign[c] = best_s
            if best_s != s0:
                improved = True
                base = best_obj
        if not improved:
            break

    chunk_of_bin = np.searchsorted(bounds[1:-1], np.arange(grid),
                                   side="right")
    bins = np.arange(n0, dtype=np.int64) * grid // n0
    return assign[chunk_of_bin[bins]]


def _tile_level(level: HaloLevel, n_shards: int) -> HaloLevel:
    """S identical copies of a one-shard HaloLevel along the shard axis."""
    def tile(a):
        return np.tile(a, (n_shards,) + (1,) * (a.ndim - 1))

    return dataclasses.replace(_map_arrays(tile, level), n_shards=n_shards,
                               replicated=True)


def build_partition(
    levels: BistrideLevels,
    n_shards: int,
    n_global_pad: int,
    pos: np.ndarray,
    block: int = 128,
    local_layouts: bool = False,
    edge_block: int = EDGE_BLOCK,
    window: int = 0,
    replicate_floor: int = 0,
    balance: str = "chunked",
    ghost_floor: int = 0,
) -> PartitionPlan:
    """Partition raw bi-stride levels into an S-shard halo plan.

    `n_global_pad` is the row count of the padded global feature arrays the
    caller feeds `partition_nodes` (their pad rows must be zero); `pos` the
    level-0 mesh positions, for the static fibers.

    `replicate_floor`: the levels (below level 0) of at most this many
    nodes, and every deeper one, are replicated. `ghost_floor`: under
    `local_layouts`, the levels of at most this many nodes keep the plain
    halo layout. `balance`: "chunked" (S·16 contiguous chunks dealt to
    shards), "opt" (contiguous split points by coordinate descent),
    "cost" (the cumulative-edge-cost heuristic) or "nodes" (equal node
    counts)."""
    if balance not in BALANCE_MODES:
        raise ValueError(f"balance {balance!r} not in {BALANCE_MODES}")
    graphs, ids = levels.graphs, levels.ids
    n0 = graphs[0].num_nodes

    repl_plan = []
    replicating = False
    for l, g in enumerate(graphs):
        replicating = replicating or (
            0 < replicate_floor >= g.num_nodes and l > 0 and n_shards > 1
        )
        repl_plan.append(replicating)
    level_modes = [
        "skip" if repl_plan[l]
        else ("ghost"
              if local_layouts and not (0 < ghost_floor >= g.num_nodes)
              else "plain")
        for l, g in enumerate(graphs)
    ]

    if balance == "chunked":
        assignment = _chunked_assignment(graphs, ids, n_shards, level_modes)
    elif balance == "opt":
        assignment = _optimize_breakpoints(graphs, ids, n_shards, level_modes)
    elif balance == "cost":
        assignment = _balanced_assignment(graphs, ids, n_shards)
    else:
        per = -(-n0 // n_shards)
        assignment = np.minimum(np.arange(n0) // per, n_shards - 1)

    halo_levels, owned_per_level, local_per_level, assignments = [], [], [], []
    ecs = transition_edge_weights(levels)
    lvl_pos = smoothed_positions(levels, pos)
    for l, g in enumerate(graphs):
        deg_g = g.degrees().astype(np.float32)
        replicating = repl_plan[l]
        a_lvl = (np.zeros(g.num_nodes, assignment.dtype) if replicating
                 else assignment)
        s_lvl = 1 if replicating else n_shards
        lvl, owned, local_of, halo_lists = _partition_level(
            g.flat_edges, g.num_nodes, deg_g, ecs[l], lvl_pos[l],
            a_lvl, s_lvl, block,
        )
        if level_modes[l] == "ghost" or (replicating and local_layouts):
            lvl = _attach_ghost_layout(
                lvl, g.flat_edges, ecs[l], lvl_pos[l], a_lvl,
                owned, local_of, halo_lists, edge_block, window,
            )
        if replicating:
            lvl = _tile_level(lvl, n_shards)
        halo_levels.append(lvl)
        owned_per_level.append(owned)
        local_per_level.append(local_of)
        assignments.append(assignment)
        if l < len(ids):
            assignment = assignment[ids[l]]

    transitions = []
    for l, kept in enumerate(ids):
        n_loc_p = halo_levels[l].n_pad_nodes
        n_loc_c = halo_levels[l + 1].n_pad_nodes
        if repl_plan[l]:
            # Both levels replicated: the one-shard transition, tiled.
            nc = len(kept)
            pool1 = np.full(n_loc_c, n_loc_p - 1, np.int32)
            pool1[:nc] = kept.astype(np.int32)
            unpool1 = np.full(n_loc_p, n_loc_c, np.int32)
            unpool1[kept] = np.arange(nc, dtype=np.int32)
            transitions.append(Transition(
                pool_ids=np.tile(pool1, (n_shards, 1)),
                unpool_inv=np.tile(unpool1, (n_shards, 1)),
            ))
            continue
        if repl_plan[l + 1]:
            # Replication boundary: parent partitioned, child replicated.
            # Each shard supplies the child rows whose parent it owns
            # (pool_mask); the group sum assembles the rest.
            pool_local = np.full((n_shards, n_loc_c), n_loc_p - 1, np.int32)
            pool_mask = np.zeros((n_shards, n_loc_c, 1), np.float32)
            unpool_local = np.full((n_shards, n_loc_p), n_loc_c, np.int32)
            parent_local = local_per_level[l]
            child_assign = assignments[l + 1]  # owner of each child's parent
            for s in range(n_shards):
                cs = np.flatnonzero(child_assign == s)
                pool_local[s, cs] = parent_local[kept[cs]].astype(np.int32)
                pool_mask[s, cs, 0] = 1.0
                unpool_local[s, parent_local[kept[cs]]] = cs.astype(np.int32)
            transitions.append(Transition(
                pool_ids=pool_local, unpool_inv=unpool_local,
                pool_mask=pool_mask,
            ))
            continue
        pool_local = np.full((n_shards, n_loc_c), n_loc_p - 1, np.int32)
        unpool_local = np.full((n_shards, n_loc_p), n_loc_c, np.int32)
        parent_local = local_per_level[l]
        child_local = local_per_level[l + 1]
        child_assign = assignments[l + 1]
        for s in range(n_shards):
            cs = np.flatnonzero(child_assign == s)
            pool_local[s, child_local[cs]] = (
                parent_local[kept[cs]].astype(np.int32))
            unpool_local[s, parent_local[kept[cs]]] = (
                child_local[cs].astype(np.int32))
        transitions.append(Transition(pool_ids=pool_local,
                                      unpool_inv=unpool_local))

    n_loc0 = halo_levels[0].n_pad_nodes
    if n_global_pad <= n0:
        raise ValueError("global arrays must carry at least one pad row")
    perm = np.full((n_shards, n_loc0), n_global_pad - 1, np.int64)
    for s in range(n_shards):
        o = owned_per_level[0][s]
        perm[s, : len(o)] = o

    return PartitionPlan(
        hierarchy=HaloHierarchy(levels=tuple(halo_levels),
                                transitions=tuple(transitions)),
        perm=perm, n_global=n_global_pad, n_real=n0,
    )


def shard_hierarchy(plan: PartitionPlan, s: int) -> Hierarchy:
    """Shard s's own `Hierarchy`: leaf [s] of every stacked array of the
    plan's levels (with their ghost layouts) and transitions; each level
    keeps its halo map, `replicated` and static sizes, each transition its
    `pool_mask`. `graph.hierarchy.to_device` moves it to a device."""
    if not 0 <= s < plan.n_shards:
        raise ValueError(f"shard {s} outside [0, {plan.n_shards})")

    def take(a):
        return np.ascontiguousarray(a[s])

    h = plan.hierarchy
    return Hierarchy(
        levels=tuple(_map_arrays(take, lvl) for lvl in h.levels),
        transitions=tuple(_map_arrays(take, t) for t in h.transitions),
    )


def partition_nodes(plan: PartitionPlan, x: np.ndarray) -> np.ndarray:
    """Global [..., N_pad, C] → shard-major [S, ..., N_loc, C] (pad slots
    read the global pad row, zero by construction)."""
    x = np.asarray(x)
    out = np.take(x, plan.perm.reshape(-1), axis=-2)
    s, n_loc = plan.perm.shape
    out = out.reshape(x.shape[:-2] + (s, n_loc) + x.shape[-1:])
    return np.moveaxis(out, -3, 0) if x.ndim > 2 else out


def unpartition_nodes(plan: PartitionPlan, y: np.ndarray) -> np.ndarray:
    """Shard-major [S, ..., N_loc, C] → global [..., N_pad, C]; the global
    pad rows are zeroed."""
    y = np.asarray(y)
    s, n_loc = plan.perm.shape
    flat = np.moveaxis(y, 0, -3) if y.ndim > 3 else y
    lead = flat.shape[:-3]
    flat = flat.reshape(lead + (s * n_loc,) + y.shape[-1:])
    inv = np.zeros(plan.n_global, np.int64)
    valid = plan.perm.reshape(-1) < plan.n_global - 1
    inv[plan.perm.reshape(-1)[valid]] = np.flatnonzero(valid)
    out = np.take(flat, inv, axis=-2)
    out[..., plan.n_real:, :] = 0.0
    return out
