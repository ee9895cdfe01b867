"""Static-shape padded hierarchy artifacts, and their move to a device.

Counterpart of `bsms_gnn_tpu/graph/hierarchy.py`: `build_hierarchy` →
`pad_levels` → `_pad_level` / `_pad_trans_layout`, with the per-chunk
source windows (`_window_vote`, `_window_tables`), the compact residual
tables (`_compact_resid`) or, on bucketed builds, the mini residual
sub-layouts (`LevelGraph.resid`) of the out-of-window edges, the
component-major fiber (`_fiber_t`), the pool / unpool maps, and the
bucketed build of variable-mesh datasets (`node_buckets`, `edge_buckets`,
`resid_buckets`, `ell_buckets`: every mesh of a size group pads to the
group's shapes; such builds carry no compact residual and no fused
transition operator, as in the JAX package), and the ELL tables of the
`ell` and `segment` methods (`_build_ell`: each node's incident edge slots,
padded with E_pad). The arrays equal the JAX package's array for array;
the dense transition matrices of bucketed builds, the mini residual
sub-layouts of unbucketed builds (the model reads their compact tables)
are not built here. `load_or_build_hierarchy` / `load_or_build_levels`
cache the padded hierarchy and the raw bi-stride levels as npz files of
the port's own names (`*_torch_mmesh_*.npz`, `*_torch_levels_*.npz`):
a dataset directory may also hold the JAX package's caches, and neither
package reads the other's. `load_or_build_hierarchy(window="auto")` gives
each level the width the JAX package's tuner picks (`choose_windows`,
`window_coverage`).

Padding convention: nodes pad to N_pad (always > N); pad edge slots connect
pad node N_pad-1 to itself and carry weight 0, so garbage never reaches a
real node. Every 128-node receiver block's edge segment pads to a multiple
of `edge_block` slots, at least one chunk per block, except on skip-empty
layouts (the residual sub-levels), where a block with no edge gets no
slot. An edge bucket larger than the layout appends chunks of pad slots,
which belong to the last block.

`to_device` turns a built hierarchy into the same dataclasses holding
tensors, plus the per-block chunk ranges and the per-row slot lists the
CUDA kernels walk.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from bsms_gnn_tpu_torch.device import resolve_device
from bsms_gnn_tpu_torch.graph.bistride import (
    BistrideLevels,
    build_bistride_levels,
    smoothed_positions,
    transition_edge_weights,
)
from bsms_gnn_tpu_torch.graph.csr import CsrGraph

EDGE_BLOCK = 128
NODE_BLOCK = 128
# Candidate source-window widths for window="auto" (`choose_windows`).
AUTO_WINDOW_CANDIDATES = (128, 256, 512, 1024)
# The cost model's price, in selection rows per edge, of one edge on the
# residual path; shared by `choose_windows`' default and the auto build's
# cache key.
AUTO_RESID_ROWS = 2048
# Transitions whose input and output pads are at most this wide (and that
# are not windowed) also carry a dense [N_out, N_in] operator matrix.
DENSE_TRANS_MAX = 2048
# The row-ordered gather of kernels 1, 2, 7 and 15 (`csrc/row_gather.cuh`):
# a row of more than GATHER_PIECE listed slots (`long_rows`) is cut into
# pieces of that many over a thread block of its own.
GATHER_PIECE = 32


def _pad_to(n: int, multiple: int, minimum: int = 0) -> int:
    n = max(n, minimum)
    return ((n + multiple - 1) // multiple) * multiple


@dataclass
class CompactResid:
    """Dense (per-real-edge) residual tables: the out-of-window edges,
    receiver-sorted and padded only to the next 128 rows. The aggregate runs
    one VISIT per (128-row input block × output node-block) incidence."""

    senders: np.ndarray  # [Rp] int32 absolute (pad → n_pad-1)
    receivers: np.ndarray  # [Rp] int32 absolute, non-decreasing (pad → n_pad-1)
    ew: np.ndarray  # [Rp] f64 (pad 0)
    ew_rev: np.ndarray  # [Rp] f64 twin's weight (levels; == ew for TransOps)
    fiber: np.ndarray  # [Rp, pd1] f64 (zeros when no positions)
    twin: np.ndarray  # [Rp] int32 compact row of the reverse edge (or identity)
    visit_block: np.ndarray  # [V] int32 output node-block (non-decreasing)
    visit_cblk: np.ndarray  # [V] int32 input 128-row block of compact rows
    visit_recv: np.ndarray  # [ceil(V/8)*8, 128] int32 LOCAL recv row (-1 = masked)
    n_real: int = 0
    n_pad_nodes: int = 0
    symmetric: bool = True
    # Set by to_device, for kernel 2's gather (`compact_row_tables`): the
    # distinct receivers of the real rows, ascending, cr_rows [U]; receiver
    # cr_rows[k] sums compact rows cr_row_ptr[k] .. cr_row_ptr[k+1]; cr_long
    # the receivers split into pieces (`long_rows`).
    cr_rows: Optional[torch.Tensor] = None
    cr_row_ptr: Optional[torch.Tensor] = None
    cr_long: Optional[torch.Tensor] = None

    @property
    def n_rows(self) -> int:
        return self.senders.shape[-1]


@dataclass
class LevelGraph:
    """One level's padded static graph. All index arrays are int32.
    Real edges are grouped by their receiver's 128-node block (sender-sorted
    within a block on windowed layouts), each block segment padded to a
    multiple of `edge_block` slots; real slots are flagged by edge_mask."""

    senders: np.ndarray  # [E_pad]
    receivers: np.ndarray  # [E_pad]
    recv_indptr: np.ndarray  # [N_pad+1] layout offset of each node's edges
    recv_ell: np.ndarray  # [N_pad, K_in] edge slots per receiver (pad = E_pad)
    send_ell: np.ndarray  # [N_pad, K_out] edge slots per sender (pad = E_pad)
    deg: np.ndarray  # [N_pad] f32 out-degree over real edges (>= 1)
    node_mask: np.ndarray  # [N_pad, 1] f32, 1.0 for real nodes
    edge_mask: np.ndarray  # [E_pad] f32, 1.0 for real edge slots
    reverse_perm: np.ndarray  # [E_pad] int32 slot of each edge's reverse
    ew: np.ndarray  # [E_pad] f64 transition-conv weights (pad 0)
    fiber: np.ndarray  # [E_pad, pos_dim+1] f64 static [Δpos, ‖Δpos‖]
    n_nodes: int
    n_edges: int
    edge_block: int = EDGE_BLOCK
    ew_rev: Optional[np.ndarray] = None  # [E_pad] f64
    # Windowed tables: send_win is each slot's sender relative to its
    # chunk's source window (sentinel `window` = out of window, or pad);
    # win_base maps each chunk to its window's half-window block index
    # (window = rows [b·W/2, b·W/2 + W)).
    send_win: Optional[np.ndarray] = None  # [E_pad] int32
    win_base: Optional[np.ndarray] = None  # [E_pad // edge_block] int32
    # The out-of-window edges (symmetrized): as compact tables on unbucketed
    # builds, as a skip-empty mini level over the same padded node space
    # (edge_block ≤ 128) on bucketed ones.
    resid: Optional["LevelGraph"] = None
    cresid: Optional[CompactResid] = None
    window: int = 0
    skip_empty: bool = False
    # Component-major static fiber [8, E_pad] f32: rows [0, pd1) = fiber
    # components, row pd1 = constant 1.0 carrying the first bias, rest 0.
    fiber_t: Optional[np.ndarray] = None
    # Set by to_device: [n_pad/128 + 1] int32, chunks of output block b are
    # chunk_ptr[b] .. chunk_ptr[b+1]; chunk_block [num_chunks] int32 is the
    # output block of each chunk.
    chunk_ptr: Optional[torch.Tensor] = None
    chunk_block: Optional[torch.Tensor] = None
    # Set by to_device on windowed levels, for kernel 7's gather (the
    # sender-window sum, `send_row_tables`): the in-window slots of sender
    # row n are send_row_slots[send_row_ptr[n] .. send_row_ptr[n+1]], in slot
    # order; send_long the rows split into pieces (`long_rows`).
    send_row_ptr: Optional[torch.Tensor] = None
    send_row_slots: Optional[torch.Tensor] = None
    send_long: Optional[torch.Tensor] = None
    # Set by to_device, for the segment sums (`row_tables`): row r sums the
    # slots row_slots[row_ptr[r] .. row_ptr[r+1]] (receiver form) or, for
    # the sender form, the slots row_send[...] of their reverse edges.
    row_ptr: Optional[torch.Tensor] = None
    row_slots: Optional[torch.Tensor] = None
    row_send: Optional[torch.Tensor] = None
    # ... and the rows of more than GATHER_PIECE slots (`long_rows`), for
    # the receiver gather of kernel 12's dxj.
    row_long: Optional[torch.Tensor] = None
    # Set by to_device on windowed levels, for kernel 1's level form: the
    # live (in-window) slots of row r are win_row_slots[win_row_ptr[r] ..
    # win_row_ptr[r+1]], in slot order; win_long the rows split into
    # pieces (`long_rows`).
    win_row_ptr: Optional[torch.Tensor] = None
    win_row_slots: Optional[torch.Tensor] = None
    win_long: Optional[torch.Tensor] = None

    @property
    def n_pad_nodes(self) -> int:
        return self.deg.shape[-1]

    @property
    def n_pad_edges(self) -> int:
        return self.senders.shape[-1]


@dataclass
class TransOp:
    """Rectangular weighted-aggregation operator: one fused level
    transition, `out = M @ x` with M_down[k, i] = Σ_{e=(i → kept_k)} ew_e
    and M_up = M_downᵀ. The layout mirrors LevelGraph's receiver-sorted
    block-aligned scheme over the OUTPUT space; windowed tables index the
    INPUT space."""

    senders: np.ndarray  # [E_pad] INPUT-space rows
    receivers: np.ndarray  # [E_pad] OUTPUT-space rows (block-sorted)
    recv_indptr: np.ndarray  # [N_out_pad + 1]
    ew: np.ndarray  # [E_pad] f64 operator coefficients (0 on pad slots)
    n_in_pad: int
    edge_block: int = EDGE_BLOCK
    send_win: Optional[np.ndarray] = None  # [E_pad] rel. window idx
    win_base: Optional[np.ndarray] = None  # [E_pad // edge_block] int32
    # Out-of-window entries (receivers in OUTPUT space, senders in INPUT
    # space, symmetric=False).
    cresid: Optional[CompactResid] = None
    window: int = 0
    skip_empty: bool = False
    # Dense [N_out_pad, N_in_pad] f32 form, built for small unwindowed ops.
    dense: Optional[np.ndarray] = None
    chunk_ptr: Optional[torch.Tensor] = None  # set by to_device
    chunk_block: Optional[torch.Tensor] = None  # set by to_device
    row_ptr: Optional[torch.Tensor] = None  # set by to_device
    row_slots: Optional[torch.Tensor] = None  # set by to_device
    row_long: Optional[torch.Tensor] = None  # set by to_device
    # Set by to_device on windowed ops, for kernel 1 (as on LevelGraph).
    win_row_ptr: Optional[torch.Tensor] = None
    win_row_slots: Optional[torch.Tensor] = None
    win_long: Optional[torch.Tensor] = None

    @property
    def n_pad_nodes(self) -> int:  # OUTPUT rows
        return self.recv_indptr.shape[-1] - 1

    @property
    def n_pad_edges(self) -> int:
        return self.senders.shape[-1]


@dataclass
class Transition:
    """Pool / unpool maps between level l (parent) and level l+1 (child),
    and the fused conv→pool (`down_op`) and unpool→conv (`up_op`)
    operators, which bucketed builds do not have."""

    pool_ids: np.ndarray  # [M_pad] parent rows (pad → the parent pad node)
    unpool_inv: np.ndarray  # [N_pad_parent] child row, or M_pad (zero slot)
    down_op: Optional[TransOp] = None
    up_op: Optional[TransOp] = None
    # [M_pad, 1] f32, on a shard's transition into the first replicated
    # level of a partition plan (`parallel/partition.py`): 1.0 on the child
    # rows whose parent this shard owns.
    pool_mask: Optional[np.ndarray] = None


@dataclass
class Hierarchy:
    levels: Tuple[LevelGraph, ...]
    transitions: Tuple[Transition, ...]
    # A union of `samples` hierarchies of one size group (`union`): each
    # level holds `samples` blocks of its per-sample N_pad rows, and
    # `sample_nodes[l]` lists each sample's real node count at level l.
    samples: int = 1
    sample_nodes: Tuple[Tuple[int, ...], ...] = ()

    @property
    def depth(self) -> int:
        return len(self.transitions)

    def sample_pad(self, l: int) -> int:
        """Level l's padded rows per sample."""
        return self.levels[l].n_pad_nodes // self.samples


def _compact_resid(
    s: np.ndarray, r: np.ndarray, ew: np.ndarray, ew_rev: np.ndarray,
    n_pad: int, lvl_pos: Optional[np.ndarray], symmetric: bool,
    n_in_pad: Optional[int] = None,
) -> CompactResid:
    """Build CompactResid from raw (unsorted) residual edges. `n_in_pad`
    (rectangular operators) sets the sender pad row; receivers live in the
    `n_pad` output space."""
    s = np.asarray(s, np.int64)
    r = np.asarray(r, np.int64)
    order = np.lexsort((s, r))
    s, r = s[order], r[order]
    ew = np.asarray(ew, np.float64)[order]
    ew_rev = np.asarray(ew_rev, np.float64)[order]
    n = s.shape[0]
    rp = max(-(-n // 128) * 128, 128)

    senders = np.full(rp, (n_in_pad or n_pad) - 1, np.int32)
    receivers = np.full(rp, n_pad - 1, np.int32)
    senders[:n] = s
    receivers[:n] = r
    ew_p = np.zeros(rp, np.float64)
    ew_p[:n] = ew
    ewr_p = np.zeros(rp, np.float64)
    ewr_p[:n] = ew_rev

    pd1 = 1 if lvl_pos is None else lvl_pos.shape[1] + 1
    fiber = np.zeros((rp, pd1), np.float64)
    if lvl_pos is not None and n:
        p = np.asarray(lvl_pos, np.float64)
        d = p[s] - p[r]
        fiber[:n] = np.concatenate(
            [d, np.linalg.norm(d, axis=-1, keepdims=True)], axis=-1
        )

    twin = np.arange(rp, dtype=np.int32)
    if symmetric and n:
        key = s * n_pad + r
        key_rev = r * n_pad + s
        ko = np.argsort(key)
        pos = np.searchsorted(key[ko], key_rev)
        if not np.array_equal(key[ko][pos], key_rev):
            raise ValueError("residual edge set is not symmetric")
        twin[:n] = ko[pos].astype(np.int32)

    # Visits: one per (compact 128-row block, output node-block) incidence.
    vb, vc, vr = [], [], []
    rblk = np.where(np.arange(rp) < n, receivers // NODE_BLOCK, -1)
    for cb in range(rp // 128):
        seg = rblk[cb * 128:(cb + 1) * 128]
        for ob in np.unique(seg[seg >= 0]):
            vb.append(ob)
            vc.append(cb)
            loc = np.where(seg == ob,
                           receivers[cb * 128:(cb + 1) * 128]
                           - ob * NODE_BLOCK, -1)
            vr.append(loc.astype(np.int32))
    if not vb:  # empty residual: one no-op visit keeps the kernel valid
        vb, vc, vr = [0], [0], [np.full(128, -1, np.int32)]
    v = len(vb)
    v8 = -(-v // 8) * 8
    visit_recv = np.full((v8, 128), -1, np.int32)
    visit_recv[:v] = np.stack(vr)
    return CompactResid(
        senders=senders,
        receivers=receivers,
        ew=ew_p,
        ew_rev=ewr_p,
        fiber=fiber,
        twin=twin,
        visit_block=np.asarray(vb, np.int32),
        visit_cblk=np.asarray(vc, np.int32),
        visit_recv=visit_recv,
        n_real=int(n),
        n_pad_nodes=int(n_pad),
        symmetric=bool(symmetric),
    )


def _block_slots(r_sorted: np.ndarray, n_pad: int, edge_block: int,
                 min_chunks: bool):
    """Block-aligned slotting shared by levels and operators: per 128-node
    receiver block, its edges then pad slots up to a multiple of
    `edge_block` (at least one chunk per block when `min_chunks`). Returns
    (slots of the sorted edges, E_pad, recv_indptr int32)."""
    recv_counts = np.bincount(r_sorted, minlength=n_pad)
    block_counts = recv_counts.reshape(-1, NODE_BLOCK).sum(axis=1)
    min_per_block = np.maximum(block_counts, 1) if min_chunks else block_counts
    seg_lens = -(-min_per_block // edge_block) * edge_block
    e_pad = int(seg_lens.sum())

    block_starts = np.zeros(len(seg_lens) + 1, np.int64)
    np.cumsum(seg_lens, out=block_starts[1:])
    blk_of_edge = r_sorted // NODE_BLOCK
    cum_before = np.zeros(len(seg_lens) + 1, np.int64)
    np.cumsum(block_counts, out=cum_before[1:])
    slots = block_starts[blk_of_edge] + (
        np.arange(len(r_sorted)) - cum_before[blk_of_edge]
    )

    within = recv_counts.reshape(-1, NODE_BLOCK)
    within_cum = np.cumsum(within, axis=1) - within
    recv_indptr = np.zeros(n_pad + 1, np.int64)
    recv_indptr[:n_pad] = (block_starts[:-1, None] + within_cum).reshape(-1)
    recv_indptr[n_pad] = e_pad
    return slots, e_pad, recv_indptr.astype(np.int32)


def _build_ell(index: np.ndarray, slots: np.ndarray, n_pad: int, e_pad: int,
               k_min: int = 0) -> np.ndarray:
    """ELL table: row n lists the layout slots (from `slots`) whose `index`
    value equals n, in their order in `index`, padded with e_pad. K is the
    largest multiplicity over the nodes, at least 1 and `k_min` (a bucket
    plan's width, so every mesh of a group has the same shape)."""
    idx = np.asarray(index, np.int64)
    counts = np.bincount(idx, minlength=n_pad)
    k = max(int(counts.max()) if counts.size else 0, 1, k_min)
    ell = np.full((n_pad, k), e_pad, dtype=np.int32)
    order = np.argsort(idx, kind="stable")
    sorted_idx = idx[order]
    starts = np.zeros(n_pad + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(idx)) - starts[sorted_idx]
    ell[sorted_idx, pos] = np.asarray(slots)[order].astype(np.int32)
    return ell


def layout_edge_count(edge_counts_per_node: np.ndarray, n_pad: int,
                      edge_block: int = EDGE_BLOCK) -> int:
    """Slots of the block-aligned layout for these per-node real edge
    counts: per 128-node block, ceil(max(count, 1) / edge_block) chunks."""
    counts = np.zeros(n_pad, np.int64)
    counts[:len(edge_counts_per_node)] = edge_counts_per_node
    seg = np.maximum(counts.reshape(-1, NODE_BLOCK).sum(axis=1), 1)
    return int((-(-seg // edge_block) * edge_block).sum())


def _pad_level(
    g: CsrGraph, n_pad: int, ec: np.ndarray,
    lvl_pos: Optional[np.ndarray] = None, edge_block: int = EDGE_BLOCK,
    window: int = 0, e_pad_min: int = 0, min_chunks: bool = True,
    resid_e_pad_min: int = 0, force_resid: bool = False,
    compact: bool = True, ell_k_min: int = 0, resid_ell_k_min: int = 0,
    force_cresid: bool = False,
) -> LevelGraph:
    """One level's layout. `e_pad_min` (an edge bucket) appends pad chunks
    to the last block; `min_chunks=False` builds a skip-empty layout;
    `ell_k_min` widens the ELL tables. Windowed levels also get the compact
    residual tables (`compact`) or else the residual sub-level, padded to
    `resid_e_pad_min` slots and ELL width `resid_ell_k_min`, built even
    with no out-of-window edge when `force_resid`. `force_cresid` builds
    both, the compact tables even when empty (a shard's ghost layout,
    `parallel/partition.py`, whose shards must carry the same tables)."""
    n, e = g.num_nodes, g.flat_edges.shape[1]
    if n_pad <= n or n_pad % NODE_BLOCK:
        raise ValueError(f"n_pad {n_pad} must exceed {n} and be "
                         f"{NODE_BLOCK}-aligned")
    if window and (window % 2 or window < NODE_BLOCK
                   or n_pad % (window // 2)):
        raise ValueError(f"window {window} does not fit n_pad {n_pad}")

    # Windowed layouts sort each receiver block's edges by SENDER, so that
    # chunks cluster in sender space and per-chunk windows cover them.
    if window:
        order = np.lexsort(
            (g.flat_edges[1], g.flat_edges[0], g.flat_edges[1] // NODE_BLOCK)
        )
    else:
        order = np.lexsort((g.flat_edges[0], g.flat_edges[1]))
    r_sorted = g.flat_edges[1][order]
    s_sorted = g.flat_edges[0][order]
    ec_sorted = np.asarray(ec, np.float64)[order]
    fib_sorted = None
    if lvl_pos is not None:
        p = np.asarray(lvl_pos, np.float64)
        d = p[s_sorted] - p[r_sorted]
        fib_sorted = np.concatenate(
            [d, np.linalg.norm(d, axis=-1, keepdims=True)], axis=-1
        )

    slots, e_pad, recv_indptr = _block_slots(r_sorted, n_pad, edge_block,
                                             min_chunks)
    e_pad = max(e_pad, _pad_to(e_pad_min, edge_block))
    recv_indptr[n_pad] = e_pad
    senders = np.full(e_pad, n_pad - 1, dtype=np.int32)
    receivers = np.full(e_pad, n_pad - 1, dtype=np.int32)
    edge_mask = np.zeros(e_pad, np.float32)
    senders[slots] = s_sorted
    receivers[slots] = r_sorted
    edge_mask[slots] = 1.0

    # Reverse-edge permutation: match (s, r) with (r, s) among real slots.
    key_fwd = s_sorted.astype(np.int64) * n_pad + r_sorted
    key_rev = r_sorted.astype(np.int64) * n_pad + s_sorted
    key_order = np.argsort(key_fwd)
    pos_of_rev = np.searchsorted(key_fwd[key_order], key_rev)
    if not np.array_equal(key_fwd[key_order][pos_of_rev], key_rev):
        raise ValueError("level edge set is not symmetric")
    rev_idx = key_order[pos_of_rev]
    reverse_perm = np.arange(e_pad, dtype=np.int32)
    reverse_perm[slots] = slots[rev_idx].astype(np.int32)

    deg = np.zeros(n_pad, dtype=np.float32)
    deg[:n] = g.degrees().astype(np.float32)
    deg = np.maximum(deg, 1.0)
    node_mask = np.zeros((n_pad, 1), dtype=np.float32)
    node_mask[:n] = 1.0

    ew = np.zeros(e_pad, np.float64)
    ew[slots] = ec_sorted
    pd1 = 1 if lvl_pos is None else lvl_pos.shape[1] + 1
    fiber = np.zeros((e_pad, pd1), np.float64)
    if fib_sorted is not None:
        fiber[slots] = fib_sorted

    send_win = win_base = resid = cresid = None
    if window:
        # Tiny levels: a window wider than the node set shrinks to it.
        window = min(window, n_pad)
        send_win, win_base, resid, cresid = _window_tables(
            senders, receivers, edge_mask, reverse_perm, ew, n_pad, window,
            edge_block, n, lvl_pos, resid_e_pad_min, force_resid, compact,
            resid_ell_k_min, force_cresid,
        )
    return LevelGraph(
        senders=senders,
        receivers=receivers,
        recv_indptr=recv_indptr,
        recv_ell=_build_ell(r_sorted, slots, n_pad, e_pad, ell_k_min),
        send_ell=_build_ell(s_sorted, slots, n_pad, e_pad, ell_k_min),
        deg=deg,
        node_mask=node_mask,
        edge_mask=edge_mask,
        reverse_perm=reverse_perm,
        ew=ew,
        fiber=fiber,
        n_nodes=n,
        n_edges=e,
        edge_block=edge_block,
        ew_rev=ew[reverse_perm],
        send_win=send_win,
        win_base=win_base,
        resid=resid,
        cresid=cresid,
        window=window,
        skip_empty=not min_chunks,
        fiber_t=_fiber_t(fiber),
    )


def _pad_trans_layout(
    s: np.ndarray, r: np.ndarray, w: np.ndarray,
    n_in_pad: int, n_out_pad: int, edge_block: int, window: int = 0,
) -> TransOp:
    """Block-aligned receiver-sorted layout for a rectangular operator:
    outputs r (in [0, n_out_pad)), inputs s (in [0, n_in_pad)), weights w.
    `window` > 0 builds the input-space windowed-selection tables (sender-
    sorted chunks, per-chunk window vote, compact residual for uncovered
    entries; no symmetrization: rectangular operators have no twins)."""
    if window:
        window = min(window, n_in_pad)
        order = np.lexsort((r, s, r // NODE_BLOCK))
    else:
        order = np.lexsort((s, r))
    s_sorted = s[order].astype(np.int64)
    r_sorted = r[order].astype(np.int64)
    w_sorted = np.asarray(w, np.float64)[order]

    slots, e_pad, recv_indptr = _block_slots(r_sorted, n_out_pad, edge_block,
                                             min_chunks=True)
    senders = np.full(e_pad, n_in_pad - 1, dtype=np.int32)
    receivers = np.full(e_pad, n_out_pad - 1, dtype=np.int32)
    edge_mask = np.zeros(e_pad, np.float32)
    ew = np.zeros(e_pad, np.float64)
    senders[slots] = s_sorted
    receivers[slots] = r_sorted
    edge_mask[slots] = 1.0
    ew[slots] = w_sorted

    send_win = win_base = cresid = None
    if window:
        # Identity reverse_perm disables the symmetrization step.
        base, covered = _window_vote(
            senders, edge_mask, np.arange(e_pad, dtype=np.int32),
            n_in_pad, window, edge_block,
        )
        wh = window // 2
        lo = np.repeat(base, edge_block) * wh
        send_win = np.where(covered, senders - lo, window).astype(np.int32)
        win_base = base.astype(np.int32)
        uncov = (edge_mask > 0) & ~covered
        if uncov.any():
            cresid = _compact_resid(
                senders[uncov].astype(np.int64),
                receivers[uncov].astype(np.int64),
                ew[uncov], ew[uncov], n_out_pad, None, symmetric=False,
                n_in_pad=n_in_pad,
            )

    dense = None
    if (window == 0
            and n_in_pad <= DENSE_TRANS_MAX and n_out_pad <= DENSE_TRANS_MAX):
        dense = np.zeros((n_out_pad, n_in_pad), np.float32)
        np.add.at(dense, (r_sorted, s_sorted), w_sorted.astype(np.float32))

    return TransOp(
        senders=senders,
        receivers=receivers,
        recv_indptr=recv_indptr,
        ew=ew,
        n_in_pad=n_in_pad,
        edge_block=edge_block,
        send_win=send_win,
        win_base=win_base,
        cresid=cresid,
        window=window,
        skip_empty=False,
        dense=dense,
    )


def _build_trans_ops(
    flat_edges: np.ndarray, ec: np.ndarray, kept: np.ndarray,
    parent_pad: int, child_pad: int, edge_block: int, window: int = 0,
) -> Tuple[TransOp, TransOp]:
    """Fused transition operators from level-l raw edges + offline weights
    + the kept-node ids. Only edges whose receiver is kept contribute."""
    snd = flat_edges[0].astype(np.int64)
    rcv = flat_edges[1].astype(np.int64)
    local_of = np.full(parent_pad, -1, np.int64)
    local_of[kept.astype(np.int64)] = np.arange(len(kept))
    sel = local_of[rcv] >= 0
    s_par = snd[sel]  # parent-space inputs (down) / outputs (up)
    r_chd = local_of[rcv[sel]]  # child-space outputs (down) / inputs (up)
    w = np.asarray(ec, np.float64)[sel]
    down = _pad_trans_layout(s_par, r_chd, w, parent_pad, child_pad,
                             edge_block, window=window)
    up = _pad_trans_layout(r_chd, s_par, w, child_pad, parent_pad,
                           edge_block, window=window)
    return down, up


def _fiber_t(fiber: np.ndarray) -> np.ndarray:
    """[8, E_pad] f32 component-major fiber with a constant-1 row at index
    pd1 (carries the edge MLP's first bias through the same dot)."""
    e_pad, pd1 = fiber.shape
    if pd1 >= 8:
        raise ValueError(f"fiber width {pd1} does not fit the 8-row stream")
    out = np.zeros((8, e_pad), np.float32)
    out[:pd1] = fiber.T.astype(np.float32)
    out[pd1] = 1.0
    return out


def _window_vote(
    senders: np.ndarray,
    edge_mask: np.ndarray,
    reverse_perm: np.ndarray,
    n_pad: int,
    window: int,
    edge_block: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-chunk window vote: each `edge_block`-slot chunk picks the W-row
    source window (base aligned to W/2) covering the most of its real
    senders, ties to the lowest base. Returns (base [num_chunks], covered
    [E_pad]) with coverage symmetrized (an edge counts as covered only if
    its reverse twin is too, so the residual edge set stays symmetric)."""
    wh = window // 2
    e_pad = len(senders)
    num_chunks = e_pad // edge_block
    max_base = n_pad // wh - 2
    real = edge_mask > 0
    s64 = senders.astype(np.int64)

    chunk_of = np.repeat(np.arange(num_chunks, dtype=np.int64), edge_block)
    gr = s64 // wh
    cand = np.concatenate([gr - 1, gr])
    cchunk = np.concatenate([chunk_of, chunk_of])
    keep = np.concatenate([real, real]) & (cand >= 0) & (cand <= max_base)
    stride = max_base + 1
    total_keys = num_chunks * stride
    if total_keys <= 200_000_000:
        # Dense histogram + row argmax (first maximum = lowest candidate).
        hist = np.bincount(cchunk[keep] * stride + cand[keep],
                           minlength=total_keys).reshape(num_chunks, stride)
        base = np.argmax(hist, axis=1).astype(np.int64)
    else:
        keys, cnts = np.unique(cchunk[keep] * stride + cand[keep],
                               return_counts=True)
        base = np.zeros(num_chunks, np.int64)
        if keys.size:
            kchunk = keys // stride
            new_run = np.r_[True, kchunk[1:] != kchunk[:-1]]
            run_id = np.cumsum(new_run) - 1
            run_starts = np.flatnonzero(new_run)
            run_max = np.maximum.reduceat(cnts, run_starts)
            at_max = np.flatnonzero(cnts == run_max[run_id])
            runs_at = run_id[at_max]
            first = at_max[np.r_[True, runs_at[1:] != runs_at[:-1]]]
            base[kchunk[run_starts]] = keys[first] % stride

    lo = np.repeat(base, edge_block) * wh
    covered = real & (s64 >= lo) & (s64 < lo + window)
    covered &= covered[reverse_perm]
    return base, covered


def _window_tables(
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_mask: np.ndarray,
    reverse_perm: np.ndarray,
    ew: np.ndarray,
    n_pad: int,
    window: int,
    edge_block: int,
    n: int,
    lvl_pos: Optional[np.ndarray],
    resid_e_pad_min: int = 0,
    force_resid: bool = False,
    compact: bool = True,
    resid_ell_k_min: int = 0,
    force_cresid: bool = False,
):
    """Per-chunk aligned source windows for the windowed kernels, plus the
    edges left outside (symmetrized) as compact residual tables (with
    `compact`) or else as a skip-empty mini level (`resid`), the one the
    model reads. `force_resid` builds the mini level even when every edge
    is covered (a bucketed group whose bucket has a residual at this
    level); `force_cresid` builds the mini level and the compact tables,
    each even when empty (`_window_tables`, `hierarchy.py:862-885` of the
    JAX package, with both flags set)."""
    base, covered = _window_vote(
        senders, edge_mask, reverse_perm, n_pad, window, edge_block
    )
    wh = window // 2
    s64 = senders.astype(np.int64)
    lo = np.repeat(base, edge_block) * wh
    real = edge_mask > 0

    send_win = np.where(covered, s64 - lo, window).astype(np.int32)
    win_base = base.astype(np.int32)

    resid = cresid = None
    m = real & ~covered
    r64 = receivers.astype(np.int64)
    if force_cresid:
        resid = _pad_level(
            CsrGraph(np.stack([s64[m], r64[m]]), n), n_pad, ew[m], lvl_pos,
            edge_block=min(edge_block, EDGE_BLOCK), e_pad_min=resid_e_pad_min,
            min_chunks=False, ell_k_min=resid_ell_k_min,
        )
        cresid = _compact_resid(
            s64[m], r64[m], ew[m], ew[reverse_perm][m], n_pad, lvl_pos,
            symmetric=True,
        )
    elif compact and m.any():
        cresid = _compact_resid(
            s64[m], r64[m], ew[m], ew[reverse_perm][m], n_pad, lvl_pos,
            symmetric=True,
        )
    elif not compact and (m.any() or force_resid):
        resid = _pad_level(
            CsrGraph(np.stack([s64[m], r64[m]]), n), n_pad, ew[m], lvl_pos,
            edge_block=min(edge_block, EDGE_BLOCK), e_pad_min=resid_e_pad_min,
            min_chunks=False, ell_k_min=resid_ell_k_min,
        )
    return send_win, win_base, resid, cresid


def window_coverage(level: LevelGraph, window: int) -> float:
    """The share of the real edges a built windowed level would cover at
    source-window width `window` (the chunk layout does not depend on the
    width: the blocks are sender-sorted once, `_pad_level`); NaN where the
    width does not divide the level's N_pad."""
    n_pad = level.n_pad_nodes
    w = min(window, n_pad)
    if n_pad % (w // 2):
        return float("nan")
    _, covered = _window_vote(
        np.asarray(level.senders), np.asarray(level.edge_mask),
        np.asarray(level.reverse_perm), n_pad, w, level.edge_block)
    return float(covered.sum()) / max(level.n_edges, 1)


def choose_windows(h: Hierarchy) -> List[int]:
    """The JAX package's per-level window tuner, on a hierarchy built with
    windowed layouts of any width: each level takes the candidate W that
    minimizes

        cost(W) = E_pad · W/2 + uncovered_edges · AUTO_RESID_ROWS,

    the windowed kernels' selection work (W/2 source rows per edge) plus
    each out-of-window edge's trip through the residual path, priced at
    AUTO_RESID_ROWS selection rows, over AUTO_WINDOW_CANDIDATES (the
    constants are the JAX package's, tuned for its TPU; the auto cache key
    folds both in). Returns the widths for `pad_levels(window=[...])`."""
    out = []
    for g in h.levels:
        n_pad = g.n_pad_nodes
        best_w, best_cost = 0, None
        for w in AUTO_WINDOW_CANDIDATES:
            weff = min(w, n_pad)
            if n_pad % (weff // 2):
                continue
            cov = window_coverage(g, weff)
            n_resid = (1.0 - cov) * g.n_edges
            cost = g.n_pad_edges * (weff // 2) + n_resid * AUTO_RESID_ROWS
            if best_cost is None or cost < best_cost:
                best_w, best_cost = w, cost
        if best_cost is None:
            raise ValueError(f"no window candidate of "
                             f"{AUTO_WINDOW_CANDIDATES} divides "
                             f"n_pad {n_pad}")
        out.append(best_w)
    return out


def build_hierarchy(
    flat_edges: np.ndarray,
    num_layers: int,
    num_nodes: int,
    pos: np.ndarray,
    pad_multiple: int = 128,
    edge_block: int = EDGE_BLOCK,
    window: "int | List[int]" = 0,
    node_buckets: Optional[List[int]] = None,
    edge_buckets: Optional[List[int]] = None,
    resid_buckets: Optional[List[Tuple[int, int]]] = None,
    ell_buckets: Optional[List[int]] = None,
) -> Hierarchy:
    """Build bi-stride levels and pad them to static shapes. `window` > 0
    builds the windowed tables (best with a Morton-ordered mesh,
    graph/order.py); a per-level list sets each level's window. The
    buckets are `pad_levels`'."""
    levels = build_bistride_levels(flat_edges, num_layers, num_nodes, pos)
    return pad_levels(levels, pad_multiple, pos=pos, edge_block=edge_block,
                      window=window, node_buckets=node_buckets,
                      edge_buckets=edge_buckets, resid_buckets=resid_buckets,
                      ell_buckets=ell_buckets)


def _check_widths(widths, window) -> None:
    """A negative or string width is refused before any work: a negative
    `datasets.window` means "auto", which the readers pass on as such."""
    if any(isinstance(w, str) or w < 0 for w in widths):
        raise ValueError(
            f"window {window!r}: per-level widths are tuned by window='auto' "
            "in load_or_build_hierarchy (the readers map datasets.window < 0 "
            "to it); pad_levels takes 0 or widths of at least 128")


def pad_levels(
    levels: BistrideLevels,
    pad_multiple: int = 128,
    pos: Optional[np.ndarray] = None,
    edge_block: int = EDGE_BLOCK,
    window: "int | List[int]" = 0,
    node_buckets: Optional[List[int]] = None,
    edge_buckets: Optional[List[int]] = None,
    resid_buckets: Optional[List[Tuple[int, int]]] = None,
    ell_buckets: Optional[List[int]] = None,
) -> Hierarchy:
    """`node_buckets` / `edge_buckets` pin each level's N_pad / E_pad,
    `ell_buckets` its ELL width, and `resid_buckets` each windowed level's
    residual sub-layout as (E_pad, ELL width), (0, 0) meaning none
    (`graph/buckets.py` plans them). A bucketed build
    carries no compact residual and no fused transition operator: the
    model then takes the explicit conv + pool transitions and the
    residual sub-levels."""
    graphs, ids = levels.graphs, levels.ids
    windows = (
        list(window)
        if isinstance(window, (list, tuple))
        else [window] * len(graphs)
    )
    if len(windows) != len(graphs):
        raise ValueError(f"per-level window list has {len(windows)} entries "
                         f"for {len(graphs)} levels")
    _check_widths(windows, window)
    lvl_pos = None if pos is None else smoothed_positions(levels, pos)
    node_multiple = _pad_to(pad_multiple, NODE_BLOCK)
    if any(windows):
        node_multiple = _pad_to(node_multiple, max(windows) // 2)
    if node_buckets is None:
        n_pads = [_pad_to(g.num_nodes + 1, node_multiple) for g in graphs]
    else:
        n_pads = list(node_buckets)
        for l, (g, n_pad) in enumerate(zip(graphs, n_pads)):
            if (n_pad <= g.num_nodes or n_pad % NODE_BLOCK or (
                    windows[l] and n_pad % (min(windows[l], n_pad) // 2))):
                raise ValueError(f"node bucket {n_pad} does not fit level "
                                 f"{l} ({g.num_nodes} nodes, window "
                                 f"{windows[l]})")
    e_pads = [0] * len(graphs) if edge_buckets is None else list(edge_buckets)
    resids = ([(0, 0)] * len(graphs) if resid_buckets is None
              else list(resid_buckets))
    bucketed = node_buckets is not None or resid_buckets is not None
    ecs = transition_edge_weights(levels)

    def build_level(l, g):
        return _pad_level(
            g, n_pads[l], ecs[l], None if lvl_pos is None else lvl_pos[l],
            edge_block=edge_block, window=windows[l], e_pad_min=e_pads[l],
            resid_e_pad_min=resids[l][0], force_resid=resids[l][0] > 0,
            compact=not bucketed,
            ell_k_min=0 if ell_buckets is None else ell_buckets[l],
            resid_ell_k_min=resids[l][1],
        )

    def build_transition(l, kept):
        parent_pad, child_pad = n_pads[l], n_pads[l + 1]
        m = len(kept)
        pool_ids = np.full(child_pad, parent_pad - 1, np.int32)
        pool_ids[:m] = kept
        unpool_inv = np.full(parent_pad, child_pad, np.int32)
        unpool_inv[kept] = np.arange(m, dtype=np.int32)
        down_op = up_op = None
        if node_buckets is None and edge_buckets is None:
            down_op, up_op = _build_trans_ops(
                graphs[l].flat_edges, ecs[l], kept, parent_pad, child_pad,
                edge_block, window=windows[l],
            )
        return Transition(pool_ids=pool_ids, unpool_inv=unpool_inv,
                          down_op=down_op, up_op=up_op)

    # Levels build independently, and the hot numpy kernels (lexsort,
    # bincount, unique) release the GIL.
    workers = min(len(graphs), os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        lvl_graphs = tuple(ex.map(lambda lg: build_level(*lg),
                                  enumerate(graphs)))
        transitions = tuple(ex.map(lambda lk: build_transition(*lk),
                                   enumerate(ids)))
    # Every mesh of a group lands on the group's exact shapes.
    for l, g in enumerate(lvl_graphs):
        if edge_buckets is not None and g.n_pad_edges != _pad_to(
                e_pads[l], edge_block):
            raise ValueError(f"level {l}: layout {g.n_pad_edges} exceeds "
                             f"edge bucket {e_pads[l]}")
        if resid_buckets is None:
            continue
        want = _pad_to(resids[l][0], min(edge_block, EDGE_BLOCK))
        got = 0 if g.resid is None else g.resid.n_pad_edges
        if got != want:
            raise ValueError(f"level {l}: residual layout {got} != bucket "
                             f"{resids[l][0]}")
    return Hierarchy(levels=lvl_graphs, transitions=transitions)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """f64 arrays become f32 (the JAX package's device arrays are f32 with
    x64 off; ops cast to the compute dtype at use); ints keep int32."""
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def block_chunk_ptr(recv_indptr: np.ndarray, edge_block: int) -> np.ndarray:
    """[n_pad/128 + 1] int32: the chunks of output block b are
    chunk_ptr[b] .. chunk_ptr[b+1] (each block's edge segment starts on a
    chunk boundary)."""
    starts = np.asarray(recv_indptr)[::NODE_BLOCK]
    return (starts // edge_block).astype(np.int32)


def row_tables(receivers: np.ndarray, chunk_ptr: np.ndarray,
               edge_block: int) -> Tuple[np.ndarray, np.ndarray]:
    """(row_ptr [n_pad + 1], row_slots) of a block-aligned layout: row r
    owns exactly the slots the TPU segment-sum kernel's one-hot assigns to
    it, the slots of the chunks of r's 128-row block whose receiver is r,
    in slot order. A pad slot carries receiver n_pad − 1, so it is dropped
    in every block but the last, where it lands on row n_pad − 1 as on the
    TPU (`segment_sum.py:23-25`). `recv_indptr` alone would give the last
    row of each block its block's pad slots."""
    n_blocks = len(chunk_ptr) - 1
    slot_block = np.repeat(
        np.repeat(np.arange(n_blocks, dtype=np.int64), np.diff(chunk_ptr)),
        edge_block)
    recv = np.asarray(receivers, np.int64)
    keep = np.flatnonzero(recv // NODE_BLOCK == slot_block)
    slots = keep[np.argsort(recv[keep], kind="stable")]
    ptr = np.searchsorted(recv[slots], np.arange(n_blocks * NODE_BLOCK + 1))
    return ptr.astype(np.int32), slots.astype(np.int32)


def live_row_tables(row_ptr: np.ndarray, row_slots: np.ndarray,
                    live: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(ptr, slots) of `row_tables`' lists with only the slots where
    `live` [E_pad] holds, in the same row and slot order: the lists the
    gather of kernels 1 (live: `send_win < window`) and 15 (covered)
    walks, with no sentinel or pad slot."""
    keep = np.asarray(live, bool)[row_slots]
    ptr = np.concatenate([[0], np.cumsum(keep)])[row_ptr]
    return ptr.astype(np.int32), row_slots[keep].astype(np.int32)


def send_row_tables(send_win: np.ndarray, win_base: np.ndarray,
                    edge_block: int, window: int,
                    n_pad: int) -> Tuple[np.ndarray, np.ndarray]:
    """(ptr [n_pad + 1], slots) of kernel 7's gather on a windowed level:
    every slot with send_win < window, grouped by its sender row
    win_base[e // edge_block]·window/2 + send_win[e], in slot order within
    a row. The receiver plays no part (the TPU kernel's one-hot tests
    send_win alone), so a pad slot with an in-window send_win is listed as
    the TPU kernel counts it; these are not kernel 1's lists."""
    sw = np.asarray(send_win, np.int64)
    live = np.flatnonzero(sw < window)
    base = np.repeat(np.asarray(win_base, np.int64), edge_block)
    rows = base[live] * (window // 2) + sw[live]
    if len(rows) and rows.max() >= n_pad:
        raise ValueError(f"a sender row {rows.max()} lies past the level's "
                         f"{n_pad} rows")
    order = np.argsort(rows, kind="stable")
    ptr = np.searchsorted(rows[order], np.arange(n_pad + 1))
    return ptr.astype(np.int32), live[order].astype(np.int32)


def compact_row_tables(receivers: np.ndarray,
                       n_real: int) -> Tuple[np.ndarray, np.ndarray]:
    """(rows [U], ptr [U + 1]) of kernel 2's gather: the distinct receivers
    of the first n_real compact rows, ascending, and their contiguous
    ranges of compact rows (the rows are sorted by receiver). The pad rows
    (n_real ..) carry receiver n_pad − 1 but add nothing, as the TPU
    kernel masks them, so no list holds them."""
    r = np.asarray(receivers[:n_real], np.int64)
    if np.any(np.diff(r) < 0):
        raise ValueError("compact rows are not sorted by receiver")
    rows, first = np.unique(r, return_index=True)
    ptr = np.append(first, n_real)
    return rows.astype(np.int32), ptr.astype(np.int32)


def long_rows(row_ptr: np.ndarray, piece: int = GATHER_PIECE) -> np.ndarray:
    """int32, in row order: the rows of more than `piece` listed slots,
    which the gather of kernels 1, 2, 7 and 15 cuts into pieces of `piece`
    slots over a thread block of their own."""
    return np.flatnonzero(np.diff(row_ptr) > piece).astype(np.int32)


def _to_device(obj, device):
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray):
            changes[f.name] = _tensor(v, device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _to_device(v, device)
        elif isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            changes[f.name] = tuple(_to_device(x, device) for x in v)
    out = dataclasses.replace(obj, **changes)
    if isinstance(obj, (LevelGraph, TransOp)):
        ptr = block_chunk_ptr(obj.recv_indptr, obj.edge_block)
        out.chunk_ptr = _tensor(ptr, device)
        out.chunk_block = _tensor(
            np.repeat(np.arange(len(ptr) - 1, dtype=np.int32), np.diff(ptr)),
            device)
        row_ptr, row_slots = row_tables(obj.receivers, ptr, obj.edge_block)
        out.row_ptr = _tensor(row_ptr, device)
        out.row_slots = _tensor(row_slots, device)
        out.row_long = _tensor(long_rows(row_ptr), device)
        if isinstance(obj, LevelGraph):
            out.row_send = _tensor(
                np.asarray(obj.reverse_perm)[row_slots], device)
        if obj.window > 0:
            win_ptr, win_slots = live_row_tables(
                row_ptr, row_slots, np.asarray(obj.send_win) < obj.window)
            out.win_row_ptr = _tensor(win_ptr, device)
            out.win_row_slots = _tensor(win_slots, device)
            out.win_long = _tensor(long_rows(win_ptr), device)
    if isinstance(obj, LevelGraph) and obj.window > 0:
        ptr, slots = send_row_tables(obj.send_win, obj.win_base,
                                     obj.edge_block, obj.window,
                                     obj.n_pad_nodes)
        out.send_row_ptr = _tensor(ptr, device)
        out.send_row_slots = _tensor(slots, device)
        out.send_long = _tensor(long_rows(ptr), device)
    if isinstance(obj, CompactResid):
        rows, ptr = compact_row_tables(obj.receivers, obj.n_real)
        out.cr_rows = _tensor(rows, device)
        out.cr_row_ptr = _tensor(ptr, device)
        out.cr_long = _tensor(long_rows(ptr), device)
    return out


def to_device(h: Hierarchy, device=None) -> Hierarchy:
    """The same hierarchy with every array a tensor on `device`, plus the
    chunk → output block map (`chunk_block`), the per-block chunk ranges
    (`chunk_ptr`) and per-row slot lists (`row_ptr`, `row_slots`,
    `row_send`, `row_long`; on windowed layouts also the live ones, `win_row_ptr`,
    `win_row_slots`, `win_long`, and on windowed levels the sender rows',
    `send_row_ptr`, `send_row_slots`, `send_long`) the kernels walk, and
    each compact residual's receiver ranges (`cr_rows`, `cr_row_ptr`,
    `cr_long`). Each output block's edge segment starts on a chunk
    boundary by construction, so its chunks are one contiguous range."""
    return _to_device(h, resolve_device(device))


# -- unions: B samples of one size group as one block-diagonal hierarchy ------

# How an index field of a layout moves in a union (`union`): sample s's
# entries add s times its node rows, edge slots, 128-row node blocks or
# half-windows (`win_base` counts half-windows of window / 2 rows).
_OFFSETS = {"senders": "rows", "receivers": "rows", "row_long": "rows",
            "win_long": "rows", "send_long": "rows",
            "reverse_perm": "slots", "row_slots": "slots",
            "row_send": "slots", "win_row_slots": "slots",
            "send_row_slots": "slots", "chunk_block": "blocks",
            "win_base": "half_windows"}
# The cumulative pointer arrays (one entry longer than their rows, the last
# the total), each with the list it points into: sample s's entries add the
# lengths of the earlier samples' lists, which differ from mesh to mesh.
_POINTERS = {"recv_indptr": "senders", "chunk_ptr": "chunk_block",
             "row_ptr": "row_slots", "win_row_ptr": "win_row_slots",
             "send_row_ptr": "send_row_slots"}


def _cat(parts, dim: int = 0):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim)
    return np.concatenate(parts, axis=dim)


def _one(like, value: int):
    """[value] as a 1-element array of `like`'s kind, dtype and device."""
    if isinstance(like, torch.Tensor):
        return torch.tensor([value], dtype=like.dtype, device=like.device)
    return np.asarray([value], like.dtype)


def _union_ell(tables, e: int):
    """The union of the samples' ELL tables ([N_pad, K_s], pad entry E_pad
    = `e`): sample s's slots add s·E_pad, and its pad entries, which offset
    would name sample s+1's first slot, become the union's pad B·E_pad;
    every sample pads to the widest K with it."""
    b = len(tables)
    k = max(t.shape[-1] for t in tables)
    parts = []
    for i, t in enumerate(tables):
        if isinstance(t, torch.Tensor):
            moved = torch.where(t == e, b * e, t + i * e).to(t.dtype)
            fill = torch.full((t.shape[0], k - t.shape[-1]), b * e,
                              dtype=t.dtype, device=t.device)
        else:
            moved = np.where(t == e, b * e, t + i * e).astype(t.dtype)
            fill = np.full((t.shape[0], k - t.shape[-1]), b * e, t.dtype)
        parts.append(_cat([moved, fill], 1))
    return _cat(parts)


def union_layout(ls: List[LevelGraph]) -> LevelGraph:
    """The union of one level's layouts (and their residual sub-levels),
    every field offset by its kind (`_OFFSETS`, `_POINTERS`, the ELL
    tables by `_union_ell`) and concatenated, `fiber_t` along its slot
    axis; the real counts summed."""
    l0 = ls[0]
    n, e, w = l0.n_pad_nodes, l0.n_pad_edges, l0.window
    shape = (n, e, l0.edge_block, w, l0.skip_empty, l0.fiber.shape[-1],
             l0.resid is None)
    for lv in ls[1:]:
        got = (lv.n_pad_nodes, lv.n_pad_edges, lv.edge_block, lv.window,
               lv.skip_empty, lv.fiber.shape[-1], lv.resid is None)
        if got != shape:
            raise ValueError(f"the samples' layouts differ: (N_pad, E_pad, "
                             f"edge_block, window, skip_empty, fiber, no "
                             f"residual) {got} != {shape}")
    if any(lv.cresid is not None for lv in ls):
        raise ValueError("a union takes bucketed layouts, which carry no "
                         "compact residual")
    # Row and slot indices stay int32 (the kernels widen them to 64 bits
    # before they scale them by the row width): the cylinder's level 0 at
    # B = 48 holds 98,304 rows and 761,856 slots.
    if len(ls) * max(n, e) >= 2**31:
        raise ValueError(f"{len(ls)} samples of {n} rows and {e} slots "
                         f"overflow int32 indices")
    step = {"rows": n, "slots": e, "blocks": n // NODE_BLOCK}
    if w:
        wh = w // 2
        step["half_windows"] = n // wh
        # Every chunk's source window, rows [base·W/2, base·W/2 + W), lies
        # inside its own sample (`_pad_level` shrinks a window wider than
        # the level to it), so no kernel reads another sample's rows.
        reach = max(int(lv.win_base.max()) for lv in ls) * wh + w
        if n % wh or reach > n:
            raise ValueError(f"a window of {w} rows reaches row {reach} of "
                             f"a sample of {n}")
    changes = {}
    for f in dataclasses.fields(LevelGraph):
        vals = [getattr(lv, f.name) for lv in ls]
        v0 = vals[0]
        if f.name == "resid":
            changes[f.name] = None if v0 is None else union_layout(vals)
        elif f.name in ("n_nodes", "n_edges"):
            changes[f.name] = sum(vals)
        elif v0 is None or not hasattr(v0, "shape"):
            continue
        elif f.name in ("recv_ell", "send_ell"):
            changes[f.name] = _union_ell(vals, e)
        elif f.name in _POINTERS:
            totals = np.cumsum([0] + [getattr(lv, _POINTERS[f.name]).shape[0]
                                      for lv in ls])
            changes[f.name] = _cat(
                [v[:-1] + int(o) for v, o in zip(vals, totals)]
                + [_one(v0, int(totals[-1]))])
        elif f.name in _OFFSETS:
            s = step[_OFFSETS[f.name]]
            changes[f.name] = _cat([v + i * s for i, v in enumerate(vals)])
        else:
            changes[f.name] = _cat(vals, -1 if f.name == "fiber_t" else 0)
    return dataclasses.replace(l0, **changes)


def _union_transition(ts: List[Transition], n_parent: int,
                      n_child: int) -> Transition:
    """The union of one transition's pool / unpool maps: sample s's parent
    rows add s·N_pad_parent, its child rows s·M_pad; unpool's zero slot
    (M_pad) becomes the union's, B·M_pad."""
    if any(t.down_op is not None or t.up_op is not None for t in ts):
        raise ValueError("a union takes bucketed transitions, which carry "
                         "no fused operator")
    b = len(ts)
    xp = torch if isinstance(ts[0].pool_ids, torch.Tensor) else np
    return Transition(
        pool_ids=_cat([t.pool_ids + i * n_parent for i, t in enumerate(ts)]),
        unpool_inv=_cat([xp.where(t.unpool_inv == n_child, b * n_child,
                                  t.unpool_inv + i * n_child)
                         for i, t in enumerate(ts)]))


def union(hs) -> Hierarchy:
    """One hierarchy holding the B hierarchies `hs` of one size group (the
    same padded shapes; built by `pad_levels` with one bucket plan's
    sizes) side by side: level l has B·N_pad_l rows, sample s's at s·N_pad_l
    on, and every index is offset by its sample's rows, slots, chunks or
    windows, so the graph is block-diagonal and a batch [B, N_pad, C]
    viewed as [B·N_pad, C] runs every route and kernel as one sample does.
    The arrays may be numpy (`pad_levels`) or tensors on one device
    (`to_device`, derived tables included); the union is of the same
    kind. Unbucketed hierarchies (fused transition operators, compact
    residuals) raise ValueError: their batch runs on the batch axis."""
    hs = list(hs)
    h0 = hs[0]
    if any(h.samples != 1 or len(h.levels) != len(h0.levels) for h in hs):
        raise ValueError("a union takes single hierarchies of one depth")
    levels = tuple(union_layout([h.levels[l] for h in hs])
                   for l in range(len(h0.levels)))
    transitions = tuple(
        _union_transition([h.transitions[l] for h in hs],
                          h0.levels[l].n_pad_nodes,
                          h0.levels[l + 1].n_pad_nodes)
        for l in range(h0.depth))
    return Hierarchy(levels=levels, transitions=transitions, samples=len(hs),
                     sample_nodes=tuple(tuple(h.levels[l].n_nodes for h in hs)
                                        for l in range(len(h0.levels))))


def needs_union(h: Hierarchy) -> bool:
    """Whether a batch on `h` runs as a union: h is one already, or a
    bucketed hierarchy, whose explicit conv + pool transitions and residual
    sub-levels take one sample's rows (a batch of b frames on it runs on
    `union([h] * b)`)."""
    return h.samples > 1 or any(t.down_op is None for t in h.transitions) \
        or any(lv.resid is not None for lv in h.levels)


# -- the npz caches -----------------------------------------------------------

# Bumped whenever the padded layout or the file's form changes, so a stale
# cache is rebuilt.
CACHE_VERSION = 1
LEVELS_CACHE_VERSION = 1
# What reading a stale or corrupt cache file raises: it is rebuilt.
_STALE = (OSError, EOFError, KeyError, ValueError, TypeError,
          zipfile.BadZipFile)
# The dataclasses nested in a cached hierarchy: (class, field) → class.
_NESTED = {(LevelGraph, "resid"): LevelGraph,
           (LevelGraph, "cresid"): CompactResid,
           (TransOp, "cresid"): CompactResid,
           (Transition, "down_op"): TransOp,
           (Transition, "up_op"): TransOp}


def _atomic_savez(path: str, arrays: dict) -> None:
    """Write an npz under a temporary name unique to this writer (several
    sampler threads may build one shared cache at once), then rename it:
    the last writer wins and no reader sees half a file. Caches over 100 MB
    are written uncompressed (deflate costs more than the build there)."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    raw_bytes = sum(a.nbytes for a in arrays.values())
    save = np.savez if raw_bytes > 100_000_000 else np.savez_compressed
    save(tmp, **arrays)
    os.replace(tmp + ".npz", path)


def _cache_key(num_layers: int, pad_multiple: int, node_buckets,
               edge_buckets, edge_block: int = EDGE_BLOCK, window=0,
               ell_buckets=None, resid_buckets=None) -> str:
    blob = (f"v{CACHE_VERSION}|{num_layers}|{pad_multiple}|{node_buckets}"
            f"|{edge_buckets}|eb{edge_block}|w{window}")
    if window == "auto":
        # The tuner's candidates and cost constant decide the widths "auto"
        # resolves to: a change to either must not reuse an older build.
        blob += f"|cand{AUTO_WINDOW_CANDIDATES}|rr{AUTO_RESID_ROWS}"
    if ell_buckets is not None or resid_buckets is not None:
        blob += f"|k{ell_buckets}|r{resid_buckets}"
    return hashlib.sha1(blob.encode()).hexdigest()[:10]


def _flatten(obj, prefix: str, arrays: dict) -> None:
    """Every host array and scalar field of a layout dataclass (and of the
    dataclasses in it) into `arrays`, keyed `prefix + field`; None fields
    and the tensors of `to_device` are left out."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or isinstance(v, torch.Tensor):
            continue
        if dataclasses.is_dataclass(v):
            _flatten(v, f"{prefix}{f.name}/", arrays)
        else:
            arrays[prefix + f.name] = np.asarray(v)


def _unflatten(cls, prefix: str, z, keys) -> object:
    kw = {}
    for f in dataclasses.fields(cls):
        key = prefix + f.name
        child = _NESTED.get((cls, f.name))
        if child is not None:
            if any(k.startswith(key + "/") for k in keys):
                kw[f.name] = _unflatten(child, key + "/", z, keys)
        elif key in keys:
            a = z[key]
            kw[f.name] = a.item() if a.ndim == 0 else a
    return cls(**kw)


def save_hierarchy(path: str, h: Hierarchy) -> None:
    """A built (host) hierarchy as one npz, atomically."""
    if h.samples != 1:
        raise ValueError("a union is not cached; cache its samples")
    arrays = {"depth": np.int64(h.depth)}
    for l, g in enumerate(h.levels):
        _flatten(g, f"l{l}/", arrays)
    for l, t in enumerate(h.transitions):
        _flatten(t, f"t{l}/", arrays)
    _atomic_savez(path, arrays)


def load_hierarchy(path: str) -> Hierarchy:
    with np.load(path) as z:
        keys = set(z.files)
        depth = int(z["depth"])
        levels = tuple(_unflatten(LevelGraph, f"l{l}/", z, keys)
                       for l in range(depth + 1))
        transitions = tuple(_unflatten(Transition, f"t{l}/", z, keys)
                            for l in range(depth))
    return Hierarchy(levels=levels, transitions=transitions)


def load_or_build_levels(cache_dir: str, cache_name: str,
                         flat_edges: np.ndarray, num_layers: int,
                         num_nodes: int, pos: np.ndarray) -> BistrideLevels:
    """Cache-through build of the raw (unpadded) bi-stride levels, the
    costly part: padding is cheap and is done again per bucket spec."""
    path = os.path.join(
        cache_dir,
        f"{cache_name}_torch_levels_v{LEVELS_CACHE_VERSION}_d{num_layers}"
        ".npz")
    if os.path.isfile(path):
        try:
            with np.load(path) as z:
                graphs = [CsrGraph(z[f"edges{l}"], int(z[f"n{l}"]))
                          for l in range(num_layers + 1)]
                ids = [z[f"ids{l}"] for l in range(num_layers)]
            return BistrideLevels(graphs=graphs, ids=ids)
        except _STALE:
            pass  # a stale or corrupt cache: rebuild it
    levels = build_bistride_levels(flat_edges, num_layers, num_nodes, pos)
    arrays = {}
    for l, g in enumerate(levels.graphs):
        arrays[f"edges{l}"] = g.flat_edges
        arrays[f"n{l}"] = np.int64(g.num_nodes)
    for l, kept in enumerate(levels.ids):
        arrays[f"ids{l}"] = kept
    os.makedirs(cache_dir, exist_ok=True)
    _atomic_savez(path, arrays)
    return levels


def load_or_build_hierarchy(
    cache_dir: str,
    cache_name: str,
    flat_edges: np.ndarray,
    num_layers: int,
    num_nodes: int,
    pos: np.ndarray,
    pad_multiple: int = 128,
    node_buckets: Optional[List[int]] = None,
    edge_buckets: Optional[List[int]] = None,
    edge_block: int = EDGE_BLOCK,
    window: "int | List[int] | str" = 0,
    ell_buckets: Optional[List[int]] = None,
    resid_buckets: Optional[List[Tuple[int, int]]] = None,
) -> Hierarchy:
    """Cache-through `pad_levels` of the cached raw levels. `cache_name`
    is shared by the trajectories of a consistent-mesh dataset (one build
    serves all) and is the trajectory's own otherwise.

    `window="auto"` builds the windowed layout once at the largest
    candidate width, chooses each level's width with `choose_windows` and
    pads again with those widths, all under one cache entry. The node
    padding keeps the probe's alignment (the largest candidate / 2, 512
    rows) whatever widths are chosen: the coverage the tuner measured
    holds for that layout only. Per-mesh widths do not stack, so "auto"
    takes no node or edge buckets."""
    if window != "auto":
        _check_widths(window if isinstance(window, (list, tuple))
                      else [window], window)
    if window == "auto" and (node_buckets is not None
                             or edge_buckets is not None):
        raise ValueError(
            "window='auto' chooses each mesh's own widths, which bucketed "
            "stacking cannot take; pin a window instead")
    key = _cache_key(num_layers, pad_multiple, node_buckets, edge_buckets,
                     edge_block, window, ell_buckets, resid_buckets)
    path = os.path.join(cache_dir, f"{cache_name}_torch_mmesh_{key}.npz")
    if os.path.isfile(path):
        try:
            return load_hierarchy(path)
        except _STALE:
            pass  # a stale or corrupt cache: rebuild it
    levels = load_or_build_levels(cache_dir, cache_name, flat_edges,
                                  num_layers, num_nodes, pos)
    if window == "auto":
        probe_w = AUTO_WINDOW_CANDIDATES[-1]
        pad_multiple = _pad_to(_pad_to(pad_multiple, NODE_BLOCK),
                               probe_w // 2)
        probe = pad_levels(levels, pad_multiple, pos=pos,
                           edge_block=edge_block, window=probe_w)
        window = choose_windows(probe)
    h = pad_levels(levels, pad_multiple, pos=pos, edge_block=edge_block,
                   window=window, node_buckets=node_buckets,
                   edge_buckets=edge_buckets, resid_buckets=resid_buckets,
                   ell_buckets=ell_buckets)
    os.makedirs(cache_dir, exist_ok=True)
    save_hierarchy(path, h)
    return h
