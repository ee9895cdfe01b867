"""Bi-stride pooling: BFS-parity node selection + adjacency squaring.

Counterpart of `bsms_gnn_tpu/graph/bistride.py`. Per connected cluster,
seed at the node nearest the cluster centroid, split nodes by BFS-ring
parity and keep the smaller side (even wins ties or when odd is empty);
square A+I to preserve connectivity among kept nodes; relabel kept nodes
and drop dangling edges. The squaring is the C++ SpGEMM of `graph/native`
(SciPy's sparse product, the same pattern, where no compiler is found).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import scipy.sparse

from bsms_gnn_tpu_torch.graph.csr import UNREACHABLE, CsrGraph
from bsms_gnn_tpu_torch.graph.native import square_pattern


def nearest_center_seeds(pos: np.ndarray, clusters: List[np.ndarray]) -> np.ndarray:
    """Per cluster, the node closest (L2) to the cluster centroid."""
    seeds = []
    for c in clusters:
        center = pos[c].mean(axis=0)
        d = np.linalg.norm(pos[c] - center[None, :], axis=-1)
        seeds.append(c[int(np.argmin(d))])
    return np.asarray(seeds, dtype=np.int64)


def bstride_select(g: CsrGraph, pos: np.ndarray) -> np.ndarray:
    """Kept-node indices (sorted) for one bi-stride level."""
    clusters = g.components()
    seeds = nearest_center_seeds(pos, clusters)
    dist = g.bfs_dist(seeds)

    labels = np.empty(g.num_nodes, dtype=np.int64)
    for ci, c in enumerate(clusters):
        labels[c] = ci
    reachable = dist != UNREACHABLE
    parity = np.zeros(g.num_nodes, dtype=np.int64)
    parity[reachable] = dist[reachable] % 2

    n_clusters = len(clusters)
    even_counts = np.bincount(labels[reachable & (parity == 0)], minlength=n_clusters)
    odd_counts = np.bincount(labels[reachable & (parity == 1)], minlength=n_clusters)
    # Keep even when |even| <= |odd| or odd is empty, else odd.
    keep_even = (even_counts <= odd_counts) | (odd_counts == 0)

    keep = reachable & (parity == np.where(keep_even, 0, 1)[labels])
    return np.flatnonzero(keep).astype(np.int64)


def squared_adjacency(g: CsrGraph) -> CsrGraph:
    """Graph of (A + I)^2 with the diagonal removed (pattern only); the
    native pattern is row-major CSR already, so CsrGraph skips its sort."""
    adj = g.to_adj() + scipy.sparse.eye(g.num_nodes, format="csr")
    indptr, indices = square_pattern(adj, drop_diag=True)
    return CsrGraph.from_csr(indptr, indices, g.num_nodes)


def pool_edges(g: CsrGraph, kept: np.ndarray) -> CsrGraph:
    """Restrict g to `kept` nodes, relabeling them 0..len(kept)-1."""
    remap = np.full(g.num_nodes, -1, dtype=np.int64)
    remap[kept] = np.arange(len(kept), dtype=np.int64)
    e = remap[g.flat_edges]
    valid = (e[0] >= 0) & (e[1] >= 0)
    return CsrGraph(e[:, valid], len(kept))


@dataclass
class BistrideLevels:
    """Raw (unpadded) multi-level graph structure: graphs[l] is the level-l
    graph (graphs[0] = input mesh graph); ids[l] are the level-l node
    indices kept to form level l+1."""

    graphs: List[CsrGraph]
    ids: List[np.ndarray]


def build_bistride_levels(
    flat_edges: np.ndarray, num_layers: int, num_nodes: int, pos: np.ndarray
) -> BistrideLevels:
    g = CsrGraph(flat_edges, num_nodes)
    pos = np.asarray(pos, dtype=np.float64)
    graphs = [g]
    ids: List[np.ndarray] = []
    for _ in range(num_layers):
        kept = bstride_select(g, pos)
        g = pool_edges(squared_adjacency(g), kept)
        pos = pos[kept]
        graphs.append(g)
        ids.append(kept)
    return BistrideLevels(graphs=graphs, ids=ids)


def transition_edge_weights(levels: BistrideLevels) -> List[np.ndarray]:
    """Per-level transition edge weights `ec`, precomputed offline:
        normed_w = w / out_degree;  aggr_w[j] = Σ_{i→j} normed_w[i] + 1e-12
        ec[i→j] = normed_w[i] / aggr_w[j];  w_next = aggr_w[kept]
    in f64 with f32 degrees. Returns, for levels 0..depth, `ec` arrays
    aligned with each level's `flat_edges` columns."""
    w = np.ones(levels.graphs[0].num_nodes, np.float64)
    out = []
    for l, g in enumerate(levels.graphs):
        snd, rcv = g.flat_edges[0], g.flat_edges[1]
        deg = np.bincount(snd, minlength=g.num_nodes).astype(np.float32)
        deg = np.maximum(deg, 1.0)
        normed_w = w / deg
        aggr_w = np.bincount(rcv, weights=normed_w[snd],
                             minlength=g.num_nodes) + 1e-12
        out.append((normed_w[snd] / aggr_w[rcv]).astype(np.float64))
        if l < len(levels.ids):
            w = aggr_w[levels.ids[l]]
    return out


def smoothed_positions(levels: BistrideLevels, pos: np.ndarray) -> List[np.ndarray]:
    """Per-level node positions as each GMP sees them: level l's array is
    the position before that level's weighted conv; the bottom level gets
    the fully smoothed and pooled chain."""
    ecs = transition_edge_weights(levels)
    p = np.asarray(pos, np.float64)
    out = []
    for l, g in enumerate(levels.graphs):
        out.append(p)
        if l == len(levels.ids):
            break
        snd, rcv = g.flat_edges[0], g.flat_edges[1]
        ec = ecs[l]
        smoothed = np.stack(
            [np.bincount(rcv, weights=ec * p[snd, d], minlength=g.num_nodes)
             for d in range(p.shape[1])],
            axis=-1,
        )
        p = smoothed[levels.ids[l]]
    return out
