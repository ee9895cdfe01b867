"""CSR graph container with vectorized BFS and connected components.

Counterpart of `bsms_gnn_tpu/graph/csr.py`: BFS is frontier-vectorized over
CSR arrays and components come from scipy.csgraph.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import scipy.sparse
from scipy.sparse import csgraph

UNREACHABLE = np.iinfo(np.int64).max


class CsrGraph:
    """Static directed graph over `num_nodes` nodes stored as CSR.

    Mesh graphs here are symmetric (both edge directions present), so
    out-neighborhood BFS equals undirected BFS.
    """

    def __init__(self, flat_edges: np.ndarray, num_nodes: int):
        flat_edges = np.asarray(flat_edges, dtype=np.int64).reshape(2, -1)
        self.num_nodes = int(num_nodes)
        self.flat_edges = flat_edges
        order = np.lexsort((flat_edges[1], flat_edges[0]))
        s, r = flat_edges[0][order], flat_edges[1][order]
        self.indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        self.indptr[1:] = np.bincount(s, minlength=num_nodes)
        np.cumsum(self.indptr, out=self.indptr)
        self.indices = r

    @classmethod
    def from_csr(
        cls, indptr: np.ndarray, indices: np.ndarray, num_nodes: int
    ) -> "CsrGraph":
        """Adopt already-row-major CSR arrays without re-sorting; within-row
        column order is not relied upon anywhere downstream."""
        g = cls.__new__(cls)
        g.num_nodes = int(num_nodes)
        g.indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        g.indices = np.ascontiguousarray(indices, dtype=np.int64)
        senders = np.repeat(
            np.arange(num_nodes, dtype=np.int64), np.diff(g.indptr)
        )
        g.flat_edges = np.stack([senders, g.indices])
        return g

    def to_adj(self) -> scipy.sparse.csr_matrix:
        e = self.flat_edges
        return scipy.sparse.csr_matrix(
            (np.ones(e.shape[1], dtype=np.float64), (e[0], e[1])),
            shape=(self.num_nodes, self.num_nodes),
        )

    def bfs_dist(self, seed: Union[int, Sequence[int]]) -> np.ndarray:
        """Hop distance from seed(s); UNREACHABLE for disconnected nodes.
        Each level expands all frontier adjacency rows at once."""
        dist = np.full(self.num_nodes, UNREACHABLE, dtype=np.int64)
        frontier = np.atleast_1d(np.asarray(seed, dtype=np.int64))
        dist[frontier] = 0
        depth = 0
        while frontier.size:
            depth += 1
            starts = self.indptr[frontier]
            ends = self.indptr[frontier + 1]
            counts = ends - starts
            total = int(counts.sum())
            if total == 0:
                break
            offsets = np.repeat(starts, counts) + (
                np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
            )
            neigh = self.indices[offsets]
            new = np.unique(neigh[dist[neigh] == UNREACHABLE])
            dist[new] = depth
            frontier = new
        return dist

    def components(self) -> List[np.ndarray]:
        """Connected components (edges treated as undirected), each a sorted
        node-index array; isolated nodes form their own clusters."""
        if self.num_nodes == 0:
            return []
        n_comp, labels = csgraph.connected_components(
            self.to_adj(), directed=False, return_labels=True
        )
        order = np.argsort(labels, kind="stable")
        bounds = np.searchsorted(labels[order], np.arange(n_comp + 1))
        return [np.sort(order[bounds[i] : bounds[i + 1]]) for i in range(n_comp)]

    def degrees(self) -> np.ndarray:
        """Out-degree per node."""
        return np.diff(self.indptr)
