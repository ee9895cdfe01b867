"""Cell connectivity → bidirectional flat edge lists (NumPy, vectorized).

Counterpart of `bsms_gnn_tpu/graph/mesh.py`: collect the cell edges,
canonicalize each as (max, min), dedupe, and emit both directions as a
[2, E] int array.
"""

from __future__ import annotations

import numpy as np

# Local vertex pairs forming the edges of each cell type.
_CELL_EDGES = {
    "tri": [(0, 1), (1, 2), (2, 0)],
    "tetra": [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2), (1, 3)],
    "quad": [(0, 1), (1, 2), (2, 3), (3, 0)],
}


def cells_to_edges(cells: np.ndarray, pairs) -> np.ndarray:
    """Unique undirected cell edges emitted in both directions, [2, E]."""
    cells = np.asarray(cells)
    segs = np.concatenate([cells[:, [a, b]] for a, b in pairs], axis=0)
    lo = segs.min(axis=1).astype(np.int64)
    hi = segs.max(axis=1).astype(np.int64)
    # Scalar-key unique: hi*n+lo sorts identically to lexsort by (hi, lo).
    n = int(hi.max()) + 1 if hi.size else 0
    key = np.unique(hi * n + lo)
    s, r = key // max(n, 1), key % max(n, 1)
    return np.stack([np.concatenate([s, r]), np.concatenate([r, s])]).astype(np.int64)


def lines_to_edges(cells: np.ndarray) -> np.ndarray:
    """Line cells given as [2, M]: emit both directions (no dedupe)."""
    cells = np.asarray(cells)
    s, r = cells[0], cells[1]
    return np.stack([np.concatenate([s, r]), np.concatenate([r, s])]).astype(np.int64)


def to_flat_edge(mesh: np.ndarray, mesh_type: str) -> np.ndarray:
    """Dispatch on mesh type; `"flat"` passes a ready [2, E] list through."""
    if mesh_type in _CELL_EDGES:
        return cells_to_edges(mesh, _CELL_EDGES[mesh_type])
    if mesh_type == "line":
        return lines_to_edges(mesh)
    if mesh_type == "flat":
        return np.asarray(mesh, dtype=np.int64)
    raise ValueError(f"Unsupported mesh type {mesh_type!r}")
