"""Spatial (Morton / Z-curve) node ordering.

Counterpart of `bsms_gnn_tpu/graph/order.py`. The windowed kernels select
sender rows from a per-chunk source window, which only covers the graph's
edges if node ids are spatially coherent; one offline Morton reorder of the
mesh gives every bi-stride level that coherence, because the level-(l+1)
numbering is the kept-id order of level l.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def morton_perm(pos: np.ndarray, bits: int = 16) -> np.ndarray:
    """Permutation sorting nodes along the Z-order curve of their
    (quantized) positions. Works for any dimensionality ≥ 1."""
    p = np.asarray(pos, np.float64)
    if p.ndim != 2:
        raise ValueError(f"pos must be [N, D], got {p.shape}")
    mn, mx = p.min(axis=0), p.max(axis=0)
    scale = np.maximum(mx - mn, 1e-12)
    q = ((p - mn) / scale * ((1 << bits) - 1)).astype(np.uint64)
    code = np.zeros(len(p), np.uint64)
    d_dim = p.shape[1]
    for bit in range(bits):
        for d in range(d_dim):
            code |= ((q[:, d] >> np.uint64(bit)) & np.uint64(1)) << np.uint64(
                bit * d_dim + d
            )
    return np.argsort(code, kind="stable")


def reorder_mesh(
    pos: np.ndarray,
    cells: np.ndarray,
    node_arrays: Sequence[np.ndarray] = (),
) -> Tuple[np.ndarray, np.ndarray, Tuple[np.ndarray, ...], np.ndarray]:
    """Relabel mesh nodes along the Morton curve. Returns (pos', cells',
    node_arrays', perm) where `perm` maps new id → old id."""
    perm = morton_perm(pos)
    inv = np.empty(len(perm), np.int64)
    inv[perm] = np.arange(len(perm))
    cells2 = inv[np.asarray(cells, np.int64)].astype(cells.dtype)
    arrays2 = tuple(np.asarray(a)[perm] for a in node_arrays)
    return np.asarray(pos)[perm], cells2, arrays2, perm
