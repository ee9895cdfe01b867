#!/usr/bin/env python3
"""Host seconds of the bi-stride build (`graph.bistride.build_bistride_levels`)
with the adjacency squared by the native C++ SpGEMM (`graph.native`) and by
SciPy's sparse product, on chip_smoke.py's meshes.

    python3 build_times.py [--no-large]

Meshes, each Morton-reordered as chip_smoke.py builds it: the 5,233-node
graded airfoil at depth 7 (the main path), the plate's three tetra blocks
(TETRA_MESHES, depth 5) and, unless `--no-large`, the 1M-node Delaunay mesh
of the v6 benchmark (V6_NODES) at depth 7. Each mesh is built with the two
routes in turn, REPEATS times (the large one once), and the levels of the
two routes must be equal array for array. Prints one line per mesh (the
best whole build and the best squaring time of each route) and, last, a
JSON summary. Runs on the CPU; needs `g++` for the native route.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import chip_smoke as cs
from bsms_gnn_tpu_torch.data.synthetic import (
    make_delaunay_mesh,
    make_graded_airfoil_mesh,
    make_tetra_mesh,
)
from bsms_gnn_tpu_torch.graph import bistride, native
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.graph.order import reorder_mesh

REPEATS = 3
ROUTES = {"native": native.square_pattern,
          "scipy": native.square_pattern_scipy}


def meshes(large):
    """(name, flat edges, depth, pos) of each mesh."""
    pos, cells, _ = make_graded_airfoil_mesh(cs.N_NODES,
                                             np.random.default_rng(0))
    pos, cells, _, _ = reorder_mesh(pos, cells)
    yield "airfoil", to_flat_edge(cells, "tri"), cs.DEPTH, pos
    for n, seed in cs.TETRA_MESHES:
        pos, cells, _ = make_tetra_mesh(n, np.random.default_rng(seed))
        pos, cells, _, _ = reorder_mesh(pos, cells)
        yield f"plate{n}", to_flat_edge(cells, "tetra"), cs.TETRA_DEPTH, pos
    if large:
        pos, cells, _ = make_delaunay_mesh(cs.V6_NODES,
                                           np.random.default_rng(0))
        pos, cells, _, _ = reorder_mesh(pos, cells)
        yield "delaunay1M", to_flat_edge(cells, "tri"), cs.DEPTH, pos


def build(route, edges, depth, pos):
    """(levels, whole build s, squaring s) on one route."""
    square = ROUTES[route]
    spent = [0.0]

    def timed(adj, drop_diag=True):
        t0 = time.perf_counter()
        out = square(adj, drop_diag)
        spent[0] += time.perf_counter() - t0
        return out

    bistride.square_pattern = timed
    try:
        t0 = time.perf_counter()
        levels = bistride.build_bistride_levels(edges, depth, pos.shape[0],
                                                pos.astype(np.float64))
        return levels, time.perf_counter() - t0, spent[0]
    finally:
        bistride.square_pattern = native.square_pattern


def same(a, b):
    return (len(a.graphs) == len(b.graphs)
            and all(np.array_equal(x.indptr, y.indptr)
                    and np.array_equal(x.indices, y.indices)
                    for x, y in zip(a.graphs, b.graphs))
            and all(np.array_equal(x, y) for x, y in zip(a.ids, b.ids)))


def main() -> int:
    large = "--no-large" not in sys.argv[1:]
    t0 = time.perf_counter()
    if not native.native_available():
        print(f"native SpGEMM not available: {native.error}")
        return 1
    print(f"native library loaded (built if need be) in "
          f"{time.perf_counter() - t0:.3f} s")
    out, ok = {}, True
    for name, edges, depth, pos in meshes(large):
        reps = REPEATS if name != "delaunay1M" else 1
        best = {}
        for _ in range(reps):
            for route in ROUTES:
                levels, whole, square = build(route, edges, depth, pos)
                prev = best.get(route)
                best[route] = (levels, min(whole, prev[1]) if prev else whole,
                               min(square, prev[2]) if prev else square)
        equal = same(best["native"][0], best["scipy"][0])
        ok &= equal
        n_sq = sum(g.indices.size for g in best["native"][0].graphs[1:])
        row = {r: {"build_s": best[r][1], "square_s": best[r][2]}
               for r in ROUTES}
        out[name] = {"nodes": int(pos.shape[0]), "depth": depth,
                     "squared_edges": int(n_sq), "repeats": reps,
                     "levels_equal": equal, **row}
        print(f"{name}: {pos.shape[0]} nodes, depth {depth}; best of {reps}: "
              f"native build {row['native']['build_s']:.4f} s (squaring "
              f"{row['native']['square_s']:.4f}), scipy build "
              f"{row['scipy']['build_s']:.4f} s (squaring "
              f"{row['scipy']['square_s']:.4f}); levels equal: {equal}")
    print(json.dumps({"build_times": out}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
