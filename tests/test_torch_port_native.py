"""The port's native graph precompute (`bsms_gnn_tpu_torch/graph/native`,
its own copy of the JAX package's C++ SpGEMM and BFS, built with g++ at
first use) against its SciPy route and the JAX package's native module:
the squared pattern bit for bit on a triangle mesh, a tetra block and a
graph with isolated nodes, with and without the diagonal; the BFS against
`CsrGraph.bfs_dist`; the bi-stride levels of a tetra block against the
JAX package's. Every comparison is exact (integer patterns)."""

import os

import numpy as np
import pytest
import scipy.sparse

import torch_threads  # noqa: F401 (the worker's share of the cores)

from bsms_gnn_tpu.graph import native as jax_native
from bsms_gnn_tpu.graph.bistride import build_bistride_levels as jax_levels
from bsms_gnn_tpu_torch.data.synthetic import (
    make_delaunay_mesh,
    make_tetra_mesh,
)
from bsms_gnn_tpu_torch.graph import native
from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels
from bsms_gnn_tpu_torch.graph.csr import UNREACHABLE, CsrGraph
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge


def tri_mesh():
    pos, cells, _ = make_delaunay_mesh(500, np.random.default_rng(3))
    return CsrGraph(to_flat_edge(cells, "tri"), len(pos))


def tetra_block():
    pos, cells, _ = make_tetra_mesh(700, np.random.default_rng(5))
    return CsrGraph(to_flat_edge(cells, "tetra"), len(pos))


def isolated_nodes():
    """A ring of 40 nodes, a path of 10 and 6 nodes with no edge (ids 50 to
    55, among them the last)."""
    ring = np.arange(40)
    s = np.concatenate([ring, (ring + 1) % 40, np.arange(40, 49),
                        np.arange(41, 50)])
    r = np.concatenate([(ring + 1) % 40, ring, np.arange(41, 50),
                        np.arange(40, 49)])
    return CsrGraph(np.stack([s, r]), 56)


GRAPHS = {"tri": tri_mesh, "tetra": tetra_block, "isolated": isolated_nodes}


def test_native_library_builds_here():
    """This machine has g++: the library builds into the git-ignored
    `build/` directory beside the source and loads."""
    assert native.native_available(), native.error
    assert os.path.isfile(native._SO)
    assert os.path.dirname(native._SO) == native.BUILD_DIR
    assert native.BUILD_DIR.startswith(os.path.dirname(native._SRC))


@pytest.mark.parametrize("drop_diag", [True, False])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_square_pattern_equals_scipy_and_jax(graph, drop_diag):
    g = GRAPHS[graph]()
    for adj in (g.to_adj(),
                g.to_adj() + scipy.sparse.eye(g.num_nodes, format="csr")):
        got = native.square_pattern(adj, drop_diag=drop_diag)
        for want in (native.square_pattern_scipy(adj, drop_diag),
                     jax_native.square_pattern(adj, drop_diag=drop_diag)):
            for a, b in zip(got, want):
                assert a.dtype == b.dtype == np.int64
                np.testing.assert_array_equal(a, b)
        indptr, indices = got
        assert indptr[-1] == len(indices) > 0
        if drop_diag:
            rows = np.repeat(np.arange(g.num_nodes), np.diff(indptr))
            assert not (rows == indices).any()


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_bfs_equals_bfs_dist(graph):
    g = GRAPHS[graph]()
    adj = g.to_adj()
    for seed in (0, g.num_nodes // 2, g.num_nodes - 1):
        got = native.bfs(adj.indptr, adj.indices, seed)
        want = g.bfs_dist(seed)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(
            got, np.where(want == UNREACHABLE, -1, want))
    assert graph != "isolated" or (got == -1).any()


def test_tetra_levels_equal_jax():
    """The bi-stride levels of a 1,271-node tetra block at depth 5 (its
    levels 4 and 5 one node each), squared natively, equal the JAX
    package's."""
    pos, cells, _ = make_tetra_mesh(1271, np.random.default_rng(0))
    edges = to_flat_edge(cells, "tetra")
    pos = pos.astype(np.float64)
    got = build_bistride_levels(edges, 5, len(pos), pos)
    want = jax_levels(edges, 5, len(pos), pos)
    assert [g.num_nodes for g in got.graphs][-2:] == [1, 1]
    for a, b in zip(got.graphs, want.graphs):
        assert a.num_nodes == b.num_nodes
        np.testing.assert_array_equal(a.flat_edges, b.flat_edges)
    for a, b in zip(got.ids, want.ids):
        np.testing.assert_array_equal(a, b)
