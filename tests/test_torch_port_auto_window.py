"""`window="auto"` in the port against the JAX package: `window_coverage`
and `choose_windows` on a Morton-ordered Delaunay mesh and on the
5,233-node graded airfoil at depth 7; the auto-built hierarchy table for
table against `load_or_build_hierarchy(window="auto")`; the readers with
`datasets.window=-1` (the JAX CLI's spelling of "auto"); the refusals
(`plan_buckets` with a negative window, "auto" with buckets, a bare
negative width, which names "auto"); and the two packages' caches side by
side. Every comparison is exact: both packages compute the same numpy
arrays, the coverage from the same integer counts."""

import functools
import glob
import os

import numpy as np
import pytest

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_hierarchy import assert_same

from bsms_gnn_tpu.config import DatasetConfig as JaxDatasetConfig
from bsms_gnn_tpu.data import synthetic as jax_synthetic
from bsms_gnn_tpu.data.pipeline import plan_buckets as jax_plan_buckets
from bsms_gnn_tpu.data.trajectory import TrajectoryReader as JaxReader
from bsms_gnn_tpu.graph import hierarchy as jax_hierarchy
from bsms_gnn_tpu.graph.bistride import build_bistride_levels as jax_levels
from bsms_gnn_tpu_torch.config import DatasetConfig
from bsms_gnn_tpu_torch.data.pipeline import plan_buckets
from bsms_gnn_tpu_torch.data.synthetic import (
    make_delaunay_mesh,
    make_graded_airfoil_mesh,
)
from bsms_gnn_tpu_torch.data.trajectory import TrajectoryReader
from bsms_gnn_tpu_torch.graph import hierarchy
from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.graph.order import reorder_mesh

EDGE_BLOCK = 512
MESHES = {"delaunay": (make_delaunay_mesh, 1500, 4, 3),
          "airfoil": (make_graded_airfoil_mesh, 5233, 7, 0)}


@functools.lru_cache(maxsize=None)
def mesh(name):
    """(pos f64, cells, depth) of a Morton-ordered mesh."""
    make, n, depth, seed = MESHES[name]
    pos, cells, _ = make(n, np.random.default_rng(seed))
    pos, cells, _, _ = reorder_mesh(pos, cells)
    return pos.astype(np.float64), cells, depth


@functools.lru_cache(maxsize=None)
def probes(name):
    """(JAX, port) hierarchies at the auto build's probe: the largest
    candidate window on 512-row node alignment."""
    pos, cells, depth = mesh(name)
    edges = to_flat_edge(cells, "tri")
    probe = hierarchy.AUTO_WINDOW_CANDIDATES[-1]
    kw = dict(pos=pos, edge_block=EDGE_BLOCK, window=probe)
    return (jax_hierarchy.pad_levels(jax_levels(edges, depth, len(pos), pos),
                                     probe // 2, **kw),
            hierarchy.pad_levels(build_bistride_levels(edges, depth, len(pos),
                                                       pos), probe // 2, **kw))


def test_tuner_constants_equal_jax():
    assert (hierarchy.AUTO_WINDOW_CANDIDATES
            == jax_hierarchy.AUTO_WINDOW_CANDIDATES)
    assert hierarchy.AUTO_RESID_ROWS == jax_hierarchy.AUTO_RESID_ROWS


@pytest.mark.parametrize("name", sorted(MESHES))
def test_window_coverage_equals_jax(name):
    hj, ht = probes(name)
    for l, (a, b) in enumerate(zip(hj.levels, ht.levels)):
        for w in (*hierarchy.AUTO_WINDOW_CANDIDATES, 384):
            got = hierarchy.window_coverage(b, w)
            want = jax_hierarchy.window_coverage(a, w)
            assert (np.isnan(got) and np.isnan(want)) or got == want, (l, w)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_choose_windows_equals_jax(name, monkeypatch):
    hj, ht = probes(name)
    got = hierarchy.choose_windows(ht)
    assert got == jax_hierarchy.choose_windows(hj)
    assert set(got) <= set(hierarchy.AUTO_WINDOW_CANDIDATES)
    for rows in (64, 20_000):  # a cheap and a dear residual path
        monkeypatch.setattr(hierarchy, "AUTO_RESID_ROWS", rows)
        assert (hierarchy.choose_windows(ht)
                == jax_hierarchy.choose_windows(hj, resid_rows=rows))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_auto_hierarchy_equals_jax(tmp_path, name):
    """The cache-through auto build, then its cached copy, table for table
    against the JAX package's (which also builds the mini residual
    sub-layouts of unbucketed levels: the port reads their compact
    tables)."""
    pos, cells, depth = mesh(name)
    args = (str(tmp_path), "m", to_flat_edge(cells, "tri"), depth, len(pos),
            pos)
    kw = dict(edge_block=EDGE_BLOCK, window="auto")
    hj = jax_hierarchy.load_or_build_hierarchy(*args, **kw)
    for _ in range(2):  # built, then loaded from the port's cache
        ht = hierarchy.load_or_build_hierarchy(*args, **kw)
        assert ([g.window for g in ht.levels]
                == [g.window for g in hj.levels])
        assert all(g.n_pad_nodes % 512 == 0 for g in ht.levels)
        for l, (a, b) in enumerate(zip(hj.levels, ht.levels)):
            assert_same(a, b, f"level{l}", skip=("resid",))
        for l, (a, b) in enumerate(zip(hj.transitions, ht.transitions)):
            np.testing.assert_array_equal(b.pool_ids, a.pool_ids)
            np.testing.assert_array_equal(b.unpool_inv, a.unpool_inv)
            assert_same(a.down_op, b.down_op, f"trans{l}.down")
            assert_same(a.up_op, b.up_op, f"trans{l}.up")
    names = sorted(os.listdir(tmp_path))
    assert len([n for n in names if "_torch_mmesh_" in n]) == 1
    assert len([n for n in names if "_tpu_mmesh_" in n]) == 1
    assert len(names) == 4  # and each package's raw levels


def test_auto_cache_key_folds_in_the_tuner():
    """The auto build's key changes with the candidates or the cost
    constant, as JAX's does, and differs from every fixed width's."""
    key = functools.partial(hierarchy._cache_key, 3, 128, None, None, 512)
    auto = key("auto")
    assert auto != key(256) and auto != key(1024) and auto != key(0)
    saved = hierarchy.AUTO_RESID_ROWS
    try:
        hierarchy.AUTO_RESID_ROWS = saved + 1
        assert key("auto") != auto and key(256) == key(256)
    finally:
        hierarchy.AUTO_RESID_ROWS = saved
    assert key("auto") == auto


def test_negative_width_and_auto_refusals(tmp_path):
    """A bare negative width (not reached through a reader) raises a
    ValueError naming "auto" before any padding; "auto" with node or edge
    buckets raises (JAX asserts); an unknown string raises."""
    pos, cells, _ = mesh("delaunay")
    edges = to_flat_edge(cells, "tri")
    levels = build_bistride_levels(edges, 2, len(pos), pos)
    for call in (
            lambda: hierarchy.pad_levels(levels, 128, pos=pos, window=-1),
            lambda: hierarchy.pad_levels(levels, 128, pos=pos,
                                         window=[256, -1, 128]),
            lambda: hierarchy.build_hierarchy(edges, 2, len(pos), pos,
                                              window=-1),
            lambda: hierarchy.load_or_build_hierarchy(
                str(tmp_path), "n", edges, 2, len(pos), pos, window=-1)):
        with pytest.raises(ValueError, match="auto"):
            call()
    for kw in (dict(node_buckets=[2048, 1024, 512]),
               dict(edge_buckets=[8192, 8192, 8192])):
        with pytest.raises(ValueError, match="auto"):
            hierarchy.load_or_build_hierarchy(
                str(tmp_path), "b", edges, 2, len(pos), pos, window="auto",
                **kw)
        with pytest.raises(AssertionError):
            jax_hierarchy.load_or_build_hierarchy(
                str(tmp_path), "b", edges, 2, len(pos), pos, window="auto",
                **kw)
    with pytest.raises(ValueError, match="auto"):
        hierarchy.load_or_build_hierarchy(str(tmp_path), "s", edges, 2,
                                          len(pos), pos, window="wide")
    assert not glob.glob(str(tmp_path / "*_mmesh_*"))


@pytest.fixture(scope="module")
def airfoil_files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("auto_data"))
    jax_synthetic.generate_synthetic_dataset(
        root, "synthetic_airfoil", n_train=1, n_test=1, n_nodes=700,
        n_frames=4, consistent_mesh=True, with_density=True, seed=6)
    jax_synthetic.generate_synthetic_dataset(
        root, "synthetic_cylinder_flow", n_train=3, n_test=0, n_nodes=500,
        n_frames=4, consistent_mesh=False, with_density=True, seed=2)
    return root


def test_reader_with_window_minus_one_equals_jax(airfoil_files):
    """`datasets.window=-1`: both readers Morton-order the mesh (the same
    `node_perm`), cache under the `_mrt` name and build the tuned widths:
    node_in, node_out, node_mask and every table equal."""
    kw = dict(root=airfoil_files, name="synthetic_airfoil", unet_depth=3,
              window=-1, edge_block=EDGE_BLOCK)
    jcfg, tcfg = JaxDatasetConfig(**kw), DatasetConfig(**kw)
    path = sorted(glob.glob(os.path.join(airfoil_files, "synthetic_airfoil",
                                          "train", "*.h5")))[0]
    jr = JaxReader(jcfg, path)
    for _ in range(2):  # built, then loaded from the port's cache
        tr = TrajectoryReader(tcfg, path, device="cpu")
        assert tr.node_perm is not None
        np.testing.assert_array_equal(tr.node_perm, jr.node_perm)
        for k in ("node_in", "node_out", "node_mask", "cells"):
            np.testing.assert_array_equal(getattr(tr, k), getattr(jr, k))
        assert tr.n_pad == jr.n_pad and tr.n_pad % 512 == 0
        widths = [g.window for g in tr.hierarchy.levels]
        assert widths == [g.window for g in jr.hierarchy.levels]
        assert all(w > 0 for w in widths)
        for l, (a, b) in enumerate(zip(jr.hierarchy.levels,
                                       tr.hierarchy.levels)):
            assert_same(a, b, f"level{l}", skip=("resid",))
        assert tr.hd.levels[0].window == widths[0]
    names = os.listdir(os.path.dirname(path))
    assert any(n.startswith("shared_mrt_torch_mmesh_") for n in names)
    assert any(n.startswith("shared_mrt_tpu_mmesh_") for n in names)


def test_plan_buckets_refuses_a_negative_window(airfoil_files):
    """Bucketed variable meshes take one width for every mesh of a group:
    both packages' planners refuse window=-1."""
    kw = dict(root=airfoil_files, name="synthetic_cylinder_flow",
              unet_depth=2, window=-1, edge_block=EDGE_BLOCK,
              consist_mesh=False)
    with pytest.raises(ValueError, match="auto"):
        jax_plan_buckets(JaxDatasetConfig(**kw), "train")
    with pytest.raises(ValueError, match="auto"):
        plan_buckets(DatasetConfig(**kw), "train")
