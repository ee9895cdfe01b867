"""The port's data feed against the JAX package's on the same HDF5 files:
the synthetic writers bit for bit; `TrajectoryReader` (node_in, node_out,
node_mask, node_perm and every hierarchy table both packages hold) on a
windowed and an unwindowed consistent-mesh airfoil and on bucketed
variable meshes with the plan's buckets; `plan_buckets`' groups and
`file_group`; the first batches of a one-worker `TrajectorySampler` and
`rollout_iterator`'s trajectories; the npz caches, each package reading
only its own files in a shared directory; and the TFRecord converter on
records the test writes itself.

Meshes: a 300-node Delaunay airfoil stand-in and cylinder meshes of 300 to
600 nodes, depth 2 (window 128, edge_block 512 where windowed). Every
comparison is exact: both packages compute the same numpy arrays."""

import functools
import glob
import json
import os

import h5py
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_tfrecord import _make_meta_and_example, encode_example, write_tfrecord
from test_torch_port_hierarchy import assert_same

from bsms_gnn_tpu.config import DatasetConfig as JaxDatasetConfig
from bsms_gnn_tpu.data import synthetic as jax_synthetic
from bsms_gnn_tpu.data import tfrecord as jax_tfrecord
from bsms_gnn_tpu.data.pipeline import TrajectorySampler as JaxSampler
from bsms_gnn_tpu.data.pipeline import plan_buckets as jax_plan_buckets
from bsms_gnn_tpu.data.pipeline import rollout_iterator as jax_rollout_iterator
from bsms_gnn_tpu.data.trajectory import TrajectoryReader as JaxReader
from bsms_gnn_tpu_torch.config import DatasetConfig
from bsms_gnn_tpu_torch.data import synthetic, tfrecord
from bsms_gnn_tpu_torch.data.datasets import DATASET_HANDLER, get_mask
from bsms_gnn_tpu_torch.data.pipeline import (
    TrajectorySampler,
    device_prefetch,
    plan_buckets,
    rollout_iterator,
)
from bsms_gnn_tpu_torch.data.trajectory import TrajectoryReader
from bsms_gnn_tpu_torch.graph.hierarchy import load_or_build_hierarchy

DEPTH, WINDOW, EDGE_BLOCK = 2, 128, 512
N_BATCHES, BATCH = 6, 2
CASES = {
    "airfoil_windowed": dict(name="synthetic_airfoil", window=WINDOW,
                             edge_block=EDGE_BLOCK),
    "airfoil_unwindowed": dict(name="synthetic_airfoil"),
    "cylinder_bucketed": dict(name="synthetic_cylinder_flow",
                              consist_mesh=False, window=WINDOW,
                              edge_block=EDGE_BLOCK, size_buckets=2),
}


def configs(root, **kw):
    """The JAX and the port's DatasetConfig of one dataset."""
    kw = dict(root=root, unet_depth=DEPTH, **kw)
    return JaxDatasetConfig(**kw), DatasetConfig(**kw)


def write(root, name):
    if name == "synthetic_airfoil":
        jax_synthetic.generate_synthetic_dataset(
            root, name, n_train=2, n_test=1, n_nodes=300, n_frames=8,
            consistent_mesh=True, with_density=True, seed=3)
    else:
        jax_synthetic.generate_synthetic_dataset(
            root, name, n_train=3, n_test=1, n_nodes=600, n_frames=8,
            consistent_mesh=False, with_density=True, seed=7)


@functools.lru_cache(maxsize=None)
def dataset(case, root):
    """(JAX config, port config, files) of a case's dataset under root,
    each case in a directory of its own."""
    kw = CASES[case]
    write(os.path.join(root, case), kw["name"])
    jcfg, tcfg = configs(os.path.join(root, case), **kw)
    files = sorted(glob.glob(os.path.join(root, case, kw["name"], "*",
                                          "*.h5")))
    return jcfg, tcfg, files


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("port_data"))


def _h5(path):
    with h5py.File(path, "r") as f:
        return {k: (f[k].dtype, np.asarray(f[k])) for k in f}


@pytest.mark.parametrize("kind", ["consistent", "variable", "inflating"])
def test_writers_equal_jax_bit_for_bit(tmp_path, kind):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    if kind == "inflating":
        jax_synthetic.generate_synthetic_inflating_dataset(a, n_nodes=120,
                                                           seed=2)
        synthetic.generate_synthetic_inflating_dataset(b, n_nodes=120, seed=2)
    else:
        kw = dict(n_train=2, n_test=1, n_nodes=200, n_frames=5,
                  consistent_mesh=kind == "consistent", seed=4)
        jax_synthetic.generate_synthetic_dataset(a, "d", **kw)
        synthetic.generate_synthetic_dataset(b, "d", **kw)
        jax_synthetic.generate_synthetic_dataset(a, "v", with_density=False,
                                                 **kw)
        synthetic.generate_synthetic_dataset(b, "v", with_density=False, **kw)
    fa = sorted(os.path.relpath(p, a) for p in glob.glob(f"{a}/*/*/*.h5"))
    fb = sorted(os.path.relpath(p, b) for p in glob.glob(f"{b}/*/*/*.h5"))
    assert fa == fb and fa
    for rel in fa:
        x, y = _h5(os.path.join(a, rel)), _h5(os.path.join(b, rel))
        assert sorted(x) == sorted(y), rel
        for k in x:
            assert x[k][0] == y[k][0], (rel, k)
            np.testing.assert_array_equal(x[k][1], y[k][1], err_msg=rel + k)


def test_masks_equal_jax():
    from bsms_gnn_tpu.data.datasets import DATASET_HANDLER as JAX_HANDLER
    from bsms_gnn_tpu.data.datasets import get_mask as jax_get_mask

    assert DATASET_HANDLER == JAX_HANDLER
    node_type = np.arange(7).reshape(1, 7, 1).repeat(2, 0)
    for name in DATASET_HANDLER:
        got = get_mask(name, node_type)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_get_mask(name, node_type))
    with pytest.raises(KeyError):
        get_mask("no_such_dataset", node_type)


def assert_readers_equal(jr, tr, bucketed):
    for k in ("node_in", "node_out", "node_mask", "cells", "mesh_pos0"):
        a, b = getattr(jr, k), getattr(tr, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert (jr.node_perm is None) == (tr.node_perm is None)
    if tr.node_perm is not None:
        np.testing.assert_array_equal(tr.node_perm, jr.node_perm)
    assert len(tr) == len(jr) and tr.n_pad == jr.n_pad
    assert tr.level_sizes() == jr.level_sizes()
    for l, (a, b) in enumerate(zip(jr.hierarchy.levels, tr.hierarchy.levels)):
        # Unbucketed builds keep their out-of-window edges as compact
        # tables only; the JAX package also builds a residual sub-level.
        assert_same(a, b, f"level{l}", skip=() if bucketed else ("resid",))
    for l, (a, b) in enumerate(zip(jr.hierarchy.transitions,
                                   tr.hierarchy.transitions)):
        np.testing.assert_array_equal(b.pool_ids, a.pool_ids)
        np.testing.assert_array_equal(b.unpool_inv, a.unpool_inv)
        assert (b.down_op is None) == bucketed == (a.down_op is None)
        if not bucketed:
            assert_same(a.down_op, b.down_op, f"trans{l}.down")
            assert_same(a.up_op, b.up_op, f"trans{l}.up")
    hd = tr.hd
    assert hd.levels[0].senders.device.type == "cpu"
    np.testing.assert_array_equal(hd.levels[0].senders.numpy(),
                                  tr.hierarchy.levels[0].senders)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_equals_jax(root, case):
    """Each file's reader, built and then again from the port's cache."""
    jcfg, tcfg, files = dataset(case, root)
    bucketed = not tcfg.consist_mesh
    jplan = jax_plan_buckets(jcfg, "train") if bucketed else None
    plan = plan_buckets(tcfg, "train") if bucketed else None
    for path in files:
        jr = JaxReader(jcfg, path, **({} if jplan is None
                                      else jplan.for_file(path)))
        bk = {} if plan is None else plan.for_file(path)
        for _ in range(2):  # built, then loaded from the cache
            tr = TrajectoryReader(tcfg, path, device="cpu", **bk)
            assert_readers_equal(jr, tr, bucketed)
    if tcfg.window:
        assert any(lv.cresid is not None or lv.resid is not None
                   for lv in tr.hierarchy.levels)


def test_reader_from_fields_and_shared(root):
    """`from_fields` on a file's fields equals the file's reader; a reader
    made with `shared` takes the other's hierarchy and equals its own."""
    _, tcfg, files = dataset("airfoil_windowed", root)
    first = TrajectoryReader(tcfg, files[0], device="cpu")
    with h5py.File(files[1], "r") as f:
        fields = {k: np.asarray(f[k]) for k in tcfg.field_names}
    tr = TrajectoryReader.from_fields(
        tcfg, fields, os.path.dirname(files[1]), "shared", device="cpu")
    want = TrajectoryReader(tcfg, files[1], device="cpu")
    shared = TrajectoryReader(tcfg, files[1], device="cpu", shared=first)
    assert shared.hd is first.hd
    for r in (tr, shared):
        for k in ("node_in", "node_out", "node_mask", "node_perm"):
            np.testing.assert_array_equal(getattr(r, k), getattr(want, k))
        assert_same(want.hierarchy.levels[0], r.hierarchy.levels[0], "l0")


@pytest.mark.parametrize("window", [WINDOW, 0])
def test_plan_equals_jax(root, window):
    """The plan's groups and file groups, and its JSON cache (the port's
    own file beside JAX's) read back."""
    jcfg, tcfg, files = dataset("cylinder_bucketed", root)
    jcfg.window = tcfg.window = window
    want = jax_plan_buckets(jcfg, "train")
    for _ in range(2):  # planned, then read from the JSON cache
        got = plan_buckets(tcfg, "train")
        assert got.file_group == want.file_group
        assert len(got.groups) == len(want.groups) == 2
        for g, w in zip(got.groups, want.groups):
            for k in ("node_buckets", "edge_buckets", "ell_buckets"):
                assert g[k] == list(w[k]), k
            assert g["resid_buckets"] == w["resid_buckets"]
        for path in files:
            assert got.for_file(path) == want.for_file(path)
    names = os.listdir(os.path.dirname(os.path.dirname(files[0])))
    assert any(n.startswith("torch_buckets_") for n in names)
    assert any(n.startswith("tpu_buckets_") for n in names)
    jcfg.window = tcfg.window = WINDOW


@pytest.mark.parametrize("case", sorted(CASES))
def test_sampler_batches_equal_jax(root, case):
    """One worker: the first batches in JAX's order, arrays equal; each
    batch's hierarchy the readers' shared one, or the union of its B
    samples' on a variable-mesh dataset."""
    jcfg, tcfg, _ = dataset(case, root)
    js = JaxSampler(jcfg, BATCH, num_workers=1, base_seed=5)
    ts = TrajectorySampler(tcfg, BATCH, num_workers=1, base_seed=5,
                           device="cpu", timeout=120)
    try:
        for i, (jb, tb) in enumerate(zip(js, device_prefetch(ts))):
            if i == N_BATCHES:
                break
            for k in ("node_in", "node_tar", "node_mask"):
                got = getattr(tb, k)
                assert isinstance(got, torch.Tensor), k
                np.testing.assert_array_equal(got.numpy(), getattr(jb, k))
            hd = tb.hierarchy
            if tcfg.consist_mesh:
                assert hd.samples == 1
            else:
                assert hd.samples == BATCH
                n = [g.n_nodes for g in jb.hierarchy.levels]
                assert [s[0] for s in hd.sample_nodes] == n
            assert hd.levels[0].n_pad_nodes == hd.samples * tb.node_in.shape[1]
        assert i == N_BATCHES
    finally:
        js.close()
        ts.close()
    assert all(not t.is_alive() for t in ts._threads)


def test_sampler_surfaces_worker_errors_and_times_out(root):
    _, tcfg, files = dataset("airfoil_unwindowed", root)
    readers = [TrajectoryReader(tcfg, p, device="cpu") for p in files]
    with pytest.raises(ValueError, match="no trajectory holds"):
        TrajectorySampler.from_readers(tcfg, readers, 100)
    bad = DatasetConfig(**{**vars(tcfg),
                           "field_names": tcfg.field_names + ["no_such"]})
    ts = TrajectorySampler(bad, BATCH, num_workers=1, device="cpu",
                           timeout=60)
    try:
        with pytest.raises(RuntimeError, match="worker failed"):
            next(ts)
    finally:
        ts.close()
    # Trajectories shorter than the batch give no batch: the wait ends.
    ts = TrajectorySampler(tcfg, 100, num_workers=1, device="cpu",
                           timeout=0.5)
    try:
        with pytest.raises(TimeoutError):
            next(ts)
    finally:
        ts.close()
    assert all(not t.is_alive() for t in ts._threads)
    ts = TrajectorySampler.from_readers(tcfg, readers, BATCH, num_workers=1)
    ts.close()
    assert ts._queue.empty() and not ts._threads[0].is_alive()


@pytest.mark.parametrize("case", ["airfoil_windowed", "cylinder_bucketed"])
def test_rollout_iterator_equals_jax(root, case):
    jcfg, tcfg, _ = dataset(case, root)
    got = list(rollout_iterator(tcfg, device="cpu"))
    want = list(jax_rollout_iterator(jcfg))
    assert len(got) == len(want) >= 1
    for (tr, *ta), (jr, *ja) in zip(got, want):
        for a, b in zip(ta, ja):
            np.testing.assert_array_equal(a, b)
        assert tr.n_pad == jr.n_pad


def test_caches_are_each_packages_own(root, monkeypatch):
    """JAX and the port build in one directory: each writes and reads
    only its own npz caches."""
    jcfg, tcfg, files = dataset("airfoil_windowed", root)
    path = files[0]
    loaded = []
    real_load = np.load

    def spy(file, *a, **kw):
        loaded.append(os.path.basename(str(file)))
        return real_load(file, *a, **kw)

    monkeypatch.setattr(np, "load", spy)
    JaxReader(jcfg, path)
    jax_loads, loaded[:] = list(loaded), []
    TrajectoryReader(tcfg, path, device="cpu")
    port_loads = list(loaded)
    assert jax_loads and all("_tpu_" in n for n in jax_loads), jax_loads
    assert port_loads and all("_torch_" in n for n in port_loads), port_loads
    names = os.listdir(os.path.dirname(path))
    assert any("_torch_mmesh_" in n for n in names)
    assert any("_tpu_mmesh_" in n for n in names)


def test_auto_window_is_not_ported(tmp_path):
    """`window="auto"` is ported (`test_torch_port_auto_window.py` holds
    it against JAX); what it still refuses, before any build: node
    buckets (per-mesh widths do not stack), and a bare negative width,
    which the readers alone map to "auto"."""
    args = (str(tmp_path), "x", np.zeros((2, 0), int), 1, 4,
            np.zeros((4, 2)))
    with pytest.raises(ValueError, match="auto"):
        load_or_build_hierarchy(*args, window="auto", node_buckets=[128, 128])
    with pytest.raises(ValueError, match="auto"):
        load_or_build_hierarchy(*args, window=-1)
    assert not os.listdir(tmp_path)


def test_tfrecord_equals_jax(tmp_path):
    meta, example, _ = _make_meta_and_example()
    record = encode_example(example)
    got, want = tfrecord.parse_example(record), jax_tfrecord.parse_example(
        record)
    assert got == want
    a, b = (tfrecord.decode_trajectory(got, meta),
            jax_tfrecord.decode_trajectory(want, meta))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    src = tmp_path / "raw"
    src.mkdir()
    (src / "meta.json").write_text(json.dumps(meta))
    write_tfrecord(str(src / "train.tfrecord"), [record] * 2)
    write_tfrecord(str(src / "test.tfrecord"), [b"\xff\xff", record])
    assert (list(tfrecord.read_records(str(src / "test.tfrecord")))
            == list(jax_tfrecord.read_records(str(src / "test.tfrecord"))))
    tfrecord.convert_tfrecord_to_h5(str(src), str(tmp_path / "port"),
                                    meta["field_names"])
    jax_tfrecord.convert_tfrecord_to_h5(str(src), str(tmp_path / "jax"),
                                        meta["field_names"])
    fa = sorted(os.path.relpath(p, tmp_path / "jax")
                for p in glob.glob(str(tmp_path / "jax" / "*" / "*.h5")))
    fb = sorted(os.path.relpath(p, tmp_path / "port")
                for p in glob.glob(str(tmp_path / "port" / "*" / "*.h5")))
    assert fa == fb == ["test/1.h5", "train/0.h5", "train/1.h5"]
    for rel in fa:
        x, y = _h5(tmp_path / "jax" / rel), _h5(tmp_path / "port" / rel)
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k][0] == y[k][0]
            np.testing.assert_array_equal(x[k][1], y[k][1])


def test_corrupt_cache_is_rebuilt(tmp_path):
    """A truncated hierarchy or levels cache is rebuilt, not read."""
    _, tcfg = configs(str(tmp_path), **CASES["airfoil_windowed"])
    write(str(tmp_path), "synthetic_airfoil")
    path = sorted(glob.glob(str(tmp_path / "synthetic_airfoil" / "train" /
                                "*.h5")))[0]
    want = TrajectoryReader(tcfg, path, device="cpu")
    for cache in glob.glob(os.path.join(os.path.dirname(path),
                                        "*_torch_*.npz")):
        with open(cache, "r+b") as f:
            f.truncate(100)
    got = TrajectoryReader(tcfg, path, device="cpu")
    for a, b in zip(want.hierarchy.levels, got.hierarchy.levels):
        assert_same(a, b, "level")
