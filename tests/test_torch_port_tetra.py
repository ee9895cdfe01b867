"""The tetra side of the port's data against the JAX package: the tetra
block, its squeeze trajectory and the deforming-plate dataset writer bit
for bit from the same seeds; `TrajectoryReader` (a 3-D Morton order, world
positions of width 3, tetra cells) and the bucket plan on those files; a
depth-5 hierarchy of a 1,271-node block (levels 4 and 5 one node each)
table for table, and the deforming-plate model's forward on it.

The dataset: `generate_synthetic_tetra_dataset(n_nodes=600, n_frames=4,
seed=5)`, three train and one test trajectories, read at depth 2 with
window 256 and edge_block 512 in one size group. The forward: the
deforming-plate model at depth 5 cut to hidden 1 (latent 128) on the
`fused` method, the 1,271-node block Morton-ordered and bucketed alone
(window 256, edge_block 512), against JAX's `ell` method (the same
function on XLA: its `fused` kernels in interpret mode would take minutes
at this size), within 5e-4 of the largest |value| on the real rows. Every
other comparison is exact."""

import functools
import glob
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_data import assert_readers_equal
from test_torch_port_hierarchy import assert_same
from test_torch_port_train import assert_close
from test_torch_port_weights import jax_state_with_stats, port_simulator

from bsms_gnn_tpu.config import DatasetConfig as JaxDatasetConfig
from bsms_gnn_tpu.config import ModelConfig as JaxModelConfig
from bsms_gnn_tpu.data import synthetic as jax_synthetic
from bsms_gnn_tpu.data.pipeline import plan_buckets as jax_plan_buckets
from bsms_gnn_tpu.data.trajectory import TrajectoryReader as JaxReader
from bsms_gnn_tpu.graph.bistride import build_bistride_levels as jax_levels
from bsms_gnn_tpu.graph.hierarchy import pad_levels as jax_pad_levels
from bsms_gnn_tpu.models.simulator import simulator_forward
from bsms_gnn_tpu_torch.config import DatasetConfig, deforming_plate_config
from bsms_gnn_tpu_torch.data import synthetic
from bsms_gnn_tpu_torch.data.datasets import get_mask
from bsms_gnn_tpu_torch.data.pipeline import plan_buckets
from bsms_gnn_tpu_torch.data.trajectory import TrajectoryReader
from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels
from bsms_gnn_tpu_torch.graph.buckets import plan_buckets as plan_levels
from bsms_gnn_tpu_torch.graph.hierarchy import pad_levels, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.graph.order import reorder_mesh

LAYOUT = dict(window=256, edge_block=512)
NAME = "synthetic_deforming_plate"
FIELDS = ["node_type", "cells", "mesh_pos", "world_pos"]
BLOCK_NODES, BLOCK_DEPTH, FORWARD_TOL = 1271, 5, 5e-4


def h5(path):
    with h5py.File(path, "r") as f:
        return {k: (f[k].dtype, np.asarray(f[k])) for k in f}


@pytest.mark.parametrize("n,seed", [(20, 1), (1271, 0)])
def test_tetra_mesh_and_trajectory_equal_jax(n, seed):
    for a, b in zip(synthetic.make_tetra_mesh(n, np.random.default_rng(seed)),
                    jax_synthetic.make_tetra_mesh(
                        n, np.random.default_rng(seed))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    got = synthetic.generate_tetra_trajectory(n, 3, np.random.default_rng(4))
    want = jax_synthetic.generate_tetra_trajectory(n, 3,
                                                   np.random.default_rng(4))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["cells"].shape[-1] == 4 and got["world_pos"].shape[-1] == 3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The JAX writer's dataset (the port's is held equal to it below)."""
    root = str(tmp_path_factory.mktemp("tetra"))
    jax_synthetic.generate_synthetic_tetra_dataset(
        root, NAME, n_train=3, n_test=1, n_nodes=600, n_frames=4, seed=5)
    return root


def test_writer_equals_jax_bit_for_bit(tmp_path, root):
    synthetic.generate_synthetic_tetra_dataset(
        str(tmp_path), NAME, n_train=3, n_test=1, n_nodes=600, n_frames=4,
        seed=5)
    fa = sorted(os.path.relpath(p, root)
                for p in glob.glob(f"{root}/*/*/*.h5"))
    fb = sorted(os.path.relpath(p, tmp_path)
                for p in glob.glob(f"{tmp_path}/*/*/*.h5"))
    assert fa == fb and len(fa) == 4
    for rel in fa:
        x, y = h5(os.path.join(root, rel)), h5(os.path.join(tmp_path, rel))
        assert sorted(x) == sorted(y) == sorted(FIELDS), rel
        for k in x:
            assert x[k][0] == y[k][0], (rel, k)
            np.testing.assert_array_equal(x[k][1], y[k][1], err_msg=rel + k)


def configs(root):
    kw = dict(root=root, name=NAME, field_names=FIELDS,
              output_field_names=["world_pos"], mesh_type="tetra",
              consist_mesh=False, space_dim=3, unet_depth=2, size_buckets=1,
              **LAYOUT)
    return JaxDatasetConfig(**kw), DatasetConfig(**kw)


def test_plan_and_readers_equal_jax(root):
    """The bucket plan (one size group) and each file's reader: node_in
    [world 3, mesh 3, node type], the targets, the deforming-plate mask,
    the 3-D Morton order and every bucketed table."""
    jcfg, tcfg = configs(root)
    jplan, plan = jax_plan_buckets(jcfg, "train"), plan_buckets(tcfg, "train")
    assert len(plan.groups) == len(jplan.groups) == 1
    files = sorted(glob.glob(os.path.join(root, NAME, "*", "*.h5")))
    for path in files:
        assert plan.for_file(path) == jplan.for_file(path)
        jr = JaxReader(jcfg, path, **jplan.for_file(path))
        tr = TrajectoryReader(tcfg, path, device="cpu",
                              **plan.for_file(path))
        assert_readers_equal(jr, tr, bucketed=True)
        assert tr.node_in.shape[-1] == 7 and tr.node_perm is not None
        n = tr.n_nodes
        want = get_mask(NAME, tr.node_in[:, :n, 6:7].astype(np.int32))
        np.testing.assert_array_equal(tr.node_mask[:, :n], want)
        assert tr.hierarchy.levels[0].fiber.shape[-1] == 4
    assert any(lv.resid is not None for lv in tr.hierarchy.levels)


@functools.lru_cache(maxsize=None)
def block():
    """The 1,271-node block, Morton-ordered, bucketed alone at depth 5:
    (JAX hierarchy, port hierarchy, pos, node_type)."""
    pos, cells, node_type = synthetic.make_tetra_mesh(
        BLOCK_NODES, np.random.default_rng(0))
    pos, cells, (node_type,), _ = reorder_mesh(pos, cells, (node_type,))
    pos = pos.astype(np.float64)
    edges = to_flat_edge(cells, "tetra")
    levels = build_bistride_levels(edges, BLOCK_DEPTH, len(pos), pos)
    plan = plan_levels([levels], DatasetConfig(
        consist_mesh=False, pad_multiple=128, size_buckets=1, **LAYOUT))
    kw = dict(pos=pos, **LAYOUT, **plan.for_mesh(0))
    hj = jax_pad_levels(jax_levels(edges, BLOCK_DEPTH, len(pos), pos), 128,
                        **kw)
    return hj, pad_levels(levels, 128, **kw), pos, node_type


def test_depth5_block_hierarchy_equals_jax():
    hj, ht, _, _ = block()
    assert [g.n_nodes for g in ht.levels][-2:] == [1, 1]
    assert [g.n_edges for g in ht.levels][-2:] == [0, 0]
    assert ht.levels[0].resid is not None
    for l, (a, b) in enumerate(zip(hj.levels, ht.levels)):
        assert_same(a, b, f"level{l}")
    for a, b in zip(hj.transitions, ht.transitions):
        np.testing.assert_array_equal(b.pool_ids, a.pool_ids)
        np.testing.assert_array_equal(b.unpool_inv, a.unpool_inv)
        assert a.down_op is None and b.down_op is None


def test_depth5_block_forward_matches_jax():
    """The deforming-plate model at depth 5 on the block: the port on
    `fused` (kernel 13, the residual branch, kernel 9, the explicit convs:
    their plain versions here) against JAX on `ell`, f32, a frame of the
    squeeze."""
    hj, ht, pos, node_type = block()
    jcfg = JaxModelConfig(latent_dim=128, hidden_layer=1,
                          unet_depth=BLOCK_DEPTH, out_dim=3, pos_dim=3,
                          world_edges=True, aggregation="ell")
    state = jax_state_with_stats(jcfg)
    sim = port_simulator(deforming_plate_config(hidden_layer=1).model, state)
    n, n_pad = len(pos), ht.levels[0].n_pad_nodes
    node_in = np.zeros((n_pad, 7), np.float32)
    s = 1.0 - 0.2 * np.sin(0.9) * pos[:, 2]
    node_in[:n, :3] = pos * s[:, None]
    node_in[:n, 3:6] = pos
    node_in[:n, 6] = node_type[:, 0]
    mask = np.zeros((n_pad, 1), np.float32)
    mask[:n] = get_mask(NAME, node_type)
    want = jax.jit(lambda ni, m: simulator_forward(
        state.params, state.norm_in, state.norm_out, hj, ni, m, jcfg))(
        jnp.asarray(node_in), jnp.asarray(mask))
    with torch.no_grad():
        got = sim(to_device(ht, "cpu"), torch.tensor(node_in),
                  torch.tensor(mask))
    assert bool(torch.isfinite(got).all())
    assert_close(got[:n], np.asarray(want)[:n], FORWARD_TOL, "forward")
