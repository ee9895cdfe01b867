"""The port's partition plans (`bsms_gnn_tpu_torch/parallel/partition.py`)
against the JAX package's `build_partition`, bit for bit: every array of
every level, ghost layout, residual table and transition, and every static
field, at S = 2, 4 and 8 shards, for each `balance` mode, on plain and
ghost layouts, unwindowed and at window 128, with `replicate_floor` and
`ghost_floor`; then a 24×24 grid with scrambled ids whose windowed shard
layouts leave edges out of their windows (the residual sub-levels and the
compact tables, unified over the shards); the node permutation's round
trip; `shard_hierarchy`; the ghost `_pad_level` against JAX's; and the
kernels' row tables that `to_device` builds on a shard's ghost layout."""

import dataclasses

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from conftest import make_grid_mesh

from bsms_gnn_tpu.graph.bistride import build_bistride_levels as jax_levels
from bsms_gnn_tpu.graph.csr import CsrGraph as JaxCsr
from bsms_gnn_tpu.graph.hierarchy import _pad_level as jax_pad_level
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.parallel.partition import build_partition as jax_partition
from bsms_gnn_tpu.parallel.partition import partition_nodes as jax_part_nodes
from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels
from bsms_gnn_tpu_torch.graph.csr import CsrGraph
from bsms_gnn_tpu_torch.graph.hierarchy import _pad_level, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.parallel.partition import (
    BALANCE_MODES,
    build_partition,
    partition_nodes,
    shard_hierarchy,
    unpartition_nodes,
)

# (keywords of build_partition) per layout, on the 9×9 grid at depth 2:
# replicate_floor 25 replicates the bottom level, 45 levels 1 and 2;
# ghost_floor 45 keeps levels 1 and 2 on the plain halo layout.
LAYOUTS = {
    "plain": dict(),
    "ghost": dict(local_layouts=True),
    "ghost_w128": dict(local_layouts=True, window=128),
    "ghost_repl25": dict(local_layouts=True, replicate_floor=25),
    "ghost_floor45": dict(local_layouts=True, ghost_floor=45),
    "plain_repl45": dict(replicate_floor=45),
}


def assert_bitwise(want, got, path):
    """Every field of the port's object equals the JAX object's field of
    the same name: arrays in dtype, shape and every bit, the rest by ==.
    The port's own fields (the device tables `to_device` sets) are None."""
    if dataclasses.is_dataclass(got):
        assert want is not None, path
        for f in dataclasses.fields(got):
            if not hasattr(want, f.name):
                assert getattr(got, f.name) is None, f"{path}.{f.name}"
                continue
            assert_bitwise(getattr(want, f.name), getattr(got, f.name),
                           f"{path}.{f.name}")
    elif isinstance(got, tuple):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_bitwise(w, g, f"{path}[{i}]")
    elif got is None:
        assert want is None, path
    elif isinstance(got, np.ndarray):
        want = np.asarray(want)
        assert (want.dtype, want.shape) == (got.dtype, got.shape), path
        assert want.tobytes() == got.tobytes(), path
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def grid():
    pos, cells = make_grid_mesh(9, 9)
    jl = jax_levels(jax_flat_edge(cells, "tri"), 2, len(pos), pos)
    tl = build_bistride_levels(to_flat_edge(cells, "tri"), 2, len(pos), pos)
    return pos, jl, tl


@pytest.fixture(scope="module")
def scrambled():
    """A 24×24 grid with scrambled ids at depth 3: its windowed shard
    layouts leave edges out of their windows."""
    pos, cells = make_grid_mesh(24, 24)
    perm = np.random.default_rng(0).permutation(len(pos))
    inv = np.empty(len(pos), np.int64)
    inv[perm] = np.arange(len(pos))
    pos, cells = pos[perm], inv[cells]
    jl = jax_levels(jax_flat_edge(cells, "tri"), 3, len(pos), pos)
    tl = build_bistride_levels(to_flat_edge(cells, "tri"), 3, len(pos), pos)
    return pos, jl, tl


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("balance", BALANCE_MODES)
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_plan_matches_jax_bit_for_bit(grid, n_shards, balance, layout):
    pos, jl, tl = grid
    kw = dict(block=32, balance=balance, **LAYOUTS[layout])
    want = jax_partition(jl, n_shards, 96, pos, **kw)
    got = build_partition(tl, n_shards, 96, pos, **kw)
    assert_bitwise(want, got, "plan")
    levels = got.hierarchy.levels
    if "repl" in layout:
        assert levels[-1].replicated and not levels[0].replicated
    if layout == "ghost_floor45":
        assert levels[0].local is not None and levels[-1].local is None


@pytest.mark.parametrize("kw", [
    dict(window=128),
    dict(window=128, edge_block=512, replicate_floor=100),
    dict(window=256, edge_block=512, balance="opt"),
], ids=["w128", "w128_eb512_repl100", "w256_eb512_opt"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_windowed_plan_with_residuals_matches_jax(scrambled, n_shards, kw):
    pos, jl, tl = scrambled
    want = jax_partition(jl, n_shards, 640, pos, local_layouts=True, **kw)
    got = build_partition(tl, n_shards, 640, pos, local_layouts=True, **kw)
    assert_bitwise(want, got, "plan")
    # Level 0 leaves edges out of its windows on every shard layout: both
    # residual forms, stacked.
    lg = got.hierarchy.levels[0].local
    assert lg.resid is not None and lg.cresid is not None


def test_partition_round_trip_matches_jax(grid):
    pos, jl, tl = grid
    n = len(pos)
    plan = build_partition(tl, 4, 96, pos, block=32, local_layouts=True)
    x = np.zeros((2, 96, 5), np.float32)
    x[:, :n] = np.random.default_rng(0).standard_normal((2, n, 5))
    sh = partition_nodes(plan, x)
    assert sh.shape == (4, 2, plan.perm.shape[1], 5)
    jplan = jax_partition(jl, 4, 96, pos, block=32, local_layouts=True)
    np.testing.assert_array_equal(sh, jax_part_nodes(jplan, x))
    np.testing.assert_array_equal(unpartition_nodes(plan, sh), x)
    np.testing.assert_array_equal(
        unpartition_nodes(plan, partition_nodes(plan, x[0])), x[0])


def test_shard_hierarchy_takes_each_shard(grid):
    pos, _, tl = grid
    plan = build_partition(tl, 4, 96, pos, block=32, local_layouts=True,
                           window=128, replicate_floor=25)
    for s in range(4):
        h = shard_hierarchy(plan, s)
        for lvl, full in zip(h.levels, plan.hierarchy.levels):
            assert (lvl.replicated, lvl.n_shards, lvl.halo_width) == (
                full.replicated, full.n_shards, full.halo_width)
            np.testing.assert_array_equal(lvl.halo_send, full.halo_send[s])
            np.testing.assert_array_equal(lvl.local.senders,
                                          full.local.senders[s])
            assert lvl.local.window == full.local.window
        for t, full in zip(h.transitions, plan.hierarchy.transitions):
            np.testing.assert_array_equal(t.pool_ids, full.pool_ids[s])
            assert (t.pool_mask is None) == (full.pool_mask is None)
            if t.pool_mask is not None:
                np.testing.assert_array_equal(t.pool_mask, full.pool_mask[s])
    with pytest.raises(ValueError, match="outside"):
        shard_hierarchy(plan, 4)


@pytest.mark.parametrize("force", [False, True])
def test_ghost_pad_level_matches_jax(scrambled, force):
    """`_pad_level` on a shard's local (ghost) edges, extended positions
    and weights, plain and with both residual forms forced, against JAX's
    on the same inputs, array for array."""
    pos, _, tl = scrambled
    plan = build_partition(tl, 2, 640, pos, local_layouts=True, window=128)
    lg = shard_hierarchy(plan, 1).levels[0].local
    real = lg.edge_mask > 0
    edges = np.stack([lg.senders[real], lg.receivers[real]]).astype(np.int64)
    n_ext = int(lg.n_nodes)
    ext_pos = np.random.default_rng(1).standard_normal((n_ext, 2))
    ec = np.random.default_rng(2).uniform(size=edges.shape[1])
    kw = dict(resid_e_pad_min=1024, force_resid=True) if force else {}
    want = jax_pad_level(JaxCsr(edges, n_ext), lg.n_pad_nodes,
                         lg.n_pad_edges, ec, ext_pos, edge_block=128,
                         window=128, force_cresid=force, **kw)
    got = _pad_level(CsrGraph(edges, n_ext), lg.n_pad_nodes, ec, ext_pos,
                     edge_block=128, window=128, e_pad_min=lg.n_pad_edges,
                     compact=not force, force_cresid=force, **kw)
    if not force:  # the port reads the compact tables, not the sub-level
        want = want.replace(resid=None)
    assert_bitwise(want, got, "level")
    assert (got.resid is not None) == force and got.cresid is not None


def test_to_device_builds_ghost_tables(scrambled):
    """A shard's ghost layout on a device carries the tables of kernels 1,
    2, 7 and 8, over its extended rows: every in-window slot listed once
    by its receiver row and once by its sender row, every compact row
    once by its receiver."""
    pos, _, tl = scrambled
    plan = build_partition(tl, 2, 640, pos, local_layouts=True, window=128,
                           edge_block=512, replicate_floor=100)
    for s in range(2):
        h = to_device(shard_hierarchy(plan, s), "cpu")
        for lvl in h.levels:
            lg = lvl.local
            live = (lg.send_win < lg.window).numpy()
            covered = live & (lg.edge_mask > 0).numpy()
            assert torch.equal(torch.sort(lg.win_row_slots).values,
                               torch.from_numpy(np.flatnonzero(covered)).int())
            assert int(lg.send_row_ptr[-1]) == int(live.sum())
            assert lg.row_ptr.shape == (lg.n_pad_nodes + 1,)
            assert lg.row_send.shape == lg.row_slots.shape
            cr = lg.cresid
            if cr is not None:
                assert int(cr.cr_row_ptr[-1]) == cr.n_real
            assert isinstance(lvl.halo_send, torch.Tensor)
