"""The port's graph modules against the JAX package's, array for array:
mesh edges, Morton order, the synthetic airfoil and sphere meshes, and the
padded hierarchy, windowed and not (every level, its compact residual and
fiber stream, every transition operator and its compact residual), plus
the device tables `to_device` derives: the chunk ranges, the compact
residuals' receiver ranges, and the per-row slot lists of the segment sums
against the TPU kernel's one-hot."""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import make_grid_mesh

from bsms_gnn_tpu.data.synthetic import make_graded_airfoil_mesh as jax_airfoil
from bsms_gnn_tpu.data.synthetic import make_sphere_mesh as jax_sphere
from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.graph.order import reorder_mesh as jax_reorder
from bsms_gnn_tpu.ops.pallas.fused_gmp import _chunk_tables
from bsms_gnn_tpu_torch.data.synthetic import (
    generate_inflating_trajectory,
    make_graded_airfoil_mesh,
    make_grid_strip_mesh,
    make_sphere_mesh,
)
from bsms_gnn_tpu_torch.graph.hierarchy import (
    CompactResid,
    build_hierarchy,
    to_device,
)
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.graph.order import reorder_mesh

DEVICE_TABLES = ("chunk_ptr", "chunk_block", "cr_rows", "cr_row_ptr",
                 "cr_long", "send_row_ptr", "send_row_slots", "send_long",
                 "row_ptr", "row_slots", "row_send", "row_long",
                 "win_row_ptr", "win_row_slots", "win_long")


def assert_same(jax_obj, port_obj, path, skip=()):
    """Every field of the port's dataclass but those in `skip` equals the
    JAX object's field of the same name: integers exactly, floats within
    1e-12."""
    for f in dataclasses.fields(port_obj):
        if f.name in DEVICE_TABLES or f.name in skip:
            continue
        want, got = getattr(jax_obj, f.name), getattr(port_obj, f.name)
        where = f"{path}.{f.name}"
        if dataclasses.is_dataclass(got):
            assert want is not None, where
            assert_same(want, got, where)
        elif isinstance(got, np.ndarray):
            want = np.asarray(want)
            assert (want.shape, want.dtype) == (got.shape, got.dtype), where
            if got.dtype.kind == "f":
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                           err_msg=where)
            else:
                np.testing.assert_array_equal(got, want, err_msg=where)
        else:
            assert got == want, where


def scrambled_grid():
    pos, cells = make_grid_mesh(24, 24)
    perm = np.random.default_rng(0).permutation(len(pos))
    inv = np.empty(len(pos), np.int64)
    inv[perm] = np.arange(len(pos))
    return pos[perm], inv[cells]


def morton_airfoil():
    pos, cells, _ = make_graded_airfoil_mesh(700, np.random.default_rng(1))
    pos, cells, _, _ = reorder_mesh(pos, cells)
    return pos.astype(np.float64), cells


def morton_strip():
    """The flag case's cloth strip: 1,568 nodes of a 2-D mesh,
    Morton-ordered."""
    pos, cells, _ = make_grid_strip_mesh(1579, ny=32)
    pos, cells, _, _ = reorder_mesh(pos, cells)
    return pos.astype(np.float64), cells


def sphere():
    pos, cells, _ = make_sphere_mesh(600, np.random.default_rng(0))
    return pos.astype(np.float64), cells


CASES = {
    "grid_w128_eb512_d3": (scrambled_grid, 3, dict(edge_block=512, window=128)),
    "airfoil_w256_eb512_d2": (morton_airfoil, 2,
                              dict(edge_block=512, window=256)),
    "grid_unwindowed_d3": (scrambled_grid, 3, dict()),
    "strip_morton_w256_eb512_d5": (morton_strip, 5,
                                   dict(edge_block=512, window=256)),
    "sphere_unwindowed_d3": (sphere, 3, dict()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hierarchy_matches_jax_array_for_array(case):
    make, depth, kw = CASES[case]
    pos, cells = make()
    hj = jax_build(jax_flat_edge(cells, "tri"), depth, len(pos), pos, **kw)
    ht = build_hierarchy(to_flat_edge(cells, "tri"), depth, len(pos), pos,
                         **kw)
    assert len(ht.levels) == len(hj.levels) == depth + 1
    assert ht.depth == hj.depth == depth
    for l, (a, b) in enumerate(zip(hj.levels, ht.levels)):
        # An unbucketed build keeps its out-of-window edges as compact
        # tables only: the model never reads the mini residual sub-level
        # JAX builds beside them.
        assert_same(a, b, f"level{l}", skip=("resid",))
        assert b.resid is None
        assert b.fiber_t is not None
    for l, (a, b) in enumerate(zip(hj.transitions, ht.transitions)):
        assert_same(a.down_op, b.down_op, f"trans{l}.down")
        assert_same(a.up_op, b.up_op, f"trans{l}.up")
    if kw.get("window"):
        assert any(g.cresid is not None for g in ht.levels)
        assert any(t.down_op.cresid is not None for t in ht.transitions)
    if pos.shape[1] == 2:  # the static fiber [Δpos 2, ‖Δpos‖], bias row 3
        for b in ht.levels:
            assert b.fiber.shape[1] == 3
            np.testing.assert_array_equal(b.fiber_t[3], 1.0)
            np.testing.assert_array_equal(b.fiber_t[4:], 0.0)


def test_strip_mesh_matches_jax():
    from bsms_gnn_tpu.data.synthetic import make_grid_strip_mesh as jax_strip

    for a, b in zip(jax_strip(1579, ny=32), make_grid_strip_mesh(1579, ny=32)):
        np.testing.assert_array_equal(a, b)


def test_mesh_order_and_airfoil_match_jax():
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    for a, b in zip(jax_airfoil(900, rng_j), make_graded_airfoil_mesh(900, rng_t)):
        np.testing.assert_array_equal(a, b)
    pos, cells, nt = make_graded_airfoil_mesh(900, np.random.default_rng(5))
    for a, b in zip(jax_reorder(pos, cells, (nt,)), reorder_mesh(pos, cells, (nt,))):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(jax_flat_edge(cells, "tri"),
                                  to_flat_edge(cells, "tri"))
    for a, b in zip(jax_sphere(700, np.random.default_rng(6)),
                    make_sphere_mesh(700, np.random.default_rng(6))):
        np.testing.assert_array_equal(a, b)


def test_inflating_trajectory_matches_jax():
    from bsms_gnn_tpu.data.synthetic import (
        generate_inflating_trajectory as jax_traj,
    )

    want = jax_traj(300, 4, np.random.default_rng(2))
    got = generate_inflating_trajectory(300, 4, np.random.default_rng(2))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_device_tables_follow_the_layout():
    pos, cells = scrambled_grid()
    kw = dict(edge_block=512, window=128)
    hj = jax_build(jax_flat_edge(cells, "tri"), 3, len(pos), pos, **kw)
    hd = to_device(build_hierarchy(to_flat_edge(cells, "tri"), 3, len(pos),
                                   pos, **kw), "cpu")
    ops = [(a, b) for ta, tb in zip(hj.transitions, hd.transitions)
           for a, b in ((ta.down_op, tb.down_op), (ta.up_op, tb.up_op))]
    for jl, tl in list(zip(hj.levels, hd.levels)) + ops:
        assert tl.send_win.dtype == torch.int32
        assert tl.ew.dtype == torch.float32  # f64 arrays land as f32
        chunk_block, _, _ = _chunk_tables(jl)
        np.testing.assert_array_equal(tl.chunk_block.numpy(),
                                      np.asarray(chunk_block))
        ptr = tl.chunk_ptr.numpy()
        assert ptr[0] == 0 and ptr[-1] == tl.n_pad_edges // tl.edge_block
        np.testing.assert_array_equal(
            np.repeat(np.arange(len(ptr) - 1), np.diff(ptr)),
            tl.chunk_block.numpy())
        cr = tl.cresid
        if cr is not None:
            # Receiver cr_rows[k] owns compact rows cr_row_ptr[k] ..
            # cr_row_ptr[k+1]: the real rows with that receiver in JAX's
            # layout, each once; no pad row.
            assert isinstance(cr, CompactResid)
            jr = np.asarray(jl.cresid.receivers)[:cr.n_real]
            rows, ptr = cr.cr_rows.numpy(), cr.cr_row_ptr.numpy()
            np.testing.assert_array_equal(rows, np.unique(jr))
            assert ptr[0] == 0 and ptr[-1] == cr.n_real
            for k, r in enumerate(rows):
                np.testing.assert_array_equal(
                    np.arange(ptr[k], ptr[k + 1]), np.flatnonzero(jr == r))


def _one_hot_rows(layout):
    """The JAX kernel's one-hot semantics on `layout`, in numpy: for each
    slot, the output row its chunk's one-hot adds it to (-1: no row), from
    the JAX package's own chunk → block table."""
    chunk_block, _, _ = _chunk_tables(layout)
    be = layout.edge_block
    base = np.repeat(np.asarray(chunk_block), be) * 128
    local = np.asarray(layout.receivers) - base
    return np.where((local >= 0) & (local < 128), base + local, -1)


@pytest.mark.parametrize("case", ["sphere_unwindowed_d3",
                                  "grid_w128_eb512_d3"])
def test_row_tables_follow_the_one_hot(case):
    """row_slots lists, row by row and in slot order, exactly the slots the
    TPU kernel's one-hot adds to each row, pad slots included: the last
    block's land on row n_pad − 1, every other block's nowhere. row_send
    is reverse_perm of row_slots."""
    make, depth, kw = CASES[case]
    pos, cells = make()
    hj = jax_build(jax_flat_edge(cells, "tri"), depth, len(pos), pos, **kw)
    hd = to_device(build_hierarchy(to_flat_edge(cells, "tri"), depth,
                                   len(pos), pos, **kw), "cpu")
    ops = [(a, b) for ta, tb in zip(hj.transitions, hd.transitions)
           for a, b in ((ta.down_op, tb.down_op), (ta.up_op, tb.up_op))]
    dropped = 0  # pad slots of blocks other than the last
    for jl, tl in list(zip(hj.levels, hd.levels)) + ops:
        row = _one_hot_rows(jl)
        n_pad = tl.n_pad_nodes
        ptr, slots = tl.row_ptr.numpy(), tl.row_slots.numpy()
        assert ptr.dtype == slots.dtype == np.int32
        assert ptr[0] == 0 and ptr[-1] == len(slots) == (row >= 0).sum()
        for r in np.unique(np.r_[row[row >= 0], [0, n_pad - 1]]):
            np.testing.assert_array_equal(slots[ptr[r]:ptr[r + 1]],
                                          np.flatnonzero(row == r))
        pad = np.asarray(jl.receivers) == n_pad - 1
        last_block = np.arange(tl.n_pad_edges) >= np.asarray(
            jl.recv_indptr)[n_pad - 128]
        np.testing.assert_array_equal(slots[ptr[n_pad - 1]:],
                                      np.flatnonzero(pad & last_block))
        dropped += int((pad & ~last_block).sum())
        if getattr(tl, "row_send", None) is not None:
            np.testing.assert_array_equal(
                tl.row_send.numpy(), np.asarray(jl.reverse_perm)[slots])
    assert dropped > 0
