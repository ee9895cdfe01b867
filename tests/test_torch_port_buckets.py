"""The port's bucketed hierarchies of variable-mesh datasets against the
JAX package on the CPU: the bucket plan (`graph/buckets.py` against
`plan_buckets` on a dataset the JAX generator writes), the bucketed
hierarchy array for array (the levels, their residual sub-levels, the pool
and unpool maps, no TransOp, no compact residual; windowed, with a forced
empty residual, and unwindowed), the device row tables of the skip-empty
and tail-chunk layouts against the TPU kernel's one-hot, kernel 9's and
kernel 1's level form's plain versions against the JAX kernels (interpret
mode), and pool / unpool with their gradients.

The group: two Morton-ordered Delaunay meshes (450 and 600 nodes, depth 2,
window 256, edge_block 512), planned into one size group. The 450-node
mesh's layouts are smaller than the group's buckets, so its level 0 ends
in tail chunks of pad slots, and its residual sub-level too.

Tolerances, relative to the largest |value| of the reference: the plain
kernels sum the same f32 values as the JAX kernels in another order, 1e-6
on the rows of real nodes; row n_pad − 1, where the last block's pad slots
(tail chunks included) land, sums hundreds of rows and is held at 1e-5.
bf16 rows add exactly in f32 on both sides; kernel 1 rounds ew to bf16 on
both sides. Pool / unpool move values and are held exactly.
"""

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

from test_torch_port_hierarchy import _one_hot_rows, assert_same

from bsms_gnn_tpu.config import DatasetConfig as JaxDatasetConfig
from bsms_gnn_tpu.data import generate_synthetic_dataset
from bsms_gnn_tpu.data.pipeline import plan_buckets as jax_plan_buckets
from bsms_gnn_tpu.graph.bistride import build_bistride_levels as jax_levels
from bsms_gnn_tpu.graph.hierarchy import pad_levels as jax_pad_levels
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.ops.pallas.segment_sum import (
    segment_sum_accum_raw as jax_accum,
)
from bsms_gnn_tpu.ops.pallas.segment_sum import (
    segment_sum_accum_send_raw as jax_accum_send,
)
from bsms_gnn_tpu.ops.pallas.windowed import windowed_conv_raw
from bsms_gnn_tpu.ops.pool import pool_nodes as jax_pool
from bsms_gnn_tpu.ops.pool import unpool_nodes as jax_unpool
from bsms_gnn_tpu_torch.config import DatasetConfig
from bsms_gnn_tpu_torch.data.synthetic import make_delaunay_mesh
from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels
from bsms_gnn_tpu_torch.graph.buckets import plan_buckets
from bsms_gnn_tpu_torch.graph.hierarchy import NODE_BLOCK, pad_levels, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.graph.order import reorder_mesh
from bsms_gnn_tpu_torch.ops.kernels import segment_sum_accum as ssa
from bsms_gnn_tpu_torch.ops.kernels.windowed import windowed_conv_plain
from bsms_gnn_tpu_torch.ops.pool import pool_nodes, unpool_nodes

MESHES, DEPTH, WINDOW, EDGE_BLOCK, C = ((450, 5), (600, 4)), 2, 256, 512, 128
REAL_TOL, PAD_ROW_TOL = 1e-6, 1e-5
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def dataset_config(window):
    return DatasetConfig(consist_mesh=False, pad_multiple=128,
                         edge_block=EDGE_BLOCK, size_buckets=1, window=window)


@functools.lru_cache(maxsize=None)
def group(window):
    """(meshes (pos f64, cells, node_type), the port's plan, per mesh (JAX
    hierarchy, port hierarchy)) of the two meshes at `window`
    (Morton-ordered when windowed)."""
    meshes = []
    for n, seed in MESHES:
        pos, cells, node_type = make_delaunay_mesh(
            n, np.random.default_rng(seed))
        if window:
            pos, cells, (node_type,), _ = reorder_mesh(pos, cells,
                                                       (node_type,))
        meshes.append((pos.astype(np.float64), cells, node_type))
    levels = [build_bistride_levels(to_flat_edge(c, "tri"), DEPTH, len(p), p)
              for p, c, _ in meshes]
    plan = plan_buckets(levels, dataset_config(window))
    assert len(plan.groups) == 1
    pairs = []
    for i, ((pos, cells, _), lv) in enumerate(zip(meshes, levels)):
        kw = dict(pos=pos, edge_block=EDGE_BLOCK, window=window,
                  **plan.for_mesh(i))
        jl = jax_levels(jax_flat_edge(cells, "tri"), DEPTH, len(pos), pos)
        pairs.append((jax_pad_levels(jl, 128, **kw), pad_levels(lv, 128, **kw)))
    return meshes, plan, pairs


@functools.lru_cache(maxsize=None)
def forced():
    """The 600-node mesh padded as a group whose bucket gives level 1 a
    residual it does not have: an all-pad residual sub-level."""
    meshes, plan, _ = group(WINDOW)
    pos, cells, _ = meshes[1]
    kw = plan.for_mesh(1)
    assert kw["resid_buckets"][1] == (0, 0)
    kw["resid_buckets"] = [kw["resid_buckets"][0], (128, 1),
                           *kw["resid_buckets"][2:]]
    kw.update(pos=pos, edge_block=EDGE_BLOCK, window=WINDOW)
    jl = jax_levels(jax_flat_edge(cells, "tri"), DEPTH, len(pos), pos)
    pl = build_bistride_levels(to_flat_edge(cells, "tri"), DEPTH, len(pos),
                               pos)
    return jax_pad_levels(jl, 128, **kw), pad_levels(pl, 128, **kw)


def _tail_chunks(layout):
    """Chunks of the last block beyond what its real edges need."""
    n_pad, eb = layout.n_pad_nodes, layout.edge_block
    start = int(np.asarray(layout.recv_indptr)[n_pad - NODE_BLOCK])
    real = int((np.asarray(layout.receivers)[np.asarray(layout.edge_mask) > 0]
                >= n_pad - NODE_BLOCK).sum())
    need = -(-max(real, 0 if layout.skip_empty else 1) // eb)
    return (layout.n_pad_edges - start) // eb - need


# -- the hierarchy ---------------------------------------------------------


@pytest.mark.parametrize("case", ["windowed", "forced", "unwindowed"])
def test_bucketed_hierarchy_matches_jax(case):
    if case == "forced":
        pairs = [forced()]
    else:
        pairs = group(WINDOW if case == "windowed" else 0)[2]
    for hj, ht in pairs:
        shapes = [(g.n_pad_nodes, g.n_pad_edges) for g in ht.levels]
        assert shapes == [(g.n_pad_nodes, g.n_pad_edges) for g in hj.levels]
        for l, (a, b) in enumerate(zip(hj.levels, ht.levels)):
            assert_same(a, b, f"level{l}")
            assert b.cresid is None
            assert (b.resid is None) == (a.resid is None)
            if b.resid is not None:
                assert b.resid.skip_empty and b.resid.edge_block == 128
        for l, (a, b) in enumerate(zip(hj.transitions, ht.transitions)):
            assert a.down_op is None and b.down_op is None and b.up_op is None
            np.testing.assert_array_equal(b.pool_ids, np.asarray(a.pool_ids))
            np.testing.assert_array_equal(b.unpool_inv,
                                          np.asarray(a.unpool_inv))
    if case == "windowed":
        # Both meshes land on the group's shapes; the small one's level 0
        # and its residual end in tail chunks.
        (_, h0), (_, h1) = pairs
        for a, b in zip(h0.levels, h1.levels):
            assert (a.n_pad_nodes, a.n_pad_edges) == (b.n_pad_nodes,
                                                      b.n_pad_edges)
        assert _tail_chunks(h0.levels[0]) > 0
        assert _tail_chunks(h0.levels[0].resid) > 0
    if case == "forced":
        r = pairs[0][1].levels[1].resid
        assert r.n_edges == 0 and r.n_pad_edges == 128


@pytest.mark.parametrize("case", ["windowed", "forced"])
def test_row_tables_of_skip_empty_and_tail_layouts(case):
    """Each residual sub-level's row table (and level 0's, with its tail
    chunks) lists, row by row, exactly the slots the TPU kernel's one-hot
    adds to that row: blocks that own no chunk list nothing, and the tail
    chunks belong to the last block, their pad slots to row n_pad − 1."""
    if case == "forced":
        hj, ht = forced()
        hd = to_device(ht, "cpu")
        layouts = [(hj.levels[1].resid, hd.levels[1].resid)]
    else:
        hj, ht = group(WINDOW)[2][0]
        hd = to_device(ht, "cpu")
        layouts = [(hj.levels[0], hd.levels[0]),
                   (hj.levels[0].resid, hd.levels[0].resid)]
    for jl, tl in layouts:
        row = _one_hot_rows(jl)
        ptr, slots = tl.row_ptr.numpy(), tl.row_slots.numpy()
        n_pad = tl.n_pad_nodes
        assert ptr[-1] == len(slots) == (row >= 0).sum()
        for r in range(n_pad):
            np.testing.assert_array_equal(slots[ptr[r]:ptr[r + 1]],
                                          np.flatnonzero(row == r))
        assert _tail_chunks(jl) > 0
        if case == "forced":  # blocks with no chunk, then the tail chunk
            chunks = np.diff(tl.chunk_ptr.numpy())
            assert chunks[-1] == 1 and chunks[:-1].sum() == 0
            assert ptr[n_pad - 1] == 0 and len(slots) == 128


def _dataset(root, seed):
    """A variable-mesh synthetic cylinder_flow dataset written by the JAX
    generator (four meshes of 300–600 nodes), and the JAX config that
    plans it."""
    generate_synthetic_dataset(root, "synthetic_cylinder_flow", n_train=3,
                               n_test=1, n_nodes=600, n_frames=2,
                               consistent_mesh=False, with_density=False,
                               seed=seed)
    return JaxDatasetConfig(name="synthetic_cylinder_flow", root=root,
                            unet_depth=DEPTH, consist_mesh=False,
                            edge_block=EDGE_BLOCK, size_buckets=2)


@pytest.mark.parametrize("window", [WINDOW, 0])
def test_plan_matches_jax_plan_buckets(tmp_path, window):
    """The port's plan over the meshes read back from the dataset's files
    (train then test, as the JAX planner lists them): every group's node,
    edge, ELL and residual buckets, and each mesh's group."""
    jcfg = _dataset(str(tmp_path), 11)
    jcfg.window = window
    want = jax_plan_buckets(jcfg, "train")
    paths = (sorted(glob.glob(str(tmp_path / "*" / "train" / "*.h5")))
             + sorted(glob.glob(str(tmp_path / "*" / "test" / "*.h5"))))
    levels = []
    for path in paths:
        with h5py.File(path, "r") as f:
            cells = np.asarray(f["cells"][0])
            pos = np.asarray(f["mesh_pos"][0], np.float64)
        if window:
            pos, cells, _, _ = reorder_mesh(pos, cells)
        levels.append(build_bistride_levels(to_flat_edge(cells, "tri"),
                                            DEPTH, len(pos), pos))
    got = plan_buckets(levels, DatasetConfig(
        consist_mesh=False, edge_block=EDGE_BLOCK, size_buckets=2,
        window=window))
    assert len(got.groups) == len(want.groups) == 2
    for g, w in zip(got.groups, want.groups):
        for k in ("node_buckets", "edge_buckets", "ell_buckets"):
            assert g[k] == list(w[k]), k
        if window:
            assert g["resid_buckets"] == [list(r) for r in w["resid_buckets"]]
            assert any(r[0] for r in g["resid_buckets"])
        else:
            assert g["resid_buckets"] is None and w["resid_buckets"] is None
    for i, path in enumerate(paths):
        key = os.path.join(os.path.basename(os.path.dirname(path)),
                           os.path.basename(path))
        assert got.mesh_group[i] == want.file_group[key]


def test_consistent_mesh_has_no_plan():
    with pytest.raises(ValueError, match="consistent-mesh"):
        plan_buckets([], DatasetConfig())


# -- kernels 9 and 1 (level form): the plain versions ----------------------


def _assert_rows_close(got, want, n_pad, what):
    """Real node rows at REAL_TOL, row n_pad − 1 at PAD_ROW_TOL, of the
    reference's largest |value|."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err[:n_pad - 1].max() <= REAL_TOL * scale, what
    assert err[n_pad - 1].max() <= PAD_ROW_TOL * scale, what


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("send", [False, True], ids=["recv", "send"])
@pytest.mark.parametrize("layout", ["resid", "level", "forced"])
def test_kernel9_plain_matches_jax(layout, send, dt):
    """acc + the receiver (sender) sums against `segment_sum_accum_raw`
    (`_send_raw`) on the 450-node mesh's level-0 residual sub-level
    (skip-empty, tail chunk), on its level 0 (tail chunks) and on the
    forced empty residual, where only row n_pad − 1 changes."""
    if layout == "forced":
        hj, ht = forced()
        jl, tl = hj.levels[1].resid, to_device(ht, "cpu").levels[1].resid
    else:
        hj, ht = group(WINDOW)[2][0]
        hd = to_device(ht, "cpu")
        jl, tl = ((hj.levels[0].resid, hd.levels[0].resid)
                  if layout == "resid" else (hj.levels[0], hd.levels[0]))
    jd, td = DTYPES[dt]
    rng = np.random.default_rng(20)
    feat = rng.standard_normal((tl.n_pad_edges, C)).astype(np.float32)
    acc = rng.standard_normal((tl.n_pad_nodes, C)).astype(np.float32)
    jfn = jax_accum_send if send else jax_accum
    want = jfn(jl, jnp.asarray(feat).astype(jd), jnp.asarray(acc))
    ssa.segment_sum_accum_plain.calls = 0
    fn = (ssa.segment_sum_accum_send_plain if send
          else ssa.segment_sum_accum_plain)
    got = fn(tl, torch.tensor(feat).to(td), torch.tensor(acc))
    assert ssa.segment_sum_accum_plain.calls == 1
    assert got.dtype == torch.float32
    _assert_rows_close(got, want, tl.n_pad_nodes, layout)
    if layout == "forced":
        np.testing.assert_array_equal(got.numpy()[:-1], acc[:-1])
        assert not np.array_equal(got.numpy()[-1], acc[-1])


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("which", ["ew", "ew_rev"])
@pytest.mark.parametrize("lvl", [0, 1])
def test_kernel1_level_form_plain_matches_jax(lvl, which, dt):
    """Kernel 1's level form against `windowed_conv_raw` with the level's
    `ew` (down) or `ew_rev` (up), cast to the row dtype as the JAX caller
    casts it, on the 450-node mesh (level 0 with tail chunks)."""
    hj, ht = group(WINDOW)[2][0]
    jl, tl = hj.levels[lvl], to_device(ht, "cpu").levels[lvl]
    jd, td = DTYPES[dt]
    x = np.random.default_rng(21).standard_normal(
        (tl.n_pad_nodes, C)).astype(np.float32)
    want = windowed_conv_raw(jl, jnp.asarray(x).astype(jd),
                             getattr(jl, which).astype(jd))
    got = windowed_conv_plain(tl, torch.tensor(x).to(td), getattr(tl, which))
    assert got.dtype == torch.float32
    _assert_rows_close(got, want, tl.n_pad_nodes, which)


# -- pool / unpool -----------------------------------------------------------


@pytest.mark.parametrize("t", [0, 1])
def test_pool_unpool_and_gradients_match_jax(t):
    """Forward values and the gradients under a cotangent on every row (the
    child's pad rows too: pool's backward drops their collisions on the
    parent pad node, as JAX's custom VJP does), exactly."""
    hj, ht = group(WINDOW)[2][0]
    tj, tt = hj.transitions[t], to_device(ht, "cpu").transitions[t]
    n_par, n_chd = ht.levels[t].n_pad_nodes, ht.levels[t + 1].n_pad_nodes
    rng = np.random.default_rng(22 + t)
    xp = rng.standard_normal((n_par, C)).astype(np.float32)
    xc = rng.standard_normal((n_chd, C)).astype(np.float32)
    gc = rng.standard_normal((n_chd, C)).astype(np.float32)
    gp = rng.standard_normal((n_par, C)).astype(np.float32)
    for fj, ft, x, g in ((jax_pool, pool_nodes, xp, gc),
                         (jax_unpool, unpool_nodes, xc, gp)):
        want, vjp = jax.vjp(lambda a: fj(tj, a), jnp.asarray(x))
        (dwant,) = vjp(jnp.asarray(g))
        xt = torch.tensor(x, requires_grad=True)
        out = ft(tt, xt)
        out.backward(torch.tensor(g))
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(dwant))
    # The collisions: every child pad row reads the parent pad node, and
    # the gradient there is dropped, not summed.
    assert (tt.pool_ids[ht.levels[t + 1].n_nodes:] == n_par - 1).all()
