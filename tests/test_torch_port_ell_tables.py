"""The ELL tables of the `ell` and `segment` methods in the port's
hierarchies against the JAX package on the CPU: `recv_ell` / `send_ell`
(each node's incident edge slots, in slot order, padded with E_pad) bit for
bit on unwindowed, windowed and bucketed layouts (the plan's `ell_buckets`,
and the residual sub-levels' widths from `resid_buckets`), and the union's
tables: each sample's slots offset by its base, every pad entry on the
union's pad B·E_pad (offset naively it would name the next sample's first
slot), every sample padded to the widest K, so that the union's ELL sums
equal the samples' own, exactly.

The layouts: `test_torch_port_hierarchy.py`'s scrambled 24×24 grid (depth
3, unwindowed, and window 128 with edge_block 512) and 600-node sphere
(depth 3, unwindowed), and `test_torch_port_buckets.py`'s group (Delaunay
meshes of 450 and 600 nodes, depth 2, one size group; window 256 with
edge_block 512, and unwindowed). The sums are over rows drawn on a 2^-6
grid, so every f32 sum is exact and the union's sums are held bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_buckets import WINDOW, group
from test_torch_port_hierarchy import scrambled_grid, sphere

from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels
from bsms_gnn_tpu_torch.graph.hierarchy import (
    build_hierarchy,
    pad_levels,
    to_device,
    union,
)
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.ops.scatter import aggregate_recv, aggregate_send

C = 8
BUILT = {"grid_unwindowed_d3": (scrambled_grid, 3, dict()),
         "grid_w128_eb512_d3": (scrambled_grid, 3,
                                dict(edge_block=512, window=128)),
         "sphere_unwindowed_d3": (sphere, 3, dict())}
LAYOUTS = sorted(BUILT) + ["bucketed_w256", "bucketed_unwindowed"]


@functools.lru_cache(maxsize=None)
def hierarchies(name):
    """[(JAX hierarchy, port hierarchy)] of a layout case: one pair, or
    one per mesh of the bucketed group."""
    if name.startswith("bucketed"):
        return group(WINDOW if name.endswith("w256") else 0)[2]
    make, depth, kw = BUILT[name]
    pos, cells = make()
    return [(jax_build(jax_flat_edge(cells, "tri"), depth, len(pos), pos,
                       **kw),
             build_hierarchy(to_flat_edge(cells, "tri"), depth, len(pos),
                             pos, **kw))]


def _layouts(hj, ht):
    """(where, JAX layout, port layout) of every level and, where the port
    builds one (bucketed windowed levels), residual sub-level."""
    out = []
    for l, (a, b) in enumerate(zip(hj.levels, ht.levels)):
        out.append((f"level {l}", a, b))
        if b.resid is not None:
            out.append((f"level {l} resid", a.resid, b.resid))
    return out


@pytest.mark.parametrize("name", LAYOUTS)
def test_ell_tables_equal_jax(name):
    """`recv_ell` / `send_ell` equal JAX's bit for bit (shape, dtype,
    entries) at every level and residual sub-level."""
    pairs = hierarchies(name)
    checked = resid = 0
    for hj, ht in pairs:
        for where, a, b in _layouts(hj, ht):
            for t in ("recv_ell", "send_ell"):
                want, got = np.asarray(getattr(a, t)), getattr(b, t)
                assert got.dtype == want.dtype == np.int32, (where, t)
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{where} {t}")
                checked += 1
            resid += where.endswith("resid")
    assert checked >= 6
    if name == "bucketed_w256":
        assert resid >= 2


@pytest.mark.parametrize("name", LAYOUTS)
def test_ell_rows_list_each_nodes_slots(name):
    """Row n of `recv_ell` lists, in slot order, exactly the real slots
    whose receiver is n (`send_ell`: whose sender is n), then E_pad; K is
    the widest row (or the plan's wider width), at least 1."""
    for _, ht in hierarchies(name):
        for where, _, lv in _layouts(ht, ht):
            real = np.flatnonzero(lv.edge_mask > 0)
            for t, idx in (("recv_ell", lv.receivers),
                           ("send_ell", lv.senders)):
                ell = getattr(lv, t)
                e = lv.n_pad_edges
                counts = np.bincount(idx[real], minlength=lv.n_pad_nodes)
                assert ell.shape[0] == lv.n_pad_nodes, where
                assert ell.shape[1] >= max(int(counts.max()), 1), where
                order = np.argsort(idx[real], kind="stable")
                lists = np.split(real[order], np.cumsum(counts)[:-1])
                for n, (row, mine) in enumerate(zip(ell, lists)):
                    np.testing.assert_array_equal(row[:len(mine)], mine,
                                                  err_msg=f"{where} {t} {n}")
                    assert (row[len(mine):] == e).all(), (where, t, n)


@pytest.mark.parametrize("window", [WINDOW, 0])
def test_bucket_plan_pins_every_meshs_ell_width(window):
    """Every mesh of a size group has the plan's ELL width at every level
    and its residual width at every residual sub-level, so their tables
    have one shape."""
    _, plan, pairs = group(window)
    g = plan.groups[0]
    for _, ht in pairs:
        for l, lv in enumerate(ht.levels):
            assert lv.recv_ell.shape[1] == lv.send_ell.shape[1] == max(
                g["ell_buckets"][l], 1)
            if lv.resid is not None:
                k = g["resid_buckets"][l][1]
                assert lv.resid.recv_ell.shape[1] == max(k, 1)


def _grid_rows(shape, seed):
    """f32 rows on a 2^-6 grid in [-2, 2): every sum of a few hundred of
    them is exact in f32."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, shape) / 64.0).astype(np.float32)


@pytest.mark.parametrize("device_side", [False, True])
@pytest.mark.parametrize("window", [WINDOW, 0])
def test_union_ell_sums_equal_the_samples_sums(window, device_side):
    """The union of B = 3 samples (meshes 0, 1, 0 of the group, numpy or
    on the device): its ELL entries are each sample's own plus s·E_pad,
    its pad entries all B·E_pad; the ELL receiver and sender sums of a
    batch of edge rows on the union equal each sample's own sums on its
    own layout, bit for bit, at every level and residual sub-level."""
    hs = [group(window)[2][i][1] for i in (0, 1, 0)]
    if device_side:
        hs = [to_device(h, "cpu") for h in hs]
    u = union(hs)
    b = len(hs)
    for l in range(len(u.levels)):
        layouts = [(u.levels[l], [h.levels[l] for h in hs])]
        if u.levels[l].resid is not None:
            layouts.append((u.levels[l].resid,
                            [h.levels[l].resid for h in hs]))
        for lu, own in layouts:
            e, n = own[0].n_pad_edges, own[0].n_pad_nodes
            for t in ("recv_ell", "send_ell"):
                got = np.asarray(getattr(lu, t))
                for s, o in enumerate(own):
                    mine = np.asarray(getattr(o, t))
                    blk = got[s * n:(s + 1) * n]
                    k = mine.shape[1]
                    np.testing.assert_array_equal(
                        blk[:, :k], np.where(mine == e, b * e, mine + s * e))
                    assert (blk[:, k:] == b * e).all()
            feat = _grid_rows((b * e, C), 7 + l)
            for agg in (aggregate_recv, aggregate_send):
                whole = agg(_torchify(lu), torch.from_numpy(feat), "ell")
                for s, o in enumerate(own):
                    part = agg(_torchify(o),
                               torch.from_numpy(feat[s * e:(s + 1) * e]),
                               "ell")
                    torch.testing.assert_close(
                        whole[s * n:(s + 1) * n], part, rtol=0, atol=0)


def test_union_pads_narrower_samples_to_the_widest_k():
    """A sample built with a wider ELL bucket than another: the union
    takes the widest K, the narrower sample's extra columns hold the
    union's pad, and its sums are unchanged."""
    meshes, plan, pairs = group(0)
    pos, cells, _ = meshes[1]
    kw = plan.for_mesh(1)
    kw["ell_buckets"] = [k + 3 for k in kw["ell_buckets"]]
    wide = pad_levels(build_bistride_levels(to_flat_edge(cells, "tri"),
                                            len(kw["node_buckets"]) - 1,
                                            len(pos), pos),
                      128, pos=pos, edge_block=512, window=0, **kw)
    narrow = pairs[1][1]
    u = union([narrow, wide])
    for l, lu in enumerate(u.levels):
        e, n = narrow.levels[l].n_pad_edges, narrow.levels[l].n_pad_nodes
        k0 = narrow.levels[l].recv_ell.shape[1]
        assert lu.recv_ell.shape[1] == wide.levels[l].recv_ell.shape[1] == (
            k0 + 3)
        assert (lu.recv_ell[:n, k0:] == 2 * e).all()
        feat = _grid_rows((2 * e, C), 30 + l)
        whole = aggregate_recv(_torchify(lu), torch.from_numpy(feat), "ell")
        for s, o in enumerate((narrow.levels[l], wide.levels[l])):
            torch.testing.assert_close(
                whole[s * n:(s + 1) * n],
                aggregate_recv(_torchify(o),
                               torch.from_numpy(feat[s * e:(s + 1) * e]),
                               "ell"), rtol=0, atol=0)


class _torchify:
    """A numpy layout's index tables as tensors (the scatter ops' view)."""

    def __init__(self, lv):
        self._lv = lv

    def __getattr__(self, name):
        v = getattr(self._lv, name)
        return torch.from_numpy(np.asarray(v)) if isinstance(
            v, np.ndarray) else v
