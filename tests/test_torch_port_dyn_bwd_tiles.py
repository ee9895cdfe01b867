"""Kernel 13's backward on the edge backward tile walk
(`csrc/edge_bwd_tiles.cuh` with the kDyn front, then the receiver gather of
`csrc/row_gather.cuh`) on the CPU, where the CUDA kernels cannot run: what
it relies on and the order in which it sums, held against the plain
version and JAX's v4 backward (`fused_gmp.py::_get_bwd4`, interpret mode).

- (a) The receiver lists (`win_row_ptr`, `win_row_slots`) hold exactly the
  slots to which JAX's v4 backward gives a nonzero cotangent (an
  in-window sender and a receiver in the chunk's block), each in its
  receiver's row; pad and out-of-window slots are not listed.
- (b) The dead-tile rule: a tile with no live slot writes zero dpre rows
  and skips the walk, so dpre must be exactly zero there, in the plain
  version and in JAX's kernel, also on a level cut to one live tile and
  to none.
- (c) The walk's order of sums, emulated from the plain version's per-slot
  operands: per-block partials [dW | db | dwf8 | dwf_dyn | dwf_nrm] over
  `tile_ranges(T, G)` for G in {1, 25, 132} (one block; the flag's level-0
  chunk count; the H100's SMs at one block each), the blocks added in
  order; dxj by the gather over the receiver lists in list order.
- (d) In bf16, dwf_nrm sums ‖Δ‖·dpre with dpre not yet rounded (JAX's
  `fused_gmp.py:1103-1105`): the walk's order on the unrounded dpre meets
  the plain version and JAX, and a control that rounds dpre to bf16 first
  misses both.

Layouts: the flag's hierarchy (chip_smoke.py's: `make_grid_strip_mesh(1579,
ny=32)`, Morton order, depth 5, edge_block 512, window 256; its levels
hold 200, 152, 104, 80, 48 and 8 tiles) and `test_torch_port_contact.py`'s
520-node strip (depth 2). Inputs: xwi, xj 3·N(0, 1), three tail layers at
0.2, so that the hidden ReLU inputs spread to a scale of ~5 and the draws
(seed 0) leave every ReLU input of a live slot at least 3e-6 from zero
(asserted), where JAX's sums in another order cannot flip a unit.

Tolerances:
- against the plain version, f32: a largest error of 2e-5 and an RMS
  error of 2e-6 of each output's RMS (chip_smoke.py's f32 `BWD_TOL` for
  kernel 13's backward): only the grouping of f32 sums changes.
- against JAX, f32: `F32_TOL` (5e-4) of the largest |value|, the port's
  f32 limit (`test_torch_port_slice.py`).
- bf16 dwf_nrm: the same unrounded products summed in another order, 1e-5
  of the largest |value| against the plain version (read: 3e-7); against
  JAX, whose bf16 dpre may round a rare intermediate the other way, 2e-4
  (read: 6e-5 to 8e-5). Rounding dpre first moves the sum by 1e-3 of it.
"""

import functools
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_edge_bwd_tiles import (
    dead_tiles,
    list_order_gather,
    per_slot_terms,
    walk_sum,
    win_live,
)
from test_torch_port_train import assert_close

from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.ops.pallas import fused_gmp as jfg
from bsms_gnn_tpu.ops.pallas.windowed import _pack_rows
from bsms_gnn_tpu_torch.data.synthetic import make_grid_strip_mesh
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.graph.order import reorder_mesh
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp as fg
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp_dyn as fgd
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import round_bf16

C, WD, LAYERS = 128, 3, 3
TR = fg.TILE_ROWS
MESHES = {"flag": (1579, 32, 5), "strip": (520, 13, 2)}
LAYOUT = dict(edge_block=512, window=256)
FLAG = [f"flag L{l}" for l in range(6)]
F32_TOL = 5e-4
PLAIN_TOL = (2e-5, 2e-6)
NRM_TOL = {"plain": 1e-5, "jax": 2e-4}
RELU_MARGIN = 3e-6
GRIDS = (1, 25, 132)


@functools.lru_cache(maxsize=None)
def hierarchies(mesh):
    """(JAX hierarchy, the port's) of a Morton-ordered strip."""
    n_nodes, ny, depth = MESHES[mesh]
    pos, cells, node_type = make_grid_strip_mesh(n_nodes, ny=ny)
    pos, cells, _, _ = reorder_mesh(pos, cells, (node_type,))
    p64 = pos.astype(np.float64)
    hj = jax_build(jax_flat_edge(cells, "tri"), depth, len(pos), p64,
                   **LAYOUT)
    ht = to_device(build_hierarchy(to_flat_edge(cells, "tri"), depth,
                                   len(pos), p64, **LAYOUT), "cpu")
    return hj, ht


@functools.lru_cache(maxsize=None)
def level(name):
    """(JAX level, the port's) by name ("flag L3"); "... cut one" and
    "... cut none" keep the first two live slots, or none, and move every
    other slot out of window."""
    base, _, cut = name.partition(" cut ")
    mesh, lv = base.split(" L")
    hj, ht = hierarchies(mesh)
    jl, tl = hj.levels[int(lv)], ht.levels[int(lv)]
    if not cut:
        return jl, tl
    sw = tl.send_win.numpy().copy()
    keep = np.flatnonzero(win_live(tl).numpy())[:2 if cut == "one" else 0]
    sw[np.setdiff1d(np.arange(len(sw)), keep)] = tl.window
    return (jl.replace(send_win=jnp.asarray(sw)),
            replace(tl, send_win=torch.from_numpy(sw)))


@functools.lru_cache(maxsize=None)
def inputs(name, seed=0):
    """Kernel 13's backward inputs on a level (f32 numpy): xwi, xj (3·N(0,
    1)), the world positions (N(0, 1) on real nodes), wf8, wf_dyn, wf_nrm
    (0.3), three tail layers at 0.2 (biases 0.05), g (N(0, 1))."""
    _, tl = level(name)
    rng = np.random.default_rng(seed)
    n = tl.n_pad_nodes
    xwi, xj, g = (rng.standard_normal((n, C)).astype(np.float32)
                  for _ in range(3))
    wpos = np.zeros((n, WD), np.float32)
    wpos[:tl.n_nodes] = rng.standard_normal((tl.n_nodes, WD))
    wf8, wfd = ((0.3 * rng.standard_normal(s)).astype(np.float32)
                for s in ((8, C), (WD, C)))
    wfn = (0.3 * rng.standard_normal(C)).astype(np.float32)
    ws = tuple((0.2 * rng.standard_normal((C, C))).astype(np.float32)
               for _ in range(LAYERS))
    bs = tuple((0.05 * rng.standard_normal(C)).astype(np.float32)
               for _ in range(LAYERS))
    return 3 * xwi, 3 * xj, wpos, wf8, wfd, wfn, ws, bs, g


def torch_args(name, dtype=torch.float32):
    """The plain backward's arguments; xwi, xj and the positions in
    `dtype`."""
    xwi, xj, wpos, wf8, wfd, wfn, ws, bs, g = inputs(name)
    t = torch.from_numpy
    return (level(name)[1], t(xwi).to(dtype), t(xj).to(dtype),
            t(wpos).to(dtype), t(wf8), t(wfd), t(wfn), [t(w) for w in ws],
            [t(b) for b in bs], t(g))


@functools.lru_cache(maxsize=None)
def jax_bwd4(name, dt="float32"):
    """JAX's v4 backward (`_get_bwd4`, interpret mode) as
    `fused_edge_phase_win_dyn`'s custom VJP calls it, on the extended
    [N, 2C] tables and weight blocks: (dpre, dxj, dwf8, dwf_dyn [wd, C],
    dwf_nrm [C], dW, db), numpy f32."""
    lj, tl = level(name)
    xwi, xj, wpos, wf8, wfd, wfn, ws, bs, g = inputs(name)
    e, n, be = tl.n_pad_edges, tl.n_pad_nodes, tl.edge_block
    jd = jnp.dtype(dt)

    def ext(a):
        pad = np.zeros((n, C - WD), np.float32)
        return jnp.asarray(np.concatenate([a, wpos, pad], -1)).astype(jd)

    wfd_ext = np.zeros((C, C), np.float32)
    wfd_ext[:WD] = wfd
    wfn8 = np.zeros((8, C), np.float32)
    wfn8[0] = wfn
    cb, first, recv = jfg._chunk_tables(lj)
    sw = _pack_rows(lj.send_win.astype(jnp.int32), be, e // be, lj.window)
    call = jfg._get_bwd4(e, n, C, LAYERS, True, dt, dt, be, lj.window // 2,
                         WD)
    out = call(cb, first, lj.win_base.astype(jnp.int32),
               lj.fiber_t.astype(jd), ext(xwi), ext(xwi), ext(xj), wf8,
               wfd_ext, wfn8, jnp.stack(ws), jnp.stack(bs), sw, recv, g)
    dpre, dxj, dwf8, dwfd, dwfn, dw, db = (np.asarray(o, np.float32)
                                           for o in out)
    return dpre, dxj[:, :C], dwf8, dwfd[:WD], dwfn[0], dw, db


def listed(tl):
    return np.sort(tl.win_row_slots.numpy())


# -- (a) ---------------------------------------------------------------------


@pytest.mark.parametrize("name", FLAG + ["strip L0", "strip L1"])
def test_receiver_lists_hold_the_v4_backwards_slots(name):
    _, tl = level(name)
    slots = listed(tl)
    live = win_live(tl).numpy()
    np.testing.assert_array_equal(slots, np.flatnonzero(live))
    # No pad or out-of-window slot is listed, and each listed slot sits in
    # its receiver's row.
    assert (tl.send_win.numpy()[slots] < tl.window).all()
    ptr, recv = tl.win_row_ptr.numpy(), tl.receivers.numpy()
    rows = np.repeat(np.arange(tl.n_pad_nodes), np.diff(ptr))
    np.testing.assert_array_equal(recv[tl.win_row_slots.numpy()], rows)
    # JAX's v4 backward gives exactly these slots a nonzero cotangent, and
    # so does the plain version.
    nonzero = np.flatnonzero(np.abs(jax_bwd4(name)[0]).max(1) > 0)
    np.testing.assert_array_equal(nonzero, slots)
    with torch.no_grad():
        dpre = fgd.fused_edge_phase_win_dyn_bwd_plain(*torch_args(name))[0]
    np.testing.assert_array_equal(
        np.flatnonzero(dpre.abs().amax(1).numpy() > 0), slots)


# -- (b) ---------------------------------------------------------------------


@pytest.mark.parametrize("name", ["flag L0", "flag L2", "flag L5",
                                  "flag L5 cut one", "flag L5 cut none"])
def test_dead_tiles_have_zero_dpre(name):
    _, tl = level(name)
    live = win_live(tl)
    dead = dead_tiles(live)
    n_live_tiles = int((~dead).sum())
    if name.endswith("cut one"):
        assert n_live_tiles == 1
    elif name.endswith("cut none"):
        assert n_live_tiles == 0
    else:
        assert 0 < n_live_tiles
    with torch.no_grad():
        dpre = fgd.fused_edge_phase_win_dyn_bwd_plain(*torch_args(name))[0]
    assert (dpre.view(-1, TR, C)[dead] == 0).all()
    assert (dpre[~live] == 0).all()  # and every masked slot, live tiles too
    jd = jax_bwd4(name)[0].reshape(-1, TR, C)
    assert (jd[dead.numpy()] == 0).all()


# -- (c) ---------------------------------------------------------------------


def slot_operands(name):
    """The plain backward's per-slot operands on a level, f32: (Δ, ‖Δ‖,
    each tail layer's input, each layer's cotangent, dpre)."""
    tl, xwi, xj, pos, wf8, wfd, wfn, ws, bs, g = torch_args(name)
    pre, covered, recv, delta, nrm = fgd._edge_pre_dyn(
        tl, xwi, xj, pos, wf8, wfd, wfn, False)
    assert torch.equal(covered, win_live(tl))
    normed, inv, hs = fg.mlp_tail_fwd_save(pre, ws, bs, False)
    ge = torch.where(covered[:, None], g.index_select(0, recv), 0.0)
    ds, dpre = per_slot_terms(pre, hs, normed, inv, ge, ws)
    return delta, nrm, hs, ds, dpre


def relu_margin(name):
    """The smallest |ReLU input| over the live slots, f32 plain route."""
    tl, xwi, xj, pos, wf8, wfd, wfn, ws, bs, _ = torch_args(name)
    pre, covered, _, _, _ = fgd._edge_pre_dyn(tl, xwi, xj, pos, wf8, wfd,
                                              wfn, False)
    ins, h = [pre], torch.relu(pre)
    for w, b in zip(ws[:-1], bs[:-1]):
        z = h @ w + b
        ins.append(z)
        h = torch.relu(z)
    return min(float(z[covered].abs().min()) for z in ins)


def assert_plain_close(got, want, what):
    err = (got - want).abs()
    rms = want.square().mean().sqrt()
    assert err.max() <= PLAIN_TOL[0] * rms, what
    assert err.square().mean().sqrt() <= PLAIN_TOL[1] * rms, what


def walk_partials(tl, delta, nrm, hs, ds, dpre, grid):
    """The G blocks' partials [dW | db | dwf8 | dwf_dyn | dwf_nrm] summed as
    the walk sums them, split into (dW, db, dwf8, dwf_dyn, dwf_nrm)."""
    n = len(hs)

    def term(s):
        return torch.cat(
            [(hs[l][s].t() @ ds[l][s]).reshape(-1) for l in range(n)]
            + [ds[l][s].sum(0) for l in range(n)]
            + [(tl.fiber_t[:, s] @ dpre[s]).reshape(-1),
               (delta[s].t() @ dpre[s]).reshape(-1), nrm[s] @ dpre[s]])

    total = walk_sum(tl.n_pad_edges, win_live(tl), grid, term)
    dw, db, dwf8, dwfd, dwfn = total.split(
        [n * C * C, n * C, 8 * C, WD * C, C])
    return (dw.view(n, C, C), db.view(n, C), dwf8.view(8, C),
            dwfd.view(WD, C), dwfn)


@pytest.mark.parametrize("name", ["flag L0", "strip L0"])
def test_walk_order_of_sums(name):
    """dxj by the receiver lists, the weight gradients by block partials,
    against the plain outputs and JAX's v4 backward."""
    assert relu_margin(name) >= RELU_MARGIN
    tl = level(name)[1]
    with torch.no_grad():
        _, dxj_p, dwf8_p, dwfd_p, dwfn_p, dw_p, db_p = (
            fgd.fused_edge_phase_win_dyn_bwd_plain(*torch_args(name)))
    delta, nrm, hs, ds, dpre = slot_operands(name)
    _, dxj_j, dwf8_j, dwfd_j, dwfn_j, dw_j, db_j = jax_bwd4(name)

    dxj = list_order_gather(tl, dpre)
    assert_plain_close(dxj, dxj_p, "dxj")
    assert_close(dxj, dxj_j, F32_TOL, "dxj vs JAX")
    for grid in GRIDS:
        dw, db, dwf8, dwfd, dwfn = walk_partials(tl, delta, nrm, hs, ds,
                                                 dpre, grid)
        for got, plain, want, what in (
                (dwf8, dwf8_p, dwf8_j, "dwf8"),
                (dwfd, dwfd_p, dwfd_j, "dwf_dyn"),
                (dwfn, dwfn_p, dwfn_j, "dwf_nrm"),
                *((dw[l], dw_p[l], dw_j[l], f"dW{l}") for l in range(LAYERS)),
                *((db[l], db_p[l], db_j[l], f"db{l}") for l in range(LAYERS))):
            assert_plain_close(got, plain, f"{what} grid {grid}")
            assert_close(got, want, F32_TOL, f"{what} grid {grid} vs JAX")


# -- (d) ---------------------------------------------------------------------


def rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", ["flag L0", "strip L0"])
def test_dwf_nrm_takes_unrounded_dpre_in_bf16(name):
    assert relu_margin(name) >= RELU_MARGIN
    args = torch_args(name, torch.bfloat16)
    tl, xwi, xj, pos, wf8, wfd, wfn, ws, bs, g = args
    with torch.no_grad():
        dwfn_p = fgd.fused_edge_phase_win_dyn_bwd_plain(*args)[4]
    pre, covered, recv, _, nrm = fgd._edge_pre_dyn(tl, xwi, xj, pos, wf8,
                                                   wfd, wfn, True)
    normed, inv, hs = fg.mlp_tail_fwd_save(pre, ws, bs, True)
    ge = round_bf16(torch.where(covered[:, None], g.index_select(0, recv),
                                0.0))
    dpre = fg.mlp_tail_bwd(pre, hs, normed, inv, ge, ws, True)[0]
    dwfn_j = jax_bwd4(name, "bfloat16")[4]
    live = win_live(tl)
    for grid in GRIDS:
        walk = walk_sum(tl.n_pad_edges, live, grid,
                        lambda s: nrm[s] @ dpre[s])
        ctrl = walk_sum(tl.n_pad_edges, live, grid,
                        lambda s: nrm[s] @ round_bf16(dpre[s]))
        errs = {k: (rel_err(v, dwfn_p), rel_err(v, dwfn_j))
                for k, v in (("walk", walk), ("control", ctrl))}
        assert errs["walk"][0] <= NRM_TOL["plain"], (grid, errs)
        assert errs["walk"][1] <= NRM_TOL["jax"], (grid, errs)
        assert errs["control"][0] > NRM_TOL["plain"], (grid, errs)
        assert errs["control"][1] > NRM_TOL["jax"], (grid, errs)
