"""The edge backward tile walk of kernels 5 and 11's backward
(`csrc/edge_bwd_tiles.cuh`) on the CPU, where the CUDA kernels cannot run:
what it relies on and the order in which it sums, held against the plain
versions and the JAX package.

- (a) `fused_gmp.tile_ranges`, which sizes the walk's grid: every tile once,
  in order, in ranges whose sizes differ by at most one.
- (b) The dead-tile rule: a tile with no live slot (kernel 5: an in-window
  sender and a receiver in the chunk's block; kernel 11: a receiver in the
  block) writes zero dpre rows and skips the walk, so dpre must be exactly
  zero there, in the plain version and in the JAX kernel (interpret mode),
  on every level, and on levels cut to one live tile and to none.
- (c) The walk's order of sums, emulated from the plain version's per-slot
  products: each tile's sum, each block's range of tiles in order, then the
  blocks in order; kernel 5's dxj by the receiver lists (`win_row_*`) in
  list order.
- (d) The bf16 weight stacks the walk takes, rounded once per call, equal
  the weights rounded at staging.

Layouts: the depth-4 Morton airfoil of `test_torch_port_window_gather.py`
(window 256, edge_block 512), kernel 5 with three tail layers; the
600-node sphere of `test_torch_port_fused_stream.py` (edge_block 128),
kernel 11 with one.

Tolerances:
- dxj: exact, on rows drawn on a 2^-6 grid (`grid_normal`), as
  `test_torch_port_row_gather.py` holds its gathers: only the order of the
  f32 sums changes, and such sums are exact in any order.
- dW, db, dwf8 against the plain version: a largest error of 2e-5 and an
  RMS error of 2e-6 of each output's RMS (chip_smoke.py's f32 `BWD_TOL`
  for kernel 5): only the grouping of f32 sums changes.
- against JAX: 1e-4 of the largest |value|, the f32 limit of the port's
  kernel-5 and kernel-11 backward tests.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_fused_stream import _case as stream_case
from test_torch_port_fused_stream import _tail
from test_torch_port_row_gather import grid_normal
from test_torch_port_train import assert_close
from test_torch_port_window_gather import layouts

from bsms_gnn_tpu.ops.pallas import fused_gmp as jfg
from bsms_gnn_tpu.ops.pallas.fused_gmp import (
    fused_edge_mlp_aggregate as jax_v1,
)
from bsms_gnn_tpu.ops.pallas.fused_gmp import fused_edge_phase_win as jax_v3
from bsms_gnn_tpu.ops.pallas.windowed import _pack_rows
from bsms_gnn_tpu_torch.ops.kernels import build
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp as fg
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp_stream as fgs
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import round_bf16, tile_ranges

C, BN = 128, 128
PLAIN_TOL = (2e-5, 2e-6)
JAX_TOL = 1e-4
LEVELS = [f"airfoil L{l}" for l in range(5)]
TR = fg.TILE_ROWS


# -- (a) ---------------------------------------------------------------------


@pytest.mark.parametrize("n_tiles", [1, 7, 248, 656, 1530])
@pytest.mark.parametrize("grid", [1, 5, 132, 264, "T-1", "T", "T+9"])
def test_tile_ranges_cover_every_tile_once(n_tiles, grid):
    g = {"T-1": n_tiles - 1, "T": n_tiles, "T+9": n_tiles + 9}.get(grid, grid)
    bounds = tile_ranges(n_tiles, g)
    assert len(bounds) - 1 == max(1, min(g, n_tiles))
    assert bounds[0] == 0 and bounds[-1] == n_tiles
    sizes = np.diff(bounds)
    assert (sizes >= 1).all() and sizes.max() - sizes.min() <= 1
    b = np.arange(len(bounds) - 1)
    np.testing.assert_array_equal(bounds[:-1], b * n_tiles // len(sizes))


def test_the_tile_shape_fits_the_layouts():
    """The tile rows divide every edge_block the port builds (128, 512) and
    those of the layouts below, so a tile never straddles two chunks."""
    assert 128 % TR == 0 and 512 % TR == 0
    blocks = {layouts()[n][1].edge_block for n in LEVELS}
    blocks |= {lv.edge_block for lv in stream_case("world")["ht"].levels}
    assert all(b % TR == 0 for b in blocks), blocks


# -- layouts and inputs --------------------------------------------------------


def win_live(level):
    """Kernel 5's live slots: an in-window sender and a receiver in the
    chunk's 128-row block."""
    blk = level.chunk_block.long().repeat_interleave(level.edge_block)
    return (level.send_win.long() < level.window) & (
        level.receivers.long() // BN == blk)


def dead_tiles(live):
    return ~live.view(-1, TR).any(1)


@functools.lru_cache(maxsize=None)
def level(name):
    """(JAX level, the port's) by name; "... one" and "... none" are level
    4 with every slot but the first two live ones, or every slot, given the
    out-of-window sentinel."""
    base, _, cut = name.partition(" cut ")
    jl, tl = layouts()[base]
    if not cut:
        return jl, tl
    sw = tl.send_win.numpy().copy()
    keep = np.flatnonzero(win_live(tl).numpy())[:2 if cut == "one" else 0]
    drop = np.setdiff1d(np.arange(len(sw)), keep)
    sw[drop] = tl.window
    from dataclasses import replace
    return (jl.replace(send_win=jnp.asarray(sw)),
            replace(tl, send_win=torch.from_numpy(sw)))


@functools.lru_cache(maxsize=None)
def win_inputs(name, seed=5):
    """Kernel 5's inputs on a level: xwi, xj, g unit normal (zero on pad
    rows), wf8, three tail layers at 0.05 (f32 numpy)."""
    _, tl = level(name)
    rng = np.random.default_rng(seed)
    mask = np.asarray(tl.node_mask, np.float32).reshape(-1, 1)
    xwi, xj, g = ((rng.standard_normal((tl.n_pad_nodes, C)) * mask)
                  .astype(np.float32) for _ in range(3))
    wf8 = (0.3 * rng.standard_normal((8, C))).astype(np.float32)
    ws = tuple((0.05 * rng.standard_normal((C, C))).astype(np.float32)
               for _ in range(3))
    bs = tuple((0.05 * rng.standard_normal(C)).astype(np.float32)
               for _ in range(3))
    return xwi, xj, wf8, ws, bs, g


def torch_args(name):
    xwi, xj, wf8, ws, bs, g = win_inputs(name)
    t = torch.from_numpy
    return (level(name)[1], t(xwi), t(xj), t(wf8), [t(w) for w in ws],
            [t(b) for b in bs], t(g))


@functools.lru_cache(maxsize=None)
def jax_bwd3(name):
    """The JAX kernel's backward (`_get_bwd3`, interpret mode) as
    `fused_edge_phase_win`'s custom VJP calls it: (dpre, dxj, dwf8, dW,
    db)."""
    lj, _ = level(name)
    xwi, xj, wf8, ws, bs, g = win_inputs(name)
    e, n, be = lj.n_pad_edges, lj.n_pad_nodes, lj.edge_block
    cb, first, recv = jfg._chunk_tables(lj)
    sw = _pack_rows(lj.send_win.astype(jnp.int32), be, e // be, lj.window)
    call = jfg._get_bwd3(e, n, C, len(ws), True, "float32", "float32", be,
                         lj.window // 2)
    out = call(cb, first, lj.win_base.astype(jnp.int32),
               lj.fiber_t.astype(jnp.float32), xwi, xwi, xj, wf8,
               jnp.stack(ws), jnp.stack(bs), sw, recv, g)
    return tuple(np.asarray(o) for o in out)


@functools.lru_cache(maxsize=None)
def stream_inputs(l):
    """Kernel 11's case on level l of the sphere: (JAX level, the port's),
    pre [E_pad, C] and g [n_pad, C] unit normal, and the level-0 down
    GMP's tail (one layer), in numpy."""
    case = stream_case("world")
    lj, lt = case["hj"].levels[l], case["ht"].levels[l]
    rng = np.random.default_rng(4 + l)
    pre = rng.standard_normal((lt.n_pad_edges, C)).astype(np.float32)
    g = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    mj = case["state"].params.process.down_gmps[0].mlp_edge
    ws, bs = (tuple(np.array(x) for x in t) for t in _tail(mj))
    return lj, lt, pre, g, ws, bs


def stream_live(lt):
    return fgs.in_block(lt)[1]


@functools.lru_cache(maxsize=None)
def jax_v1_vjp(l):
    """jax.vjp of the JAX kernel 11 (interpret mode): (dpre, dW, db)."""
    lj, _, pre, g, ws, bs = stream_inputs(l)
    _, vjp = jax.vjp(lambda p, w, b: jax_v1(lj, p, w, b), jnp.asarray(pre),
                     ws, bs)
    dpre, dws, dbs = vjp(jnp.asarray(g))
    return np.asarray(dpre), np.stack(dws), np.stack(dbs)


# -- (b) ---------------------------------------------------------------------


@pytest.mark.parametrize("name", LEVELS + ["airfoil L4 cut one",
                                           "airfoil L4 cut none"])
def test_dead_tiles_have_zero_dpre_kernel5(name):
    _, tl = level(name)
    live = win_live(tl)
    dead = dead_tiles(live)
    n_live_tiles = int((~dead).sum())
    if name.endswith("cut one"):
        assert n_live_tiles == 1
    elif name.endswith("cut none"):
        assert n_live_tiles == 0
    else:
        assert 0 < int(dead.sum()) < len(dead)  # the rule has tiles to skip
    dpre = fg.fused_edge_phase_win_bwd_plain(*torch_args(name))[0]
    rows = dpre.view(-1, TR, C)
    assert (rows[dead] == 0).all()
    assert (dpre[~live] == 0).all()  # and every masked slot, live tiles too
    jd = jax_bwd3(name)[0].reshape(-1, TR, C)
    assert (jd[dead.numpy()] == 0).all()


@pytest.mark.parametrize("l", [0, 1, 2])
def test_dead_tiles_have_zero_dpre_kernel11(l):
    lj, lt, pre, g, ws, bs = stream_inputs(l)
    live = stream_live(lt)
    dead = dead_tiles(live)
    assert (int(dead.sum()) > 0) == (l > 0) and int(dead.sum()) < len(dead)
    dpre = fgs.fused_edge_mlp_aggregate_bwd_plain(
        lt, torch.from_numpy(pre), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(b) for b in bs], torch.from_numpy(g))[0]
    assert (dpre.view(-1, TR, C)[dead] == 0).all()
    assert (dpre[~live] == 0).all()
    assert (jax_v1_vjp(l)[0].reshape(-1, TR, C)[dead.numpy()] == 0).all()


# -- (c) ---------------------------------------------------------------------


def per_slot_terms(pre, hs, normed, inv, ge, ws):
    """The plain backward's per-slot operands (f32): for each tail layer l
    the pair (hs[l], d_l) whose products sum to dW[l] (and d_l's rows to
    db[l]), and dpre."""
    dout = (ge - ge.mean(-1, keepdim=True)
            - normed * (ge * normed).mean(-1, keepdim=True)) * inv
    n = len(ws)
    ds = [None] * n
    ds[-1] = dout
    dh = dout @ ws[-1].t()
    for l in range(n - 2, -1, -1):
        dh = dh * (hs[l + 1] > 0)
        ds[l] = dh
        dh = dh @ ws[l].t()
    return ds, dh * (pre > 0)


def walk_sum(n_slots, live, grid, tile_term):
    """Σ over slots as the walk adds: each live tile's own sum, the tiles of
    a block's range in order, then the blocks in order; dead tiles add
    nothing."""
    dead = dead_tiles(live)
    bounds = tile_ranges(n_slots // TR, grid)
    total = None
    for b in range(len(bounds) - 1):
        part = None
        for t in range(bounds[b], bounds[b + 1]):
            if dead[t]:
                continue
            s = tile_term(slice(t * TR, (t + 1) * TR))
            part = s if part is None else part + s
        if part is not None:
            total = part if total is None else total + part
    return total


def ordered_row_sums(ptr, slots, rows):
    """out[n] = (((0 + rows[s_0]) + rows[s_1]) + ...) over row n's slots
    slots[ptr[n]:ptr[n + 1]], in list order, f32. Step j adds every row's
    j-th slot at once; a row whose list has ended adds a zero row, which
    leaves its sum's bits as they are (a sum from +0 is never -0)."""
    ptr = torch.as_tensor(ptr).long()
    lens = ptr[1:] - ptr[:-1]
    out = torch.zeros(len(lens), rows.shape[-1])
    if len(slots) == 0:
        return out
    rows = torch.cat([rows.float(), rows.new_zeros(1, rows.shape[-1]).float()])
    zero = rows.shape[0] - 1
    for j in range(int(lens.max())):
        at = (ptr[:-1] + j).clamp(max=len(slots) - 1)
        out = out + rows[torch.where(j < lens, slots[at], zero)]
    return out


def list_order_gather(level, dpre):
    """dxj[n] = Σ dpre[e] over receiver row n's `win_row_slots`, in list
    order."""
    return ordered_row_sums(level.win_row_ptr, level.win_row_slots.long(),
                            dpre)


def assert_plain_close(got, want, what):
    err = (got - want).abs()
    rms = want.square().mean().sqrt()
    assert err.max() <= PLAIN_TOL[0] * rms, what
    assert err.square().mean().sqrt() <= PLAIN_TOL[1] * rms, what


@pytest.mark.parametrize("name", ["airfoil L0", "airfoil L4"])
def test_kernel5_order_of_sums(name):
    """dxj by the receiver lists, dW, db and dwf8 by block partials,
    against the plain outputs and jax.vjp of the JAX fused_edge_phase_win
    (interpret mode)."""
    args = torch_args(name)
    tl, xwi, xj, wf8, ws, bs, g = args
    _, dxj_p, dwf8_p, dw_p, db_p = fg.fused_edge_phase_win_bwd_plain(*args)

    # dxj: the gather of a grid-valued dpre (zero off the live slots, as
    # the walk leaves it) in list order is the plain index_add_ exactly.
    live = win_live(tl)
    rows = torch.from_numpy(grid_normal(np.random.default_rng(3),
                                        (tl.n_pad_edges, C)))
    rows[~live] = 0
    want = torch.zeros(tl.n_pad_nodes, C).index_add_(
        0, tl.receivers.long(), rows)
    assert torch.equal(list_order_gather(tl, rows), want)

    pre, covered, recv = fg._edge_pre(tl, xwi, xj, wf8, False)
    normed, inv, hs = fg.mlp_tail_fwd_save(pre, ws, bs, False)
    ge = torch.where(covered[:, None], g.index_select(0, recv), 0.0)
    ds, dpre = per_slot_terms(pre, hs, normed, inv, ge, ws)
    dxj = list_order_gather(tl, dpre)
    assert_plain_close(dxj, dxj_p, "dxj")

    jl = level(name)[0]
    xwi_n, xj_n, wf8_n, ws_n, bs_n, g_n = win_inputs(name)
    _, vjp = jax.vjp(lambda a, b, w8, w, bb: jax_v3(jl, a, b, w8, w, bb),
                     jnp.asarray(xwi_n), jnp.asarray(xj_n),
                     jnp.asarray(wf8_n), ws_n, bs_n)
    _, dxj_j, dwf8_j, dws_j, dbs_j = vjp(jnp.asarray(g_n))
    assert_close(dxj, dxj_j, JAX_TOL, "dxj vs JAX")

    e = tl.n_pad_edges
    for grid in (7, 132):
        dwf8 = walk_sum(e, live, grid, lambda s: tl.fiber_t[:, s] @ dpre[s])
        assert_plain_close(dwf8, dwf8_p, f"dwf8 grid {grid}")
        assert_close(dwf8, dwf8_j, JAX_TOL, "dwf8 vs JAX")
        for l in range(len(ws)):
            dw = walk_sum(e, live, grid, lambda s: hs[l][s].t() @ ds[l][s])
            db = walk_sum(e, live, grid, lambda s: ds[l][s].sum(0))
            assert_plain_close(dw, dw_p[l], f"dW{l} grid {grid}")
            assert_plain_close(db, db_p[l], f"db{l} grid {grid}")
            assert_close(dw, dws_j[l], JAX_TOL, f"dW{l} vs JAX")
            assert_close(db, dbs_j[l], JAX_TOL, f"db{l} vs JAX")


def test_kernel11_order_of_sums():
    """dW and db by block partials against the plain outputs and jax.vjp of
    the JAX fused_edge_mlp_aggregate (interpret mode), on the sphere's level
    1 (two dead tiles)."""
    _, lt, pre_n, g_n, ws_n, bs_n = stream_inputs(1)
    t = torch.from_numpy
    ws, bs = [t(w) for w in ws_n], [t(b) for b in bs_n]
    pre, g = t(pre_n), t(g_n)
    dpre_p, dw_p, db_p = fgs.fused_edge_mlp_aggregate_bwd_plain(
        lt, pre, ws, bs, g)
    live = stream_live(lt)
    recv = lt.receivers.long()
    normed, inv, hs = fg.mlp_tail_fwd_save(pre, ws, bs, False)
    ge = torch.where(live[:, None], g.index_select(0, recv), 0.0)
    ds, dpre = per_slot_terms(pre, hs, normed, inv, ge, ws)
    assert_plain_close(dpre, dpre_p, "dpre")
    dpre_j, dws_j, dbs_j = jax_v1_vjp(1)
    e = lt.n_pad_edges
    for grid in (5, 132):
        for l in range(len(ws)):
            dw = walk_sum(e, live, grid, lambda s: hs[l][s].t() @ ds[l][s])
            db = walk_sum(e, live, grid, lambda s: ds[l][s].sum(0))
            assert_plain_close(dw, dw_p[l], f"dW{l} grid {grid}")
            assert_plain_close(db, db_p[l], f"db{l} grid {grid}")
            assert_close(dw, dws_j[l], JAX_TOL, f"dW{l} vs JAX")
            assert_close(db, dbs_j[l], JAX_TOL, f"db{l} vs JAX")


# -- (d) ---------------------------------------------------------------------


@pytest.mark.parametrize("transpose", [False, True])
def test_bf16_weight_stack_is_rounding_at_staging(transpose):
    """The stack the walk takes in bf16 mode holds the values a bf16-mode
    kernel's staging would round to, once: each entry is round_bf16 of the
    weight (transposed for Wᵀ), and rounding it again changes nothing; an
    f32 stack is the weights as they are."""
    rng = np.random.default_rng(2)
    ws = [torch.from_numpy(rng.standard_normal((C, C)).astype(np.float32))
          for _ in range(3)]
    got = build.stacked(ws, transpose=transpose, to_bf16=True)
    want = torch.stack([w.t() if transpose else w for w in ws])
    assert got.dtype == torch.float32
    assert torch.equal(got, round_bf16(want))
    assert torch.equal(round_bf16(got), got)
    assert not torch.equal(got, want)
    plain = build.stacked(ws, transpose=transpose)
    assert torch.equal(plain, want)
    assert build.stacked(ws, transpose=transpose, to_bf16=True) is got
