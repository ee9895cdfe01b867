"""Kernel 4's forward tile walk (`csrc/edge_fwd_tiles.cuh`, then the
receiver gather of `csrc/row_gather.cuh`) on the CPU, where the CUDA kernels
cannot run: what it relies on and the order in which it sums, held against
the plain version and the JAX package.

- (a) The receiver lists (`win_row_ptr`, `win_row_slots`) hold exactly the
  slots kernel 4 covers: the in-window slots, each in its receiver's row,
  whose receivers all lie in their chunk's 128-row block (so the walk's
  live rule, the plain version's mask and the JAX kernel's one-hot agree).
- (b) Gathering per-slot rows over those lists in list order equals
  `index_add_` of the covered slots, exactly, on rows drawn on a 2^-6 grid
  (f32, and the same rows rounded to bf16: such sums are exact in any
  order).
- (c) The new order, emulated from the plain version's per-slot messages
  (only the live tiles' live slots written, every other row NaN, as the
  walk leaves `msg`), then the list-order gather, against JAX's
  `fused_edge_phase_win` (interpret mode) at `F32_TOL` and in bf16 at the
  port's kernel bound (`MLP_TOL`), and against the plain version.
- (e) The walk's order (block b of G takes tiles b, b + G, b + 2G, ...,
  `walked_tiles`) covers every tile once at the grids of the card (132 or
  264 blocks) and the tile counts of the 5k airfoil's levels, and every
  listed slot lies in a live tile, so skipping dead tiles loses no
  message.

Layouts: the depth-4 Morton airfoil of `test_torch_port_window_gather.py`
(window 256, edge_block 512: the `fused` and `fused4` paths' layout) and
the bucketed 450-node mesh of `test_torch_port_buckets.py` (the cylinder
path's layout: a bucketed level 0 ending in tail chunks of pad slots);
"... wide": the airfoil at latent 256 with four tail layers, on the
32-slot tiles of the forward walk's plan there (`fused_gmp.walk_plan`).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_edge_bwd_tiles import dead_tiles, list_order_gather
from test_torch_port_hierarchy import _one_hot_rows
from test_torch_port_row_gather import grid_normal
from test_torch_port_window_gather import layouts

from bsms_gnn_tpu.ops.pallas.fused_gmp import fused_edge_phase_win as jax_v3
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp as fg
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import round_bf16, tile_ranges

C, BN = 128, 128
TR = fg.TILE_ROWS
F32_TOL = 5e-4  # test_torch_port_slice.py's
MLP_TOL = {"f32": 1e-4, "bf16": 2e-2}  # test_torch_port_kernels.py's
PLAIN_TOL = (2e-5, 1e-6)  # chip_smoke.py's f32 TOL for kernel 4
LAYOUTS = ["airfoil L0", "airfoil L2", "airfoil L4", "bucketed L0",
           "bucketed L1"]
# The 5k airfoil's tiles per level (chip_smoke.py's main path; at latent
# 256 its level 0 in 32-slot tiles) and the grids the card gives the walk
# (132 SMs at one or two blocks each).
AIRFOIL_TILES = (656, 488, 360, 272, 240, 192, 8, 1312)
WIDE = " wide"


def shape(name):
    """(layout name, latent width, tail layers, the forward walk's tile
    rows) of a case name."""
    c, layers = (256, 4) if name.endswith(WIDE) else (C, 3)
    return (name.removesuffix(WIDE), c, layers,
            fg.walk_plan(c, layers, "win", torch.float32, backward=False)[1])


def kernel4_live(level):
    """The slots kernel 4's walk computes: an in-window sender and a
    receiver in the chunk's 128-row block."""
    blk = level.chunk_block.long().repeat_interleave(level.edge_block)
    return (level.send_win.long() < level.window) & (
        level.receivers.long() // BN == blk)


# -- (a) ---------------------------------------------------------------------


@pytest.mark.parametrize("name", LAYOUTS)
def test_receiver_lists_hold_kernel4s_covered_slots(name):
    jl, tl = layouts()[name]
    live = kernel4_live(tl)
    _, covered = fg.sender_rows(tl)
    # Every in-window slot's receiver lies in its chunk's block: the plain
    # version's mask (in-window) is the walk's live rule.
    assert torch.equal(live, covered)
    # ... and the JAX kernel's one-hot puts it on its receiver's row.
    row = _one_hot_rows(jl)
    cov = covered.numpy()
    np.testing.assert_array_equal(row[cov], np.asarray(tl.receivers)[cov])
    ptr, slots = tl.win_row_ptr.long(), tl.win_row_slots.long()
    assert len(slots) == int(covered.sum()) > 0
    assert len(set(slots.tolist())) == len(slots)  # each slot once
    assert covered[slots].all()
    owner = torch.repeat_interleave(torch.arange(tl.n_pad_nodes),
                                    torch.diff(ptr))
    assert torch.equal(owner, tl.receivers.long()[slots])
    for r in range(0, tl.n_pad_nodes, max(1, tl.n_pad_nodes // 64)):
        s = slots[ptr[r]:ptr[r + 1]]
        assert torch.equal(s, s.sort().values)  # slot order in each row


# -- (b) ---------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", LAYOUTS)
def test_list_gather_is_index_add_of_the_covered_slots(name, dt):
    _, tl = layouts()[name]
    rows = torch.from_numpy(grid_normal(np.random.default_rng(7),
                                        (tl.n_pad_edges, C)))
    if dt == "bf16":
        rows = round_bf16(rows)
    covered = kernel4_live(tl)
    want = torch.zeros(tl.n_pad_nodes, C).index_add_(
        0, tl.receivers.long()[covered], rows[covered])
    # Rows the lists do not name may hold anything: the gather never reads
    # them.
    rows[~covered] = float("nan")
    assert torch.equal(list_order_gather(tl, rows), want)


# -- (c) ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def inputs(name, seed=9):
    """xwi, xj unit normal (zero on pad rows), wf8 at 0.3, three tail layers
    at 0.05 (f32 numpy); a wide case four at latent 256, at 0.05·√½."""
    base, C, layers, _ = shape(name)  # noqa: N806 (the case's width)
    _, tl = layouts()[base]
    rng = np.random.default_rng(seed + (0 if base == name else C))
    mask = np.asarray(tl.node_mask, np.float32).reshape(-1, 1)
    xwi, xj = ((rng.standard_normal((tl.n_pad_nodes, C)) * mask)
               .astype(np.float32) for _ in range(2))
    wf8 = (0.3 * rng.standard_normal((8, C))).astype(np.float32)
    s = 0.05 * np.sqrt(128 / C)
    ws = tuple((s * rng.standard_normal((C, C))).astype(np.float32)
               for _ in range(layers))
    bs = tuple((0.05 * rng.standard_normal(C)).astype(np.float32)
               for _ in range(layers))
    return xwi, xj, wf8, ws, bs


def slot_messages(pre, live, ws, bs, bf16):
    """Each live slot's message (the LN output of the tail on its
    pre-activation, rounded to bf16 in bf16 mode), every other row NaN. A
    message does not depend on the tile that computes it, so the walks'
    emulations take them from here, computed once."""
    out = torch.full(pre.shape, float("nan"))
    e = fg.mlp_tail_plain(pre[live], ws, bs, bf16)
    out[live] = round_bf16(e) if bf16 else e
    return out


def walk_forward(tl, xwi, xj, wf8, ws, bs, bf16, tr=TR):
    """The walk's function in its order: each live tile's (tr slots) live
    slots' messages (the LN output, rounded to bf16 in bf16 mode) into msg,
    every other row NaN (never written); then the list-order gather."""
    pre, _, _ = fg._edge_pre(tl, xwi, xj, wf8, bf16)
    live = kernel4_live(tl)
    keep = live & ~dead_tiles(live, tr).repeat_interleave(tr)
    assert torch.equal(keep, live)
    return list_order_gather(tl, slot_messages(pre, keep, ws, bs, bf16))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["airfoil L0", "airfoil L4", "bucketed L0",
                                  "airfoil L0" + WIDE])
def test_walk_order_matches_jax_and_plain(name, dt):
    base, _, _, tr = shape(name)
    jl, tl = layouts()[base]
    xwi, xj, wf8, ws, bs = inputs(name)
    tdt, jdt = ((torch.float32, jnp.float32) if dt == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    t = torch.from_numpy
    args = (t(xwi).to(tdt), t(xj).to(tdt), t(wf8), [t(w) for w in ws],
            [t(b) for b in bs])
    got = walk_forward(tl, *args, dt == "bf16", tr)
    assert torch.isfinite(got).all()
    want = np.asarray(jax_v3(jl, jnp.asarray(xwi).astype(jdt),
                             jnp.asarray(xj).astype(jdt), jnp.asarray(wf8),
                             ws, bs)).astype(np.float32)
    scale = np.abs(want).max()
    tol = F32_TOL if dt == "f32" else MLP_TOL["bf16"]
    assert np.abs(got.numpy() - want).max() <= tol * scale
    plain = fg.fused_edge_phase_win_plain(tl, *args)
    err = (got - plain).abs()
    rms = plain.square().mean().sqrt()
    assert err.max() <= PLAIN_TOL[0] * rms
    assert err.square().mean().sqrt() <= PLAIN_TOL[1] * rms


# -- (e) ---------------------------------------------------------------------


def walked_tiles(live_tiles, n_tiles, grid):
    """The tiles the forward walk computes, in the order of its blocks and
    steps: block b of G = min(grid, T) blocks (as `walk_grid` sizes the
    grid) takes the live ones of tiles b, b + G, b + 2G, ..."""
    g = len(tile_ranges(n_tiles, grid)) - 1
    return [t for b in range(g) for t in range(b, n_tiles, g)
            if live_tiles[t]]


@pytest.mark.parametrize("n_tiles", AIRFOIL_TILES)
@pytest.mark.parametrize("grid", [132, 264, "T"])
def test_forward_tile_ranges_cover_every_tile_once(n_tiles, grid):
    g = n_tiles if grid == "T" else grid
    seen = np.bincount(walked_tiles([True] * n_tiles, n_tiles, g),
                       minlength=n_tiles)
    assert (seen == 1).all()
    assert len(tile_ranges(n_tiles, g)) - 1 == min(g, n_tiles)


@pytest.mark.parametrize("name", LAYOUTS + ["airfoil L0" + WIDE])
def test_every_listed_slot_lies_in_a_live_tile(name):
    base, _, _, tr = shape(name)
    _, tl = layouts()[base]
    live = kernel4_live(tl)
    dead = dead_tiles(live, tr)
    slots = tl.win_row_slots.long()
    assert not dead[slots // tr].any()
    assert tl.edge_block % tr == 0  # no tile straddles two chunks
