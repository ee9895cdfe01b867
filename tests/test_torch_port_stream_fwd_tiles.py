"""Kernels 11's and 12's forwards on the forward tile walk
(`csrc/fused_gmp_stream.cu` over `csrc/edge_fwd_tiles.cuh` with the
streamed front, then the receiver gather of `csrc/row_gather.cuh` over
`row_ptr` / `row_slots` / `row_long`) on the CPU, where the CUDA kernels
cannot run: what they rely on and the order in which they sum, held
against the plain versions and JAX's v1 / v2 forwards
(`fused_gmp.py::fused_edge_mlp_aggregate`, `::fused_edge_phase`,
interpret mode).

- (a) The receiver lists hold exactly the slots JAX's forwards sum: each
  listed slot in its receiver's row, the lists' slots the plain versions'
  in-block slots, and JAX's forward with a tail whose last layer is zero
  (so that every counted slot adds the same LN output) sums at each row
  as many messages as the row lists, row n_pad − 1 (the last block's pad
  slots) included.
- (b) The walk's grid: block b of G walks tiles b, b + G, b + 2G, ...,
  dead tiles (no slot with a receiver in its chunk's block) skipped; every
  live tile is computed exactly once at G = 1 and at the card's grids (132
  and 264 blocks: one and two blocks per SM), and no listed slot lies in a
  dead tile, so the gather reads no row that no tile writes. With blocks
  placed on SM b mod 132 the blocks of an SM hold ⌊T/132⌋ or ⌈T/132⌉
  tiles together, where the ranges of `tile_ranges` put 4 on four SMs at
  272 tiles on 264 blocks (kernels 4's and 14's level 3), 3 on the rest.
- (c) The walk's order, emulated from the plain version's per-slot
  messages: the live slots of the walked tiles written into `msg`, every
  other row NaN (never written), then the list-order gather, at each of
  those grids, against JAX's forward (`F32_TOL` in f32, the port's bf16
  kernel bound `MLP_TOL` in bf16) and against the plain version at
  chip_smoke.py's limits for kernels 11 and 12 (`TOL`), in f32 and bf16.

Layouts: `test_torch_port_stream_bwd_tiles.py`'s unwindowed levels (the
600-node sphere's levels 0 and 1, a 2,000-node graded airfoil's levels 0,
2 and 4; edge_block 128), kernel 12 on all of them, kernel 11 on the
sphere's; and for kernel 11 also the flag's windowed level 0
(`test_torch_port_dyn_bwd_tiles.py`'s hierarchy: edge_block 512, window
256), where the flag's GMP with a wide world stream runs v1. Inputs: the
streamed rows (zi or pre) and xj 3·N(0, 1), three tail layers at 0.2
(biases 0.05), drawn from seed 4 (kernel 12, `test_torch_port_stream_bwd_
tiles.py`'s draws) or seeds 8 and 20 (kernel 11 on the sphere and the
flag), whose draws leave every ReLU input of a live slot of the levels of
part (c) at least 3e-6 from zero (asserted), where sums in another order
cannot flip a unit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_dyn_bwd_tiles import level as flag_level
from test_torch_port_edge_bwd_tiles import dead_tiles
from test_torch_port_edge_fwd_tiles import slot_messages, walked_tiles
from test_torch_port_stream_bwd_tiles import (
    RELU_MARGIN,
    list_order_gather,
    live_slots,
)
from test_torch_port_stream_bwd_tiles import inputs as stream_inputs
from test_torch_port_stream_bwd_tiles import level as stream_level

from bsms_gnn_tpu.ops.pallas.fused_gmp import (
    fused_edge_mlp_aggregate as jax_v1,
)
from bsms_gnn_tpu.ops.pallas.fused_gmp import fused_edge_phase as jax_v2
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp as fg
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp_stream as fgs
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import tile_ranges

C, LAYERS = 128, 3
TR = fg.TILE_ROWS
UNWINDOWED = ["sphere L0", "sphere L1", "airfoil L0", "airfoil L2",
              "airfoil L4"]
# (kernel, level): kernel 12 ("v2") on the unwindowed levels, kernel 11
# ("v1") on the sphere's and the flag's windowed level 0.
CASES = ([("v2", n) for n in UNWINDOWED]
         + [("v1", n) for n in ("sphere L0", "sphere L1", "flag L0")])
CHECKED = [("v2", "sphere L0"), ("v2", "airfoil L0"), ("v2", "airfoil L4"),
           ("v1", "sphere L0"), ("v1", "flag L0")]
GRIDS = (1, 132, 264)
SMS = 132
# Kernel 11's seeds by mesh (seeds 5 and 9 put a ReLU input within 1e-6
# of zero on both).
V1_SEEDS = {"sphere": 8, "flag": 20}
F32_TOL = 5e-4  # test_torch_port_slice.py's
MLP_TOL = 2e-2  # test_torch_port_kernels.py's bf16 kernel bound
# chip_smoke.py's TOL for kernels 11 and 12 against their plain versions.
PLAIN_TOL = {"f32": (2e-4, 1e-6), "bf16": (2e-2, 2e-5)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def level(name):
    """(JAX level, the port's) by name."""
    return flag_level(name) if name.startswith("flag") else stream_level(name)


@functools.lru_cache(maxsize=None)
def inputs(kernel, name):
    """The kernel's inputs on a level (f32 numpy): the streamed rows [E_pad,
    C] and, for v2, xj [n_pad, C] (3·N(0, 1)); three tail layers at 0.2
    (biases 0.05): v2 `test_torch_port_stream_bwd_tiles.py`'s draws, v1
    its own."""
    if kernel == "v2":
        zi, xj, ws, bs, _ = stream_inputs(name)
        return [zi, xj], ws, bs
    _, tl = level(name)
    rng = np.random.default_rng(V1_SEEDS[name.split()[0]])
    rows = [3 * rng.standard_normal((tl.n_pad_edges, C)).astype(np.float32)]
    ws = tuple((0.2 * rng.standard_normal((C, C))).astype(np.float32)
               for _ in range(LAYERS))
    bs = tuple((0.05 * rng.standard_normal(C)).astype(np.float32)
               for _ in range(LAYERS))
    return rows, ws, bs


def torch_rows(kernel, name, dtype):
    rows, ws, bs = inputs(kernel, name)
    src = torch.from_numpy(rows[0]).to(dtype)
    xj = torch.from_numpy(rows[1]).to(dtype) if kernel == "v2" else None
    return src, xj, [torch.from_numpy(w) for w in ws], [
        torch.from_numpy(b) for b in bs]


def plain(kernel, tl, src, xj, ws, bs):
    with torch.no_grad():
        if kernel == "v2":
            return fgs.fused_edge_phase_plain(tl, src, xj, ws, bs)
        return fgs.fused_edge_mlp_aggregate_plain(tl, src, ws, bs)


def jax_forward(kernel, lj, rows, ws, bs, jd):
    if kernel == "v2":
        return jax_v2(lj, *(jnp.asarray(r).astype(jd) for r in rows), ws, bs)
    return jax_v1(lj, jnp.asarray(rows[0]).astype(jd), ws, bs)


# -- (a) ---------------------------------------------------------------------


@pytest.mark.parametrize("kernel,name", CASES)
def test_receiver_lists_hold_the_slots_jax_sums(kernel, name):
    lj, tl = level(name)
    ptr, slots = tl.row_ptr.numpy(), tl.row_slots.numpy()
    live = live_slots(tl).numpy()
    np.testing.assert_array_equal(np.sort(slots), np.flatnonzero(live))
    owner = np.repeat(np.arange(tl.n_pad_nodes), np.diff(ptr))
    np.testing.assert_array_equal(tl.receivers.numpy()[slots], owner)
    assert ptr[-1] > ptr[-2]  # the last block's pad slots, on n_pad − 1
    # A tail whose last layer is zero: every counted slot's message is u =
    # LN(b_last), so row n of the aggregate is count[n]·u.
    rows, ws, bs = inputs(kernel, name)
    ws = (ws[0], np.zeros((C, C), np.float32))
    bs = (bs[0], np.linspace(-1.0, 1.0, C).astype(np.float32))
    tws, tbs = [torch.from_numpy(w) for w in ws], [torch.from_numpy(b)
                                                   for b in bs]
    u = fg.mlp_tail_plain(torch.zeros(1, C), tws, tbs, False)[0].numpy()
    out = np.asarray(jax_forward(kernel, lj, rows, ws, bs, jnp.float32))
    count = out @ u / (u @ u)
    np.testing.assert_allclose(count, np.rint(count), atol=1e-3)
    np.testing.assert_array_equal(np.rint(count), np.diff(ptr))
    src = torch.from_numpy(rows[0])
    xj = torch.from_numpy(rows[1]) if kernel == "v2" else None
    got = plain(kernel, tl, src, xj, tws, tbs)
    np.testing.assert_allclose(got.numpy(), out, rtol=0, atol=1e-3)


# -- (b) ---------------------------------------------------------------------


def live_tiles(tl):
    return ~dead_tiles(live_slots(tl))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("kernel,name", CASES)
def test_every_live_tile_is_computed_once(kernel, name, grid):
    _, tl = level(name)
    live = live_tiles(tl)
    n_tiles = tl.n_pad_edges // TR
    done = walked_tiles(live.tolist(), n_tiles, grid)
    assert sorted(done) == np.flatnonzero(live.numpy()).tolist()
    assert 0 < len(done) <= n_tiles
    # No listed slot lies in a dead tile: the gather reads only rows that
    # a walked tile writes.
    assert live[tl.row_slots.long() // TR].all()


@pytest.mark.parametrize("n_tiles", [528, 416, 1530, 272])
def test_the_stride_balances_the_sms(n_tiles):
    """Tiles per SM with two blocks per SM placed on SM b mod 132: the
    stride gives every SM ⌊T/132⌋ or ⌈T/132⌉ tiles; the ranges give four
    SMs 4 at 272."""
    g = min(2 * SMS, n_tiles)
    stride = np.bincount(np.arange(n_tiles) % g % SMS, minlength=SMS)
    assert stride.max() - stride.min() <= 1
    assert stride.max() == -(-n_tiles // SMS)
    bounds = np.asarray(tile_ranges(n_tiles, g))
    ranged = np.bincount(np.arange(g) % SMS, weights=np.diff(bounds),
                         minlength=SMS)
    assert ranged.max() >= stride.max()
    if n_tiles == 272:
        assert (stride.max(), ranged.max()) == (3, 4)
        assert (ranged == 4).sum() == 4


def test_the_layouts_have_dead_tiles_to_skip():
    assert any(not bool(live_tiles(level(n)[1]).all()) for _, n in CASES)


# -- (c) ---------------------------------------------------------------------


def relu_margin(kernel, name):
    """The smallest |ReLU input| over the live slots, f32 plain route."""
    _, tl = level(name)
    src, xj, ws, bs = torch_rows(kernel, name, torch.float32)
    pre, _, inb = fgs._stream_pre(tl, src, xj)
    ins, h = [pre], torch.relu(pre)
    for w, b in zip(ws[:-1], bs[:-1]):
        z = h @ w + b
        ins.append(z)
        h = torch.relu(z)
    return min(float(z[inb].abs().min()) for z in ins)


def walk_forward(tl, src, xj, ws, bs, bf16, grid):
    """The walk's function in its order at `grid` blocks: each walked
    tile's messages (the LN output, rounded to bf16 in bf16 mode) of its
    live slots into msg, every other row NaN (never written); then the
    list-order gather over the receiver lists."""
    pre, _, inb = fgs._stream_pre(tl, src, xj)
    msgs = slot_messages(pre, inb, ws, bs, bf16)
    msg = torch.full((tl.n_pad_edges, C), float("nan"))
    for t in walked_tiles(live_tiles(tl).tolist(), tl.n_pad_edges // TR,
                          grid):
        rows = torch.arange(t * TR, (t + 1) * TR)
        keep = rows[inb[rows]]
        msg[keep] = msgs[keep]
    return list_order_gather(tl, msg)


@functools.lru_cache(maxsize=None)
def jax_out(kernel, name, dt):
    """JAX's forward (interpret mode) on the level's inputs, numpy f32."""
    lj, _ = level(name)
    rows, ws, bs = inputs(kernel, name)
    return np.asarray(jax_forward(kernel, lj, rows, ws, bs, DTYPES[dt][1]),
                      np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kernel,name", CHECKED)
def test_walk_order_matches_jax_and_plain(kernel, name, dt):
    assert relu_margin(kernel, name) >= RELU_MARGIN
    _, tl = level(name)
    src, xj, ws, bs = torch_rows(kernel, name, DTYPES[dt][0])
    want = jax_out(kernel, name, dt)
    ref = plain(kernel, tl, src, xj, ws, bs)
    rms = ref.square().mean().sqrt()
    for grid in GRIDS:
        got = walk_forward(tl, src, xj, ws, bs, dt == "bf16", grid)
        assert torch.isfinite(got).all()
        tol = F32_TOL if dt == "f32" else MLP_TOL
        assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()
        err = (got - ref).abs()
        assert err.max() <= PLAIN_TOL[dt][0] * rms, grid
        assert err.square().mean().sqrt() <= PLAIN_TOL[dt][1] * rms, grid
