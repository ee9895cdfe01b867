"""Kernel 12's backward on the edge backward tile walk
(`csrc/edge_bwd_tiles.cuh` with the streamed front and the receiver row xj,
then the receiver gather of `csrc/row_gather.cuh` over `row_ptr` /
`row_slots`) on the CPU, where the CUDA kernels cannot run: what it relies
on and the order in which it sums, held against the plain version and
JAX's v2 backward (`fused_gmp.py::_get_bwd2` through `fused_edge_phase`'s
VJP, interpret mode).

- (a) The receiver lists (`row_ptr`, `row_slots`, `row_long`) hold
  exactly the slots to which JAX's v2 backward gives a nonzero cotangent
  (a receiver in the chunk's 128-row block; the last block's pad slots on
  row n_pad − 1), each once, in its receiver's row, in slot order.
- (b) The dead-tile rule: a tile with no slot in its chunk's block writes
  zero dzi rows and skips the walk, so dzi must be exactly zero there, in
  the plain version and in JAX's kernel.
- (c) The walk's order of sums, emulated from the plain version's per-slot
  operands: per-block partials [dW | db] over `tile_ranges(T, G)` for G in
  {1, 25, 132} (one block; a few; the H100's SMs at one block each), the
  blocks added in order; dxj by the gather over the receiver lists in list
  order, of dzi as stored (bf16-rounded in bf16 mode).

Layouts (unwindowed, edge_block 128, as the `airfoil_plain` path's):
the 600-node sphere of `test_torch_port_fused_stream.py` (levels 0 and 1)
and a 2,000-node graded airfoil, not reordered, depth 4 (levels 0, 2 and
4). Inputs: zi, xj 3·N(0, 1), three tail layers at 0.2 (biases 0.05), g
N(0, 1), so that the hidden ReLU inputs spread to a scale of ~5, drawn
from seed 4, whose draws leave every ReLU input of a live slot of the
levels the order is checked on at least 3e-6 from zero (asserted), where
JAX's sums in another order cannot flip a unit (seeds 0-3 put one within
1e-6 at some level of the five).

Tolerances:
- against the plain version, f32: a largest error of 2e-4 and an RMS
  error of 2e-6 of each output's RMS (chip_smoke.py's f32 `BWD_TOL` for
  kernel 12's backward): only the grouping of f32 sums changes.
- against JAX, f32: `F32_TOL` (5e-4) of the largest |value|, the port's
  f32 limit (`test_torch_port_slice.py`); bf16: `MLP_TOL` (2e-2), the
  port's bf16 kernel bound (`test_torch_port_kernels.py`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_edge_bwd_tiles import (
    dead_tiles,
    ordered_row_sums,
    per_slot_terms,
    walk_sum,
)
from test_torch_port_train import assert_close

from bsms_gnn_tpu.data.synthetic import make_graded_airfoil_mesh as jax_airfoil
from bsms_gnn_tpu.data.synthetic import make_sphere_mesh as jax_sphere
from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.ops.pallas.fused_gmp import fused_edge_phase as jax_v2
from bsms_gnn_tpu_torch.data.synthetic import (
    make_graded_airfoil_mesh,
    make_sphere_mesh,
)
from bsms_gnn_tpu_torch.graph.hierarchy import (
    GATHER_PIECE,
    build_hierarchy,
    long_rows,
    to_device,
)
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp as fg
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp_stream as fgs
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import round_bf16

C, LAYERS = 128, 3
TR = fg.TILE_ROWS
# A case "... deep": four tail layers, still on the backward walk's `Base`
# plan with the streamed front (its tiles keep no fiber stream, so five
# 64-slot tiles fit a block: `fused_gmp.walk_plan`).
DEEP = " deep"


def layers_of(name):
    return 4 if name.endswith(DEEP) else LAYERS
MESHES = {"sphere": (600, 2), "airfoil": (2000, 4)}
LEVELS = ["sphere L0", "sphere L1", "airfoil L0", "airfoil L2", "airfoil L4"]
F32_TOL = 5e-4
MLP_TOL = 2e-2
PLAIN_TOL = (2e-4, 2e-6)
RELU_MARGIN = 3e-6
GRIDS = (1, 25, 132)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def hierarchies(mesh):
    """(JAX hierarchy, the port's) of a mesh on the default unwindowed
    layout (edge_block 128)."""
    n_nodes, depth = MESHES[mesh]
    make, jmake = ((make_sphere_mesh, jax_sphere) if mesh == "sphere"
                   else (make_graded_airfoil_mesh, jax_airfoil))
    pos, cells, _ = make(n_nodes, np.random.default_rng(0))
    np.testing.assert_array_equal(jmake(n_nodes, np.random.default_rng(0))[1],
                                  cells)
    p64 = pos.astype(np.float64)
    hj = jax_build(jax_flat_edge(cells, "tri"), depth, len(pos), p64)
    ht = to_device(build_hierarchy(to_flat_edge(cells, "tri"), depth,
                                   len(pos), p64), "cpu")
    assert all(g.window == 0 and g.edge_block == 128 for g in ht.levels)
    return hj, ht


def level(name):
    mesh, lv = name.removesuffix(DEEP).split(" L")
    hj, ht = hierarchies(mesh)
    return hj.levels[int(lv)], ht.levels[int(lv)]


@functools.lru_cache(maxsize=None)
def inputs(name, seed=4):
    """Kernel 12's backward inputs on a level (f32 numpy): zi [E_pad, C],
    xj [n_pad, C] (3·N(0, 1)), three tail layers at 0.2 (biases 0.05), g
    [n_pad, C] (N(0, 1))."""
    _, tl = level(name)
    rng = np.random.default_rng(seed)
    zi = rng.standard_normal((tl.n_pad_edges, C)).astype(np.float32)
    xj, g = (rng.standard_normal((tl.n_pad_nodes, C)).astype(np.float32)
             for _ in range(2))
    ws = tuple((0.2 * rng.standard_normal((C, C))).astype(np.float32)
               for _ in range(layers_of(name)))
    bs = tuple((0.05 * rng.standard_normal(C)).astype(np.float32)
               for _ in range(layers_of(name)))
    return 3 * zi, 3 * xj, ws, bs, g


def torch_args(name, dtype=torch.float32):
    zi, xj, ws, bs, g = inputs(name)
    t = torch.from_numpy
    return (level(name)[1], t(zi).to(dtype), t(xj).to(dtype),
            [t(w) for w in ws], [t(b) for b in bs], t(g))


@functools.lru_cache(maxsize=None)
def jax_bwd2(name, dt="f32"):
    """jax.vjp of JAX's v2 kernel (interpret mode): (dzi, dxj, dW, db),
    numpy f32."""
    lj, _ = level(name)
    zi, xj, ws, bs, g = inputs(name)
    jd = DTYPES[dt][0]
    _, vjp = jax.vjp(lambda a, b, w, bb: jax_v2(lj, a, b, w, bb),
                     jnp.asarray(zi).astype(jd), jnp.asarray(xj).astype(jd),
                     ws, bs)
    dzi, dxj, dws, dbs = vjp(jnp.asarray(g))
    return (np.asarray(dzi.astype(jnp.float32)),
            np.asarray(dxj.astype(jnp.float32)), np.stack(dws),
            np.stack(dbs))


def live_slots(tl):
    return fgs.in_block(tl)[1]


def list_order_gather(tl, rows):
    """dxj[n] = Σ rows[e] over receiver row n's `row_slots`, in list
    order, f32."""
    return ordered_row_sums(tl.row_ptr, tl.row_slots.long(), rows)


# -- (a) ---------------------------------------------------------------------


@pytest.mark.parametrize("name", LEVELS)
def test_receiver_lists_hold_the_v2_backwards_slots(name):
    _, tl = level(name)
    ptr, slots = tl.row_ptr.numpy(), tl.row_slots.numpy()
    live = live_slots(tl).numpy()
    np.testing.assert_array_equal(np.sort(slots), np.flatnonzero(live))
    # Each slot once, in its receiver's row, in slot order within a row.
    recv = tl.receivers.numpy()
    rows = np.repeat(np.arange(tl.n_pad_nodes), np.diff(ptr))
    np.testing.assert_array_equal(recv[slots], rows)
    for r in range(tl.n_pad_nodes):
        s = slots[ptr[r]:ptr[r + 1]]
        assert (np.diff(s) > 0).all()
    # The last block's pad slots are listed, on row n_pad − 1.
    last = tl.n_pad_nodes - 1
    assert ptr[last + 1] > ptr[last]
    # The rows the gather cuts into pieces.
    np.testing.assert_array_equal(tl.row_long.numpy(), long_rows(ptr))
    assert all(ptr[r + 1] - ptr[r] > GATHER_PIECE for r in tl.row_long.numpy())
    # JAX's v2 backward gives exactly these slots a nonzero cotangent, and
    # so does the plain version.
    nonzero = np.flatnonzero(np.abs(jax_bwd2(name)[0]).max(1) > 0)
    np.testing.assert_array_equal(nonzero, np.flatnonzero(live))
    dzi = fgs.fused_edge_phase_bwd_plain(*torch_args(name))[0]
    np.testing.assert_array_equal(
        np.flatnonzero(dzi.abs().amax(1).numpy() > 0), np.flatnonzero(live))


# -- (b) ---------------------------------------------------------------------


@pytest.mark.parametrize("name", LEVELS)
def test_dead_tiles_have_zero_dzi(name):
    _, tl = level(name)
    live = live_slots(tl)
    dead = dead_tiles(live)
    assert int((~dead).sum()) > 0
    dzi = fgs.fused_edge_phase_bwd_plain(*torch_args(name))[0]
    assert (dzi.view(-1, TR, C)[dead] == 0).all()
    assert (dzi[~live] == 0).all()  # and every masked slot, live tiles too
    assert (jax_bwd2(name)[0].reshape(-1, TR, C)[dead.numpy()] == 0).all()


def test_the_layouts_have_dead_tiles_to_skip():
    assert any(bool(dead_tiles(live_slots(level(n)[1])).any())
               for n in LEVELS)


# -- (c) ---------------------------------------------------------------------


def slot_operands(name, bf16=False):
    """The plain backward's per-slot operands on a level, f32: (each tail
    layer's input, each layer's cotangent, dzi before its storage
    rounding)."""
    tl, zi, xj, ws, bs, g = torch_args(
        name, torch.bfloat16 if bf16 else torch.float32)
    pre, recv, inb = fgs._stream_pre(tl, zi, xj)
    normed, inv, hs = fg.mlp_tail_fwd_save(pre, ws, bs, bf16)
    ge = torch.where(inb[:, None], g.index_select(0, recv), 0.0)
    if bf16:
        ge = round_bf16(ge)
    if not bf16:
        ds, dzi = per_slot_terms(pre, hs, normed, inv, ge, ws)
        return hs, ds, dzi
    return hs, None, fg.mlp_tail_bwd(pre, hs, normed, inv, ge, ws, True)[0]


def relu_margin(name):
    """The smallest |ReLU input| over the live slots, f32 plain route."""
    tl, zi, xj, ws, bs, _ = torch_args(name)
    pre, _, inb = fgs._stream_pre(tl, zi, xj)
    ins, h = [pre], torch.relu(pre)
    for w, b in zip(ws[:-1], bs[:-1]):
        z = h @ w + b
        ins.append(z)
        h = torch.relu(z)
    return min(float(z[inb].abs().min()) for z in ins)


def assert_plain_close(got, want, what):
    err = (got - want).abs()
    rms = want.square().mean().sqrt()
    assert err.max() <= PLAIN_TOL[0] * rms, what
    assert err.square().mean().sqrt() <= PLAIN_TOL[1] * rms, what


@pytest.mark.parametrize("name", ["sphere L0", "airfoil L0", "airfoil L4",
                                  "sphere L0" + DEEP])
def test_walk_order_of_sums(name):
    """dxj by the receiver lists, dW and db by block partials, against the
    plain outputs and JAX's v2 backward."""
    assert relu_margin(name) >= RELU_MARGIN
    assert fg.walk_plan(C, layers_of(name), "stream",
                        torch.float32)[1] == TR
    tl = level(name)[1]
    dzi_p, dxj_p, dw_p, db_p = fgs.fused_edge_phase_bwd_plain(
        *torch_args(name))
    hs, ds, dzi = slot_operands(name)
    dzi_j, dxj_j, dw_j, db_j = jax_bwd2(name)
    assert_plain_close(dzi, dzi_p, "dzi")
    assert_close(dzi, dzi_j, F32_TOL, "dzi vs JAX")

    dxj = list_order_gather(tl, dzi)
    assert_plain_close(dxj, dxj_p, "dxj")
    assert_close(dxj, dxj_j, F32_TOL, "dxj vs JAX")
    live = live_slots(tl)
    for grid in GRIDS:
        for l in range(layers_of(name)):
            dw = walk_sum(tl.n_pad_edges, live, grid,
                          lambda s: hs[l][s].t() @ ds[l][s])
            db = walk_sum(tl.n_pad_edges, live, grid,
                          lambda s: ds[l][s].sum(0))
            assert_plain_close(dw, dw_p[l], f"dW{l} grid {grid}")
            assert_plain_close(db, db_p[l], f"db{l} grid {grid}")
            assert_close(dw, dw_j[l], F32_TOL, f"dW{l} grid {grid} vs JAX")
            assert_close(db, db_j[l], F32_TOL, f"db{l} grid {grid} vs JAX")


@pytest.mark.parametrize("name", ["sphere L0", "airfoil L0"])
def test_bf16_dxj_gathers_dzi_as_stored(name):
    """In bf16 the walk stores dzi in bf16 and the gather sums those rows
    in f32 in list order: the plain version's dxj (index_add_ of the
    rounded dpre, in another order) at the f32 limits, and JAX's bf16 dxj
    within the bf16 kernel bound."""
    assert relu_margin(name) >= RELU_MARGIN
    tl = level(name)[1]
    _, dxj_p, _, _ = fgs.fused_edge_phase_bwd_plain(
        *torch_args(name, torch.bfloat16))
    _, _, dzi = slot_operands(name, bf16=True)
    stored = dzi.to(torch.bfloat16)
    dxj = list_order_gather(tl, stored)
    assert_plain_close(dxj, dxj_p, "dxj")
    assert_close(dxj, jax_bwd2(name, "bf16")[1], MLP_TOL, "dxj vs JAX")
