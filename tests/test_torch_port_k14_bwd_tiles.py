"""Kernel 14's backward on the edge backward tile walk
(`csrc/fused_gmp_k_bwd.cu` over `csrc/edge_bwd_tiles.cuh` with the windowed
front, then the receiver gather of `csrc/row_gather.cuh` and
`grad_sum_kernel`) on the CPU, where the CUDA kernels cannot run: what it
relies on and the order in which it sums, held against the plain version
and JAX's v5 backward (`fused_gmp.py::fused_edge_phase_win_k`, interpret
mode).

- (a) On the levels that pass the density gate, the receiver lists
  (`win_row_ptr`, `win_row_slots`) hold exactly the slots to which JAX's
  v5 backward (`_get_bwd5`, as the custom VJP calls it) gives a nonzero
  cotangent, each in its receiver's row; so does the plain version.
- (b) The dead-tile rule: a tile with no live slot writes zero dpre rows,
  so dpre must be exactly zero there, in the plain version and in JAX's
  kernel.
- (c) The walk's order of sums, emulated from the plain version's per-slot
  operands: per-block partials [dW | db | dwf8] over `tile_ranges(T, G)`
  for G in {1, 132} (one block; the H100's SMs at one block each), the
  blocks added in order; dxj by the gather of dpre (bf16 in bf16 mode)
  over the receiver lists in list order. Against `jax.vjp` of JAX's
  `fused_edge_phase_win_k` at K = 2 and 4 (K orders only the TPU kernel's
  sums): `F32_TOL` in f32, the port's bf16 kernel bound `MLP_TOL` in bf16;
  against the plain version at chip_smoke.py's `BWD_TOL` for kernel 14.

The case: `test_torch_port_interleave.py`'s Morton-ordered 2,000-node
airfoil (depth 4, window 256, edge_block 512), whose levels 3 and 4 pass
the gate. Inputs (seed 4): xwi, xj 3·N(0, 1) (zero on pad rows), g
N(0, 1), wf8 0.3·N(0, 1), three tail layers at 0.2 (biases 0.05), so that
the hidden ReLU inputs spread to a scale of ~5; this draw leaves every
ReLU input of a live slot at least 3e-6 from zero (asserted; seeds 0-3
put one within 1.2e-6 at level 3), where sums in another order cannot
flip a unit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_edge_bwd_tiles import (
    dead_tiles,
    list_order_gather,
    walk_sum,
    win_live,
)
from test_torch_port_interleave import airfoil
from test_torch_port_train import assert_close

from bsms_gnn_tpu.ops.pallas import fused_gmp as jfg
from bsms_gnn_tpu.ops.pallas.fused_gmp import fused_edge_phase_win_k as jax_v5
from bsms_gnn_tpu.ops.pallas.windowed import _pack_rows
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp as fg
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp_k as fgk
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import round_bf16

C, LAYERS = 128, 3
TR = fg.TILE_ROWS
GATED = (3, 4)
F32_TOL = 5e-4  # test_torch_port_slice.py's
MLP_TOL = 2e-2  # test_torch_port_kernels.py's bf16 kernel bound
# chip_smoke.py's BWD_TOL for kernel 14's backward against its plain
# version: (largest error, RMS error) of each output's RMS.
PLAIN_TOL = {"f32": (2e-5, 2e-6), "bf16": (1e-1, 5e-4)}
RELU_MARGIN = 3e-6
GRIDS = (1, 132)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
OUTPUTS = ("dxj", "dwf8", "dW", "db")


def level(l):
    hj, ht, _, _ = airfoil()
    return hj.levels[l], ht.levels[l]


@functools.lru_cache(maxsize=None)
def inputs(l, seed=4):
    """Kernel 14's backward inputs on level l (f32 numpy): xwi, xj, wf8,
    the tail's weights and biases, g."""
    _, tl = level(l)
    rng = np.random.default_rng(seed)
    mask = np.asarray(tl.node_mask, np.float32).reshape(-1, 1)
    xwi, xj = ((3 * rng.standard_normal((tl.n_pad_nodes, C)) * mask)
               .astype(np.float32) for _ in range(2))
    g = (rng.standard_normal((tl.n_pad_nodes, C)) * mask).astype(np.float32)
    wf8 = (0.3 * rng.standard_normal((8, C))).astype(np.float32)
    ws = tuple((0.2 * rng.standard_normal((C, C))).astype(np.float32)
               for _ in range(LAYERS))
    bs = tuple((0.05 * rng.standard_normal(C)).astype(np.float32)
               for _ in range(LAYERS))
    return xwi, xj, wf8, ws, bs, g


def torch_args(l, dt="f32"):
    """The plain backward's arguments; xwi and xj in dt's dtype."""
    xwi, xj, wf8, ws, bs, g = inputs(l)
    t, td = torch.from_numpy, DTYPES[dt][0]
    return (level(l)[1], t(xwi).to(td), t(xj).to(td), t(wf8),
            [t(w) for w in ws], [t(b) for b in bs], t(g))


@functools.lru_cache(maxsize=None)
def jax_bwd5(l, k):
    """JAX's v5 backward kernel (`_get_bwd5`, interpret mode) as
    `fused_edge_phase_win_k`'s custom VJP calls it, f32: dpre reassembled
    from its K streams' chunk ranges, numpy."""
    lj, _ = level(l)
    xwi, xj, wf8, ws, bs, g = inputs(l)
    e, n, be = lj.n_pad_edges, lj.n_pad_nodes, lj.edge_block
    tabs, _, recv = jfg._chunk_tables5(lj, k)
    sw = _pack_rows(lj.send_win.astype(jnp.int32), be, e // be, lj.window)
    call = jfg._get_bwd5(e, n, C, LAYERS, True, "float32", "float32", be,
                         lj.window // 2, k)
    stream = [lj.fiber_t.astype(jnp.float32), jnp.asarray(xwi),
              jnp.asarray(xwi), jnp.asarray(xj), sw, recv, jnp.asarray(g)]
    out = jax.jit(call)(*tabs, *(stream * k), jnp.asarray(wf8),
                        jnp.stack(ws), jnp.stack(bs))
    nc = e // be
    m = -(-nc // k)
    parts = [np.asarray(out[s])[:(min((s + 1) * m, nc) - s * m) * be]
             for s in range(k) if min((s + 1) * m, nc) > s * m]
    return np.concatenate(parts)


@functools.lru_cache(maxsize=None)
def jax_v5_vjp(l, k, dt):
    """jax.vjp of JAX's `fused_edge_phase_win_k` (interpret mode): (dxj,
    dwf8, dW, db), numpy f32."""
    lj, _ = level(l)
    xwi, xj, wf8, ws, bs, g = inputs(l)
    jd = DTYPES[dt][1]

    @jax.jit
    def grads(b, w8, w, bb, cot):
        _, vjp = jax.vjp(
            lambda *a: jax_v5(lj, jnp.asarray(xwi).astype(jd), *a, k),
            b, w8, w, bb)
        return vjp(cot)

    dxj, dwf8, dws, dbs = grads(
        jnp.asarray(xj).astype(jd), jnp.asarray(wf8),
        tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
        jnp.asarray(g))
    return tuple(np.asarray(jnp.asarray(x).astype(jnp.float32))
                 for x in (dxj, dwf8, jnp.stack(dws), jnp.stack(dbs)))


def relu_margin(l):
    """The smallest |ReLU input| over the live slots, f32 plain route."""
    tl, xwi, xj, wf8, ws, bs, _ = torch_args(l)
    pre, covered, _ = fg._edge_pre(tl, xwi, xj, wf8, False)
    ins, h = [pre], torch.relu(pre)
    for w, b in zip(ws[:-1], bs[:-1]):
        z = h @ w + b
        ins.append(z)
        h = torch.relu(z)
    return min(float(z[covered].abs().min()) for z in ins)


# -- (a) ---------------------------------------------------------------------


@pytest.mark.parametrize("l", GATED)
def test_receiver_lists_hold_the_v5_backwards_slots(l):
    _, tl = level(l)
    assert fgk.passes_gate(tl)
    slots = np.sort(tl.win_row_slots.numpy())
    np.testing.assert_array_equal(slots, np.flatnonzero(win_live(tl).numpy()))
    ptr, recv = tl.win_row_ptr.numpy(), tl.receivers.numpy()
    rows = np.repeat(np.arange(tl.n_pad_nodes), np.diff(ptr))
    np.testing.assert_array_equal(recv[tl.win_row_slots.numpy()], rows)
    for k in (2, 4):
        nonzero = np.flatnonzero(np.abs(jax_bwd5(l, k)).max(1) > 0)
        np.testing.assert_array_equal(nonzero, slots)
    dpre = fgk.fused_edge_phase_win_k_bwd_plain(*torch_args(l), 2)[0]
    np.testing.assert_array_equal(
        np.flatnonzero(dpre.abs().amax(1).numpy() > 0), slots)


# -- (b) ---------------------------------------------------------------------


@pytest.mark.parametrize("l", GATED)
def test_dead_tiles_have_zero_dpre(l):
    _, tl = level(l)
    live = win_live(tl)
    dead = dead_tiles(live)
    assert 0 < int(dead.sum()) < len(dead)  # the rule has tiles to skip
    dpre = fgk.fused_edge_phase_win_k_bwd_plain(*torch_args(l), 2)[0]
    assert (dpre.view(-1, TR, C)[dead] == 0).all()
    assert (dpre[~live] == 0).all()  # and every masked slot, live tiles too
    for k in (2, 4):
        assert (jax_bwd5(l, k).reshape(-1, TR, C)[dead.numpy()] == 0).all()


# -- (c) ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def walk_backward(l, dt, grid):
    """The walk's outputs in its order, bf16 rounding points included: the
    per-slot operands of the plain backward, each block's tiles summed in
    tile order into its partial, the partials in block order; dxj by the
    list-order gather of dpre as stored."""
    tl, xwi, xj, wf8, ws, bs, g = torch_args(l, dt)
    bf16 = dt == "bf16"
    pre, covered, recv = fg._edge_pre(tl, xwi, xj, wf8, bf16)
    normed, inv, hs = fg.mlp_tail_fwd_save(pre, ws, bs, bf16)
    ge = torch.where(covered[:, None], g.index_select(0, recv), 0.0)
    if bf16:
        ge = round_bf16(ge)
    d = (ge - ge.mean(-1, keepdim=True)
         - normed * (ge * normed).mean(-1, keepdim=True)) * inv
    ds = [None] * LAYERS
    for i in range(LAYERS - 1, -1, -1):
        ds[i] = d
        d = fg.dot(d, ws[i].t(), bf16)
        if i:
            d = d * (hs[i] > 0)
    dpre = d * (pre > 0)

    def term(s):
        return torch.cat(
            [fg.dot(hs[i][s].t(), ds[i][s], bf16).reshape(-1)
             for i in range(LAYERS)]
            + [ds[i][s].sum(0) for i in range(LAYERS)]
            + [fg.dot(tl.fiber_t[:, s], dpre[s], bf16).reshape(-1)])

    total = walk_sum(tl.n_pad_edges, covered, grid, term)
    dw, db, dwf8 = total.split([LAYERS * C * C, LAYERS * C, 8 * C])
    stored = round_bf16(dpre) if bf16 else dpre
    return (list_order_gather(tl, stored), dwf8.view(8, C),
            dw.view(LAYERS, C, C), db.view(LAYERS, C))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("l", GATED)
def test_walk_order_matches_jax_v5_and_plain(l, k, dt):
    assert relu_margin(l) >= RELU_MARGIN
    _, dxj_p, dwf8_p, dw_p, db_p = fgk.fused_edge_phase_win_k_bwd_plain(
        *torch_args(l, dt), k)
    plain = (dxj_p, dwf8_p, dw_p, db_p)
    want = jax_v5_vjp(l, k, dt)
    tol = F32_TOL if dt == "f32" else MLP_TOL
    for grid in GRIDS:
        got = walk_backward(l, dt, grid)
        for name, a, p, j in zip(OUTPUTS, got, plain, want):
            what = f"{name} grid {grid} {dt}"
            assert torch.isfinite(a).all(), what
            err = (a - p).abs()
            rms = p.square().mean().sqrt()
            assert err.max() <= PLAIN_TOL[dt][0] * rms, what
            assert err.square().mean().sqrt() <= PLAIN_TOL[dt][1] * rms, what
            assert_close(a, j, tol, f"{what} vs JAX")
