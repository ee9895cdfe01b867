"""Kernel 14's forward on the forward tile walk (`csrc/fused_gmp_k.cu` over
`csrc/edge_fwd_tiles.cuh`, then the receiver gather of
`csrc/row_gather.cuh`) on the CPU, where the CUDA kernels cannot run: what
it relies on and the order in which it sums, held against the plain
version and JAX's v5 forward (`fused_gmp.py::fused_edge_phase_win_k`,
interpret mode).

- (a) On the levels that pass the density gate, the receiver lists
  (`win_row_ptr`, `win_row_slots`) hold exactly the slots the walk
  computes (an in-window sender and a receiver in the chunk's 128-row
  block), each in its receiver's row, and every one lies in a live tile.
- (b) The walk's grid: block b of G walks tiles b, b + G, b + 2G, ...,
  dead tiles skipped; every live tile of a gated level is computed exactly
  once, at the grids of the card (132 and 264 blocks) and on one block.
- (c) The walk's order, emulated from the plain version's per-slot
  messages: only the live tiles' live slots written into `msg`, every
  other row NaN (never written), then the list-order gather, against JAX's
  v5 at K = 2 and 4 (F32_TOL in f32, the port's bf16 kernel bound MLP_TOL
  in bf16), and against the plain version at chip_smoke.py's limits for
  kernel 14 (`TOL`). K orders nothing of the walk's result.

The case: `test_torch_port_interleave.py`'s Morton-ordered 2,000-node
airfoil (depth 4, window 256, edge_block 512), whose levels 3 and 4 pass
the gate (6.0 and 9.0 chunks per 128-node block).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_edge_bwd_tiles import dead_tiles, list_order_gather
from test_torch_port_edge_fwd_tiles import (
    kernel4_live,
    slot_messages,
    walked_tiles,
)
from test_torch_port_interleave import airfoil

from bsms_gnn_tpu.ops.pallas.fused_gmp import fused_edge_phase_win_k as jax_v5
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp as fg
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp_k as fgk

C = 128
TR = fg.TILE_ROWS
GATED = (3, 4)
F32_TOL = 5e-4  # test_torch_port_slice.py's
MLP_TOL = 2e-2  # test_torch_port_kernels.py's bf16 kernel bound
# chip_smoke.py's TOL for kernel 14 against its plain version.
PLAIN_TOL = {"f32": (2e-5, 1e-6), "bf16": (5e-3, 2e-5)}


def level(l):
    hj, ht, _, _ = airfoil()
    return hj.levels[l], ht.levels[l]


def test_the_gated_levels():
    _, ht, _, _ = airfoil()
    assert [l for l, g in enumerate(ht.levels)
            if fgk.passes_gate(g)] == list(GATED)


# -- (a) ---------------------------------------------------------------------


@pytest.mark.parametrize("l", GATED)
def test_receiver_lists_hold_the_walks_slots(l):
    _, tl = level(l)
    live = kernel4_live(tl)
    _, covered = fg.sender_rows(tl)
    assert torch.equal(live, covered)
    ptr, slots = tl.win_row_ptr.long(), tl.win_row_slots.long()
    np.testing.assert_array_equal(np.sort(slots.numpy()),
                                  np.flatnonzero(live.numpy()))
    owner = torch.repeat_interleave(torch.arange(tl.n_pad_nodes),
                                    torch.diff(ptr))
    assert torch.equal(owner, tl.receivers.long()[slots])
    assert not dead_tiles(live)[slots // TR].any()


# -- (b) ---------------------------------------------------------------------


@pytest.mark.parametrize("grid", [1, 132, 264])
@pytest.mark.parametrize("l", GATED)
def test_every_live_tile_is_computed_once(l, grid):
    _, tl = level(l)
    live = ~dead_tiles(kernel4_live(tl))
    n_tiles = tl.n_pad_edges // TR
    done = walked_tiles(live.tolist(), n_tiles, grid)
    assert sorted(done) == np.flatnonzero(live.numpy()).tolist()
    assert 0 < len(done) < n_tiles  # the gated levels have dead tiles


# -- (c) ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def inputs(l, seed=9):
    """xwi, xj unit normal (zero on pad rows), wf8 at 0.3, three tail layers
    at 0.05 (f32 numpy)."""
    _, tl = level(l)
    rng = np.random.default_rng(seed)
    mask = np.asarray(tl.node_mask, np.float32).reshape(-1, 1)
    xwi, xj = ((rng.standard_normal((tl.n_pad_nodes, C)) * mask)
               .astype(np.float32) for _ in range(2))
    wf8 = (0.3 * rng.standard_normal((8, C))).astype(np.float32)
    ws = tuple((0.05 * rng.standard_normal((C, C))).astype(np.float32)
               for _ in range(3))
    bs = tuple((0.05 * rng.standard_normal(C)).astype(np.float32)
               for _ in range(3))
    return xwi, xj, wf8, ws, bs


def walk_forward(tl, xwi, xj, wf8, ws, bs, bf16):
    """The walk's function in its order: each walked tile's messages (the
    LN output, rounded to bf16 in bf16 mode) of its live slots into msg,
    every other row NaN (never written); then the list-order gather."""
    pre, _, _ = fg._edge_pre(tl, xwi, xj, wf8, bf16)
    live = kernel4_live(tl)
    msgs = slot_messages(pre, live, ws, bs, bf16)
    msg = torch.full((tl.n_pad_edges, C), float("nan"))
    for t in walked_tiles((~dead_tiles(live)).tolist(),
                          tl.n_pad_edges // TR, 264):
        rows = torch.arange(t * TR, (t + 1) * TR)
        keep = rows[live[rows]]
        msg[keep] = msgs[keep]
    return list_order_gather(tl, msg)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("l", GATED)
def test_walk_order_matches_jax_v5_and_plain(l, k, dt):
    jl, tl = level(l)
    xwi, xj, wf8, ws, bs = inputs(l)
    tdt, jdt = ((torch.float32, jnp.float32) if dt == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    t = torch.from_numpy
    args = (t(xwi).to(tdt), t(xj).to(tdt), t(wf8), [t(w) for w in ws],
            [t(b) for b in bs])
    got = walk_forward(tl, *args, dt == "bf16")
    assert torch.isfinite(got).all()
    want = np.asarray(jax_v5(jl, jnp.asarray(xwi).astype(jdt),
                             jnp.asarray(xj).astype(jdt), jnp.asarray(wf8),
                             ws, bs, k)).astype(np.float32)
    scale = np.abs(want).max()
    tol = F32_TOL if dt == "f32" else MLP_TOL
    assert np.abs(got.numpy() - want).max() <= tol * scale
    plain = fgk.fused_edge_phase_win_k_plain(tl, *args, k)
    err = (got - plain).abs()
    rms = plain.square().mean().sqrt()
    assert err.max() <= PLAIN_TOL[dt][0] * rms
    assert err.square().mean().sqrt() <= PLAIN_TOL[dt][1] * rms
