"""Kernel 13's forward on the forward tile walk (`csrc/fused_gmp_dyn.cu`
over `csrc/edge_fwd_tiles.cuh` with the kDyn front, then the receiver
gather of `csrc/row_gather.cuh`) on the CPU, where the CUDA kernels cannot
run: what it relies on and the order in which it sums, held against the
plain version and JAX's v4 forward (`fused_gmp.py::
fused_edge_phase_win_dyn`, interpret mode).

- (a) The receiver lists (`win_row_ptr`, `win_row_slots`) hold exactly the
  slots the walk computes (an in-window sender and a receiver in the
  chunk's 128-row block), each in its receiver's row, every one in a live
  tile: the lists kernel 13's backward gathers dxj over.
- (b) The walk's grid: block b of G walks tiles b, b + G, b + 2G, ...,
  dead tiles skipped; every live tile is computed exactly once at G = 1
  and at the card's grids (132 and 264 blocks), on every level of the flag
  and the strip.
- (c) The walk's order, emulated from the plain version's per-slot
  messages: only the live tiles' live slots written into `msg`, every
  other row NaN (never written), then the list-order gather, against
  JAX's v4 forward (`F32_TOL` in f32, the port's bf16 kernel bound
  `MLP_TOL` in bf16) and against the plain version at chip_smoke.py's
  limits for kernel 13 (`TOL`), in f32 and bf16.

Layouts and inputs are `test_torch_port_dyn_bwd_tiles.py`'s: the flag's
hierarchy (chip_smoke.py's: `make_grid_strip_mesh(1579, ny=32)`, Morton
order, depth 5, edge_block 512, window 256; its levels hold 200, 152, 104,
80, 48 and 8 tiles) and `test_torch_port_contact.py`'s 520-node strip
(depth 2); xwi, xj 3·N(0, 1), world positions N(0, 1), three tail layers at
0.2 (seed 0). Part (c) runs on the levels whose draws leave every ReLU
input of a live slot at least 3e-6 from zero (asserted: flag levels 0, 4
and 5, strip levels 0 and 2), where sums in another order cannot flip a
unit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_contact import _jax_dyn
from test_torch_port_dyn_bwd_tiles import (
    FLAG,
    RELU_MARGIN,
    inputs,
    level,
    relu_margin,
    torch_args,
)
from test_torch_port_edge_bwd_tiles import (
    dead_tiles,
    list_order_gather,
    win_live,
)
from test_torch_port_edge_fwd_tiles import slot_messages, walked_tiles

from bsms_gnn_tpu_torch.ops.kernels import fused_gmp as fg
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp_dyn as fgd

C = 128
TR = fg.TILE_ROWS
STRIP = ["strip L0", "strip L1", "strip L2"]
# The levels held against JAX and the plain version: those whose draws keep
# every ReLU input of a live slot at least RELU_MARGIN from zero (seed 0
# puts one within 3e-6 at flag levels 1-3 and strip level 1).
CHECKED = ["flag L0", "flag L4", "flag L5", "strip L0", "strip L2"]
F32_TOL = 5e-4  # test_torch_port_slice.py's
MLP_TOL = 2e-2  # test_torch_port_kernels.py's bf16 kernel bound
# chip_smoke.py's TOL for kernel 13 against its plain version.
PLAIN_TOL = {"f32": (2e-5, 1e-6), "bf16": (5e-3, 2e-5)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


# -- (a) ---------------------------------------------------------------------


@pytest.mark.parametrize("name", FLAG + STRIP)
def test_receiver_lists_hold_the_walks_slots(name):
    _, tl = level(name)
    live = win_live(tl)
    _, covered = fg.sender_rows(tl)
    assert torch.equal(live, covered)  # the walk's rule is the plain mask
    ptr, slots = tl.win_row_ptr.long(), tl.win_row_slots.long()
    np.testing.assert_array_equal(np.sort(slots.numpy()),
                                  np.flatnonzero(live.numpy()))
    owner = torch.repeat_interleave(torch.arange(tl.n_pad_nodes),
                                    torch.diff(ptr))
    assert torch.equal(owner, tl.receivers.long()[slots])
    assert not dead_tiles(live)[slots // TR].any()


# -- (b) ---------------------------------------------------------------------


@pytest.mark.parametrize("grid", [1, 132, 264])
@pytest.mark.parametrize("name", FLAG + STRIP)
def test_every_live_tile_is_computed_once(name, grid):
    _, tl = level(name)
    live = ~dead_tiles(win_live(tl))
    n_tiles = tl.n_pad_edges // TR
    done = walked_tiles(live.tolist(), n_tiles, grid)
    assert sorted(done) == np.flatnonzero(live.numpy()).tolist()
    assert 0 < len(done) <= n_tiles


# -- (c) ---------------------------------------------------------------------


def walk_forward(tl, xwi, xj, pos, wf8, wfd, wfn, ws, bs, bf16):
    """The walk's function in its order: each walked tile's messages (the
    LN output, rounded to bf16 in bf16 mode) of its live slots into msg,
    every other row NaN (never written); then the list-order gather."""
    pre, _, _, _, _ = fgd._edge_pre_dyn(tl, xwi, xj, pos, wf8, wfd, wfn,
                                        bf16)
    live = win_live(tl)
    msgs = slot_messages(pre, live, ws, bs, bf16)
    msg = torch.full((tl.n_pad_edges, C), float("nan"))
    for t in walked_tiles((~dead_tiles(live)).tolist(),
                          tl.n_pad_edges // TR, 264):
        rows = torch.arange(t * TR, (t + 1) * TR)
        keep = rows[live[rows]]
        msg[keep] = msgs[keep]
    return list_order_gather(tl, msg)


@functools.lru_cache(maxsize=None)
def jax_v4(name, dt):
    """JAX's v4 forward (interpret mode) on the level's inputs, numpy
    f32."""
    jl, _ = level(name)
    xwi, xj, wpos, wf8, wfd, wfn, ws, bs, _ = inputs(name)
    jd = DTYPES[dt][1]
    out = _jax_dyn(jl, jnp.asarray(wpos).astype(jd), ws, bs)(
        jnp.asarray(xwi).astype(jd), jnp.asarray(xj).astype(jd),
        jnp.asarray(wf8), jnp.asarray(wfd), jnp.asarray(wfn))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", CHECKED)
def test_walk_order_matches_jax_v4_and_plain(name, dt):
    assert relu_margin(name) >= RELU_MARGIN
    tl, xwi, xj, pos, wf8, wfd, wfn, ws, bs, _ = torch_args(
        name, DTYPES[dt][0])
    got = walk_forward(tl, xwi, xj, pos, wf8, wfd, wfn, ws, bs, dt == "bf16")
    assert torch.isfinite(got).all()
    want = jax_v4(name, dt)
    tol = F32_TOL if dt == "f32" else MLP_TOL
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()
    with torch.no_grad():
        plain = fgd.fused_edge_phase_win_dyn_plain(tl, xwi, xj, pos, wf8, wfd,
                                                   wfn, ws, bs)
    err = (got - plain).abs()
    rms = plain.square().mean().sqrt()
    assert err.max() <= PLAIN_TOL[dt][0] * rms
    assert err.square().mean().sqrt() <= PLAIN_TOL[dt][1] * rms
