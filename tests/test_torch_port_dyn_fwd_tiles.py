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

- (d) In bf16 at latent 256 with four tail layers, the kernel's own order
  of f32 sums with the plain version's rounding points, against the plain
  version, beside a control that skips the hidden rounding
  (`bf16_order.py`'s `kernel_order_messages`, which that script also holds
  against the card's kernel).

(a)-(c) also run at the `WideFwd` plan (latent 256, four tail layers,
32-slot tiles: `WIDE_CASES`, "... wide").

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
from test_torch_port_wide_contact import _jax_dyn as _jax_dyn_wide
from test_torch_port_dyn_bwd_tiles import (
    FLAG,
    RELU_MARGIN,
    WIDE,
    inputs,
    level,
    relu_margin,
    torch_args,
    width_of,
)
from test_torch_port_edge_bwd_tiles import (
    dead_tiles,
    list_order_gather,
    win_live,
)
from test_torch_port_edge_fwd_tiles import slot_messages, walked_tiles

from bf16_order import kernel_order_messages
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp as fg
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp_dyn as fgd

C = 128
TR = fg.TILE_ROWS
STRIP = ["strip L0", "strip L1", "strip L2"]
# Cases at latent 256 with four tail layers: the forward walk's `WideFwd`
# plan, 32-slot tiles.
WIDE_CASES = ["flag L0" + WIDE, "flag L3" + WIDE, "strip L0" + WIDE]


def tr_of(name):
    """The tile rows of kernel 13's forward walk at the case's shape."""
    wide = name.endswith(WIDE)
    return fg.walk_plan(width_of(name), 4 if wide else 3, "dyn",
                        torch.float32, backward=False)[1]
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


@pytest.mark.parametrize("name", FLAG + STRIP + WIDE_CASES)
def test_receiver_lists_hold_the_walks_slots(name):
    _, tl = level(name)
    TR = tr_of(name)  # noqa: N806 (the case's tile rows)
    live = win_live(tl)
    _, covered = fg.sender_rows(tl)
    assert torch.equal(live, covered)  # the walk's rule is the plain mask
    ptr, slots = tl.win_row_ptr.long(), tl.win_row_slots.long()
    np.testing.assert_array_equal(np.sort(slots.numpy()),
                                  np.flatnonzero(live.numpy()))
    owner = torch.repeat_interleave(torch.arange(tl.n_pad_nodes),
                                    torch.diff(ptr))
    assert torch.equal(owner, tl.receivers.long()[slots])
    assert not dead_tiles(live, TR)[slots // TR].any()


# -- (b) ---------------------------------------------------------------------


@pytest.mark.parametrize("grid", [1, 132, 264])
@pytest.mark.parametrize("name", FLAG + STRIP + WIDE_CASES)
def test_every_live_tile_is_computed_once(name, grid):
    _, tl = level(name)
    TR = tr_of(name)  # noqa: N806 (the case's tile rows)
    live = ~dead_tiles(win_live(tl), TR)
    n_tiles = tl.n_pad_edges // TR
    done = walked_tiles(live.tolist(), n_tiles, grid)
    assert sorted(done) == np.flatnonzero(live.numpy()).tolist()
    assert 0 < len(done) <= n_tiles


# -- (c) ---------------------------------------------------------------------


def walk_forward(tl, xwi, xj, pos, wf8, wfd, wfn, ws, bs, bf16,
                 TR=TR):  # noqa: N803 (the case's tile rows)
    """The walk's function in its order on tiles of TR slots: each walked
    tile's messages (the LN output, rounded to bf16 in bf16 mode) of its
    live slots into msg, every other row NaN (never written); then the
    list-order gather."""
    pre, _, _, _, _ = fgd._edge_pre_dyn(tl, xwi, xj, pos, wf8, wfd, wfn,
                                        bf16)
    live = win_live(tl)
    msgs = slot_messages(pre, live, ws, bs, bf16)
    msg = torch.full((tl.n_pad_edges, xwi.shape[-1]), float("nan"))
    for t in walked_tiles((~dead_tiles(live, TR)).tolist(),
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
    jax_dyn = _jax_dyn_wide if width_of(name) == 256 else _jax_dyn
    out = jax_dyn(jl, jnp.asarray(wpos).astype(jd), ws, bs)(
        jnp.asarray(xwi).astype(jd), jnp.asarray(xj).astype(jd),
        jnp.asarray(wf8), jnp.asarray(wfd), jnp.asarray(wfn))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", CHECKED + ["strip L0" + WIDE])
def test_walk_order_matches_jax_v4_and_plain(name, dt):
    assert relu_margin(name) >= RELU_MARGIN
    tl, xwi, xj, pos, wf8, wfd, wfn, ws, bs, _ = torch_args(
        name, DTYPES[dt][0])
    got = walk_forward(tl, xwi, xj, pos, wf8, wfd, wfn, ws, bs, dt == "bf16",
                       tr_of(name))
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


# -- (d) ---------------------------------------------------------------------


@pytest.mark.parametrize("name", [f"flag L{l}{WIDE}" for l in range(6)]
                         + ["strip L0" + WIDE])
def test_bf16_kernel_order_rounds_where_the_plain_version_rounds(name):
    """Kernel 13's bf16 forward at (256, 4) emulated in its own order of
    f32 sums, with the plain version's rounding points, against the plain
    version: within chip_smoke.py's largest-error limit for kernel 13
    (PLAIN_TOL), while a control that leaves the hidden activations
    unrounded misses it and lands at least 20 times further in RMS error
    (83 to 1,500 times on these draws). So the kernel rounds where the
    plain version rounds, and what separates them is the order of the
    sums, which alone reads up to 2.13e-5 of the RMS here (flag level 0,
    the card's RMS limit 2e-5; PERF.md §6)."""
    tl, xwi, xj, pos, wf8, wfd, wfn, ws, bs, _ = torch_args(
        name, torch.bfloat16)
    with torch.no_grad():
        plain = fgd.fused_edge_phase_win_dyn_plain(tl, xwi, xj, pos, wf8, wfd,
                                                   wfn, ws, bs)
    rms = plain.square().mean().sqrt()
    err = {}
    for round_hidden in (True, False):
        got = list_order_gather(tl, kernel_order_messages(
            tl, xwi, xj, pos, wf8, wfd, wfn, ws, bs, round_hidden))
        d = (got - plain).abs()
        err[round_hidden] = (float(d.max() / rms),
                             float(d.square().mean().sqrt() / rms))
    assert err[True][0] <= PLAIN_TOL["bf16"][0] < err[False][0], err
    assert err[False][1] >= 20 * err[True][1], err
