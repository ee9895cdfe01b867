"""The host tables of kernels 2 and 7's row-ordered gather
(`csrc/row_gather.cuh`) on the CPU: kernel 7's sender-row lists
(`send_row_ptr` / `send_row_slots` of every windowed level), kernel 2's
receiver ranges (`cr_rows` / `cr_row_ptr` of every compact residual), the
lists split into pieces (`send_long`, `cr_long`), and a sum driven by those
tables alone, in the kernel's order, against the plain versions of
`windowed_send_sum` and `compact_accum_raw` and against the JAX package's
`windowed_send_sum_raw` / `compact_accum_raw` (interpret mode).

The layouts are `test_torch_port_window_gather.py`'s: the Morton-ordered
2,000-node airfoil at depth 4 (window 256, edge_block 512; levels 2-4 hold
sender rows of more than 32 slots) and the bucketed 450-node mesh. Two
more cases hold the rules those layouts do not reach:
- "airfoil L0 pad": level 0 with every third pad slot given an in-window
  `send_win`. The TPU kernel's one-hot tests `send_win` alone, so such a
  slot adds its row at its sender row, whatever its receiver.
- "star": a compact residual built by `_compact_resid` from the airfoil's
  level-0 residual edges plus a star of 100 edges onto one receiver. No
  residual of the layouts has a receiver of more than 32 rows.

Tolerance: 1e-6 of the output's RMS. The table-driven sum adds the same
rows as the plain version and JAX in another order, and these sums are
unweighted, with lists of up to 59 rows here, so on rows of N(0, 1) values
f32 rounding alone differs by a few units in the last place of the
largest outputs (5.7e-6 at an RMS of 4.7 on airfoil L3). So the rows (and
kernel 2's acc) are drawn on a grid of 2^-6 within ±8 (`grid_normal`): every
sum of them is then exact in f32 in any order (at most 17 significant
bits; bf16 rounding keeps them on the grid), and a row listed twice,
missed or added at the wrong output moves a sum by at least 2^-6.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_window_gather import (
    _assert_equal_to,
    _check_lists,
    _want_lists,
    check_pieces,
    layouts,
    table_sum,
)

from bsms_gnn_tpu.graph.hierarchy import _compact_resid as jax_compact_resid
from bsms_gnn_tpu.ops.pallas.compact_resid import (
    compact_accum_raw as jax_compact_accum,
)
from bsms_gnn_tpu.ops.pallas.windowed import windowed_send_sum_raw
from bsms_gnn_tpu_torch.graph.hierarchy import (
    _compact_resid,
    _to_device,
    long_rows,
    send_row_tables,
)
from bsms_gnn_tpu_torch.ops.kernels.compact_resid import compact_accum_plain
from bsms_gnn_tpu_torch.ops.kernels.windowed import windowed_send_sum_plain

C = 128
STAR = 100  # edges of the star onto one receiver
SEND_LAYOUTS = ["airfoil L0", "airfoil L2", "airfoil L3", "airfoil L4",
                "bucketed L0", "bucketed L1", "airfoil L0 pad"]
COMPACT_LAYOUTS = ["airfoil L0", "airfoil L1", "airfoil L2",
                   "airfoil T0 down", "airfoil T0 up", "airfoil T1 down",
                   "star"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def grid_normal(rng, shape):
    """N(0, 1) values rounded to the grid of 2^-6 and clipped to ±8, f32."""
    v = np.round(rng.standard_normal(shape) * 64) / 64
    return np.clip(v, -8, 8).astype(np.float32)


def _sender_rows(layout):
    """Each slot's sender row from its chunk's window, in numpy."""
    base = np.repeat(np.asarray(layout.win_base, np.int64),
                     layout.edge_block)
    return base * (layout.window // 2) + np.asarray(layout.send_win)


@functools.lru_cache(maxsize=None)
def pad_case():
    """(JAX level, the port's) of the airfoil's level 0 with every third
    pad slot given the in-window send_win e mod W, and the port's kernel 7
    tables rebuilt from it."""
    jl, tl = layouts()["airfoil L0"]
    sw = tl.send_win.numpy().copy()
    pad = np.flatnonzero(tl.edge_mask.numpy() == 0)[::3]
    sw[pad] = pad % tl.window
    ptr, slots = send_row_tables(sw, tl.win_base.numpy(), tl.edge_block,
                                 tl.window, tl.n_pad_nodes)
    tl = dataclasses.replace(
        tl, send_win=torch.from_numpy(sw), send_row_ptr=torch.from_numpy(ptr),
        send_row_slots=torch.from_numpy(slots),
        send_long=torch.from_numpy(long_rows(ptr)))
    return jl.replace(send_win=jnp.asarray(sw)), tl


def send_layout(name):
    return pad_case() if name == "airfoil L0 pad" else layouts()[name]


@functools.lru_cache(maxsize=None)
def star_case():
    """(JAX compact residual, the port's on the CPU) of the airfoil's
    level-0 residual edges plus STAR edges onto the receiver that already
    has the most rows, from distinct real senders."""
    jl, tl = layouts()["airfoil L0"]
    cr = tl.cresid
    n = cr.n_real
    s, r = cr.senders[:n].numpy(), cr.receivers[:n].numpy()
    hub = int(np.bincount(r).argmax())
    star = np.setdiff1d(np.arange(0, tl.n_nodes, 7), [hub])[:STAR]
    s = np.concatenate([s, star]).astype(np.int64)
    r = np.concatenate([r, np.full(STAR, hub)]).astype(np.int64)
    ew = np.random.default_rng(4).uniform(0.1, 1.0, len(s))
    args = (s, r, ew, ew, tl.n_pad_nodes, None, False)
    return jax_compact_resid(*args), _to_device(_compact_resid(*args), "cpu")


def compact_layout(name):
    if name == "star":
        return star_case()
    jl, tl = layouts()[name]
    return jl.cresid, tl.cresid


@pytest.mark.parametrize("name", SEND_LAYOUTS)
def test_send_row_lists_hold_each_in_window_slot_once(name):
    """Sender row n lists exactly the slots with send_win < W whose
    window puts them at n, in slot order: each such slot once, pad slots
    included, whatever the receiver (computed here from JAX's arrays)."""
    jl, tl = send_layout(name)
    send_win = np.asarray(jl.send_win)
    live = send_win < jl.window
    ptr, slots = tl.send_row_ptr.numpy(), tl.send_row_slots.numpy()
    _check_lists(ptr, slots,
                 *_want_lists(_sender_rows(jl), live, tl.n_pad_nodes))
    assert len(slots) == live.sum()
    pad = np.asarray(jl.edge_mask) == 0
    if name == "airfoil L0 pad":  # not kernel 1's lists
        assert (live & pad).sum() > 0
        assert len(slots) > tl.win_row_slots.numel()


@pytest.mark.parametrize("name", COMPACT_LAYOUTS)
def test_compact_row_lists_hold_each_real_row_once(name):
    """cr_rows are the distinct receivers of the real compact rows,
    ascending; receiver cr_rows[k] owns the range cr_row_ptr[k] ..
    cr_row_ptr[k+1], exactly the real rows with that receiver in JAX's
    tables; the ranges cover rows 0 .. n_real once, and no pad row."""
    jcr, cr = compact_layout(name)
    recv = np.asarray(jcr.receivers)[:jcr.n_real]
    rows, ptr = cr.cr_rows.numpy(), cr.cr_row_ptr.numpy()
    assert rows.dtype == ptr.dtype == np.int32
    np.testing.assert_array_equal(rows, np.unique(recv))
    assert ptr[0] == 0 and ptr[-1] == jcr.n_real < jcr.senders.shape[-1]
    assert (np.diff(ptr) > 0).all()
    for k, r in enumerate(rows):
        np.testing.assert_array_equal(np.arange(ptr[k], ptr[k + 1]),
                                      np.flatnonzero(recv == r))
    np.testing.assert_array_equal(cr.cr_long.numpy(), long_rows(ptr))
    if name == "star":
        assert np.diff(ptr).max() > STAR > 32


@pytest.mark.parametrize("name", ["send airfoil L2", "send airfoil L3",
                                  "send airfoil L4", "compact star"])
def test_long_lists_split_into_ordered_pieces(name):
    """The lists of more than 32 slots or rows (`send_long`, `cr_long`) are
    cut into ordered pieces of at most 32 over the block's 8 warps in
    turn, every position once."""
    kind, layout = name.split(" ", 1)
    if kind == "send":
        tl = layouts()[layout][1]
        ptr, long = tl.send_row_ptr.numpy(), tl.send_long.numpy()
    else:
        cr = compact_layout(layout)[1]
        ptr, long = cr.cr_row_ptr.numpy(), cr.cr_long.numpy()
    assert len(long) > 0
    check_pieces(ptr, long)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", SEND_LAYOUTS)
def test_table_sum_equals_the_plain_send_sum(name, dt):
    """Kernel 7's function from its tables alone, in its order (each
    slot's own row, no weight), against the plain version and JAX's
    windowed_send_sum_raw."""
    jl, tl = send_layout(name)
    jd, td = DTYPES[dt]
    vals = grid_normal(np.random.default_rng(21), (tl.n_pad_edges, C))
    vt = torch.from_numpy(vals).to(td)
    e = tl.n_pad_edges
    got = table_sum(tl.send_row_ptr, tl.send_row_slots.long(), tl.send_long,
                    torch.arange(e), vt, torch.ones(e))
    _assert_equal_to(got, windowed_send_sum_plain(tl, vt))
    want = windowed_send_sum_raw(jl, jnp.asarray(vals).astype(jd))
    _assert_equal_to(got, torch.tensor(np.asarray(want, np.float32)))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", COMPACT_LAYOUTS)
def test_table_sum_equals_the_plain_compact_accum(name, dt):
    """Kernel 2's function from its tables alone, in its order (each
    receiver's range of rows summed, then added onto its row of a random
    acc; the other rows of acc kept), against the plain version and JAX's
    compact_accum_raw."""
    jcr, cr = compact_layout(name)
    jd, td = DTYPES[dt]
    rng = np.random.default_rng(22)
    vals = grid_normal(rng, (cr.n_rows, C))
    acc = grid_normal(rng, (cr.n_pad_nodes, C))
    vt = torch.from_numpy(vals).to(td)
    n = cr.n_real
    sums = table_sum(cr.cr_row_ptr, torch.arange(n), cr.cr_long,
                     torch.arange(cr.n_rows), vt, torch.ones(cr.n_rows))
    got = torch.from_numpy(acc.copy())
    rows = cr.cr_rows.long()
    got[rows] = got[rows] + sums
    _assert_equal_to(got, compact_accum_plain(cr, vt, torch.tensor(acc)))
    want = jax_compact_accum(jcr, jnp.asarray(vals).astype(jd),
                             jnp.asarray(acc))
    _assert_equal_to(got, torch.tensor(np.asarray(want, np.float32)))
