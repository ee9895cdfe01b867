"""Kernel 9 (`csrc/segment_sum_accum.cu`) on the row-ordered gather
(`csrc/row_gather.cuh`), on the CPU, where the CUDA kernel cannot run.

- The long lists: on every residual sub-level (a skip-empty layout) the
  last block's pad slots land on row n_pad − 1, and where they are more
  than GATHER_PIECE = 32 that row is a long list, which the gather cuts
  into pieces over a block of its own (`row_long`). `row_long` lists
  exactly the rows of more than 32 slots, and the sender lists
  (`row_send`) are the receiver lists' reverse edges, one for one, so they
  share it.
- The order of sums: kernel 8's (test_torch_port_agg_cluster.py's
  `gather_order_sum`: a list of up to 32 slots from zero in list order,
  the walk of a warp's four lists; a longer one in pieces of 32, piece j
  into warp j mod 8, the warps' sums added in warp order), then acc's row
  added once. A sum driven by the layout's tables alone in that order,
  both forms, on acc and in the store form (no acc), against the plain
  version and JAX's `segment_sum_accum_raw` / `segment_sum_accum_send_raw`
  (interpret mode; the store form against JAX's call on zeros), exactly
  on every row: the rows and acc are drawn on test_torch_port_row_gather.
  py's `grid_normal` grid, where every f32 sum is exact in any order, so
  a slot listed twice, missed or added at the wrong row shows.
- On N(0, 1) rows the new order equals the old kernel's (acc plus a
  sequential sum in list order) bit for bit on every short list, and
  moves off it only on the long ones.
- The skip-empty gathers' backward (`ops/scatter.py::_Gather`) takes the
  store form, with no zero fill.

Layouts: test_torch_port_buckets.py's group (two Morton-ordered Delaunay
meshes of 450 and 600 nodes, depth 2, window 256, edge_block 512, in one
size group): each mesh's level-0 residual sub-level (N_pad 640, its pad
row 128 and 127 slots), and the 600-node mesh's forced empty residual
(level 1: one chunk of 128 pad slots, all on row 383).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_agg_cluster import gather_order_sum
from test_torch_port_buckets import WINDOW, forced, group
from test_torch_port_row_gather import grid_normal

from bsms_gnn_tpu.ops.pallas.segment_sum import (
    segment_sum_accum_raw as jax_accum,
)
from bsms_gnn_tpu.ops.pallas.segment_sum import (
    segment_sum_accum_send_raw as jax_accum_send,
)
from bsms_gnn_tpu_torch.graph.hierarchy import GATHER_PIECE, to_device
from bsms_gnn_tpu_torch.ops import scatter
from bsms_gnn_tpu_torch.ops.kernels import segment_sum_accum as ssa

C = 128
LAYOUTS = ["450 L0", "600 L0", "forced"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# (layout, form, dtype, whether on acc): f32 on every layout, bf16 on the
# 450-node mesh's, each in both forms, on acc and in the store form.
SUMS = [(w, f, "f32", a) for w in LAYOUTS for f in ("recv", "send")
        for a in (True, False)]
SUMS += [("450 L0", f, "bf16", a) for f in ("recv", "send")
         for a in (True, False)]


@pytest.fixture(scope="module")
def resids():
    """layout → (JAX residual sub-level, the port's on the CPU)."""
    _, _, pairs = group(WINDOW)
    out = {}
    for name, (hj, ht) in zip(("450 L0", "600 L0"), pairs):
        out[name] = hj.levels[0].resid, to_device(ht, "cpu").levels[0].resid
    hj, ht = forced()
    out["forced"] = hj.levels[1].resid, to_device(ht, "cpu").levels[1].resid
    return out


def pad_slots_of_last_row(r):
    """The pad slots (edge_mask 0) listed at row n_pad − 1."""
    ptr, slots = r.row_ptr.numpy(), r.row_slots.numpy()
    last = slots[ptr[-2]:ptr[-1]]
    return int((r.edge_mask.numpy()[last] == 0).sum())


def kernel9_order(r, feat, acc, send):
    """f32 [n_pad, C]: the gather's order over `row_ptr` and `row_slots`
    (`row_send`), then acc's row added (none in the store form)."""
    idx = (r.row_send if send else r.row_slots).numpy()
    s = gather_order_sum(r.row_ptr.numpy(), idx, feat)
    return s if acc is None else s + acc


@pytest.mark.parametrize("where", LAYOUTS)
def test_long_rows_of_residual_sublevels(resids, where):
    """`row_long` lists exactly the rows of more than 32 slots, and row
    n_pad − 1 is among them where the last block's pad slots exceed 32;
    every row's receiver (sender) lists name that row."""
    _, r = resids[where]
    assert r.skip_empty
    ptr = r.row_ptr.numpy()
    assert len(ptr) == r.n_pad_nodes + 1
    length = np.diff(ptr)
    np.testing.assert_array_equal(r.row_long.numpy(),
                                  np.flatnonzero(length > GATHER_PIECE))
    if pad_slots_of_last_row(r) > GATHER_PIECE:
        assert r.n_pad_nodes - 1 in r.row_long.numpy()
    rows = np.repeat(np.arange(r.n_pad_nodes), length)
    np.testing.assert_array_equal(r.receivers.numpy()[r.row_slots.numpy()],
                                  rows)
    send = r.row_send.numpy()
    np.testing.assert_array_equal(r.senders.numpy()[send], rows)
    assert len(np.unique(send)) == len(send)


def test_some_pad_row_is_long(resids):
    """The layouts reach the gather's long path: each pad row holds more
    than 32 pad slots (128, 127 and 128) and is a long list, and no other
    row is."""
    for where in LAYOUTS:
        _, r = resids[where]
        assert pad_slots_of_last_row(r) > GATHER_PIECE, where
        np.testing.assert_array_equal(r.row_long.numpy(),
                                      [r.n_pad_nodes - 1])


@pytest.mark.parametrize("where,form,dt,on_acc", SUMS)
def test_gather_order_sum_exact(resids, where, form, dt, on_acc):
    jl, r = resids[where]
    send = form == "send"
    rng = np.random.default_rng(30 + LAYOUTS.index(where) + 10 * send)
    feat = grid_normal(rng, (r.n_pad_edges, C))
    acc = grid_normal(rng, (r.n_pad_nodes, C))
    jdt, tdt = DTYPES[dt]
    ft = torch.from_numpy(feat).to(tdt)
    at = torch.from_numpy(acc) if on_acc else None
    got = kernel9_order(r, ft, at, send)
    ssa.segment_sum_accum_plain.calls = 0
    plain = ssa.segment_sum_accum_raw(r, ft, at, send=send)
    assert ssa.segment_sum_accum_plain.calls == 1
    assert plain.dtype == torch.float32
    jacc = jnp.asarray(acc if on_acc else np.zeros_like(acc))
    want = (jax_accum_send if send else jax_accum)(
        jl, jnp.asarray(feat).astype(jdt), jacc)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not on_acc:
        # The store form is the call on zeros, bit for bit.
        zeros = ssa.segment_sum_accum_raw(r, ft, torch.zeros(r.n_pad_nodes, C),
                                          send=send)
        np.testing.assert_array_equal(plain.numpy().view(np.int32),
                                      zeros.numpy().view(np.int32))


@pytest.mark.parametrize("where", LAYOUTS)
def test_order_moves_only_long_lists(resids, where):
    """On N(0, 1) rows the gather's order, acc added last, equals acc plus
    a sequential sum in list order (the order of the one-warp-a-row kernel
    it replaces) bit for bit on every short list; the long pad row's sum
    moves off it, within f32 rounding."""
    _, r = resids[where]
    rng = np.random.default_rng(40 + LAYOUTS.index(where))
    feat = torch.from_numpy(rng.standard_normal(
        (r.n_pad_edges, C)).astype(np.float32))
    acc = torch.from_numpy(rng.standard_normal(
        (r.n_pad_nodes, C)).astype(np.float32))
    got = kernel9_order(r, feat, acc, False)
    ptr, length = r.row_ptr.numpy(), np.diff(r.row_ptr.numpy())
    v = feat[torch.from_numpy(r.row_slots.numpy()).long()]
    seq = torch.zeros_like(acc)
    for i in range(length.max()):
        rows = np.flatnonzero(length > i)
        seq[rows] += v[ptr[rows] + i]
    old = acc + seq
    long = r.row_long.numpy()
    short = np.setdiff1d(np.arange(r.n_pad_nodes), long)
    torch.testing.assert_close(got[short], old[short], rtol=0, atol=0)
    assert not torch.equal(got[long], old[long])
    torch.testing.assert_close(got[long], old[long], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", ["recv", "send"])
def test_gather_backward_takes_the_store_form(resids, monkeypatch, form):
    """`gather_send` / `gather_recv` on a residual sub-level: the backward
    calls kernel 9's sender / receiver form with no acc, fills no zeros,
    and gives the store form's sums in x's dtype."""
    _, r = resids["450 L0"]
    send = form == "send"
    seen = []

    def record(name, fn):
        def wrapped(level, feat, acc, *rest):
            seen.append((name, acc))
            return fn(level, feat, acc, *rest)
        return wrapped

    monkeypatch.setattr(scatter, "segment_sum_accum_raw",
                        record("recv", ssa.segment_sum_accum_raw))
    monkeypatch.setattr(scatter, "segment_sum_accum_send_raw",
                        record("send", ssa.segment_sum_accum_send_raw))
    rng = np.random.default_rng(50 + send)
    x = torch.from_numpy(grid_normal(rng, (r.n_pad_nodes, C))).requires_grad_()
    ct = torch.from_numpy(grid_normal(rng, (r.n_pad_edges, C)))
    y = (scatter.gather_send if send else scatter.gather_recv)(r, x)

    def no_fill(*args, **kwargs):
        raise AssertionError("the backward filled zeros")

    monkeypatch.setattr(torch.Tensor, "new_zeros", no_fill)
    y.backward(ct)
    monkeypatch.undo()
    assert seen == [(form, None)]
    want = kernel9_order(r, ct, None, send)
    torch.testing.assert_close(x.grad, want, rtol=0, atol=0)
