"""Edge ↔ node data movement (counterpart of `bsms_gnn_tpu/ops/scatter.py`:
`gather_send`, `gather_recv`, `aggregate_recv`, `aggregate_send`, each by
`method`).

- `"ell"` (the JAX package's default): the aggregates are ELL sums, a
  gather of each node's padded incident-edge slots (`recv_ell` /
  `send_ell`, pad slot E_pad reading a zero row) and a sum over the K
  axis; each op's backward is the other kind of gather: a gather's
  backward the ELL sum over its dual table, an aggregate's backward the
  row selection by its dual index (`_gather_edges`, `_aggregate_edges`,
  `scatter.py:66-100`). The autograd Functions keep only index tables,
  never the gathered [..., N, K, C] rows, as JAX's custom VJPs do.
- `"segment"` (JAX's parity oracle): row selections and `index_add`, each
  differentiated by autograd, as JAX autodiffs `take` and `segment_sum`;
  the pad slots sum onto row n_pad − 1, which `"ell"` leaves out.
- `"pallas"` (block-aligned layouts; the default here, which the kernel
  routes call): the gathers are row selections whose backward sums the
  edge cotangents back onto the nodes through kernel 8
  (`kernels/segment_sum.py`): the sender form for `gather_send`, the
  receiver form for `gather_recv`, as `_gather_with_pallas_bwd`
  (`scatter.py:121-175`) does on the TPU. On a skip-empty layout (a
  residual sub-level) the sums run through kernel 9's store form instead,
  since kernel 8 refuses such layouts: the function of JAX's kernel 9 onto
  zeros (`scatter.py:149-171`), with no zero fill. `aggregate_recv` is
  kernel 8 (f32 out). `aggregate_send` has no kernel form: the port's
  routes sum sender-side only on narrow rows, which JAX's pallas method
  takes through its ELL form too.

`"ell"` and `"segment"` launch no kernel, on any device; they take any
leading dims (x [..., N_pad, C], edge rows [..., E_pad, C]). The `pallas`
gathers take the batch axis of a shared mesh (x [B, N_pad, C]): they
select on dim -2 and their backwards run kernel 8 at B in one launch. On a
skip-empty layout kernel 9 takes one block of rows, so a [B, ...] input
raises NotImplementedError("batch axis") there, before any work: a batch
reaches these layouts as the union of its samples' hierarchies ([B·N_pad,
C], `graph.hierarchy.union`). Any other method raises NotImplementedError.
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.ops.kernels.build import check_batch
from bsms_gnn_tpu_torch.ops.kernels.segment_sum import (
    segment_sum,
    segment_sum_raw,
)
from bsms_gnn_tpu_torch.ops.kernels.segment_sum_accum import (
    segment_sum_accum_raw,
    segment_sum_accum_send_raw,
)


def _ell_sum(feat, ell):
    """Σ_k feat[..., ell[n, k], :] → [..., N_pad, C]: the ELL table's slots
    of each node (pad slot E_pad reads an appended zero row), summed over
    the K axis in feat's dtype (`scatter.py:37-48`)."""
    padf = torch.cat([feat, feat.new_zeros(*feat.shape[:-2], 1,
                                           feat.shape[-1])], dim=-2)
    n, k = ell.shape
    g = padf.index_select(-2, ell.reshape(-1))
    return g.reshape(*feat.shape[:-2], n, k, feat.shape[-1]).sum(dim=-2)


def _seg_sum(feat, index, n_out: int):
    """The segment sum over dim -2 (`scatter.py:51-58`): edge row e adds
    onto node index[e], the pad slots onto the pad node."""
    out = feat.new_zeros(*feat.shape[:-2], n_out, feat.shape[-1])
    return out.index_add(-2, index, feat)


class _EllGather(torch.autograd.Function):
    """x[..., idx, :]; backward: the ELL sum of the cotangent over the dual
    table (`_gather_edges`)."""

    @staticmethod
    def forward(ctx, x, idx, dual_ell):
        ctx.dual_ell = dual_ell
        return x.index_select(-2, idx)

    @staticmethod
    def backward(ctx, g):
        return _ell_sum(g, ctx.dual_ell), None, None


class _EllAggregate(torch.autograd.Function):
    """The ELL sum of edge rows onto nodes; backward: the node cotangents
    selected back onto the edges by the dual index (`_aggregate_edges`)."""

    @staticmethod
    def forward(ctx, feat, ell, dual_idx):
        ctx.dual_idx = dual_idx
        return _ell_sum(feat, ell)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(-2, ctx.dual_idx), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, level, send, x):
        ctx.level, ctx.send, ctx.dtype = level, send, x.dtype
        return x.index_select(-2, level.senders if send else level.receivers)

    @staticmethod
    def backward(ctx, ct):
        lvl = ctx.level
        if lvl.skip_empty:
            accum = (segment_sum_accum_send_raw if ctx.send
                     else segment_sum_accum_raw)
            out = accum(lvl, ct, None)
        else:
            out = segment_sum_raw(lvl, ct, send=ctx.send)
        return None, None, out.to(ctx.dtype)


def _unknown(method: str):
    return NotImplementedError(f"aggregation method {method!r}")


def _gather(level, x, send: bool, method: str):
    idx, dual = ((level.senders, level.send_ell) if send
                 else (level.receivers, level.recv_ell))
    if method == "ell":
        return _EllGather.apply(x, idx, dual)
    if method == "segment":
        return x.index_select(-2, idx)
    if method == "pallas":
        check_batch(x, not level.skip_empty)
        return _Gather.apply(level, send, x)
    raise _unknown(method)


def gather_send(level, x, method: str = "pallas"):
    """x_i = x[senders] → [..., E_pad, C]."""
    return _gather(level, x, True, method)


def gather_recv(level, x, method: str = "pallas"):
    """x_j = x[receivers] → [..., E_pad, C]."""
    return _gather(level, x, False, method)


def aggregate_recv(level, feat, method: str = "pallas"):
    """Σ_{e: recv(e)=n} feat[e] → [..., N_pad, C] (f32 from kernel 8 on
    `"pallas"`, feat's dtype otherwise)."""
    if method == "ell":
        return _EllAggregate.apply(feat, level.recv_ell, level.receivers)
    if method == "segment":
        return _seg_sum(feat, level.receivers, level.n_pad_nodes)
    if method == "pallas":
        return segment_sum(level, feat)
    raise _unknown(method)


def aggregate_send(level, feat, method: str = "ell"):
    """Σ_{e: send(e)=n} feat[e] → [..., N_pad, C] (the up conv's sender
    sums) on the `"ell"` and `"segment"` forms."""
    if method == "ell":
        return _EllAggregate.apply(feat, level.send_ell, level.senders)
    if method == "segment":
        return _seg_sum(feat, level.senders, level.n_pad_nodes)
    raise _unknown(method)
