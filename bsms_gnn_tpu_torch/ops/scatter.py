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
C], `graph.hierarchy.union`).

`"halo:<group>[:<local>]"` (counterpart of `parallel/halo.py:146-404` of
the JAX package): one shard's part of an edge-partitioned level
(`parallel/partition.py::HaloLevel`, moved by `graph.hierarchy.
to_device`) in the process group registered as `<group>`
(`parallel/mesh.py`). `<local>` is the method the shard runs its own part
on ("ell" if none is named; "fusedK" is "fused"): the kernel methods sum
the ghost layout's slots with kernel 8, the others with `index_add`. On a
plain halo layout:
- gather_send gathers [x_loc ; halo rows] (one `all_to_all_single`,
  `parallel/halo.py::halo_rows`) by `senders_ext`; its backward sums by
  sender over the extended rows and returns the halo rows' sums to their
  owners (the adjoint exchange, `halo_return`), and aggregate_send is that
  sum, whose backward is the gather;
- gather_recv and aggregate_recv are local: each edge lives on its
  receiver's shard.
On a ghost layout (`HaloLevel.local`, whose slots hold each cross-shard
edge's reversed twin too):
- gather_send gathers the extended rows by the layout's senders; its
  backward is the layout's sender sum, the halo rows' part returned to
  their owners;
- gather_recv reads the receivers clamped to the local pad row (a ghost
  slot's output is dead in every receiver sum); its backward is the
  receiver sum's owned rows;
- aggregate_recv and aggregate_send sum every slot by receiver or by
  sender and keep the owned rows, with no exchange (the ghost slots carry
  the remote-owned out-edges); their backwards gather the cotangent, zero
  past the owned rows, by receiver or by sender.
A replicated level (every shard holds the whole level) exchanges nothing.
Every primitive takes any leading dims, the exchange included.

`"eshard:<group>:<local>"` (`parallel/edge_shard.py`) names no primitive
here: the GMP and the convs sum the rank's slots with the `<local>` forms
above, then over the group (`eshard_parts` parses it).

Any other method raises NotImplementedError.
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.config import split_interleave
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


# The local methods a halo method may name, and those that run kernels.
HALO_LOCAL = ("ell", "segment", "pallas", "fused")
KERNEL_LOCAL = ("pallas", "fused")


def halo_parts(method: str):
    """("<group>", "<local>") of a `"halo:<group>[:<local>]"` method (local
    "ell" when not named, "fusedK" read as "fused"), None for any other
    method."""
    if not method.startswith("halo:"):
        return None
    parts = method.split(":")
    if len(parts) not in (2, 3) or not parts[1]:
        raise _unknown(method)
    local = split_interleave(parts[2])[0] if len(parts) == 3 else "ell"
    if local not in HALO_LOCAL:
        raise _unknown(method)
    return parts[1], local


# The local methods an edge-sharded method may name
# (`parallel/edge_shard.py`): the kernel-free ones and `fused`'s windowed
# routes. `pallas` fuses its aggregate with the node phase (kernel 10), so
# no group sum fits between them.
ESHARD_LOCAL = ("ell", "segment", "fused")


def eshard_parts(method: str):
    """("<group>", "<local>") of an `"eshard:<group>:<local>"` method
    ("fusedK" read as "fused"), None for any other method."""
    if not method.startswith("eshard:"):
        return None
    parts = method.split(":")
    if len(parts) != 3 or not parts[1]:
        raise _unknown(method)
    local = split_interleave(parts[2])[0]
    if local not in ESHARD_LOCAL:
        raise NotImplementedError(
            f"{method!r}: an edge shard runs {ESHARD_LOCAL}; {local!r} "
            f"has no group sum between its aggregate and its node phase")
    return parts[1], local


def _halo():
    # Imported at use: `parallel` imports the model, which imports this.
    from bsms_gnn_tpu_torch.parallel import halo

    return halo


def _pad_rows(x, n_rows: int):
    """Zero rows appended on dim -2 up to n_rows."""
    return torch.cat([x, x.new_zeros(*x.shape[:-2], n_rows - x.shape[-2],
                                     x.shape[-1])], dim=-2)


def ghost_sum(lg, feat, send: bool, kernels: bool):
    """Σ feat over the ghost layout `lg`'s slots by receiver or by sender
    (every slot, ghosts included) → [..., N_ext_pad, C]: kernel 8 (its
    sender form through the reverse edges; f32 out, narrow rows its plain
    version) with `kernels`, else `index_add`."""
    if kernels:
        return segment_sum_raw(lg, feat, send=send)
    return _seg_sum(feat, lg.senders if send else lg.receivers,
                    lg.n_pad_nodes)


def _plain_send_gather(level, x, group):
    """[x_loc ; halo rows][senders_ext] on a plain halo layout. Its
    autograd is the sender sum below (the gather's backward sums by
    extended row, `HaloRows`' returns the halo rows' sums)."""
    ext = x if level.replicated else torch.cat(
        [x, _halo().HaloRows.apply(x, level.halo_send, group)], dim=-2)
    return ext.index_select(-2, level.senders_ext)


def _plain_send_sum(level, feat, group):
    """Σ_{e: send(e)=n} feat[e] on a plain halo layout: the sums by
    extended sender row, the halo rows' returned to their owners
    (`HaloReturn`, whose backward is the halo exchange: the autograd of
    this sum is the gather above)."""
    n_loc = level.n_pad_nodes
    if level.replicated:
        return _seg_sum(feat, level.senders_ext, n_loc)
    part = _seg_sum(feat, level.senders_ext, n_loc + level.halo_send.numel())
    return part[..., :n_loc, :] + _halo().HaloReturn.apply(
        part[..., n_loc:, :], level.halo_send, n_loc, group)


class _GhostSendGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, level, group, kernels, x):
        ctx.level, ctx.group, ctx.kernels, ctx.dtype = (level, group, kernels,
                                                         x.dtype)
        ext = _halo().ext_assemble(level, x, group)
        return ext.index_select(-2, level.local.senders)

    @staticmethod
    def backward(ctx, ct):
        level = ctx.level
        n_loc = level.n_pad_nodes
        full = ghost_sum(level.local, ct, True, ctx.kernels)
        out = full[..., :n_loc, :]
        if not level.replicated:
            nh = level.halo_send.numel()
            out = out + _halo().halo_return(
                full[..., n_loc:n_loc + nh, :], level.halo_send, n_loc,
                ctx.group)
        return None, None, None, out.to(ctx.dtype)


class _GhostRecvGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, level, kernels, x):
        ctx.level, ctx.kernels, ctx.dtype = level, kernels, x.dtype
        return x.index_select(-2, level.recv_clamped)

    @staticmethod
    def backward(ctx, ct):
        full = ghost_sum(ctx.level.local, ct, False, ctx.kernels)
        return None, None, full[..., :ctx.level.n_pad_nodes, :].to(ctx.dtype)


class _GhostSum(torch.autograd.Function):
    """Σ over every slot of the ghost layout by receiver or by sender, the
    owned rows kept; backward: the cotangent (zero past the owned rows)
    gathered by receiver or by sender."""

    @staticmethod
    def forward(ctx, level, send, kernels, feat):
        ctx.level, ctx.send, ctx.dtype = level, send, feat.dtype
        full = ghost_sum(level.local, feat, send, kernels)
        return full[..., :level.n_pad_nodes, :]

    @staticmethod
    def backward(ctx, ct):
        lg = ctx.level.local
        ct_ext = _pad_rows(ct, lg.n_pad_nodes)
        idx = lg.senders if ctx.send else lg.receivers
        return None, None, None, ct_ext.index_select(-2, idx).to(ctx.dtype)


def _halo_gather(level, x, send: bool, method: str):
    group, local = halo_parts(method)
    kernels = local in KERNEL_LOCAL
    if level.local is not None:
        if send:
            return _GhostSendGather.apply(level, group, kernels, x)
        return _GhostRecvGather.apply(level, kernels, x)
    if send:
        return _plain_send_gather(level, x, group)
    return x.index_select(-2, level.receivers)


def _halo_aggregate(level, feat, send: bool, method: str):
    group, local = halo_parts(method)
    if level.local is not None:
        return _GhostSum.apply(level, send, local in KERNEL_LOCAL, feat)
    if send:
        return _plain_send_sum(level, feat, group)
    return _seg_sum(feat, level.receivers, level.n_pad_nodes)


def _gather(level, x, send: bool, method: str):
    if method.startswith("halo:"):
        return _halo_gather(level, x, send, method)
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
    `"pallas"` and on a ghost halo layout's kernel methods, feat's dtype
    otherwise)."""
    if method.startswith("halo:"):
        return _halo_aggregate(level, feat, False, method)
    if method == "ell":
        return _EllAggregate.apply(feat, level.recv_ell, level.receivers)
    if method == "segment":
        return _seg_sum(feat, level.receivers, level.n_pad_nodes)
    if method == "pallas":
        return segment_sum(level, feat)
    raise _unknown(method)


def aggregate_send(level, feat, method: str = "ell"):
    """Σ_{e: send(e)=n} feat[e] → [..., N_pad, C] (the up conv's sender
    sums) on the `"ell"` and `"segment"` forms and the halo methods."""
    if method.startswith("halo:"):
        return _halo_aggregate(level, feat, True, method)
    if method == "ell":
        return _EllAggregate.apply(feat, level.send_ell, level.senders)
    if method == "segment":
        return _seg_sum(feat, level.senders, level.n_pad_nodes)
    raise _unknown(method)
