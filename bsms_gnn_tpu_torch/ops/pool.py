"""Pool / unpool between hierarchy levels (counterpart of
`bsms_gnn_tpu/ops/pool.py::pool_nodes` / `unpool_nodes`): both row
gathers, each the other's adjoint.

pool: h_child[m] = h_parent[pool_ids[m]] (pad rows read the parent's pad
node); unpool: h_parent[j] = h_child[unpool_inv[j]] for kept parents, 0
otherwise (`unpool_inv` points the others at a zero slot past the child's
rows). Pool's backward is unpool's gather of the cotangent: the child pad
rows all read the parent pad node, and their cotangents are dropped there,
as JAX's custom VJP drops them (`pool.py:37-42`); autograd of
`index_select` would sum them onto that pad row instead. Both select on
dim -2, so they take any leading dims: a batch of frames over one
hierarchy ([B, N_pad, C], the `ell` and `segment` methods' explicit
transitions), or one frame of a union of bucketed hierarchies
(`graph.hierarchy.union`), whose maps offset each sample's rows and point
every sample's dropped parents at the union's one zero slot.

The replication boundary of a partition plan (`parallel/partition.py`,
the transition into the first replicated level, which carries
`pool_mask`): `pool_nodes_boundary` gathers the child rows whose parent
this rank owns (the others masked to zero: the parent pad row is not
zero after a GMP), then sums them over the group, so every rank holds the
whole child level; its backward sums the cotangent over the group (each
rank's replica fed its own rows above) and unpools it onto the owned
parents. `unpool_nodes_boundary` gathers each owned parent's child from
the replicated level, with no exchange; its backward is the masked pool
gather (`pool.py:65-110` of the JAX package).
"""

from __future__ import annotations

import torch


def _gather_with_zero_slot(x, idx):
    """x[..., idx, :] where idx == x.shape[-2] selects a zero row."""
    zero = x.new_zeros(*x.shape[:-2], 1, x.shape[-1])
    return torch.cat([x, zero], dim=-2).index_select(-2, idx)


class _Pool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, h):
        ctx.t = t
        return h.index_select(-2, t.pool_ids)

    @staticmethod
    def backward(ctx, g):
        return None, _gather_with_zero_slot(g, ctx.t.unpool_inv)


class _Unpool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, h):
        ctx.t = t
        return _gather_with_zero_slot(h, t.unpool_inv)

    @staticmethod
    def backward(ctx, g):
        return None, g.index_select(-2, ctx.t.pool_ids)


def pool_nodes(t, h):
    """[..., N_pad_parent, C] → [..., M_pad_child, C] through
    `t.pool_ids`."""
    return _Pool.apply(t, h)


def unpool_nodes(t, h):
    """[..., M_pad_child, C] → [..., N_pad_parent, C], zero on the
    dropped parents."""
    return _Unpool.apply(t, h)


def _group_sum(t, group):
    from bsms_gnn_tpu_torch.parallel.halo import all_reduce

    return all_reduce(t.contiguous(), group)


class _PoolBoundary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, h):
        ctx.t, ctx.group = t, group
        part = h.index_select(-2, t.pool_ids) * t.pool_mask.to(h.dtype)
        return _group_sum(part, group)

    @staticmethod
    def backward(ctx, g):
        total = _group_sum(g.clone(), ctx.group)
        return None, None, _gather_with_zero_slot(total, ctx.t.unpool_inv)


class _UnpoolBoundary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, h):
        ctx.t = t
        return _gather_with_zero_slot(h, t.unpool_inv)

    @staticmethod
    def backward(ctx, g):
        t = ctx.t
        return None, g.index_select(-2, t.pool_ids) * t.pool_mask.to(g.dtype)


def pool_nodes_boundary(t, h, group: str):
    """Pool across the replication boundary: [..., N_loc_parent, C] → the
    whole replicated child level [..., M_pad, C], summed over `group`."""
    return _PoolBoundary.apply(t, group, h)


def unpool_nodes_boundary(t, h):
    """Unpool across the replication boundary: the replicated child
    [..., M_pad, C] → this rank's parents [..., N_loc_parent, C]."""
    return _UnpoolBoundary.apply(t, h)
