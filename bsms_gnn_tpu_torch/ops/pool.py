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
