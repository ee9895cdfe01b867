"""Fused level transitions (counterpart of `bsms_gnn_tpu/ops/transition.py`):
one precomputed operator application per direction, `down(x) = M x` and
`up(x) = Mᵀ x`, each the other's adjoint. Windowed operators run the
windowed conv kernel and add their compact residual; small unwindowed
operators carry a dense matrix; the other unwindowed operators gather
and scale their input rows and sum them at the receivers with kernel 8.

The backward of `trans_down` applies the transition's `up_op` to the
cotangent and the backward of `trans_up` its `down_op`, through the same
kernels (1 and 2, or 8) as the forward: no scatter anywhere, as on the TPU.
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.graph.hierarchy import Transition, TransOp
from bsms_gnn_tpu_torch.ops.kernels.compact_resid import compact_accum_raw
from bsms_gnn_tpu_torch.ops.kernels.segment_sum import segment_sum_raw
from bsms_gnn_tpu_torch.ops.kernels.windowed import windowed_rect_conv


def dense_apply(d, x):
    """Tiny-level operator as one matmul: d [O, I] rounded to x's dtype,
    f32 accumulation, output in x's dtype."""
    return (d.to(x.dtype).float() @ x.float()).to(x.dtype)


def _apply(op: TransOp, x):
    """out[k] = Σ_e ew[e] · x[senders[e]] summed at receivers[e]:
    x [N_in_pad, C] → [N_out_pad, C]."""
    if op.dense is not None:
        return dense_apply(op.dense, x)
    if op.window <= 0:
        msg = x.index_select(0, op.senders) * op.ew.to(x.dtype)[:, None]
        return segment_sum_raw(op, msg).to(x.dtype)
    out = windowed_rect_conv(op, x)
    cr = op.cresid
    if cr is not None:
        msg = x.index_select(0, cr.senders) * cr.ew.to(x.dtype)[:, None]
        out = compact_accum_raw(cr, msg, out)
    return out.to(x.dtype)


class _Pair(torch.autograd.Function):
    """Forward applies `op`; backward applies its adjoint `adj` to the
    cotangent, cast to the input's dtype."""

    @staticmethod
    def forward(ctx, op, adj, x):
        ctx.adj, ctx.dtype = adj, x.dtype
        return _apply(op, x)

    @staticmethod
    def backward(ctx, g):
        return None, None, _apply(ctx.adj, g).to(ctx.dtype)


def trans_down(t: Transition, x):
    """Fused conv→pool: [N_parent_pad, C] → [M_child_pad, C]."""
    return _Pair.apply(t.down_op, t.up_op, x)


def trans_up(t: Transition, x):
    """Fused unpool→reverse-conv: child → parent space."""
    return _Pair.apply(t.up_op, t.down_op, x)
