"""Fused level transitions (counterpart of `bsms_gnn_tpu/ops/transition.py`):
one precomputed operator application per direction, `down(x) = M x` and
`up(x) = Mᵀ x`, each the other's adjoint. The routes, by operator and row
width:
- small unwindowed operators carry a dense matrix (one matmul);
- the other unwindowed operators gather and scale their input rows and sum
  them at the receivers with kernel 8 (whose plain version takes widths
  that are not a multiple of 128, counted in `narrow_calls`);
- windowed operators run the windowed conv kernel (kernel 1) on 128-wide
  rows and add their compact residual (kernel 2);
- windowed operators on narrower rows (the 3-wide world-position stream of
  the world-edge models) take `narrow_apply`: the gather, the scale and a
  plain sum over all the operator's slots, as JAX's `_apply` falls back to
  XLA when its kernels refuse the width (`transition.py:78-85`). These
  calls are counted in `narrow_apply.calls`, apart from kernel launches;
  a 128-wide tensor never takes this route.

The backward of `trans_down` applies the transition's `up_op` to the
cotangent and the backward of `trans_up` its `down_op`, through the same
routes as the forward: no scatter anywhere on 128-wide rows, as on the TPU.

The batch axis (a shared mesh, x [B, N_in_pad, C]): the dense route on
the leading dims, the windowed route with kernel 1's and kernel 2's
batched launches (the compact residual's rows gathered on dim -2). The
kernel-8 route and `narrow_apply` take B = 1 and raise
NotImplementedError("batch axis") on a batch.
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.graph.hierarchy import Transition, TransOp
from bsms_gnn_tpu_torch.ops.kernels.compact_resid import compact_accum_raw
from bsms_gnn_tpu_torch.ops.kernels.segment_sum import segment_sum_raw
from bsms_gnn_tpu_torch.ops.kernels.build import check_batch
from bsms_gnn_tpu_torch.ops.kernels.windowed import BN, windowed_rect_conv


def dense_apply(d, x):
    """Tiny-level operator as one matmul: d [O, I] rounded to x's dtype,
    f32 accumulation, output in x's dtype; x [..., I, C]."""
    return (d.to(x.dtype).float() @ x.float()).to(x.dtype)


def narrow_apply(op: TransOp, x):
    """A windowed operator on rows narrower than the kernels take: every
    slot's scaled input row summed at its receiver (f32), in x's dtype.
    Pad slots have weight 0."""
    if x.shape[-1] % BN == 0:
        raise ValueError("128-wide rows take the windowed kernels")
    check_batch(x, False)
    narrow_apply.calls += 1
    msg = x.index_select(0, op.senders) * op.ew.to(x.dtype)[:, None]
    out = torch.zeros(op.n_pad_nodes, x.shape[-1], dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, op.receivers.long(), msg.float()).to(x.dtype)


narrow_apply.calls = 0


def _apply(op: TransOp, x):
    """out[k] = Σ_e ew[e] · x[senders[e]] summed at receivers[e]:
    x [..., N_in_pad, C] → [..., N_out_pad, C]."""
    if op.dense is not None:
        return dense_apply(op.dense, x)
    if op.window > 0 and x.shape[-1] % BN:
        return narrow_apply(op, x)
    if op.window <= 0:
        check_batch(x, False)
        msg = x.index_select(0, op.senders) * op.ew.to(x.dtype)[:, None]
        return segment_sum_raw(op, msg).to(x.dtype)
    out = windowed_rect_conv(op, x)
    cr = op.cresid
    if cr is not None:
        msg = x.index_select(-2, cr.senders) * cr.ew.to(x.dtype)[:, None]
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
    """Fused conv→pool: [..., N_parent_pad, C] → [..., M_child_pad, C]."""
    return _Pair.apply(t.down_op, t.up_op, x)


def trans_up(t: Transition, x):
    """Fused unpool→reverse-conv: child → parent space."""
    return _Pair.apply(t.up_op, t.down_op, x)
