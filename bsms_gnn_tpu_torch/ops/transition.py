"""Fused level transitions (counterpart of `bsms_gnn_tpu/ops/transition.py`):
one precomputed operator application per direction, `down(x) = M x` and
`up(x) = Mᵀ x`. Windowed operators run the windowed conv kernel and add
their compact residual; small unwindowed operators carry a dense matrix.
"""

from __future__ import annotations

from bsms_gnn_tpu_torch.graph.hierarchy import Transition, TransOp
from bsms_gnn_tpu_torch.ops.kernels.compact_resid import compact_accum
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
        raise NotImplementedError("unwindowed transition without a dense form")
    out = windowed_rect_conv(op, x)
    cr = op.cresid
    if cr is not None:
        msg = x.index_select(0, cr.senders) * cr.ew.to(x.dtype)[:, None]
        out = compact_accum(cr, msg, out)
    return out.to(x.dtype)


def trans_down(t: Transition, x):
    """Fused conv→pool: [N_parent_pad, C] → [M_child_pad, C]."""
    return _apply(t.down_op, x)


def trans_up(t: Transition, x):
    """Fused unpool→reverse-conv: child → parent space."""
    return _apply(t.up_op, x)
