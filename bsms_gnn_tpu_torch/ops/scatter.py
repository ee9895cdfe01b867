"""Edge gathers and the receiver aggregation on block-aligned layouts
(counterpart of the `pallas` method of `bsms_gnn_tpu/ops/scatter.py`:
`gather_send`, `gather_recv`, `aggregate_recv`).

The gathers are row selections whose backward sums the edge cotangents
back onto the nodes through kernel 8 (`kernels/segment_sum.py`): the
sender form for `gather_send`, the receiver form for `gather_recv`, as
`_gather_with_pallas_bwd` (`scatter.py:121-175`) does on the TPU. On a
skip-empty layout (a residual sub-level) the sums run through kernel 9's
store form instead, since kernel 8 refuses such layouts: the function of
JAX's kernel 9 onto zeros (`scatter.py:149-171`), with no zero fill.
Autograd of `index_select` would run an `index_add_` scatter.
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.ops.kernels.segment_sum import (
    segment_sum,
    segment_sum_raw,
)
from bsms_gnn_tpu_torch.ops.kernels.segment_sum_accum import (
    segment_sum_accum_raw,
    segment_sum_accum_send_raw,
)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, level, send, x):
        ctx.level, ctx.send, ctx.dtype = level, send, x.dtype
        return x.index_select(0, level.senders if send else level.receivers)

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


def _check(x):
    if x.dim() != 2:
        raise NotImplementedError("batch axis")


def gather_send(level, x):
    """x_i = x[senders] → [E_pad, C]; backward: the sender sums (kernel 8,
    or kernel 9 on a skip-empty layout)."""
    _check(x)
    return _Gather.apply(level, True, x)


def gather_recv(level, x):
    """x_j = x[receivers] → [E_pad, C]; backward: the receiver sums (kernel
    8, or kernel 9 on a skip-empty layout)."""
    _check(x)
    return _Gather.apply(level, False, x)


def aggregate_recv(level, feat):
    """Σ_{e: recv(e)=n} feat[e] → f32 [N_pad, C] (kernel 8)."""
    return segment_sum(level, feat)
