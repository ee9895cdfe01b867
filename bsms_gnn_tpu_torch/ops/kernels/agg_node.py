"""Kernel 10: the fused aggregation + GMP node phase.

Replaces the TPU kernel `bsms_gnn_tpu/ops/pallas/agg_node.py::
fused_aggregate_node_phase` (`_get_call` → `_make_kernel`):

    out = LN(tail(relu(x·Wa + aggr·Wb + b0))) + x,   aggr = Σ_recv feat

in one launch: the receiver sum of the edge rows (kernel 8's function)
feeds the node phase (kernel 3's function) without the aggregate reaching
device memory. Output in bf16 in bf16 compute, else in x's dtype.

CUDA design (`csrc/agg_node.cu`): one thread block per row tile sums its
rows' slot lists into shared memory, one warp per row in slot order as
kernel 8 does, then runs kernel 3's device code (`csrc/node_phase.cuh`) on
the tile in place. The TPU kernel's sequential grid over edge chunks, with
the node phase on each 128-row block's last chunk, is not carried over:
the node phase is row-local, so the tile is whatever suits the card. 64-row
tiles (kernel 3's) where the level has at least one per SM; 16-row tiles
below that, so that the deep levels, where ~10k slots fall on each
128-row block, spread their sums over more SMs. What bounds it on the card:
operations at the wide levels ((2 + L)·2·128·128 FLOP per row on the CUDA
cores), the slot reads at the deep ones.

bf16 compute rounds where the TPU rounds: the bf16 edge rows sum in f32 as
read, and every dot operand (x, the aggregate, the hidden activations, the
weights) is rounded to bf16, as kernel 3 does.

The backward (`agg_node.py:207-222`) launches no kernel of its own: it sums
the aggregate again with kernel 8 (remat, as on the TPU), runs kernel 6
(`node_mlp.py::fused_node_phase_bwd`) and gathers d_aggr by receivers for
the edge rows' cotangent.
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.ops.kernels import build
from bsms_gnn_tpu_torch.ops.kernels.node_mlp import (
    _check as _check_node,
    fused_node_phase_bwd,
    fused_node_phase_plain,
)
from bsms_gnn_tpu_torch.ops.kernels.segment_sum import (
    segment_sum_plain,
    segment_sum_raw,
)

_SIG = [build.P] * 9 + [build.I] * 3 + [build.P]
# (x dtype, bf16 compute) → (C entry, the edge rows' dtype).
_FN = {(torch.float32, False): ("fused_aggregate_node_phase_f32", torch.float32),
       (torch.bfloat16, True): ("fused_aggregate_node_phase_bf16",
                                torch.bfloat16),
       (torch.float32, True): ("fused_aggregate_node_phase_f32_bf16",
                               torch.bfloat16)}


def _check(level, feat, x, mlp, compute_dtype):
    if x.dim() != 2 or feat.dim() != 2:
        raise NotImplementedError("batch axis")
    if x.shape[0] != level.n_pad_nodes:
        raise ValueError(f"x rows {x.shape[0]} != N_pad {level.n_pad_nodes}")
    if feat.shape != (level.n_pad_edges, x.shape[1]):
        raise ValueError(f"feat {tuple(feat.shape)} != "
                         f"({level.n_pad_edges}, {x.shape[1]})")
    _check_node(x, None, mlp, compute_dtype)


def tile_rows(n_rows: int, device) -> int:
    """64-row tiles where they give at least one block per SM, else 16."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 64 if n_rows // 64 >= sms else 16


def fused_aggregate_node_phase_plain(level, feat, x, mlp, compute_dtype=None):
    """Kernel 10's function in plain PyTorch: kernel 8's plain version,
    then kernel 3's."""
    fused_aggregate_node_phase_plain.calls += 1
    return fused_node_phase_plain(x, segment_sum_plain(level, feat), mlp,
                                  compute_dtype)


fused_aggregate_node_phase_plain.calls = 0


def fused_aggregate_node_phase_fwd(level, feat, x, mlp, compute_dtype=None):
    """node_mlp([x, Σ_recv feat]) + x, no autograd. `mlp` is the GMP's node
    MLP (weights stored [in, out]). CPU tensors take the plain version;
    CUDA tensors launch kernel 10."""
    _check(level, feat, x, mlp, compute_dtype)
    if x.device.type == "cpu":
        return fused_aggregate_node_phase_plain(level, feat, x, mlp,
                                                compute_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    bf16 = compute_dtype == torch.bfloat16
    fn, feat_dtype = _FN[(x.dtype, bf16)]
    if feat.dtype != feat_dtype:
        raise ValueError(f"edge rows in {feat.dtype}, the kernel takes "
                         f"{feat_dtype} here")
    build.require("fused_aggregate_node_phase", x.device, level.row_ptr,
                  level.row_slots)
    lib = build.library("agg_node", {f: _SIG for f, _ in _FN.values()})
    ws, bs = list(mlp.weights), list(mlp.biases)
    w0, b0 = ws[0].detach().float().contiguous(), bs[0].detach().float().contiguous()
    w_stack, b_stack = build.stacked(ws[1:]), build.stacked(bs[1:])
    feat, x = feat.contiguous(), x.contiguous()
    out = torch.empty_like(x, dtype=torch.bfloat16 if bf16 else x.dtype)
    n = x.shape[0]
    err = getattr(lib, fn)(
        feat.data_ptr(), level.row_ptr.data_ptr(), level.row_slots.data_ptr(),
        x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w_stack.data_ptr(),
        b_stack.data_ptr(), out.data_ptr(), len(ws) - 1, n,
        tile_rows(n, x.device), torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "fused_aggregate_node_phase")
    fused_aggregate_node_phase_fwd.launches += 1
    return out


fused_aggregate_node_phase_fwd.launches = 0


class _AggNode(torch.autograd.Function):
    """Kernel 10 forward; kernel 8 (the aggregate again), kernel 6 and a
    gather by receivers backward. A gradient for feat, x and every weight
    and bias of the node MLP."""

    @staticmethod
    def forward(ctx, level, mlp, compute_dtype, feat, x, *params):
        ctx.level, ctx.mlp, ctx.compute_dtype = level, mlp, compute_dtype
        ctx.save_for_backward(feat, x, *params)
        return fused_aggregate_node_phase_fwd(level, feat, x, mlp,
                                              compute_dtype)

    @staticmethod
    def backward(ctx, g):
        feat, x, *params = ctx.saved_tensors
        level = ctx.level
        aggr = segment_sum_raw(level, feat)
        dx, daggr, dwa, dwb, db0, dw, db = fused_node_phase_bwd(
            x, aggr, ctx.mlp, g, ctx.compute_dtype)
        d_feat = daggr.index_select(0, level.receivers).to(feat.dtype)
        grads = ([torch.cat([dwa, dwb])] + list(dw.unbind(0))
                 + [db0] + list(db.unbind(0)))
        return (None, None, None, d_feat, dx,
                *(d.to(p.dtype) for d, p in zip(grads, params)))


def fused_aggregate_node_phase(level, feat, x, mlp, compute_dtype=None):
    """node_mlp([x, Σ_recv feat]) + x, differentiable in feat, x and the
    node MLP's weights and biases. feat: [E_pad, 128] edge rows (bf16 in
    bf16 compute); x: [N_pad, 128]."""
    _check(level, feat, x, mlp, compute_dtype)
    return _AggNode.apply(level, mlp, compute_dtype, feat, x, *mlp.weights,
                          *mlp.biases)
