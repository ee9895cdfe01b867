"""Kernel 10: the fused aggregation + GMP node phase.

Replaces the TPU kernel `bsms_gnn_tpu/ops/pallas/agg_node.py::
fused_aggregate_node_phase` (`_get_call` → `_make_kernel`):

    out = LN(tail(relu(x·Wa + aggr·Wb + b0))) + x,   aggr = Σ_recv feat

in one launch: the receiver sum of the edge rows (kernel 8's function)
feeds the node phase (kernel 3's function) without the aggregate reaching
device memory. Output in bf16 in bf16 compute, else in x's dtype.

CUDA design (`csrc/agg_node.cu`): each tile sums its rows' aggregate on
chip, a warp one row at a time, in kernel 8's order (`segment_sum.py`): a
list of up to GATHER_PIECE = 32 slots in list order, a longer one in
pieces of 32 gathered into eight shares (share v: pieces v, v + 8, ...,
each from zero, in turn) added in share order. The order comes from the
tables alone: the aggregate equals kernel 8's bit for bit, and the output
equals kernel 3 on kernel 8's aggregate (`chip_smoke.py` holds both at
every level of the 16k surface, in f32, bf16 and bf16 on f32 x). The node
phase then runs on one of two designs with kernel 3's arithmetic (one
FMA chain per output over k in order), `tile_design` picking per level:
- the one-block tile (`csrc/node_phase.cuh`): a block of 256 threads per
  64- or 16-row tile, the aggregate summed into shared memory, the whole
  phase in the block;
- kernel 3's thread-block cluster (`csrc/node_cluster_fwd.cuh`, the same
  device code) on 16-row tiles: CLUSTER CTAs per tile, CTA q summing rows
  [4q, 4q + 4) (a row a warp), owning the output columns [32q, 32q + 32)
  of every product and staging only those columns of each weight; each
  CTA runs the x·Wa half of the first product while its peers finish
  their sums, then copies the four quarters of the aggregate through
  distributed shared memory into its input tile.
The cluster was meant to take every level. On an H100 80GB HBM3 (700 W,
`level_times.py`, f32) it lost the wide levels, where the one-block tile
does more work per SM once its tiles fill the card: the 16k surface's
level 0 read 0.105 ms on 64-row blocks against 0.266 on the cluster's
4,032 CTAs (0.167 on 64-row cluster tiles, a variant measured and
dropped). It won the deep levels,
few rows with long lists, where a block per tile leaves most SMs idle and
a warp walks its rows' lists alone: levels 4-7 read 0.030, 0.027, 0.026,
0.020 ms against 0.039, 0.048, 0.060, 0.035 on 16-row blocks. Its time
grew with its CTAs per SM (level 3, four an SM: 0.048 against 0.037 on
16-row blocks). So the cluster takes a level where its 16-row tiles give
at most two CTAs per SM; the one-block tile the others, on 64 rows where
those tiles cover at least three quarters of the SMs (level 1, 126 tiles:
0.075 against 0.081 on 16 rows; level 2, 64 tiles: 0.068 against 0.048),
else on 16. The TPU kernel's sequential grid over edge chunks, with the
node phase on each 128-row block's last chunk, is not carried over: the
node phase is row-local, so the tile is whatever suits the card. What
bounds it on the card: operations at the wide levels ((2 + L)·2·128·128
FLOP per row on the CUDA cores), the slot reads at the deep ones.

bf16 compute rounds where the TPU rounds: the bf16 edge rows sum in f32 as
read, and every dot operand (x, the aggregate, the hidden activations, the
weights, those once per call on the host) is rounded to bf16, as kernel 3
does.

The backward (`agg_node.py:207-222`) launches no kernel of its own: it sums
the aggregate again with kernel 8 (remat, as on the TPU), runs kernel 6
(`node_mlp.py::fused_node_phase_bwd`) and gathers d_aggr by receivers for
the edge rows' cotangent.
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.graph.hierarchy import GATHER_PIECE
from bsms_gnn_tpu_torch.ops.kernels import build
from bsms_gnn_tpu_torch.ops.kernels.node_mlp import (
    CLUSTER,
    _check as _check_node,
    fused_node_phase_bwd,
    fused_node_phase_plain,
)
from bsms_gnn_tpu_torch.ops.kernels.segment_sum import (
    segment_sum_plain,
    segment_sum_raw,
)

_SIG = [build.P] * 3 + [build.I] + [build.P] * 6 + [build.I] * 3 + [build.P]
# The kernel's tiles, by name: the C entries' `tile` and the tile's rows.
TILES = {"block 64": (0, 64), "block 16": (1, 16), "cluster 16": (2, 16)}
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


def tile_design(n_rows: int, sms: int) -> str:
    """The tile (a key of TILES) of a level of n_rows rows on a card of
    `sms` SMs: the cluster where its 16-row tiles give at most two CTAs per
    SM; else the one-block tile, 64 rows where those tiles cover at least
    three quarters of the SMs, else 16 (see the module note)."""
    if n_rows // 16 * CLUSTER <= 2 * sms:
        return "cluster 16"
    return "block 64" if 4 * (n_rows // 64) >= 3 * sms else "block 16"


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
    w0 = build.stacked(ws[:1], to_bf16=bf16)
    b0 = bs[0].detach().float().contiguous()
    w_stack = build.stacked(ws[1:], to_bf16=bf16)
    b_stack = build.stacked(bs[1:])
    feat, x = feat.contiguous(), x.contiguous()
    out = torch.empty_like(x, dtype=torch.bfloat16 if bf16 else x.dtype)
    n = x.shape[0]
    err = getattr(lib, fn)(
        feat.data_ptr(), level.row_ptr.data_ptr(), level.row_slots.data_ptr(),
        GATHER_PIECE, x.data_ptr(), w0.data_ptr(), b0.data_ptr(),
        w_stack.data_ptr(), b_stack.data_ptr(), out.data_ptr(), len(ws) - 1,
        n, TILES[tile_design(n, torch.cuda.get_device_properties(
            x.device).multi_processor_count)][0],
        torch.cuda.current_stream(x.device).cuda_stream,
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
