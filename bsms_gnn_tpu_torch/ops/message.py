"""The GMP block on windowed layouts (counterpart of the windowed fused
branch of `bsms_gnn_tpu/ops/message.py::gmp_apply`, `_cresid_edge_phase`
and `_node_phase`).

Edge feature [Δpos, ‖Δpos‖, x_i, x_j] → edge MLP → sum to receiver → node
MLP([x, aggr]) + residual, with both first layers split by input block:
x_i/x_j are transformed per node before any gather, the static fiber term
and the first bias ride the kernel's [8, E] fiber stream (wf8), in-window
edges run the fused edge kernel, out-of-window edges run the edge MLP on
the compact residual rows and accumulate onto the aggregate, and the node
phase is one kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bsms_gnn_tpu_torch.ops.dense import MLP, dense, mlp_apply_tail
from bsms_gnn_tpu_torch.ops.kernels.compact_resid import (
    compact_accum,
    compact_gather,
)
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import fused_edge_phase_win
from bsms_gnn_tpu_torch.ops.kernels.node_mlp import fused_node_phase


class GMP(nn.Module):
    def __init__(self, latent_dim: int, hidden_layer: int, pos_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        edge_in = 2 * latent_dim + pos_dim + 1
        self.mlp_edge = MLP(edge_in, latent_dim, latent_dim, hidden_layer,
                            True, generator)
        self.mlp_node = MLP(2 * latent_dim, latent_dim, latent_dim,
                            hidden_layer, True, generator)

    def forward(self, level, x, compute_dtype=None):
        """One GMP step on a windowed level. x: [N_pad, C]."""
        if level.window <= 0:
            raise NotImplementedError("GMP on an unwindowed level")
        c = x.shape[-1]
        pd1 = level.fiber.shape[-1]
        w1 = self.mlp_edge.weights[0]
        b1 = self.mlp_edge.biases[0]
        wf, wi, wj = w1[:pd1], w1[pd1:pd1 + c], w1[pd1 + c:]
        xj = dense(x, wj, 0.0, compute_dtype)
        xwi = dense(x, wi, 0.0, compute_dtype)
        # wf8 rows [0, pd1) = static fiber rows, row pd1 = first bias
        # (the fiber stream's constant-1 row), the rest zero.
        wf8 = torch.cat([wf, b1[None], wf.new_zeros(7 - pd1, c)])
        # list(...)[1:], not a ParameterList slice (which builds a module).
        aggr = fused_edge_phase_win(
            level, xwi, xj, wf8,
            list(self.mlp_edge.weights)[1:], list(self.mlp_edge.biases)[1:],
        )
        if level.cresid is not None:
            aggr = _cresid_edge_phase(level.cresid, self, xwi, xj, wf, aggr,
                                      compute_dtype)
        return fused_node_phase(x, aggr, self.mlp_node, compute_dtype)


def _cresid_edge_phase(cr, gmp: GMP, xwi, xj, wf, aggr, compute_dtype):
    """Residual edge phase on the compact tables: gathers and the edge MLP
    over the ~R real out-of-window rows, then the block-visit accumulate
    onto `aggr` (in place)."""
    pre_r = (
        compact_gather(cr, xwi, "send")
        + compact_gather(cr, xj, "recv")
        + dense(cr.fiber.to(xwi.dtype), wf, gmp.mlp_edge.biases[0],
                compute_dtype)
    )
    e_r = mlp_apply_tail(gmp.mlp_edge, pre_r, compute_dtype)
    return compact_accum(cr, e_r, aggr)
