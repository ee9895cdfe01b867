"""The GMP block (counterpart of `bsms_gnn_tpu/ops/message.py::gmp_apply`,
its windowed `fused` branches, v3 and v4, with `_cresid_edge_phase` and
`_node_phase`, and its generic `pallas` path).

Edge feature [fibers, x_i, x_j] → edge MLP → sum to receiver → node
MLP([x, aggr]) + residual, with both first layers split by input block
(concat(a, b) @ W ≡ a @ Wa + b @ Wb): x_i/x_j are transformed per node
before any gather. The fibers are the static mesh fiber [Δpos, ‖Δpos‖]
precomputed on the level, preceded, with world edges, by the dynamic
world-space fiber [Δworld, ‖Δworld‖] from the world positions.

Two methods, as in the JAX package:
- `"fused"` (windowed levels): the static fiber term and the first bias
  ride the kernel's [8, E] fiber stream (wf8) and in-window edges run the
  fused edge kernel: kernel 4 without world edges, kernel 13 with one
  world-space stream (Δworld and ‖Δworld‖ computed in the kernel from the
  detached positions). Out-of-window edges run the edge MLP on the compact
  residual rows and accumulate onto the aggregate (kernel 2), and the node
  phase is one kernel (kernel 3). Unwindowed levels (kernels 11 and 12),
  more than one world-space stream or one wider than the latent (kernel
  11) raise.
- `"pallas"` (any block-aligned level): the gathers (backward: kernel 8),
  the fiber and the edge MLP as plain matmuls, as the JAX package leaves
  them to XLA, then the aggregation and node phase in one kernel (kernel
  10).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from bsms_gnn_tpu_torch.ops.dense import MLP, dense, mlp_apply_tail
from bsms_gnn_tpu_torch.ops.kernels.agg_node import fused_aggregate_node_phase
from bsms_gnn_tpu_torch.ops.kernels.compact_resid import (
    compact_accum,
    compact_gather,
)
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import fused_edge_phase_win
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp_dyn import (
    fused_edge_phase_win_dyn,
)
from bsms_gnn_tpu_torch.ops.kernels.node_mlp import fused_node_phase
from bsms_gnn_tpu_torch.ops.scatter import gather_recv, gather_send

METHODS = ("fused", "pallas")


class GMP(nn.Module):
    """`fiber_dims` lists the positional streams feeding the edge MLP, the
    static mesh stream last: each of width d contributes [Δp, ‖Δp‖] (d + 1
    inputs). The default (pos_dim,) is the static stream alone;
    (world_dim, pos_dim) adds the world-space stream."""

    def __init__(self, latent_dim: int, hidden_layer: int, pos_dim: int,
                 generator: Optional[torch.Generator] = None,
                 fiber_dims: Optional[Sequence[int]] = None):
        super().__init__()
        self.fiber_dims = (pos_dim,) if fiber_dims is None else tuple(fiber_dims)
        edge_in = 2 * latent_dim + sum(d + 1 for d in self.fiber_dims)
        self.mlp_edge = MLP(edge_in, latent_dim, latent_dim, hidden_layer,
                            True, generator)
        self.mlp_node = MLP(2 * latent_dim, latent_dim, latent_dim,
                            hidden_layer, True, generator)

    @property
    def dyn_dims(self):
        """Widths of the dynamic (world-space) streams."""
        return self.fiber_dims[:-1]

    def forward(self, level, x, compute_dtype=None, pos=None,
                method: str = "fused"):
        """One GMP step. x: [N_pad, C]; pos: [N_pad, Σ dyn_dims] world
        positions when the GMP has world edges."""
        if method not in METHODS:
            raise NotImplementedError(f"aggregation method {method!r}")
        if self.dyn_dims and (pos is None
                              or pos.shape[-1] != sum(self.dyn_dims)):
            raise ValueError(f"world edges need pos of width "
                             f"{sum(self.dyn_dims)}")
        if method == "pallas":
            return self._pallas(level, x, pos, compute_dtype)
        if level.window <= 0:
            raise NotImplementedError(
                "GMP on an unwindowed level on the fused method (kernel "
                f"{11 if self.dyn_dims else 12})")
        return self._fused(level, x, pos, compute_dtype)

    def _fused(self, level, x, pos, compute_dtype):
        """`gmp_apply`'s windowed branches: v3 (`message.py:251-315`) and,
        with one world-space stream of width wd, v4 (`message.py:317-389`),
        whose first edge layer's rows are [Δworld (wd), ‖Δworld‖, static
        (sfw), x_i (C), x_j (C)]."""
        c = x.shape[-1]
        wd = 0
        if self.dyn_dims:
            if len(self.dyn_dims) != 1:
                raise NotImplementedError(
                    "more than one world-space stream on the fused method "
                    "(kernel 11)")
            wd = self.dyn_dims[0]
            if wd > c:
                raise NotImplementedError(
                    f"a world-space stream of width {wd} > the latent width "
                    f"{c} on the fused method (kernel 11)")
        sfw = level.fiber.shape[-1]
        pd1 = sfw + (wd + 1 if wd else 0)
        w1 = self.mlp_edge.weights[0]
        b1 = self.mlp_edge.biases[0]
        wf, wi, wj = w1[:pd1], w1[pd1:pd1 + c], w1[pd1 + c:]
        wf_sta = wf[pd1 - sfw:]
        xj = dense(x, wj, 0.0, compute_dtype)
        xwi = dense(x, wi, 0.0, compute_dtype)
        # wf8 rows [0, sfw) = static fiber rows, row sfw = first bias (the
        # fiber stream's constant-1 row), the rest zero.
        wf8 = torch.cat([wf_sta, b1[None], wf.new_zeros(7 - sfw, c)])
        # list(...)[1:], not a ParameterList slice (which builds a module).
        tail = (list(self.mlp_edge.weights)[1:],
                list(self.mlp_edge.biases)[1:])
        wpos = wf_dyn = None
        if wd:
            # The positions carry no gradient (JAX's stop_gradient).
            wpos, wf_dyn = pos.detach().to(xwi.dtype), wf[:wd + 1]
            aggr = fused_edge_phase_win_dyn(level, xwi, xj, wpos, wf8,
                                            wf[:wd], wf[wd], *tail)
        else:
            aggr = fused_edge_phase_win(level, xwi, xj, wf8, *tail)
        if level.cresid is not None:
            aggr = _cresid_edge_phase(level.cresid, self, xwi, xj, wf_sta,
                                      aggr, compute_dtype, wpos, wf_dyn)
        return fused_node_phase(x, aggr, self.mlp_node, compute_dtype)

    def _pallas(self, level, x, pos, compute_dtype):
        """`gmp_apply`'s generic path (`message.py:391-448`)."""
        c = x.shape[-1]
        sfw = level.fiber.shape[-1]
        pd1 = sfw + sum(d + 1 for d in self.dyn_dims)
        w1 = self.mlp_edge.weights[0]
        wf, wi, wj = w1[:pd1], w1[pd1:pd1 + c], w1[pd1 + c:]
        z_i = gather_send(level, dense(x, wi, 0.0, compute_dtype))
        z_j = gather_recv(level, dense(x, wj, 0.0, compute_dtype))
        static = level.fiber.to(z_i.dtype)
        if self.dyn_dims:
            direction = gather_send(level, pos) - gather_recv(level, pos)
            parts = []
            for blk in direction.split(list(self.dyn_dims), dim=-1):
                parts += [blk, torch.linalg.vector_norm(blk, dim=-1,
                                                        keepdim=True)]
            # As jnp.concatenate promotes: the static fiber rounded to the
            # activations' dtype, then widened with the dynamic parts.
            dt = torch.promote_types(direction.dtype, static.dtype)
            fiber = torch.cat([p.to(dt) for p in parts] + [static.to(dt)],
                              dim=-1)
        else:
            fiber = static
        pre = dense(fiber, wf, self.mlp_edge.biases[0], compute_dtype) + z_i + z_j
        edge = mlp_apply_tail(self.mlp_edge, pre, compute_dtype)
        return fused_aggregate_node_phase(level, edge, x, self.mlp_node,
                                          compute_dtype)


def _cresid_edge_phase(cr, gmp: GMP, xwi, xj, wf_sta, aggr, compute_dtype,
                       wpos=None, wf_dyn=None):
    """Residual edge phase on the compact tables: gathers and the edge MLP
    over the ~R real out-of-window rows, then the block-visit accumulate
    onto `aggr` (in place). `wpos` / `wf_dyn` ([wd + 1, C], the Δworld and
    ‖Δworld‖ rows) add the world-space fiber term, computed in the
    activations' dtype as the JAX package computes it."""
    pre_r = (
        compact_gather(cr, xwi, "send")
        + compact_gather(cr, xj, "recv")
        + dense(cr.fiber.to(xwi.dtype), wf_sta, gmp.mlp_edge.biases[0],
                compute_dtype)
    )
    if wpos is not None:
        dvec = compact_gather(cr, wpos, "send") - compact_gather(cr, wpos,
                                                                 "recv")
        fib_dyn = torch.cat(
            [dvec, torch.linalg.vector_norm(dvec, dim=-1, keepdim=True)],
            dim=-1)
        pre_r = pre_r + dense(fib_dyn, wf_dyn, 0.0, compute_dtype)
    e_r = mlp_apply_tail(gmp.mlp_edge, pre_r, compute_dtype)
    return compact_accum(cr, e_r, aggr)
