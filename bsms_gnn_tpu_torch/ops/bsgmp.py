"""BSGMP: the bi-stride graph U-Net processor (counterpart of
`bsms_gnn_tpu/ops/bsgmp.py`, single-card branches).

Down pass per level: GMP, then the conv→pool transition. Bottom GMP. Up
pass: unpool→reverse-conv, GMP, then the U-Net skip add. A transition is
the fused operator pair where the hierarchy has one, and otherwise (the
bucketed hierarchies of variable-mesh datasets) the explicit conv with the
level's own weights (`message.edge_conv_down` / `edge_conv_up`) and the
pool / unpool gathers (`ops/pool.py`). Mesh
positions never appear online: the static per-level edge fibers and
transition weights are precomputed on the hierarchy. With world edges the
world positions are the one dynamic stream: they ride each down
transition beside h, and each up GMP reads the positions its level had on
the way down. A batch over one hierarchy (h [B, N_pad0, C]) runs every
step on the leading dims, where the routes take it (`ops/message.py`,
`ops/transition.py`); the explicit conv + pool path takes B = 1.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from bsms_gnn_tpu_torch.config import split_interleave
from bsms_gnn_tpu_torch.ops.message import GMP, edge_conv_down, edge_conv_up
from bsms_gnn_tpu_torch.ops.pool import pool_nodes, unpool_nodes
from bsms_gnn_tpu_torch.ops.transition import trans_down, trans_up


def use_fused_trans(trans, level, method: str) -> bool:
    """`bsgmp.py::_use_fused_trans`: the fused transition operators apply
    on the pallas and fused methods, to unwindowed levels and to windowed
    levels whose operators are windowed. The other transitions (bucketed
    hierarchies, which have no operator) take the explicit conv + pool
    path. `"fusedK"` is `"fused"` here: JAX tests the unstripped method
    (`bsgmp.py:71`), so its `"fusedK"` takes the explicit conv + pool on
    every hierarchy, a departure the port does not copy (the same function
    either way, as conv then pool is the operator)."""
    op = getattr(trans, "down_op", None)
    method, _ = split_interleave(method)
    if method not in ("pallas", "fused") or op is None:
        return False
    return level.window == 0 or op.window > 0


class BSGMP(nn.Module):
    def __init__(self, unet_depth: int, latent_dim: int, hidden_layer: int,
                 pos_dim: int, generator: Optional[torch.Generator] = None,
                 fiber_dims: Optional[Sequence[int]] = None):
        super().__init__()

        def gmp():
            return GMP(latent_dim, hidden_layer, pos_dim, generator,
                       fiber_dims)

        self.down_gmps = nn.ModuleList(gmp() for _ in range(unet_depth))
        self.up_gmps = nn.ModuleList(gmp() for _ in range(unet_depth))
        self.bottom_gmp = gmp()

    def forward(self, hierarchy, h, compute_dtype=None, tap=None, pos=None,
                method: str = "fused"):
        """h: [N_pad0, C] or [B, N_pad0, C]; pos: [N_pad0, world_dim]
        world positions when
        the GMPs have world edges (else ignored). `tap(name, value)`, if
        given, observes each GMP output ("down{i}" / "bottom" / "up{i}",
        before pool / skip add)."""
        depth = hierarchy.depth
        if len(self.down_gmps) != depth:
            raise ValueError(f"model depth {len(self.down_gmps)} != "
                             f"hierarchy depth {depth}")
        dyn = pos if self.bottom_gmp.dyn_dims else None
        down_outs, down_ps = [], []
        for i in range(depth):
            level, trans = hierarchy.levels[i], hierarchy.transitions[i]
            h = self.down_gmps[i](level, h, compute_dtype, dyn, method)
            if tap is not None:
                tap(f"down{i}", h)
            down_outs.append(h)
            down_ps.append(dyn)
            if use_fused_trans(trans, level, method):
                h = trans_down(trans, h)
                if dyn is not None:
                    dyn = trans_down(trans, dyn)
            else:
                if dyn is not None:
                    # JAX sends the narrow world stream through its ELL
                    # path (`message.py:720-721`), which is not ported.
                    raise NotImplementedError(
                        "world-edge streams through the explicit conv + pool "
                        "transitions (ROADMAP Queue 1, items 3 and 5)")
                h = pool_nodes(trans, edge_conv_down(level, h))

        h = self.bottom_gmp(hierarchy.levels[depth], h, compute_dtype, dyn,
                            method)
        if tap is not None:
            tap("bottom", h)

        for i in range(depth):
            d = depth - i - 1
            level, trans = hierarchy.levels[d], hierarchy.transitions[d]
            if use_fused_trans(trans, level, method):
                h = trans_up(trans, h)
            else:
                h = edge_conv_up(level, unpool_nodes(trans, h))
            h = self.up_gmps[i](level, h, compute_dtype, down_ps[d], method)
            if tap is not None:
                tap(f"up{i}", h)
            h = h + down_outs[d]
        return h
