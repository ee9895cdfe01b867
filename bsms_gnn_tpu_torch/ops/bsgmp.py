"""BSGMP: the bi-stride graph U-Net processor (counterpart of
`bsms_gnn_tpu/ops/bsgmp.py`, fused-transition branch).

Down pass per level: GMP, then the fused conv→pool transition. Bottom GMP.
Up pass: fused unpool→reverse-conv, GMP, then the U-Net skip add. Mesh
positions never appear online: the static per-level edge fibers and
transition weights are precomputed on the hierarchy. With world edges the
world positions are the one dynamic stream: they ride each down
transition beside h, and each up GMP reads the positions its level had on
the way down.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from bsms_gnn_tpu_torch.ops.message import GMP
from bsms_gnn_tpu_torch.ops.transition import trans_down, trans_up


def use_fused_trans(trans, level, method: str) -> bool:
    """`bsgmp.py::_use_fused_trans`: the fused transition operators apply
    on the pallas and fused methods, to unwindowed levels and to windowed
    levels whose operators are windowed. The explicit conv+pool path the
    JAX package keeps for the other cases is not ported."""
    op = getattr(trans, "down_op", None)
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
        """h: [N_pad0, C]; pos: [N_pad0, world_dim] world positions when
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
            if not use_fused_trans(trans, level, method):
                raise NotImplementedError(
                    "explicit conv + pool transitions (the ell / segment "
                    "methods, windowed levels with unwindowed operators)")
            h = trans_down(trans, h)
            if dyn is not None:
                dyn = trans_down(trans, dyn)

        h = self.bottom_gmp(hierarchy.levels[depth], h, compute_dtype, dyn,
                            method)
        if tap is not None:
            tap("bottom", h)

        for i in range(depth):
            d = depth - i - 1
            h = trans_up(hierarchy.transitions[d], h)
            h = self.up_gmps[i](hierarchy.levels[d], h, compute_dtype,
                                down_ps[d], method)
            if tap is not None:
                tap(f"up{i}", h)
            h = h + down_outs[d]
        return h
