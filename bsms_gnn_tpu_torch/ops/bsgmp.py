"""BSGMP: the bi-stride graph U-Net processor (counterpart of
`bsms_gnn_tpu/ops/bsgmp.py`, fused-transition branch).

Down pass per level: GMP, then the fused conv→pool transition. Bottom GMP.
Up pass: fused unpool→reverse-conv, GMP, then the U-Net skip add. Mesh
positions never appear online: the static per-level edge fibers and
transition weights are precomputed on the hierarchy.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bsms_gnn_tpu_torch.ops.message import GMP
from bsms_gnn_tpu_torch.ops.transition import trans_down, trans_up


class BSGMP(nn.Module):
    def __init__(self, unet_depth: int, latent_dim: int, hidden_layer: int,
                 pos_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()

        def gmps(n):
            return nn.ModuleList(
                GMP(latent_dim, hidden_layer, pos_dim, generator)
                for _ in range(n))

        self.down_gmps = gmps(unet_depth)
        self.up_gmps = gmps(unet_depth)
        self.bottom_gmp = GMP(latent_dim, hidden_layer, pos_dim, generator)

    def forward(self, hierarchy, h, compute_dtype=None, tap=None):
        """h: [N_pad0, C]. `tap(name, value)`, if given, observes each GMP
        output ("down{i}" / "bottom" / "up{i}", before pool / skip add)."""
        depth = hierarchy.depth
        if len(self.down_gmps) != depth:
            raise ValueError(f"model depth {len(self.down_gmps)} != "
                             f"hierarchy depth {depth}")
        down_outs = []
        for i in range(depth):
            h = self.down_gmps[i](hierarchy.levels[i], h, compute_dtype)
            if tap is not None:
                tap(f"down{i}", h)
            down_outs.append(h)
            h = trans_down(hierarchy.transitions[i], h)

        h = self.bottom_gmp(hierarchy.levels[depth], h, compute_dtype)
        if tap is not None:
            tap("bottom", h)

        for i in range(depth):
            d = depth - i - 1
            h = trans_up(hierarchy.transitions[d], h)
            h = self.up_gmps[i](hierarchy.levels[d], h, compute_dtype)
            if tap is not None:
                tap(f"up{i}", h)
            h = h + down_outs[d]
        return h
