"""BSGMP: the bi-stride graph U-Net processor (counterpart of
`bsms_gnn_tpu/ops/bsgmp.py`, single-card branches).

Down pass per level: GMP, then the conv→pool transition. Bottom GMP. Up
pass: unpool→reverse-conv, GMP, then the U-Net skip add. A transition is
the fused operator pair where the hierarchy has one and the method is
`fused` or `pallas`, and otherwise (the `ell` and `segment` methods, and
the bucketed hierarchies of variable-mesh datasets) the explicit conv with
the level's own weights (`message.edge_conv_down` / `edge_conv_up`, on
the method) and the pool / unpool gathers (`ops/pool.py`). Mesh
positions never appear online: the static per-level edge fibers and
transition weights are precomputed on the hierarchy. With world edges the
world positions are the one dynamic stream: they ride each down
transition beside h (on the explicit transitions the narrow stream takes
the conv's generic form, `bsgmp.py:158-163`), and each up GMP reads the
positions its level had on the way down. A batch over one unbucketed
hierarchy (h [B, N_pad0, C], with world edges pos [B, N_pad0, world_dim])
runs every step on the leading dims (`ops/message.py`,
`ops/transition.py`, `ops/scatter.py`). The explicit conv's kernel route
takes one block of rows: a batch on bucketed hierarchies reaches it as
their union ([B·N_pad0, C], `graph.hierarchy.union`, built by
`models/simulator.py`).

On a halo method (`"halo:<group>:<local>"`, one rank's shard of a
partition plan, `parallel/`) every level is the rank's part, and the
transition into the first replicated level (`trans.pool_mask`) is the
boundary pair of `ops/pool.py` (`bsgmp.py:149-156,175-177`), which sums
the child over the group.

On an edge-sharded method (`"eshard:<group>:<local>"`, one rank's range
of every level's and operator's edge slots, `parallel/edge_shard.py`)
the node rows are replicated: a fused transition applies the rank's part
of its operator between `EdgeEnter` and `EdgeSum` (the group's sum), and
the GMPs and explicit convs sum their slots the same way
(`ops/message.py`).

`remat` (JAX's `jax.checkpoint` of each GMP, `bsgmp.py:107-121`):
`torch.utils.checkpoint` around each GMP whose level has at least
`remat_min_nodes` padded rows per sample (a union's level holds
`samples` blocks of them); its forward kernels run again in the
backward, before its backward kernels.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from bsms_gnn_tpu_torch.config import split_interleave
from bsms_gnn_tpu_torch.ops.message import GMP, edge_conv_down, edge_conv_up
from bsms_gnn_tpu_torch.ops.pool import (
    pool_nodes,
    pool_nodes_boundary,
    unpool_nodes,
    unpool_nodes_boundary,
)
from bsms_gnn_tpu_torch.ops.scatter import eshard_parts, halo_parts
from bsms_gnn_tpu_torch.ops.transition import trans_down, trans_up


def use_fused_trans(trans, level, method: str) -> bool:
    """`bsgmp.py::_use_fused_trans`: the fused transition operators apply
    on the pallas and fused methods, to unwindowed levels and to windowed
    levels whose operators are windowed. The other transitions (bucketed
    hierarchies, which have no operator) take the explicit conv + pool
    path, as do the `ell` and `segment` methods on every hierarchy.
    `"fusedK"` is `"fused"` here: JAX tests the unstripped method
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
                method: str = "fused", remat: bool = False,
                remat_min_nodes: int = 0):
        """h: [N_pad0, C] or [B, N_pad0, C]; pos: [..., N_pad0, world_dim]
        world positions (h's leading dims) when the GMPs have world edges
        (else ignored). `tap(name, value)`, if
        given, observes each GMP output ("down{i}" / "bottom" / "up{i}",
        before pool / skip add). `remat` checkpoints the GMPs of the levels
        of at least `remat_min_nodes` padded rows per sample."""
        depth = hierarchy.depth
        if len(self.down_gmps) != depth:
            raise ValueError(f"model depth {len(self.down_gmps)} != "
                             f"hierarchy depth {depth}")
        dyn = pos if self.bottom_gmp.dyn_dims else None
        eshard = eshard_parts(method)
        trans_method = method if eshard is None else eshard[1]

        def fused_trans(fn, trans, x):
            if eshard is None:
                return fn(trans, x)
            from bsms_gnn_tpu_torch.parallel.edge_shard import edge_part

            return edge_part(lambda x_: fn(trans, x_), x, eshard[0])

        def gmp(module, l, h_, pos_):
            level = hierarchy.levels[l]
            if (remat and torch.is_grad_enabled()
                    and hierarchy.sample_pad(l) >= remat_min_nodes):
                # The GMP draws no random numbers: no RNG state to replay.
                return checkpoint(module, level, h_, compute_dtype, pos_,
                                  method, use_reentrant=False,
                                  preserve_rng_state=False)
            return module(level, h_, compute_dtype, pos_, method)

        down_outs, down_ps = [], []
        for i in range(depth):
            level, trans = hierarchy.levels[i], hierarchy.transitions[i]
            h = gmp(self.down_gmps[i], i, h, dyn)
            if tap is not None:
                tap(f"down{i}", h)
            down_outs.append(h)
            down_ps.append(dyn)
            if use_fused_trans(trans, level, trans_method):
                h = fused_trans(trans_down, trans, h)
                if dyn is not None:
                    dyn = fused_trans(trans_down, trans, dyn)
            elif trans.pool_mask is not None:
                # The replication boundary of a halo plan: one group sum
                # assembles the replicated child on every rank.
                group = halo_parts(method)[0]
                h = pool_nodes_boundary(
                    trans, edge_conv_down(level, h, None, method), group)
                if dyn is not None:
                    dyn = pool_nodes_boundary(
                        trans, edge_conv_down(level, dyn, None, method),
                        group)
            else:
                h = pool_nodes(trans, edge_conv_down(level, h, None, method))
                if dyn is not None:
                    dyn = pool_nodes(trans,
                                     edge_conv_down(level, dyn, None, method))

        h = gmp(self.bottom_gmp, depth, h, dyn)
        if tap is not None:
            tap("bottom", h)

        for i in range(depth):
            d = depth - i - 1
            level, trans = hierarchy.levels[d], hierarchy.transitions[d]
            if use_fused_trans(trans, level, trans_method):
                h = fused_trans(trans_up, trans, h)
            elif trans.pool_mask is not None:
                h = edge_conv_up(level, unpool_nodes_boundary(trans, h), None,
                                 method)
            else:
                h = edge_conv_up(level, unpool_nodes(trans, h), None, method)
            h = gmp(self.up_gmps[i], d, h, down_ps[d])
            if tap is not None:
                tap(f"up{i}", h)
            h = h + down_outs[d]
        return h
