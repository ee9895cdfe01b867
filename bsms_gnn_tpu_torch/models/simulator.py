"""BSMS next-step simulator: encode → BSGMP process → decode, delta target
(counterpart of `bsms_gnn_tpu/models/simulator.py::simulator_forward`).

Inputs are [N_pad, C + pos_dim + 1] = [output fields, mesh_pos, node_type],
or a batch [B, N_pad, ...]: of frames over one shared hierarchy (the
consistent-mesh batch of JAX's `simulator_forward`, on the batch axis of
`ops/message.py`), or of samples on the union of their hierarchies (a
variable-mesh batch, `data.pipeline.stack_hierarchies`; JAX's
`simulator_forward_auto` vmaps over the stacked hierarchies). A batch on a
bucketed hierarchy or on a union runs as one frame of B·N_pad rows
(`graph.hierarchy.union`; a shared bucketed hierarchy through the union
of B references to it, which the simulator keeps for its last
UNION_CACHE (hierarchy, B) pairs, `Simulator.batch_union`);
the latent input strips mesh_pos and keeps node_type. normalize → encode
MLP → BSGMP → decode MLP → denormalize the delta → zero masked nodes →
prediction = state + delta. With `world_edges` the first `world_dim`
output fields are world positions, and they enter the processor as its
dynamic stream (every GMP's edge MLP then reads [Δworld, ‖Δworld‖] beside
the static mesh fiber). The forward is differentiable (every kernel
is an autograd Function with a backward kernel); serving calls it under
`torch.no_grad()` (`training/rollout.py`). `simulator_warmup` accumulates
the normalizer statistics the trainer's warmup gate collects.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch
from torch import nn

from bsms_gnn_tpu_torch.config import ModelConfig
from bsms_gnn_tpu_torch.device import resolve_device
from bsms_gnn_tpu_torch.graph.hierarchy import Hierarchy, needs_union, union
from bsms_gnn_tpu_torch.models.normalizer import (
    denormalize,
    init_normalizer,
    normalize,
    normalizer_apply_sums,
    normalizer_row_sums,
)
from bsms_gnn_tpu_torch.ops.bsgmp import BSGMP
from bsms_gnn_tpu_torch.ops.dense import MLP, mlp_apply


def split_node_input(node_in, pos_dim: int):
    """[..., C+pos_dim+1] → (latent_input [..., C+1], pos [..., pos_dim],
    node_type [..., 1])."""
    fields = node_in[..., : -1 - pos_dim]
    pos = node_in[..., -(1 + pos_dim):-1]
    node_type = node_in[..., -1:]
    return torch.cat([fields, node_type], dim=-1), pos, node_type


# The unions of a shared bucketed hierarchy that a Simulator keeps, the
# most recently used: a dataset's full batch and its short last batch on
# each of two size groups.
UNION_CACHE = 4


def world_dim(cfg: ModelConfig) -> int:
    """Width of the world-position stream (0 in the config: pos_dim)."""
    return cfg.world_dim or cfg.pos_dim


class Simulator(nn.Module):
    """Parameters are drawn from `generator` on the CPU (so a seed gives
    the same weights on every device), then moved to `device` (None: the
    CUDA card). The normalizer states `norm_in` / `norm_out` are plain
    attributes; `convert.normalizer_from_numpy` or
    `normalizer_accumulate` fill them."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        c, hl = cfg.latent_dim, cfg.hidden_layer
        fiber_dims = None
        if cfg.world_edges:
            if cfg.out_dim < world_dim(cfg):
                raise ValueError(
                    "world_edges requires the first world_dim output "
                    f"channels to be world_pos (out_dim={cfg.out_dim} < "
                    f"world_dim={world_dim(cfg)})")
            fiber_dims = (world_dim(cfg), cfg.pos_dim)
        self.encode = MLP(cfg.out_dim + 1, c, c, hl, True, generator)
        self.process = BSGMP(cfg.unet_depth, c, hl, cfg.pos_dim, generator,
                             fiber_dims)
        self.decode = MLP(c, c, cfg.out_dim, hl, False, generator)
        self.to(device)
        self.norm_in = init_normalizer(cfg.out_dim + 1, device=device)
        self.norm_out = init_normalizer(cfg.out_dim, device=device)
        # (id(h), b) → (h, the union of b references to h); the entry holds
        # h, so its id names no other hierarchy while it is kept.
        self.unions = OrderedDict()

    def batch_union(self, h: Hierarchy, b: int) -> Hierarchy:
        """The union of b references to h (a batch of b frames on one
        bucketed mesh), built once and kept while it is among the last
        UNION_CACHE used."""
        key = (id(h), b)
        if key in self.unions:
            self.unions.move_to_end(key)
        else:
            self.unions[key] = (h, union([h] * b))
            if len(self.unions) > UNION_CACHE:
                self.unions.popitem(last=False)
        return self.unions[key][1]

    def forward(self, hierarchy, node_in, node_mask, compute_dtype=None,
                tap=None, method: Optional[str] = None):
        """Next-step prediction [..., N_pad, C]. node_in: [..., N_pad,
        C+pos_dim+1] (a batch [B, N_pad, ...] over the one hierarchy or its
        union of B samples, or one frame); node_mask: [..., N_pad, 1] (1 =
        loss-valid node). `hierarchy` is on the model's device
        (`graph.hierarchy.to_device`). On a union the taps are [B,
        N_pad_l, C], as on a batch. `method` (None: the config's
        aggregation) names another, such as a rank's halo method on its
        shard of a partition plan (`parallel/halo.py`), where N_pad is the
        shard's local rows."""
        if method is not None and method.startswith("halo:"):
            return self._forward(hierarchy, node_in, node_mask,
                                 compute_dtype, tap, method)
        if node_in.dim() == 3 and needs_union(hierarchy):
            b = node_in.shape[0]
            if hierarchy.samples == 1:
                hierarchy = self.batch_union(hierarchy, b)
            elif hierarchy.samples != b:
                raise ValueError(f"a batch of {b} on a union of "
                                 f"{hierarchy.samples} samples")

            def flat(t):
                return t.reshape(-1, t.shape[-1])

            per_sample = None if tap is None else (
                lambda k, v: tap(k, v.reshape(b, -1, v.shape[-1])))
            out = self._forward(hierarchy, flat(node_in), flat(node_mask),
                                compute_dtype, per_sample, method)
            return out.reshape(b, -1, out.shape[-1])
        return self._forward(hierarchy, node_in, node_mask, compute_dtype,
                             tap, method)

    def _forward(self, hierarchy, node_in, node_mask, compute_dtype, tap,
                 method=None):
        cfg = self.cfg
        latent_input, _, _ = split_node_input(node_in, cfg.pos_dim)
        io_cd = compute_dtype
        if cfg.io_dtype:
            io_cd = None if cfg.io_dtype == "float32" else getattr(
                torch, cfg.io_dtype)
        x = mlp_apply(self.encode, normalize(self.norm_in, latent_input),
                      io_cd)
        dyn = node_in[..., :world_dim(cfg)] if cfg.world_edges else None
        x = self.process(hierarchy, x, compute_dtype, tap, dyn,
                         method or cfg.aggregation, cfg.remat,
                         cfg.remat_min_nodes)
        if io_cd is None and x.dtype != torch.float32:
            x = x.float()
        norm_pred_delta = mlp_apply(self.decode, x, io_cd)
        pred_delta = denormalize(self.norm_out, norm_pred_delta) * node_mask
        c = pred_delta.shape[-1]
        return latent_input[..., :c] + pred_delta


@torch.no_grad()
def simulator_warmup(sim: Simulator, node_in, node_tar, node_mask=None,
                     reduce=None):
    """Accumulate the normalizer statistics of one batch into
    `sim.norm_in` / `sim.norm_out` (the reference's `_warmup`). Rows with
    mask 0 stay out of the statistics (pass None to count every row).
    `reduce` (None: these rows are the whole batch) sums a list of tensors
    in place over a group of ranks that each hold part of the batch, so
    every rank accumulates the group's row sums."""
    latent_input, _, _ = split_node_input(node_in, sim.cfg.pos_dim)
    delta = node_tar - latent_input[..., :node_tar.shape[-1]]
    sums_in = normalizer_row_sums(sim.norm_in, latent_input, node_mask)
    sums_out = normalizer_row_sums(sim.norm_out, delta, node_mask)
    if reduce is not None:
        reduce([*sums_in, *sums_out])
    sim.norm_in = normalizer_apply_sums(sim.norm_in, *sums_in)
    sim.norm_out = normalizer_apply_sums(sim.norm_out, *sums_out)
