"""BSMS next-step simulator: encode → BSGMP process → decode, delta target
(counterpart of `bsms_gnn_tpu/models/simulator.py::simulator_forward`).

Inputs are [N_pad, C + pos_dim + 1] = [output fields, mesh_pos, node_type],
or a batch [B, N_pad, ...] of frames over one shared hierarchy (the
consistent-mesh batch of JAX's `simulator_forward`, on the routes that take
it: `ops/message.py`);
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

from typing import Optional

import torch
from torch import nn

from bsms_gnn_tpu_torch.config import ModelConfig
from bsms_gnn_tpu_torch.device import resolve_device
from bsms_gnn_tpu_torch.models.normalizer import (
    denormalize,
    init_normalizer,
    normalize,
    normalizer_accumulate,
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

    def forward(self, hierarchy, node_in, node_mask, compute_dtype=None,
                tap=None):
        """Next-step prediction [..., N_pad, C]. node_in: [..., N_pad,
        C+pos_dim+1] (a batch [B, N_pad, ...] over the one hierarchy, or
        one frame); node_mask: [..., N_pad, 1] (1 = loss-valid node).
        `hierarchy` is on the model's device (`graph.hierarchy.to_device`)."""
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
                         cfg.aggregation)
        if io_cd is None and x.dtype != torch.float32:
            x = x.float()
        norm_pred_delta = mlp_apply(self.decode, x, io_cd)
        pred_delta = denormalize(self.norm_out, norm_pred_delta) * node_mask
        c = pred_delta.shape[-1]
        return latent_input[..., :c] + pred_delta


@torch.no_grad()
def simulator_warmup(sim: Simulator, node_in, node_tar, node_mask=None):
    """Accumulate the normalizer statistics of one batch into
    `sim.norm_in` / `sim.norm_out` (the reference's `_warmup`). Rows with
    mask 0 stay out of the statistics (pass None to count every row)."""
    latent_input, _, _ = split_node_input(node_in, sim.cfg.pos_dim)
    delta = node_tar - latent_input[..., :node_tar.shape[-1]]
    sim.norm_in = normalizer_accumulate(sim.norm_in, latent_input, node_mask)
    sim.norm_out = normalizer_accumulate(sim.norm_out, delta, node_mask)
