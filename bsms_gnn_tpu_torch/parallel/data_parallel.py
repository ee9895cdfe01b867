"""Data parallelism over the ranks of a `data` group (counterpart of
`bsms_gnn_tpu/parallel/data_parallel.py`, where GSPMD shards the batch and
places the collectives).

DDP's semantics, written out: the state is replicated (`replicate_state`
broadcasts the first rank's), each rank takes its slice of the batch
(`shard_batch`), and `data_parallel_step` sums the gradients with one
`all_reduce` of their concatenation before every rank applies the same
clip and AdamW. DDP itself would average per-rank losses; the loss here
is the one masked RMSE over the whole batch's sums, as the one-process
`Trainer` takes it, and the warmup gate's normalizer sums are the whole
batch's too (`Trainer.iter`'s `reduce`, `parallel/halo.py::group_reduce`).
A rank's batch is frames
over one shared hierarchy or samples on the union of their hierarchies
(`data.pipeline.stack_hierarchies` of the rank's samples).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from bsms_gnn_tpu_torch.device import resolve_device
from bsms_gnn_tpu_torch.parallel import mesh
from bsms_gnn_tpu_torch.parallel.halo import (
    check_device,
    group_reduce,
    rank_noise,
)
from bsms_gnn_tpu_torch.training.trainer import Trainer


def shard_batch(x: torch.Tensor, group: str = "data") -> torch.Tensor:
    """This rank's contiguous slice of dim 0 of a global batch (which the
    group's size must divide)."""
    size, rank = mesh.group_size(group), mesh.group_rank(group)
    if x.shape[0] % size:
        raise ValueError(f"batch {x.shape[0]} does not split over "
                         f"{size} ranks")
    b = x.shape[0] // size
    return x[rank * b:(rank + 1) * b]


@torch.no_grad()
def replicate_state(trainer: Trainer, group: str = "data") -> None:
    """Broadcast the group's first rank's parameters and normalizer
    statistics to every rank of the group."""
    pg = mesh.group(group)
    src = dist.get_global_rank(pg, 0)
    tensors = list(trainer.sim.parameters()) + [
        getattr(st, f) for st in (trainer.sim.norm_in, trainer.sim.norm_out)
        for f in ("acc_weight", "num_accumulations", "e_x", "e_x2")]
    for t in tensors:
        dist.broadcast(t.data, src, group=pg)


def data_parallel_step(trainer: Trainer, hierarchy, node_in, node_tar,
                       node_mask, noise=None, group: str = "data",
                       device=None):
    """One train step of the replicated `trainer` on this rank's part of
    the batch (node_in [B_r, N_pad, C_in] or one frame; `hierarchy` the
    shared one or the union of this rank's samples), summed over `group`:
    `Trainer.iter` with the group's sums. `noise` is this rank's part of
    the global standard-normal draw, else a draw from the rank's own
    generator (`halo.rank_noise`). `device` (None: the CUDA card) must be
    the trainer's. Returns the batch's loss."""
    device = resolve_device(device)
    check_device(device, trainer, node_in, node_tar, node_mask, noise)
    if noise is None:
        noise = rank_noise(trainer, mesh.group_rank(group), node_tar)
    return trainer.iter(hierarchy, node_in, node_tar, node_mask, noise,
                        reduce=group_reduce(group))
