"""The halo exchange over `torch.distributed`, and the sharded forward,
rollout and train step (counterpart of `bsms_gnn_tpu/parallel/halo.py`).

One rank holds one shard of a `PartitionPlan` (`parallel/partition.py`),
its own `Hierarchy` on its device (`rank_hierarchy`, built once by the
caller), and its shard of the
node arrays ([..., N_loc, C], `partition_nodes(plan, x)[rank]`). The model
runs on the method `"halo:<group>:<local>"` (`halo_method`): every op of
`ops/` then reads the rank's part of each level, and the only traffic is

- one `all_to_all_single` per sender gather, with equal splits (`halo_rows`:
  each rank ships the rows `halo_send` lists for each other rank, dest
  after dest; `halo_return` is its adjoint: the rows' cotangents go back
  and add onto the local rows they came from), as `HaloRows` /
  `HaloReturn`, each the other's backward;
- one `all_reduce` per transition into the first replicated level
  (`ops/pool.py::pool_nodes_boundary`), and in the train step the loss's
  two sums, the normalizer's sums during the warmup gate and one
  `all_reduce` of the flattened gradients.

On a ghost layout (the windowed `fused` plan) a GMP exchanges its
[x·W_i | x·W_j] rows once (with world edges [x·W_i | x·W_j | world_pos]),
then runs kernels 4, 2 and 3 on the rank's extended tables
(`ext_assemble`: local rows, received halo rows, zero pad rows), and its
convs gather the extended rows once, then run kernel 1's level form and
kernel 2 (kernel 8 on an unwindowed ghost level); the backwards run kernels
5, 7 and 6 and the adjoint exchange.

The train step (`halo_train_step`, `HaloTrainer`) is the one-device
`Trainer.iter` with the group's sums (`group_reduce`): the warmup gate
sums the normalizer's row sums over the ranks; the loss is one masked
RMSE over the group's sums; the gradients are summed over the ranks, then
clipped by their global norm and applied by AdamW, so every rank ends
with the same state. No autograd runs through a collective of the loss:
each rank's backward starts from its own sum n_s with the coefficient
∂L/∂n_s.

A collective of every rank of the group must be reached by every rank in
the same order: every rank runs the same model over a shard of the same
plan, and autograd (remat's replays included) visits its nodes in an order
the graph fixes.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist

from bsms_gnn_tpu_torch.config import split_interleave
from bsms_gnn_tpu_torch.device import resolve_device, same_device
from bsms_gnn_tpu_torch.graph.hierarchy import Hierarchy, to_device
from bsms_gnn_tpu_torch.parallel import mesh
from bsms_gnn_tpu_torch.parallel.partition import (
    PartitionPlan,
    shard_hierarchy,
)
from bsms_gnn_tpu_torch.training.trainer import Trainer

# Counts of the collectives each rank issues, and (when `timed`) their
# wall time on the host, a synchronize before each.
STATS = {"exchanges": 0, "reductions": 0, "seconds": 0.0, "timed": False}


def reset_stats(timed: bool = False) -> None:
    STATS.update(exchanges=0, reductions=0, seconds=0.0, timed=timed)


def _collective(kind: str, fn):
    STATS[kind] += 1
    if not STATS["timed"]:
        return fn()
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    STATS["seconds"] += time.perf_counter() - t0
    return out


def all_reduce(t: torch.Tensor, group: Optional[str]) -> torch.Tensor:
    """The sum of `t` over the group, in place (t must be contiguous)."""
    pg = mesh.group(group)
    _collective("reductions", lambda: dist.all_reduce(t, group=pg))
    return t


def _exchange(rows: torch.Tensor, group: Optional[str]) -> torch.Tensor:
    """`all_to_all_single` of [..., S·H, C] rows with equal splits on dim
    -2: block d goes to rank d, and block t of the result came from rank
    t (self-adjoint)."""
    pg = mesh.group(group)
    src = rows.movedim(-2, 0).contiguous()
    if src.shape[0] % dist.get_world_size(pg):
        raise ValueError(f"{src.shape[0]} rows do not split over the "
                         f"group's {dist.get_world_size(pg)} ranks")
    out = torch.empty_like(src)
    _collective("exchanges",
                lambda: dist.all_to_all_single(out, src, group=pg))
    return out.movedim(0, -2)


def halo_rows(x: torch.Tensor, halo_send: torch.Tensor,
              group: Optional[str]) -> torch.Tensor:
    """The halo rows this rank receives, [..., S·H, C]: each rank ships
    x[..., halo_send[d], :] to rank d (`_halo_rows`, `halo.py:50`)."""
    return _exchange(x.index_select(-2, halo_send.reshape(-1)), group)


def halo_return(contrib: torch.Tensor, halo_send: torch.Tensor, n_loc: int,
                group: Optional[str]) -> torch.Tensor:
    """The adjoint of `halo_rows` (`_halo_return`, `halo.py:57`): rows
    [..., S·H, C] grouped by their owner go back, and each adds onto the
    local row it was shipped from → [..., n_loc, C]."""
    back = _exchange(contrib, group)
    out = back.new_zeros(*back.shape[:-2], n_loc, back.shape[-1])
    return out.index_add_(-2, halo_send.reshape(-1), back)


class HaloRows(torch.autograd.Function):
    """`halo_rows`; backward: `halo_return` of the cotangent."""

    @staticmethod
    def forward(ctx, x, halo_send, group):
        ctx.halo_send, ctx.group, ctx.n_loc = halo_send, group, x.shape[-2]
        return halo_rows(x, halo_send, group)

    @staticmethod
    def backward(ctx, g):
        return halo_return(g, ctx.halo_send, ctx.n_loc, ctx.group), None, None


class HaloReturn(torch.autograd.Function):
    """`halo_return`; backward: `halo_rows` of the cotangent."""

    @staticmethod
    def forward(ctx, contrib, halo_send, n_loc, group):
        ctx.halo_send, ctx.group = halo_send, group
        return halo_return(contrib, halo_send, n_loc, group)

    @staticmethod
    def backward(ctx, g):
        return halo_rows(g, ctx.halo_send, ctx.group), None, None, None


def ext_assemble(level, x: torch.Tensor, group: Optional[str]) -> torch.Tensor:
    """[..., N_loc, C] → [..., N_ext_pad, C] on a ghost level: the local
    rows, the received halo rows (one exchange), zero pad rows
    (`_ext_assemble`, `halo.py:94`); a replicated level exchanges nothing
    and pads. Differentiable in x."""
    lg = level.local
    if level.replicated:
        parts = [x]
    else:
        parts = [x, HaloRows.apply(x, level.halo_send, group)]
    pad = lg.n_pad_nodes - sum(p.shape[-2] for p in parts)
    parts.append(x.new_zeros(*x.shape[:-2], pad, x.shape[-1]))
    return torch.cat(parts, dim=-2)


# -- the sharded entry points ------------------------------------------------


def halo_method(cfg, group: str = "graph") -> str:
    """The halo method string of a model config: `"halo:<group>:<local>"`,
    local the config's method with "fusedK" read as "fused" (JAX's
    `_halo_method`, `halo.py:415-421`, tests the unstripped method, so its
    "fusedK" leaves the ghost kernels; the port runs them). A plain halo
    layout runs the generic route whatever the local method."""
    local = split_interleave(cfg.aggregation)[0]
    return f"halo:{group}:{local}"


def _check_group(n_shards: int, group: str) -> int:
    """This rank's place in `group`, which must hold n_shards ranks."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized "
                           "(parallel.multihost.init_distributed)")
    size = mesh.group_size(group)
    if size != n_shards:
        raise ValueError(f"a plan of {n_shards} shards on a group of "
                         f"{size} ranks")
    return mesh.group_rank(group)


def rank_hierarchy(plan: PartitionPlan, group: str = "graph",
                   device=None) -> Hierarchy:
    """This rank's shard of the plan (its place in `group`) as a
    `Hierarchy` on `device` (None: the CUDA card): built once by the
    caller, then given to `halo_forward`, `halo_rollout` and
    `halo_train_step` (`HaloTrainer` holds its own)."""
    device = resolve_device(device)
    rank = _check_group(plan.n_shards, group)
    return to_device(shard_hierarchy(plan, rank), device)


def check_device(device, trainer=None, *tensors):
    """Raise unless the trainer (if any) and every tensor (None skipped)
    live on `device`."""
    if trainer is not None and not same_device(trainer.device, device):
        raise ValueError(f"the trainer is on {trainer.device}, not {device}")
    for t in tensors:
        if t is not None and not same_device(t.device, device):
            raise ValueError(f"a tensor on {t.device}, the rank's device is "
                             f"{device}")


def _rank_method(cfg, hier: Hierarchy, group: str) -> str:
    """The halo method on `hier`, a rank's shard in `group`."""
    _check_group(hier.levels[0].n_shards, group)
    return halo_method(cfg, group)


@torch.no_grad()
def halo_forward(sim, hier: Hierarchy, node_in, node_mask,
                 group: str = "graph", device=None, compute_dtype=None):
    """This rank's next-step prediction [..., N_loc, C] from its shard of
    the input (node_in [..., N_loc, C_in], node_mask [..., N_loc, 1]) over
    its shard `hier` (`rank_hierarchy`) on `device` (None: the CUDA card;
    the sim and tensors live there) (`make_halo_forward`, `halo.py:578`)."""
    device = resolve_device(device)
    check_device(device, None, node_in, node_mask)
    return sim(hier, node_in, node_mask, compute_dtype,
               method=_rank_method(sim.cfg, hier, group))


@torch.no_grad()
def halo_rollout(sim, hier: Hierarchy, ic, node_mask, n_steps: int,
                 group: str = "graph", device=None, compute_dtype=None):
    """The closed-loop rollout on this rank's shard `hier`
    (`make_halo_rollout`, `halo.py:617`): ic [N_loc, C + pos_dim + 1],
    node_mask [N_loc, 1] → [n_steps, N_loc, C]. The shard stays on the
    device for every step; only the halo rows cross ranks."""
    device = resolve_device(device)
    check_device(device, None, ic, node_mask)
    method = _rank_method(sim.cfg, hier, group)
    c_out = ic.shape[-1] - sim.cfg.pos_dim - 1
    pos_type = ic[..., c_out:]
    current, preds = ic, []
    for _ in range(n_steps):
        pred = sim(hier, current, node_mask, compute_dtype, method=method)
        current = torch.where(node_mask == 0, ic,
                              torch.cat([pred, pos_type], dim=-1))
        preds.append(pred)
    return torch.stack(preds)


def rank_noise(trainer: Trainer, rank: int, like: torch.Tensor):
    """A standard-normal draw shaped like `like` from the rank's noise
    generator on the trainer's device, seeded once from (the trainer's
    noise seed, rank)."""
    gen = getattr(trainer, "_rank_noise", None)
    if gen is None or gen[0] != rank:
        seed = (trainer.noise_generator.initial_seed() * 1_000_003
                + rank + 1) % 2**63
        gen = (rank, torch.Generator(trainer.device).manual_seed(seed))
        trainer._rank_noise = gen
    return torch.randn(like.shape, generator=gen[1], device=like.device,
                       dtype=like.dtype)


def group_reduce(group: str):
    """`Trainer.iter`'s `reduce` over the ranks of `group`: each tensor of
    a list summed in place through one `all_reduce` of their
    concatenation."""

    def reduce(tensors):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        all_reduce(flat, group)
        off = 0
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()

    return reduce


def halo_train_step(trainer: Trainer, hier: Hierarchy, node_in, node_tar,
                    node_mask, noise=None, group: str = "graph", device=None):
    """One train step of the replicated `trainer` on this rank's shard
    `hier` (`rank_hierarchy`) and its rows (node_in [N_loc, C_in],
    node_tar [N_loc, C], node_mask [N_loc, 1]) (`make_halo_train_step`,
    `halo.py:452`): `Trainer.iter` with the halo method and the group's
    sums. `noise` is this rank's part of the global standard-normal draw
    (node_tar's shape), else a draw from `rank_noise`. `device` (None: the
    CUDA card) must be the trainer's. Returns the group's loss."""
    device = resolve_device(device)
    check_device(device, trainer, node_in, node_tar, node_mask, noise)
    method = _rank_method(trainer.cfg.model, hier, group)
    if noise is None:
        noise = rank_noise(trainer, mesh.group_rank(group), node_tar)
    # The one-device step by name: a `HaloTrainer`'s own `iter` is this.
    return Trainer.iter(trainer, hier, node_in, node_tar, node_mask, noise,
                        method=method, reduce=group_reduce(group))


class HaloTrainer(Trainer):
    """A `Trainer` whose `iter` is `halo_train_step` on its rank's shard of
    `plan` in `group`, `self.hierarchy`, built once (every rank of the
    group holds one, made from the same config and generator, so the
    replicas start equal)."""

    def __init__(self, cfg, plan: PartitionPlan, group: str = "graph",
                 opt=None, generator=None, device=None, compute_dtype=None):
        super().__init__(cfg, opt, generator, device, compute_dtype)
        self.plan, self.group = plan, group
        self.hierarchy = rank_hierarchy(plan, group, self.device)

    def iter(self, node_in, node_tar, node_mask, noise=None):
        return halo_train_step(self, self.hierarchy, node_in, node_tar,
                               node_mask, noise, self.group, self.device)
