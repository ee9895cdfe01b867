"""Starting the distributed runtime (counterpart of
`bsms_gnn_tpu/parallel/multihost.py::init_multihost`).

Every rank runs the same program and calls `init_distributed` with the
backend, its rank, the world size and the rendezvous address (nothing on
the machine announces a cluster). `"nccl"` is the default: one card per
rank, `cuda:<rank>` unless the caller names the device. `"gloo"` is taken
only when asked for; it moves CUDA tensors through the host, and is the
backend of the CPU tests and of ranks that share one card (NCCL refuses
two ranks on one device).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from bsms_gnn_tpu_torch.device import resolve_device

BACKENDS = ("nccl", "gloo")


def init_distributed(backend: str = "nccl", rank: int = 0,
                     world_size: int = 1, *, init_method: str,
                     device=None, timeout=None) -> torch.device:
    """`dist.init_process_group` with the caller's backend, rank, world
    size, rendezvous `init_method` and `timeout`, once per process;
    returns the rank's device. Every rank names the same `init_method`,
    such as "tcp://localhost:<free port>"; it has no default, so two runs
    on one machine cannot meet by chance. `timeout` is a timedelta: how
    long a collective waits.
    With NCCL the device is `cuda:<rank>` (None) and a card count below
    the world size raises; with gloo it is `device` (None: the CUDA card,
    raising without one; pass "cpu" by name)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside [0, {world_size})")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < world_size:
            raise RuntimeError(f"nccl needs a card per rank: {cards} "
                               f"card(s) for world size {world_size}")
        dev = (torch.device("cuda", rank) if device is None
               else _indexed(torch.device(device)))
        torch.cuda.set_device(dev)
    else:
        dev = _indexed(resolve_device(device))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        if timeout is not None:
            kw["timeout"] = timeout
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, **kw)
    return dev


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index (the current card where none is
    named)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def shutdown() -> None:
    """`dist.destroy_process_group`, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
