"""The ('data', 'graph') process groups over `torch.distributed`
(counterpart of `bsms_gnn_tpu/parallel/mesh.py::make_mesh` and
`multihost.py::global_mesh`).

`make_groups(data, graph)` splits the data·graph ranks of the started
process group into rows of `graph` consecutive ranks (rank r = d·graph +
g, as JAX's mesh reshapes its devices to (data, graph)): each row is one
graph group, whose ranks hold the shards of one partitioned hierarchy,
and each column one data group, whose ranks hold replicas of the state
and split the batch. The groups are registered under the names "data" and
"graph", which the halo method strings name (`"halo:graph:fused"`,
`group(name)`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch.distributed as dist

_GROUPS: Dict[str, "dist.ProcessGroup"] = {}


@dataclass
class Groups:
    data: "dist.ProcessGroup"
    graph: "dist.ProcessGroup"
    data_size: int
    graph_size: int
    data_rank: int  # this rank's place in its data group
    graph_rank: int  # this rank's place (its shard) in its graph group


def make_groups(data: int = 1, graph: int = 1) -> Groups:
    """The data and graph groups over data·graph ranks (every rank of the
    started process group calls this with the same sizes). `data=-1`
    takes the world size over `graph`."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized "
                           "(parallel.multihost.init_distributed)")
    world = dist.get_world_size()
    if data == -1:
        if world % graph:
            raise ValueError(f"graph {graph} does not divide world {world}")
        data = world // graph
    if data * graph != world:
        raise ValueError(f"data {data} x graph {graph} != world size {world}")
    rank = dist.get_rank()
    mine = {}
    # Every rank creates every group, in the same order.
    for d in range(data):
        ranks = [d * graph + g for g in range(graph)]
        pg = dist.new_group(ranks)
        if rank in ranks:
            mine["graph"] = pg
    for g in range(graph):
        ranks = [d * graph + g for d in range(data)]
        pg = dist.new_group(ranks)
        if rank in ranks:
            mine["data"] = pg
    _GROUPS.update(mine)
    return Groups(data=mine["data"], graph=mine["graph"], data_size=data,
                  graph_size=graph, data_rank=rank // graph,
                  graph_rank=rank % graph)


def group(name: Optional[str]) -> "dist.ProcessGroup":
    """The process group registered under `name` by `make_groups` ("data"
    or "graph"); "world" (or None) is the whole started group."""
    if name in (None, "world"):
        return dist.group.WORLD
    if name not in _GROUPS:
        raise KeyError(f"no process group {name!r} (parallel.mesh."
                       f"make_groups registers 'data' and 'graph')")
    return _GROUPS[name]


def group_rank(name: Optional[str]) -> int:
    return dist.get_rank(group(name))


def group_size(name: Optional[str]) -> int:
    return dist.get_world_size(group(name))
