"""One rank of a gloo group for the port's parallel tests, on the CPU.

    python tests/torch_parallel_worker.py TASK RANK WORLD PORT OUT

TASK is a `torch.save`d dict {"cases": {name: case}} written by a test
module (`torch_parallel_group.py`); every rank runs every case in order
and saves {name: result} to OUT. A case names its kind (`CASES`), its
shard count S (the world splits into data·S ranks, `make_groups`; rank r
holds shard r mod S; an edge-sharded case names its (data, graph) `mesh`
instead, which the world must equal) and its inputs as numpy arrays: a
mesh (pos, cells),
its partition (`build_partition`'s keywords), the global node arrays,
model and optimizer configs and the weights. Imports only the port (and
`torch_threads`, `torch_parallel_group`): no JAX.
"""

import dataclasses
import datetime
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_threads  # noqa: E402,F401 (the worker's share of the cores)

from bsms_gnn_tpu_torch.config import (  # noqa: E402
    Config,
    DatasetConfig,
    ModelConfig,
    OptConfig,
)
from bsms_gnn_tpu_torch.convert import normalizer_from_numpy  # noqa: E402
from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels  # noqa: E402
from bsms_gnn_tpu_torch.graph.hierarchy import (  # noqa: E402
    build_hierarchy,
    to_device,
)
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge  # noqa: E402
from bsms_gnn_tpu_torch.models.simulator import Simulator  # noqa: E402
from bsms_gnn_tpu_torch.ops import scatter  # noqa: E402
from bsms_gnn_tpu_torch.ops.kernels import (  # noqa: E402
    compact_resid,
    fused_gmp,
    fused_gmp_dyn,
    fused_gmp_k,
    node_mlp,
    segment_sum,
    windowed,
)
from bsms_gnn_tpu_torch.ops.message import (  # noqa: E402
    edge_conv_down,
    edge_conv_up,
)
from bsms_gnn_tpu_torch.parallel import halo, mesh, multihost  # noqa: E402
from bsms_gnn_tpu_torch.parallel.edge_shard import (  # noqa: E402
    edge_shard_forward,
    edge_shard_hierarchy,
    edge_shard_train_step,
)
from bsms_gnn_tpu_torch.parallel.data_parallel import (  # noqa: E402
    data_parallel_step,
    replicate_state,
    shard_batch,
)
from bsms_gnn_tpu_torch.parallel.partition import (  # noqa: E402
    build_partition,
    partition_nodes,
)
from bsms_gnn_tpu_torch.training.trainer import Trainer  # noqa: E402
from torch_parallel_group import step_grads  # noqa: E402

DEV = torch.device("cpu")
# The plain versions of the kernels (what a CPU tensor runs where a CUDA
# tensor launches the kernel): each case reports how often it called each.
PLAIN = {
    "fused_edge_phase_win": fused_gmp.fused_edge_phase_win_plain,
    "fused_edge_phase_win_bwd": fused_gmp.fused_edge_phase_win_bwd_plain,
    "fused_edge_phase_win_dyn": fused_gmp_dyn.fused_edge_phase_win_dyn_plain,
    "fused_node_phase": node_mlp.fused_node_phase_plain,
    "fused_node_phase_bwd": node_mlp.fused_node_phase_bwd_plain,
    "compact_accum": compact_resid.compact_accum_plain,
    "windowed_conv": windowed.windowed_conv_plain,
    "windowed_rect_conv": windowed.windowed_rect_conv_plain,
    "windowed_send_sum": windowed.windowed_send_sum_plain,
    "segment_sum": segment_sum.segment_sum_plain,
    "fused_edge_phase_win_k": fused_gmp_k.fused_edge_phase_win_k_plain,
}


def plan_of(case):
    pos, cells = case["pos"], case["cells"]
    levels = build_bistride_levels(to_flat_edge(cells, "tri"), case["depth"],
                                   len(pos), pos)
    return build_partition(levels, case["S"], case["n_pad"], pos,
                           **case["plan"])


def shard(plan, x, s):
    return torch.from_numpy(np.ascontiguousarray(
        partition_nodes(plan, x)[s]))


def simulator(case):
    sim = Simulator(ModelConfig(**case["model"]), device=DEV)
    sim.load_state_dict(case["params"])
    sim.norm_in = normalizer_from_numpy(case["norm_in"], device=DEV)
    sim.norm_out = normalizer_from_numpy(case["norm_out"], device=DEV)
    return sim


def config(case):
    return Config(datasets=DatasetConfig(**case.get("datasets", {})),
                  model=ModelConfig(**case["model"]),
                  opt=OptConfig(**case.get("opt", {})))


def run_primitives(case, s):
    """The four primitives and the level's own convs on shard s of level
    `level`, each on the halo method `method` (x [N_pad, C] global)."""
    plan = plan_of(case)
    hier = halo.rank_hierarchy(plan, "graph", DEV)
    lvl = hier.levels[case["level"]]
    method = case["method"]
    x = shard(plan, case["x"], s).requires_grad_()
    xe = scatter.gather_send(lvl, x, method)
    down = scatter.aggregate_recv(lvl, xe, method)
    up = scatter.aggregate_send(lvl, xe, method)
    out = {"down": down.detach().numpy(), "up": up.detach().numpy()}
    # The adjoint: d⟨g, down(x)⟩/dx through both primitives' backwards.
    g = shard(plan, case["g"], s)
    (down * g).sum().backward()
    out["down_grad"] = x.grad.numpy().copy()
    if case.get("conv"):
        xc = shard(plan, case["x"], s).requires_grad_()
        cd = edge_conv_down(lvl, xc, None, method)
        cu = edge_conv_up(lvl, xc, None, method)
        (cd * g).sum().backward()
        out.update(conv_down=cd.detach().numpy(), conv_up=cu.detach().numpy(),
                   conv_down_grad=xc.grad.numpy().copy())
    return out


def run_forward(case, s):
    plan = plan_of(case)
    sim = simulator(case)
    hier = halo.rank_hierarchy(plan, "graph", DEV)
    ni, nm = shard(plan, case["node_in"], s), shard(plan, case["mask"], s)
    out = {"pred": halo.halo_forward(sim, hier, ni, nm, device=DEV).numpy()}
    if case.get("rollout"):
        out["rollout"] = halo.halo_rollout(sim, hier, ni, nm,
                                           case["rollout"],
                                           device=DEV).numpy()
    return out


def run_train(case, s):
    """`case["steps"]` halo train steps from the given weights; noise: the
    global draw of each step (or none)."""
    plan = plan_of(case)
    tr = halo.HaloTrainer(config(case), plan, device=DEV)
    tr.sim.load_state_dict(case["params"])
    ni, nt, nm = (shard(plan, case[k], s)
                  for k in ("node_in", "node_tar", "mask"))
    noise = case.get("noise")
    losses, grads = [], []
    for i in range(case["steps"]):
        z = None if noise is None else shard(plan, noise[i], s)
        losses.append(float(tr.iter(ni, nt, nm, z)))
        grads.append(step_grads(tr))
    return train_result(tr, losses, grads)


def train_result(tr, losses, grads):
    return {"losses": np.asarray(losses), "grads": grads,
            "params": {k: v.detach().numpy().copy()
                       for k, v in tr.sim.state_dict().items()},
            "norm_in": {f: getattr(tr.sim.norm_in, f).numpy().copy()
                        for f in ("acc_weight", "e_x", "e_x2")},
            "norm_out": {f: getattr(tr.sim.norm_out, f).numpy().copy()
                         for f in ("acc_weight", "e_x", "e_x2")},
            "updates": tr.updates}


def run_dp_train(case, s):
    """Data-parallel steps: this rank's slice of the global batch
    (`shard_batch`) over the one shared hierarchy or the union of its
    samples; noise: each step's global draw. Only the first rank loads
    the weights, and every other one shifts its normalizers:
    `replicate_state` gives every rank the first one's."""
    pos, cells = case["pos"], case["cells"]
    h = to_device(build_hierarchy(to_flat_edge(cells, "tri"), case["depth"],
                                  len(pos), pos, **case.get("layout", {})),
                  DEV)
    tr = Trainer(config(case), device=DEV)
    if s == 0:
        tr.sim.load_state_dict(case["params"])
    else:
        for name in ("norm_in", "norm_out"):
            st = getattr(tr.sim, name)
            setattr(tr.sim, name, dataclasses.replace(
                st, e_x=st.e_x + 1.0, e_x2=st.e_x2 + 2.0,
                acc_weight=st.acc_weight + 3.0,
                num_accumulations=st.num_accumulations + 1.0))
    replicate_state(tr)

    def part(a):
        return shard_batch(torch.from_numpy(a))

    ni, nt, nm = (part(case[k]) for k in ("node_in", "node_tar", "mask"))
    losses, grads = [], []
    for i in range(case["steps"]):
        z = part(case["noise"][i]) if "noise" in case else None
        losses.append(float(data_parallel_step(tr, h, ni, nt, nm, z,
                                               device=DEV)))
        grads.append(step_grads(tr))
    return train_result(tr, losses, grads)


def eshard_hierarchy(case):
    """This rank's edge shard of the case's one-device hierarchy (its
    place in the `graph` group)."""
    pos, cells = case["pos"], case["cells"]
    h = build_hierarchy(to_flat_edge(cells, "tri"), case["depth"], len(pos),
                        pos, **case.get("layout", {}))
    return edge_shard_hierarchy(h, "graph", DEV)


def run_eshard_forward(case, s):
    """The edge-sharded forward of the whole input (replicated)."""
    sim = simulator(case)
    hier = eshard_hierarchy(case)
    halo.reset_stats()
    pred = edge_shard_forward(sim, hier, torch.from_numpy(case["node_in"]),
                              torch.from_numpy(case["mask"]), device=DEV)
    return {"pred": pred.numpy(), "reductions": halo.STATS["reductions"],
            "slots": [lv.n_pad_edges for lv in hier.levels]}


def run_eshard_train(case, s):
    """Edge-sharded steps: this rank's data row's slice of the global batch
    (`shard_batch` over `data`) on its graph rank's edge shard; noise:
    each step's global draw."""
    tr = Trainer(config(case), device=DEV)
    tr.sim.load_state_dict(case["params"])
    hier = eshard_hierarchy(case)

    def part(a):
        return shard_batch(torch.from_numpy(a))

    ni, nt, nm = (part(case[k]) for k in ("node_in", "node_tar", "mask"))
    losses, grads, reductions = [], [], []
    for i in range(case["steps"]):
        z = part(case["noise"][i]) if "noise" in case else None
        halo.reset_stats()
        losses.append(float(edge_shard_train_step(tr, hier, ni, nt, nm, z,
                                                  device=DEV)))
        reductions.append(halo.STATS["reductions"])
        grads.append(step_grads(tr))
    out = train_result(tr, losses, grads)
    out.update(reductions=reductions, data_rank=mesh.group_rank("data"))
    return out


CASES = {"primitives": run_primitives, "forward": run_forward,
         "train": run_train, "dp_train": run_dp_train,
         "eshard_forward": run_eshard_forward,
         "eshard_train": run_eshard_train}


def main(task, rank, world, port, out):
    # The ranks share the cores they were given (their spinning intra-op
    # threads starve one another otherwise; see torch_threads).
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    cases = torch.load(task, weights_only=False)["cases"]
    multihost.init_distributed("gloo", rank, world,
                               init_method=f"tcp://localhost:{port}",
                               device="cpu",
                               timeout=datetime.timedelta(seconds=120))
    results = {}
    try:
        for name, case in cases.items():
            if case.get("data"):  # the data axis holds the whole world
                mesh.make_groups(world, 1)
                s = rank
            elif "mesh" in case:  # (data, graph), every rank runs
                mesh.make_groups(*case["mesh"])
                s = mesh.group_rank("graph")
            else:
                mesh.make_groups(world // case["S"], case["S"])
                s = mesh.group_rank("graph")
            if ("mesh" not in case and not case.get("data")
                    and mesh.group_rank("data") > 0):
                continue  # a replica of the first graph group's shards
            for fn in PLAIN.values():
                fn.calls = 0
            t0 = time.perf_counter()
            results[name] = CASES[case["kind"]](case, s)
            results[name].update(
                shard=s, seconds=time.perf_counter() - t0,
                plain_calls={k: fn.calls for k, fn in PLAIN.items()})
    finally:
        multihost.shutdown()
    torch.save(results, out)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5])
