"""The port's halo path (`bsms_gnn_tpu_torch/parallel/`, `"halo:"`
methods) on a gloo group of four CPU ranks against the JAX package.

The case is `test_halo.py`'s: a 9×9 triangulated grid, depth 2. One group
of ranks (`torch_parallel_worker.py`) runs every case of the module while
the JAX references compile:
- the four primitives and the ghost conv pair on level 0, plain and ghost
  layouts, narrow rows (the `ell` local method, `index_add`) and 128-wide
  ones (the `fused` local method: kernel 8's, kernel 1's level form's and
  kernel 2's plain versions), against the global sums (`test_halo.py:82,
  133, 183, 223`), and the down sum's gradient against its adjoint;
- the generic `halo:` forward (latent 16, `ell`) on plain, ghost,
  replicated and mixed `ghost_floor` plans against JAX's one-device
  forward;
- the ghost `fused` forward (latent 128, window 128) and the v4
  world-edge forward against JAX's `make_halo_forward` on the same plan
  (`test_halo.py:265, 295`), and `"fused4"` against JAX's `"fused"`
  halo forward; replication composed with the ghost `fused` path against
  JAX's one-device forward.

Tolerances: the global sums 1e-5 (`test_halo.py`'s); against JAX's
one-device model `test_halo.py`'s rtol 2e-3, atol 2e-4; against JAX on the
same plan `test_torch_port_slice.py`'s F32_TOL (both sides in f32, summed
in other orders through ~20 dense layers and LayerNorms)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from conftest import make_grid_mesh
from test_torch_port_weights import (
    jax_state_with_stats,
    jax_to_nested,
    normalizer_to_dict,
)
from torch_parallel_group import Group, gather_shards

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import ModelConfig as JaxModelConfig
from bsms_gnn_tpu.graph.bistride import build_bistride_levels as jax_levels
from bsms_gnn_tpu.graph.hierarchy import pad_levels
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.models.simulator import simulator_forward
from bsms_gnn_tpu.parallel import (
    build_partition as jax_partition,
    make_halo_forward,
    make_mesh,
    partition_nodes,
)
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import ModelConfig
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels
from bsms_gnn_tpu_torch.graph.hierarchy import to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.ops.message import cal_ew
from bsms_gnn_tpu_torch.ops.scatter import halo_parts
from bsms_gnn_tpu_torch.parallel.halo import halo_method
from bsms_gnn_tpu_torch.parallel.partition import (
    build_partition,
    shard_hierarchy,
    unpartition_nodes,
)

OUT, DEPTH, N_PAD, WORLD = 3, 2, 128, 4
SUM_TOL = 1e-5
ONE_DEVICE_TOL = dict(rtol=2e-3, atol=2e-4)
F32_TOL = 5e-4
SMALL = dict(unet_depth=DEPTH, latent_dim=16, hidden_layer=1, out_dim=OUT,
             accumulation_steps=1, aggregation="ell")
WIDE = dict(SMALL, latent_dim=128, aggregation="fused")
WORLD_EDGES = dict(WIDE, world_edges=True, world_dim=2)
# name → (S, build_partition keywords, halo method, width)
PRIMITIVES = {
    "plain_c5": (4, dict(block=32), "halo:graph", 5),
    "ghost_c5": (4, dict(block=32, local_layouts=True), "halo:graph:ell", 5),
    "ghost_c128": (4, dict(block=32, local_layouts=True), "halo:graph:fused",
                   128),
    "ghost_w128_c128": (4, dict(block=32, local_layouts=True, window=128),
                        "halo:graph:fused", 128),
}
# name → (S, build_partition keywords, model), the generic ell path
SMALL_PLANS = {
    "plain": (4, dict(block=32)),
    "ghost": (4, dict(block=32, local_layouts=True)),
    "ghost_repl25": (2, dict(block=32, local_layouts=True,
                             replicate_floor=25)),
    "plain_repl45": (4, dict(block=32, replicate_floor=45)),
    "ghost_floor45": (4, dict(block=32, local_layouts=True, ghost_floor=45)),
}
FUSED_PLAN = dict(block=64, local_layouts=True, window=128)


def port_state(jcfg, seed):
    state = jax_state_with_stats(jcfg, seed=seed)
    return state, dict(params=params_from_numpy(jax_to_nested(state.params)),
                       norm_in=normalizer_to_dict(state.norm_in),
                       norm_out=normalizer_to_dict(state.norm_out))


@pytest.fixture(scope="module")
def case():
    pos, cells = make_grid_mesh(9, 9)
    n = len(pos)
    rng = np.random.default_rng(3)
    node_in = np.zeros((N_PAD, OUT + 3), np.float32)
    node_in[:n, :OUT] = rng.standard_normal((n, OUT))
    node_in[:n, OUT:OUT + 2] = pos
    world_in = node_in.copy()
    world_in[:n, :2] = pos * 1.03 + 0.01
    mask = np.zeros((N_PAD, 1), np.float32)
    mask[:n] = 1.0
    x128 = np.zeros((N_PAD, 128), np.float32)
    x128[:n] = rng.standard_normal((n, 128))
    g128 = np.zeros((N_PAD, 128), np.float32)
    g128[:n] = rng.standard_normal((n, 128))
    mesh_in = dict(pos=pos, cells=cells, depth=DEPTH, n_pad=N_PAD)

    jcfgs = {k: JaxModelConfig(**v) for k, v in
             (("small", SMALL), ("wide", WIDE), ("world", WORLD_EDGES))}
    states, ports = {}, {}
    for i, k in enumerate(jcfgs):
        states[k], ports[k] = port_state(jcfgs[k], seed=i)

    cases = {}
    for name, (s, plan, method, c) in PRIMITIVES.items():
        cases[f"prim_{name}"] = dict(
            mesh_in, kind="primitives", S=s, plan=plan, method=method,
            level=0, conv=True, x=x128[:, :c], g=g128[:, :c])
    for name, (s, plan) in SMALL_PLANS.items():
        cases[f"small_{name}"] = dict(
            mesh_in, kind="forward", S=s, plan=plan, model=SMALL,
            node_in=node_in, mask=mask, **ports["small"])
    cases["wide_fused"] = dict(mesh_in, kind="forward", S=4, plan=FUSED_PLAN,
                               model=WIDE, node_in=node_in, mask=mask,
                               **ports["wide"])
    cases["wide_fused4"] = dict(cases["wide_fused"],
                                model=dict(WIDE, aggregation="fused4"))
    cases["wide_repl25"] = dict(cases["wide_fused"], S=2,
                                plan=dict(FUSED_PLAN, replicate_floor=25))
    cases["world_fused"] = dict(mesh_in, kind="forward", S=4,
                                plan=FUSED_PLAN, model=WORLD_EDGES,
                                node_in=world_in, mask=mask,
                                **ports["world"])
    group = Group(cases, WORLD)

    # The JAX references, while the ranks run.
    jl = jax_levels(jax_flat_edge(cells, "tri"), DEPTH, n, pos)
    hj = pad_levels(jl, pad_multiple=N_PAD, pos=pos)

    def one_device(k, ni):
        cfg = dataclasses.replace(jcfgs[k], aggregation="ell")
        st = states[k]
        return np.asarray(jax.jit(lambda a, m: simulator_forward(
            st.params, st.norm_in, st.norm_out, hj, a, m, cfg))(
                jnp.asarray(ni), jnp.asarray(mask)))

    def jax_halo(k, ni):
        plan = jax_partition(jl, 4, N_PAD, pos, **FUSED_PLAN)
        tr = JaxTrainer(JaxConfig(model=jcfgs[k]))
        fwd = make_halo_forward(tr, make_mesh(1, 4), plan)
        return np.asarray(fwd(states[k], jnp.asarray(partition_nodes(plan, ni)),
                              jnp.asarray(partition_nodes(plan, mask))))

    refs = {"small": one_device("small", node_in),
            "wide": one_device("wide", node_in),
            "halo_wide": jax_halo("wide", node_in),
            "halo_world": jax_halo("world", world_in)}
    tl = build_bistride_levels(to_flat_edge(cells, "tri"), DEPTH, n, pos)
    return dict(n=n, cases=cases, refs=refs, hj=hj, tl=tl, pos=pos,
                x=x128, g=g128, results=group.results())


def gathered(case, name, key="pred"):
    """Case `name`'s output as global rows [..., N_PAD, C]."""
    c = case["cases"][name]
    plan = build_partition(case["tl"], c["S"], N_PAD, case["pos"],
                           **c["plan"])
    return unpartition_nodes(plan, gather_shards(case["results"], name, key,
                                                 c["S"]))


def global_sums(case, c):
    """The global references on level 0: down / up as `test_halo.py`
    takes them, the down sum's gradient (its adjoint on g), and the
    conv pair with the level's own weights."""
    lvl = case["hj"].levels[0]
    snd, rcv = np.asarray(lvl.senders), np.asarray(lvl.receivers)
    em, ew = np.asarray(lvl.edge_mask), np.asarray(lvl.ew, np.float64)
    x, g = case["x"][:, :c].astype(np.float64), case["g"][:, :c]
    out = {k: np.zeros_like(x) for k in ("down", "up", "down_grad",
                                         "conv_down", "conv_up",
                                         "conv_down_grad")}
    np.add.at(out["down"], rcv, x[snd] * em[:, None])
    np.add.at(out["up"], snd, x[snd] * em[:, None])
    np.add.at(out["down_grad"], snd, g[rcv] * em[:, None])
    np.add.at(out["conv_down"], rcv, x[snd] * ew[:, None])
    np.add.at(out["conv_up"], snd, x[rcv] * ew[:, None])
    np.add.at(out["conv_down_grad"], snd, g[rcv] * ew[:, None])
    return out


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitives_and_convs_match_global(case, name):
    n = case["n"]
    want = global_sums(case, PRIMITIVES[name][3])
    for key, ref in want.items():
        got = gathered(case, f"prim_{name}", key)
        np.testing.assert_allclose(got[:n], ref[:n], rtol=SUM_TOL,
                                   atol=SUM_TOL, err_msg=key)
    calls = case["results"][0][f"prim_{name}"]["plain_calls"]
    if PRIMITIVES[name][2].endswith("fused"):
        # The kernel local method's sums run kernel 8 (its plain version
        # on the CPU); a windowed layout's convs kernel 1's level form.
        assert calls["segment_sum"] > 0
        assert (calls["windowed_conv"] > 0) == ("w128" in name)
    else:
        assert not any(calls.values())


@pytest.mark.parametrize("plan", sorted(SMALL_PLANS))
def test_generic_halo_forward_matches_one_device(case, plan):
    n = case["n"]
    got = gathered(case, f"small_{plan}")
    np.testing.assert_allclose(got[:n], case["refs"]["small"][:n],
                               **ONE_DEVICE_TOL)
    assert not any(case["results"][0][f"small_{plan}"]["plain_calls"]
                   .values())


def test_ghost_fused_forward_matches_jax_halo(case):
    n = case["n"]
    got = gathered(case, "wide_fused")
    c = case["cases"]["wide_fused"]
    plan = build_partition(case["tl"], 4, N_PAD, case["pos"], **c["plan"])
    want = unpartition_nodes(plan, case["refs"]["halo_wide"])
    np.testing.assert_allclose(got[:n], want[:n], rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got[:n], case["refs"]["wide"][:n],
                               **ONE_DEVICE_TOL)
    calls = case["results"][0]["wide_fused"]["plain_calls"]
    # Kernels 4, 3, 1 (level form) per level on the ghost tables.
    for k in ("fused_edge_phase_win", "fused_node_phase", "windowed_conv"):
        assert calls[k] > 0, k


def test_fused4_takes_the_fused_ghost_route(case):
    """`"fused4"` on a ghost plan runs the `fused` ghost route (JAX's
    `_halo_method` would send it off the kernels): JAX's `"fused"` halo
    forward, and kernel 14 never called."""
    n = case["n"]
    got = gathered(case, "wide_fused4")
    np.testing.assert_allclose(got[:n], gathered(case, "wide_fused")[:n],
                               rtol=0, atol=0)
    calls = case["results"][0]["wide_fused4"]["plain_calls"]
    assert calls["fused_edge_phase_win"] > 0
    assert calls["fused_edge_phase_win_k"] == 0


def test_ghost_fused_world_edges_forward_matches_jax_halo(case):
    n = case["n"]
    got = gathered(case, "world_fused")
    plan = build_partition(case["tl"], 4, N_PAD, case["pos"], **FUSED_PLAN)
    want = unpartition_nodes(plan, case["refs"]["halo_world"])
    np.testing.assert_allclose(got[:n], want[:n], rtol=F32_TOL, atol=F32_TOL)
    calls = case["results"][0]["world_fused"]["plain_calls"]
    assert calls["fused_edge_phase_win_dyn"] > 0
    assert calls["fused_edge_phase_win"] == 0


def test_replicated_fused_forward_matches_one_device(case):
    """Replication composed with the windowed ghost `fused` path (the
    production multi-card layout)."""
    n = case["n"]
    np.testing.assert_allclose(gathered(case, "wide_repl25")[:n],
                               case["refs"]["wide"][:n], **ONE_DEVICE_TOL)


def test_halo_method_strings():
    assert halo_parts("halo:graph") == ("graph", "ell")
    assert halo_parts("halo:graph:fused3") == ("graph", "fused")
    assert halo_parts("fused") is None
    for bad in ("halo:", "halo:graph:foo", "halo:a:b:c"):
        with pytest.raises(NotImplementedError):
            halo_parts(bad)
    assert halo_method(ModelConfig(aggregation="fused4"), "g") == (
        "halo:g:fused")


def test_cal_ew_refuses_ghost_layouts(case):
    plan = build_partition(case["tl"], 2, N_PAD, case["pos"], block=32,
                           local_layouts=True)
    lvl = to_device(shard_hierarchy(plan, 0), "cpu").levels[0]
    w = torch.ones(lvl.n_pad_nodes, 1)
    with pytest.raises(NotImplementedError, match="ghost halo layout"):
        cal_ew(lvl, w, "halo:graph:fused")
