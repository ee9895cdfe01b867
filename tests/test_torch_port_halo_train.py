"""The port's sharded train step (`parallel/halo.py`: `halo_train_step`
via `HaloTrainer`) on a gloo group of four CPU ranks against the JAX
package.

On `test_halo.py`'s 9×9 grid at depth 2 (latent 16, `ell`), a warmup gate
step and two updates at S = 2 (ghost layout) and S = 4 (ghost and plain
levels mixed by `ghost_floor`), noise level 0: every step's loss and the
normalizers after the gate against JAX's `make_halo_train_step` on the
same plan, the parameters against JAX's one-device `Trainer`; every rank
ends with the same parameters, bit for bit. JAX's halo step differentiates
its loss through a `psum` under `shard_map(check_vma=False)`, so its
gradients are S times the one-device ones (held here as the record of that
fault); Adam hides most of it, so its parameters land near, not on, the
one-device step's.

Tolerances: the losses within F32_TOL (relative, both sides in f32 summed
in other orders); each parameter's update (after − before) within 1e-2 of
the reference update's RMS in RMS (Adam moves a weight by about the rate
whatever its gradient's scale, so near-zero gradients that differ in their
last f32 bits move weights by a share of the rate more or less;
`test_torch_port_train.py`); the normalizers 1e-5 (`test_halo.py`'s)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

import torch_threads  # noqa: F401 (the worker's share of the cores)

from conftest import make_grid_mesh
from test_torch_port_weights import jax_to_nested
from torch_parallel_group import Group, update_errors

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import DatasetConfig as JaxDatasetConfig
from bsms_gnn_tpu.config import ModelConfig as JaxModelConfig
from bsms_gnn_tpu.config import OptConfig as JaxOptConfig
from bsms_gnn_tpu.graph.bistride import build_bistride_levels as jax_levels
from bsms_gnn_tpu.graph.hierarchy import pad_levels
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.models.simulator import simulator_forward
from bsms_gnn_tpu.parallel import (
    build_partition as jax_partition,
    make_halo_train_step,
    make_mesh,
    partition_nodes,
)
from bsms_gnn_tpu.parallel.halo import masked_rmse_psum
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.convert import params_from_numpy

OUT, DEPTH, N_PAD, WORLD, STEPS = 3, 2, 128, 4, 3
F32_TOL = 5e-4
UPDATE_RMS_TOL = 1e-2
SMALL = dict(unet_depth=DEPTH, latent_dim=16, hidden_layer=1, out_dim=OUT,
             accumulation_steps=1, aggregation="ell")
OPT = dict(warmup_steps=2, decay_steps=20)
# name → (S, build_partition keywords): the JAX-compared train steps.
JAX_PLANS = {
    "ghost_s2": (2, dict(block=32, local_layouts=True)),
    "mixed_s4": (4, dict(block=32, local_layouts=True, ghost_floor=45)),
}


@pytest.fixture(scope="module")
def case():
    pos, cells = make_grid_mesh(9, 9)
    n = len(pos)
    rng = np.random.default_rng(3)
    node_in = np.zeros((N_PAD, OUT + 3), np.float32)
    node_in[:n, :OUT] = rng.standard_normal((n, OUT))
    node_in[:n, OUT:OUT + 2] = pos
    node_tar = np.zeros((N_PAD, OUT), np.float32)
    node_tar[:n] = node_in[:n, :OUT] + 0.05 * rng.standard_normal((n, OUT))
    mask = np.zeros((N_PAD, 1), np.float32)
    mask[:n] = 1.0
    frame = dict(pos=pos, cells=cells, depth=DEPTH, n_pad=N_PAD,
                 node_in=node_in, node_tar=node_tar, mask=mask)

    jcfg = JaxConfig(datasets=JaxDatasetConfig(noise_level=[0.0] * OUT),
                     model=JaxModelConfig(**SMALL), opt=JaxOptConfig(**OPT))
    tr = JaxTrainer(jcfg, init_key=jax.random.PRNGKey(0))
    state0 = tr.state
    init = params_from_numpy(jax_to_nested(state0.sim.params))
    cases = {}
    for k, (s, plan) in JAX_PLANS.items():
        cases[k] = dict(frame, kind="train", S=s, plan=plan, model=SMALL,
                        opt=OPT, params=init, steps=STEPS,
                        datasets=dict(noise_level=[0.0] * OUT))
    group_train = Group(cases, WORLD)

    # JAX, while the ranks run.
    jl = jax_levels(jax_flat_edge(cells, "tri"), DEPTH, n, pos)
    refs = {}
    for k, (s, plan_kw) in JAX_PLANS.items():
        plan = jax_partition(jl, s, N_PAD, pos, **plan_kw)
        step = make_halo_train_step(tr, make_mesh(1, s), plan)
        ni, nt, nm = (jnp.asarray(partition_nodes(plan, a))
                      for a in (node_in, node_tar, mask))
        # The step donates its state: each run starts from a copy.
        state, losses = jax.tree_util.tree_map(jnp.copy, state0), []
        for i in range(STEPS):
            state, loss = step(state, ni, nt, nm, jax.random.PRNGKey(i))
            losses.append(float(loss))
        refs[k] = dict(losses=losses, state=state)
    hj = pad_levels(jl, pad_multiple=N_PAD, pos=pos)
    refs["one_device"] = dict(losses=[
        float(tr.iter(hj, jnp.asarray(node_in), jnp.asarray(node_tar),
                      jnp.asarray(mask), jax.random.PRNGKey(i)))
        for i in range(STEPS)], state=tr.state)
    # JAX's halo gradients against its one-device gradients at S = 2, at
    # the one-device run's end state.
    refs["grad_ratio"] = jax_halo_grad_ratio(tr.state.sim, jcfg, jl, hj, pos,
                                             node_in, node_tar, mask, 2)
    return dict(n=n, cases=cases, refs=refs, init=init,
                results=group_train.results())


def jax_halo_grad_ratio(sim, cfg, jl, hj, pos, node_in, node_tar, mask, s):
    """‖∇‖ of JAX's halo loss as `make_halo_train_step` differentiates it
    (`masked_rmse_psum` inside `shard_map`, then the `psum` of the
    gradients, `halo.py:528-533`) over ‖∇‖ of the one-device loss, per
    parameter tensor, at the simulator state `sim`."""

    def one_loss(p):
        pred = simulator_forward(p, sim.norm_in, sim.norm_out, hj,
                                 jnp.asarray(node_in), jnp.asarray(mask),
                                 cfg.model)
        se = (pred - node_tar) ** 2
        return jnp.sqrt(jnp.sum(se * mask) / jnp.sum(mask) / OUT)

    plan = jax_partition(jl, s, N_PAD, pos, **JAX_PLANS["ghost_s2"][1])
    mcfg = dataclasses.replace(cfg.model, aggregation="halo:graph")

    def inner(params, hier_s, ni, nt, nm):
        hh = jax.tree_util.tree_map(lambda a: a[0], hier_s)

        def loss_fn(p):
            pred = simulator_forward(p, sim.norm_in, sim.norm_out, hh,
                                     ni[0], nm[0], mcfg)
            return masked_rmse_psum(pred, nt[0], nm[0], "graph")

        return jax.lax.psum(jax.grad(loss_fn)(params), "graph")

    spec = jax.tree_util.tree_map(lambda _: P("graph"), plan.hierarchy)
    halo_grads = jax.jit(jax.shard_map(
        inner, mesh=make_mesh(1, s),
        in_specs=(P(), spec, P("graph"), P("graph"), P("graph")),
        out_specs=P(), check_vma=False))(
            sim.params, plan.hierarchy,
            *(jnp.asarray(partition_nodes(plan, a))
              for a in (node_in, node_tar, mask)))
    one_grads = jax.jit(jax.grad(one_loss))(sim.params)
    return [float(jnp.linalg.norm(a) / jnp.linalg.norm(b)) for a, b in zip(
        jax.tree_util.tree_leaves(halo_grads),
        jax.tree_util.tree_leaves(one_grads))
        if float(jnp.linalg.norm(b)) > 0]


def check_replicas(case, name):
    """Every rank of the group holds the same parameters, bit for bit."""
    s = case["cases"][name]["S"]
    res = case["results"]
    for r in range(1, s):
        for k, v in res[0][name]["params"].items():
            assert np.array_equal(v, res[r][name]["params"][k]), (r, k)


def jax_params(state):
    return {k: v.numpy() for k, v in
            params_from_numpy(jax_to_nested(state.sim.params)).items()}


@pytest.mark.parametrize("name", sorted(JAX_PLANS))
def test_halo_train_step_matches_jax(case, name):
    """The gate and two updates: the losses and normalizers against JAX's
    halo step on the same plan, the parameters against JAX's one-device
    `Trainer` (JAX's halo step sums S copies of each gradient, see
    `test_jax_halo_gradients_are_s_times_the_one_device_ones`)."""
    got, want = case["results"][0][name], case["refs"][name]
    one = case["refs"]["one_device"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=F32_TOL)
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=F32_TOL)
    assert got["updates"] == STEPS - 1
    check_replicas(case, name)
    sim = want["state"].sim
    for f in ("e_x", "e_x2", "acc_weight"):
        for norm in ("norm_in", "norm_out"):
            np.testing.assert_allclose(
                got[norm][f], np.asarray(getattr(getattr(sim, norm), f)),
                rtol=1e-5, atol=1e-7, err_msg=f"{norm}.{f}")
    errs = update_errors(got["params"], jax_params(one["state"]),
                         case["init"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= UPDATE_RMS_TOL, (worst, errs[worst])
    # JAX's own halo step, for the record: its updates miss its
    # one-device step's by more (printed with -s).
    halo = update_errors(jax_params(want["state"]), jax_params(one["state"]),
                         case["init"])
    print(f"{name}: the port's halo updates against JAX's one-device step: "
          f"worst {errs[worst]:.2e} of RMS ({worst}); JAX's halo step's: "
          f"worst {max(halo.values()):.2e}")


def test_jax_halo_gradients_are_s_times_the_one_device_ones(case):
    """The fault the port does not copy: JAX's halo loss is one RMS over
    `psum`med sums, and under `shard_map(check_vma=False)` the transpose
    of that `psum` sums the S shards' equal cotangents, so the gradient
    `psum` counts each shard's gradient S times: every tensor's gradient
    is 2× the one-device gradient at S = 2. The port's group step starts
    each rank's backward at ∂L/∂n_s (`Trainer.iter` with a `reduce`)."""
    ratios = case["refs"]["grad_ratio"]
    np.testing.assert_allclose(ratios, 2.0, rtol=1e-5)
