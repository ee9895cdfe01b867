"""The halo path's batch axis (`parallel/halo.py` on [B, N_loc, C] shards,
`partition_nodes` of a [B, N_pad, C] batch) on a gloo group of two CPU
ranks, against the JAX package's halo entry points on shard-major [S, B,
N_loc, C] arrays, which take the batch (`halo.py:452-457`, `:588-593`),
and against its one-device model.

On `test_halo.py`'s 9×9 grid at depth 2, B = 2 frames, S = 2, the
generic `ell` path on the ghost plan (latent 16), on a plan whose coarse
levels are replicated (the boundary pool's group sum), and the ghost `fused`
path (latent 128, window 128: kernels 4, 3, 2 and 1's level form batched,
their plain versions here):
- the forward (weights and normalizers holding statistics) against
  JAX's `make_halo_forward` on the same plan frame by frame, and against
  JAX's one-device forward on the batch;
- the train step (a warmup gate and two updates, noise level 0): the
  gate's loss and the normalizers after it against JAX's
  `make_halo_train_step` on the same plan (its `ell` step: the gate does
  not depend on the model), every loss against JAX's and
  the port's one-device batched steps, each update's summed, clipped
  gradients against the port's one-device step, and on `ell` each
  parameter's update against JAX's one-device `Trainer` (Queue 3: JAX's
  halo gradients are S times the one-device ones);
- every rank ends with the same parameters, bit for bit;
- the fault the port does not copy, held as its record: JAX's halo
  forward on a batch leaves its own frame-by-frame halo forward and its
  one-device forward (by ~6e-2 to 9e-2 here), and its halo step's losses
  after the gate leave its one-device step's. Its exchange
  (`bsms_gnn_tpu/parallel/halo.py::_halo_rows`, `_halo_return`) calls
  `all_to_all` with split and concat axis 0, which is the batch axis of
  [B, S, H, C] rows: at B = S it ships frame b to shard b, at a B that S
  does not divide it raises. The initial normalizers scale the model's
  output by ~1e-8, which hides the fault in a forward at them.

Tolerances are `test_torch_port_halo_train.py`'s (the losses and the
forwards against JAX on the same plan F32_TOL, against the one-device
model `test_halo.py`'s rtol 2e-3, atol 2e-4, the updates UPDATE_RMS_TOL
of each update's RMS, the normalizers 1e-5) and
`test_torch_port_data_parallel.py`'s GRAD_RMS_TOL for the gradients."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from conftest import make_grid_mesh
from test_torch_port_weights import (
    jax_state_with_stats,
    jax_to_nested,
    normalizer_to_dict,
)
from torch_parallel_group import Group, grad_errors, step_grads, update_errors

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
    make_halo_forward,
    make_halo_train_step,
    make_mesh,
    partition_nodes,
)
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import (
    Config,
    DatasetConfig,
    ModelConfig,
    OptConfig,
)
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.parallel.partition import (
    build_partition,
    unpartition_nodes,
)
from bsms_gnn_tpu_torch.training.trainer import Trainer

OUT, DEPTH, N_PAD, B, S, STEPS = 3, 2, 128, 2, 2, 3
F32_TOL = 5e-4
ONE_DEVICE_TOL = dict(rtol=2e-3, atol=2e-4)
# What JAX's batched halo path misses its one-device model by, at least.
JAX_BATCH_FAULT = 1e-2
UPDATE_RMS_TOL = 1e-2
GRAD_RMS_TOL = 1e-5
SMALL = dict(unet_depth=DEPTH, latent_dim=16, hidden_layer=1, out_dim=OUT,
             accumulation_steps=1, aggregation="ell")
WIDE = dict(SMALL, latent_dim=128, aggregation="fused")
OPT = dict(warmup_steps=2, decay_steps=20)
DATA = dict(noise_level=[0.0] * OUT)
# name → (model, build_partition keywords)
PATHS = {"ell": (SMALL, dict(block=32, local_layouts=True)),
         "repl": (SMALL, dict(block=32, local_layouts=True,
                              replicate_floor=25)),
         "fused": (WIDE, dict(block=64, local_layouts=True, window=128))}


@pytest.fixture(scope="module")
def case():
    pos, cells = make_grid_mesh(9, 9)
    n = len(pos)
    rng = np.random.default_rng(3)
    node_in = np.zeros((B, N_PAD, OUT + 3), np.float32)
    node_in[:, :n, :OUT] = rng.standard_normal((B, n, OUT))
    node_in[:, :n, OUT:OUT + 2] = pos
    node_tar = np.zeros((B, N_PAD, OUT), np.float32)
    node_tar[:, :n] = (node_in[:, :n, :OUT]
                       + 0.05 * rng.standard_normal((B, n, OUT)))
    mask = np.zeros((B, N_PAD, 1), np.float32)
    mask[:, :n] = 1.0
    frame = dict(pos=pos, cells=cells, depth=DEPTH, n_pad=N_PAD,
                 node_in=node_in, node_tar=node_tar, mask=mask, S=S)

    jtr, init, cases, stats = {}, {}, {}, {}
    for name, (model, plan) in PATHS.items():
        jcfg = JaxConfig(datasets=JaxDatasetConfig(**DATA),
                         model=JaxModelConfig(**model),
                         opt=JaxOptConfig(**OPT))
        jtr[name] = JaxTrainer(jcfg, init_key=jax.random.PRNGKey(0))
        init[name] = params_from_numpy(
            jax_to_nested(jtr[name].state.sim.params))
        stats[name] = jax_state_with_stats(JaxModelConfig(**model), seed=1)
        cases[f"{name}_fwd"] = dict(
            frame, kind="forward", plan=plan, model=model,
            params=params_from_numpy(jax_to_nested(stats[name].params)),
            norm_in=normalizer_to_dict(stats[name].norm_in),
            norm_out=normalizer_to_dict(stats[name].norm_out))
        cases[f"{name}_train"] = dict(frame, kind="train", plan=plan,
                                      model=model, opt=OPT, datasets=DATA,
                                      params=init[name], steps=STEPS)
    group = Group(cases, S)

    # JAX, while the ranks run.
    jl = jax_levels(jax_flat_edge(cells, "tri"), DEPTH, n, pos)
    refs = {}
    for name, (model, plan_kw) in PATHS.items():
        plan = jax_partition(jl, S, N_PAD, pos, **plan_kw)
        ni, nt, nm = (jnp.asarray(partition_nodes(plan, a))
                      for a in (node_in, node_tar, mask))
        fwd = make_halo_forward(jtr[name], make_mesh(1, S), plan)
        # Frame by frame ([S, N_loc, C]), and the batch [S, B, N_loc, C].
        refs[f"{name}_fwd_frames"] = np.stack(
            [np.asarray(fwd(stats[name], ni[:, b], nm[:, b]))
             for b in range(B)], axis=1)
        refs[f"{name}_fwd_halo"] = np.asarray(fwd(stats[name], ni, nm))
        if name == "ell":
            # A batch that is not a multiple of S.
            ni3, nm3 = (jnp.concatenate([a, a[:, :1]], axis=1)
                        for a in (ni, nm))
            try:
                fwd(stats[name], ni3, nm3)
                refs["b3_error"] = None
            except ValueError as e:
                refs["b3_error"] = str(e)
        if name != "ell":
            continue
        step = make_halo_train_step(jtr[name], make_mesh(1, S), plan)
        state, losses = jax.tree_util.tree_map(jnp.copy, jtr[name].state), []
        for i in range(STEPS):
            state, loss = step(state, ni, nt, nm, jax.random.PRNGKey(i))
            losses.append(float(loss))
        refs[f"{name}_train"] = dict(losses=losses, state=state)
    hj = pad_levels(jl, pad_multiple=N_PAD, pos=pos)
    for name, (model, _) in PATHS.items():
        st, cfg = stats[name], JaxModelConfig(**dict(model, aggregation="ell"))
        refs[f"{name}_fwd_one"] = np.asarray(jax.jit(
            lambda a, m: simulator_forward(st.params, st.norm_in, st.norm_out,
                                           hj, a, m, cfg))(
            jnp.asarray(node_in), jnp.asarray(mask)))
    one = jtr["ell"]
    refs["ell_one_device"] = dict(losses=[
        float(one.iter(hj, jnp.asarray(node_in), jnp.asarray(node_tar),
                       jnp.asarray(mask), jax.random.PRNGKey(i)))
        for i in range(STEPS)], params={
            k: v.numpy() for k, v in params_from_numpy(
                jax_to_nested(one.state.sim.params)).items()})

    # The port's one-device batched steps.
    hd = to_device(build_hierarchy(to_flat_edge(cells, "tri"), DEPTH, n, pos,
                                   pad_multiple=N_PAD), "cpu")
    port = {}
    for name, (model, _) in PATHS.items():
        tr = Trainer(Config(datasets=DatasetConfig(**DATA),
                            model=ModelConfig(**model), opt=OptConfig(**OPT)),
                     device="cpu")
        tr.sim.load_state_dict(init[name])
        t_in = [torch.from_numpy(a) for a in (node_in, node_tar, mask)]
        losses, grads = [], []
        for _ in range(STEPS):
            losses.append(float(tr.iter(hd, *t_in)))
            grads.append(step_grads(tr))
        port[name] = dict(losses=losses, grads=grads)
    tl = build_bistride_levels(to_flat_edge(cells, "tri"), DEPTH, n, pos)
    return dict(n=n, refs=refs, port=port, init=init, tl=tl, pos=pos,
                results=group.results())


def gathered(case, name, key="pred"):
    """Case `name`'s output as global rows [B, N_PAD, C]."""
    plan = build_partition(case["tl"], S, N_PAD, case["pos"],
                           **PATHS[name.split("_")[0]][1])
    shards = np.stack([case["results"][r][name][key] for r in range(S)])
    return plan, unpartition_nodes(plan, shards)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_batched_halo_forward_matches_jax(case, path):
    n = case["n"]
    plan, got = gathered(case, f"{path}_fwd")
    assert got.shape == (B, N_PAD, OUT)
    want = unpartition_nodes(plan, case["refs"][f"{path}_fwd_frames"])
    np.testing.assert_allclose(got[:, :n], want[:, :n], rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(got[:, :n],
                               case["refs"][f"{path}_fwd_one"][:, :n],
                               **ONE_DEVICE_TOL)
    calls = case["results"][0][f"{path}_fwd"]["plain_calls"]
    if path == "fused":
        # Kernels 4, 3, 2 and 1's level form on the batched ghost tables.
        for k in ("fused_edge_phase_win", "fused_node_phase",
                  "compact_accum", "windowed_conv"):
            assert calls[k] > 0, k
    else:
        assert not any(calls.values())


@pytest.mark.parametrize("path", sorted(PATHS))
def test_batched_halo_train_step(case, path):
    got = case["results"][0][f"{path}_train"]
    want = case["refs"]["ell_train"]
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               rtol=F32_TOL)
    assert got["updates"] == STEPS - 1
    sim = want["state"].sim
    for f in ("e_x", "e_x2", "acc_weight"):
        for norm in ("norm_in", "norm_out"):
            np.testing.assert_allclose(
                got[norm][f], np.asarray(getattr(getattr(sim, norm), f)),
                rtol=1e-5, atol=1e-7, err_msg=f"{norm}.{f}")
    one = case["port"][path]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=F32_TOL)
    # The one-device models agree at the gate (the zero prediction's loss).
    np.testing.assert_allclose(one["losses"][0], want["losses"][0],
                               rtol=F32_TOL)
    assert got["grads"][0] is None and one["grads"][0] is None
    for i in range(1, STEPS):
        errs = grad_errors(got["grads"][i], one["grads"][i])
        worst = max(errs, key=errs.get)
        assert errs[worst] <= GRAD_RMS_TOL, (i, worst, errs[worst])
    if path == "ell":
        ref = case["refs"]["ell_one_device"]
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=F32_TOL)
        errs = update_errors(got["params"], ref["params"], case["init"][path])
        worst = max(errs, key=errs.get)
        assert errs[worst] <= UPDATE_RMS_TOL, (worst, errs[worst])
    for r in range(1, S):
        for k, v in got["params"].items():
            assert np.array_equal(v, case["results"][r][f"{path}_train"][
                "params"][k]), (r, k)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_jax_batched_halo_path_leaves_its_one_device_model(case, path):
    """The record of JAX's fault: its halo forward on [S, B, ...] misses
    its own halo forward frame by frame and its one-device forward, where
    the port's batched halo forward meets both (the test above). The
    exchange's `all_to_all` splits axis 0 of the [..., S, H, C] rows it
    ships, the batch axis once there is one: at B = 3 it raises, at B = S
    it ships frame b to shard b. Its halo step's losses after the gate
    miss its one-device step's (`ell`)."""
    n = case["n"]
    plan, _ = gathered(case, f"{path}_fwd")
    halo = unpartition_nodes(plan, case["refs"][f"{path}_fwd_halo"])
    for ref in ("frames", "one"):
        want = case["refs"][f"{path}_fwd_{ref}"]
        if ref == "frames":
            want = unpartition_nodes(plan, want)
        assert np.abs(halo[:, :n] - want[:, :n]).max() > JAX_BATCH_FAULT
    if path == "ell":
        assert "split_axis (3)" in case["refs"]["b3_error"]
        jh = np.asarray(case["refs"]["ell_train"]["losses"])
        jo = np.asarray(case["refs"]["ell_one_device"]["losses"])
        assert abs(jh[0] - jo[0]) <= F32_TOL * jo[0]
        assert np.all(np.abs(jh[1:] - jo[1:]) > JAX_BATCH_FAULT * jo[1:])
