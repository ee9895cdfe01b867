"""The port's data-parallel step (`parallel/data_parallel.py`) on gloo
groups of CPU ranks.

On `test_parallel.py`'s 9×9 grid at depth 2 (latent 16, hidden 1, `ell`),
a batch of B = 4 frames, a warmup gate and two updates with noise:
- two ranks of two frames each against JAX's `make_spmd_train_step` on a
  (2, 1) mesh fed the same global draw: every step's loss, the normalizers
  after the gate, and each parameter's update;
- the same batch on a bucketed hierarchy, which the simulator runs as the
  union of each rank's samples (`graph.hierarchy.union`), against the
  port's one-process `Trainer` on the union of all four: the losses, each
  update's summed gradients and each parameter's update;
- each rank takes its slice by `shard_batch`, and only the first loads
  the weights (the other shifts its normalizers): `replicate_state` gives
  every rank the first one's state;
- one rank (world size 1) against the one-process `Trainer`, bit for bit:
  the group step starts the backward at ∂L/∂n as the one-process loss's
  backward computes it, and a group of one sums nothing;
- every rank ends with the same parameters, bit for bit.

Tolerances: the losses within F32_TOL (relative); each parameter's update
within 1e-2 of the reference update's RMS in RMS (`test_torch_port_train.
py`: Adam moves weights with near-zero gradients by a share of the rate
more or less); the normalizers 1e-5; against the port's own trainer the
losses at `test_halo.py`'s rtol 2e-3, atol 2e-4, the gradients within
GRAD_RMS_TOL of each tensor's RMS in RMS (f32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from conftest import make_grid_mesh
from test_torch_port_weights import jax_to_nested
from torch_parallel_group import (
    Group,
    grad_errors,
    step_grads,
    update_errors,
)

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import DatasetConfig as JaxDatasetConfig
from bsms_gnn_tpu.config import ModelConfig as JaxModelConfig
from bsms_gnn_tpu.config import OptConfig as JaxOptConfig
from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.parallel import (
    make_mesh,
    make_spmd_train_step,
    replicate_state,
    shard_batch,
    shard_hierarchy,
)
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import (
    Config,
    DatasetConfig,
    ModelConfig,
    OptConfig,
)
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.training.trainer import Trainer

OUT, DEPTH, N_PAD, B, STEPS = 3, 2, 128, 4, 3
F32_TOL = 5e-4
UPDATE_RMS_TOL = 1e-2
GRAD_RMS_TOL = 1e-5
ONE_DEVICE_TOL = dict(rtol=2e-3, atol=2e-4)
MODEL = dict(unet_depth=DEPTH, latent_dim=16, hidden_layer=1, out_dim=OUT,
             accumulation_steps=1, aggregation="ell")
OPT = dict(warmup_steps=2, decay_steps=20)
NOISE = dict(noise_level=[0.05] * OUT, noise_gamma=0.1)
BUCKETED = dict(pad_multiple=N_PAD, node_buckets=[N_PAD] * (DEPTH + 1))


@pytest.fixture(scope="module")
def case():
    pos, cells = make_grid_mesh(9, 9)
    n = len(pos)
    rng = np.random.default_rng(11)
    node_in = np.zeros((B, N_PAD, OUT + 3), np.float32)
    node_in[:, :n, :OUT] = rng.standard_normal((B, n, OUT))
    node_in[:, :n, OUT:OUT + 2] = pos
    node_tar = np.zeros((B, N_PAD, OUT), np.float32)
    node_tar[:, :n] = (node_in[:, :n, :OUT]
                       + 0.05 * rng.standard_normal((B, n, OUT)))
    mask = np.zeros((B, N_PAD, 1), np.float32)
    mask[:, :n] = 1.0
    keys = [jax.random.fold_in(jax.random.PRNGKey(5), i) for i in range(STEPS)]
    # JAX's noise draw of each step (`Trainer._inject_noise`).
    noise = np.stack([np.asarray(jax.random.normal(k, node_tar.shape,
                                                   jnp.float32))
                      for k in keys])

    jcfg = JaxConfig(datasets=JaxDatasetConfig(**NOISE),
                     model=JaxModelConfig(**MODEL), opt=JaxOptConfig(**OPT))
    jtr = JaxTrainer(jcfg, init_key=jax.random.PRNGKey(0))
    init = params_from_numpy(jax_to_nested(jtr.state.sim.params))
    batch = dict(pos=pos, cells=cells, depth=DEPTH, node_in=node_in,
                 node_tar=node_tar, mask=mask, kind="dp_train", model=MODEL,
                 opt=OPT, datasets=NOISE, params=init, steps=STEPS,
                 noise=noise, layout=dict(pad_multiple=N_PAD))
    two = Group({"shared": dict(batch, data=2),
                 "union": dict(batch, data=2, layout=BUCKETED)}, 2)
    one = Group({"shared": dict(batch, data=1)}, 1)

    # JAX's GSPMD step on a (2, 1) mesh, while the ranks run.
    h = jax_build(jax_flat_edge(cells, "tri"), DEPTH, n, pos,
                  pad_multiple=N_PAD)
    mesh = make_mesh(2, 1)
    step = make_spmd_train_step(jtr, mesh, h)
    state = replicate_state(mesh, jtr.state)
    h_dev = shard_hierarchy(h, mesh)
    ins = shard_batch(mesh, *(jnp.asarray(a)
                              for a in (node_in, node_tar, mask)))
    losses = []
    for k in keys:
        state, loss = step(state, h_dev, *ins, k)
        losses.append(float(loss))
    jax_ref = dict(losses=losses, params={
        k: v.numpy() for k, v in
        params_from_numpy(jax_to_nested(state.sim.params)).items()},
        norm_in=state.sim.norm_in, norm_out=state.sim.norm_out)

    # The port's one-process trainers on the whole batch.
    port_ref = {}
    for name, layout in (("shared", dict(pad_multiple=N_PAD)),
                         ("union", BUCKETED)):
        tr = Trainer(Config(datasets=DatasetConfig(**NOISE),
                            model=ModelConfig(**MODEL), opt=OptConfig(**OPT)),
                     device="cpu")
        tr.sim.load_state_dict(init)
        hd = to_device(build_hierarchy(to_flat_edge(cells, "tri"), DEPTH, n,
                                       pos, **layout), "cpu")
        t_in = [torch.from_numpy(a) for a in (node_in, node_tar, mask)]
        losses, grads = [], []
        for i in range(STEPS):
            losses.append(float(tr.iter(hd, *t_in,
                                        torch.from_numpy(noise[i]))))
            grads.append(step_grads(tr))
        port_ref[name] = dict(losses=losses, grads=grads, params={
            k: v.numpy().copy() for k, v in tr.sim.state_dict().items()})
    return dict(init=init, jax=jax_ref, port=port_ref, two=two.results(),
                one=one.results())


def check_replicas(results, name):
    for r in range(1, len(results)):
        for k, v in results[0][name]["params"].items():
            assert np.array_equal(v, results[r][name]["params"][k]), (r, k)


def test_two_ranks_match_jax_spmd_step(case):
    got, want = case["two"][0]["shared"], case["jax"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=F32_TOL)
    assert got["updates"] == STEPS - 1
    check_replicas(case["two"], "shared")
    for norm in ("norm_in", "norm_out"):
        for f in ("acc_weight", "e_x", "e_x2"):
            np.testing.assert_allclose(
                got[norm][f], np.asarray(getattr(want[norm], f)), rtol=1e-5,
                atol=1e-7, err_msg=f"{norm}.{f}")
    for k, p0 in case["init"].items():
        upd = got["params"][k] - p0.numpy()
        upd_j = want["params"][k] - p0.numpy()
        rms = np.sqrt(np.mean(upd_j.astype(np.float64) ** 2))
        err = np.sqrt(np.mean((upd - upd_j).astype(np.float64) ** 2))
        assert rms > 0 and err <= UPDATE_RMS_TOL * rms, (k, err, rms)


def test_two_ranks_on_unions_match_one_process(case):
    """The losses, each update's summed and clipped gradients (both taken
    at the initial weights: the first update's rate is schedule(0) = 0)
    and each parameter's update against the one-process step."""
    got, want = case["two"][0]["union"], case["port"]["union"]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               **ONE_DEVICE_TOL)
    assert got["grads"][0] is None and want["grads"][0] is None
    for i in range(1, STEPS):
        errs = grad_errors(got["grads"][i], want["grads"][i])
        worst = max(errs, key=errs.get)
        assert errs[worst] <= GRAD_RMS_TOL, (i, worst, errs[worst])
    errs = update_errors(got["params"], want["params"], case["init"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= UPDATE_RMS_TOL, (worst, errs[worst])
    check_replicas(case["two"], "union")


def test_one_rank_is_the_one_process_step_bit_for_bit(case):
    got, want = case["one"][0]["shared"], case["port"]["shared"]
    np.testing.assert_array_equal(got["losses"], want["losses"])
    for k, w in want["params"].items():
        np.testing.assert_array_equal(got["params"][k], w, err_msg=k)
