"""The port's trainer on the `ell` method (JAX's default aggregation)
against JAX's `Trainer` on `ell`, on the CPU: `Trainer.iter` over a
warmup-gate step and two updates, both fed JAX's own noise draw, at B = 2
frames over one windowed hierarchy (the batch axis) and at B = 3 samples
on the union of their bucketed hierarchies.

Cases: `test_torch_port_batch_train.py`'s (the slice's scrambled 24×24
grid, depth 3, window 128, edge_block 512, latent 128, hidden 2, and
`test_torch_port_batch_grads.py`'s two frames) and
`test_torch_port_stacked_train.py`'s (the stacked batch of three samples
on meshes of 450, 600 and 450 nodes, cylinder_flow cut to depth 2 and
hidden 1, its noise); each trainer draws its own weights, carried from
JAX's.

Tolerances (`test_torch_port_batch_train.py`'s): the gate step's loss
1e-6, the updates' 1e-4; the normalizer states after the gate 1e-5; every
weight within twice the summed rates of the updates, all but one in a
thousand (or one) within a quarter of them, and each tensor's update
within 1e-2 of its RMS in RMS over the others (`assert_updates_close`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_batch_train import mesh  # noqa: F401 (fixture)
from test_torch_port_slice import DEPTH
from test_torch_port_stacked import batch
from test_torch_port_train import jax_param_grads
from test_torch_port_variable_mesh import model
from test_torch_port_weights import jax_to_nested, normalizer_to_dict

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import DatasetConfig as JaxDatasetConfig
from bsms_gnn_tpu.config import OptConfig as JaxOptConfig
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import Config, ModelConfig, OptConfig
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.training.schedule import warmup_cosine_schedule
from bsms_gnn_tpu_torch.training.trainer import Trainer

OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=6)


def run_both(jtr, ttr, hj, ht, node_in, target, mask, steps=3):
    """`steps` iterations of both trainers on the same noise draws (JAX's,
    in the batch's shape); the normalizer states are compared after the
    first (the gate). Returns (JAX losses, port losses)."""
    key = jax.random.PRNGKey(7)
    losses_j, losses_t = [], []
    for i in range(steps):
        k = jax.random.fold_in(key, i)
        z = jax.random.normal(k, target.shape, jnp.float32)
        losses_j.append(float(jtr.iter(hj, *(jnp.asarray(a) for a in
                                             (node_in, target, mask)), k)))
        losses_t.append(float(ttr.iter(
            ht, *(torch.from_numpy(a) for a in (node_in, target, mask)),
            torch.tensor(np.asarray(z)))))
        if i == 0:
            for name in ("norm_in", "norm_out"):
                want = normalizer_to_dict(getattr(jtr.state.sim, name))
                got = getattr(ttr.sim, name)
                for f in ("acc_weight", "num_accumulations", "e_x", "e_x2"):
                    np.testing.assert_allclose(
                        getattr(got, f).numpy(), want[f], rtol=1e-5,
                        atol=1e-7, err_msg=f"{name}.{f}")
    assert ttr.step == jtr.step == steps and ttr.updates == steps - 1
    np.testing.assert_allclose(losses_t[:1], losses_j[:1], rtol=1e-6)
    np.testing.assert_allclose(losses_t[1:], losses_j[1:], rtol=1e-4)
    return losses_j, losses_t


def assert_updates_close(jtr, ttr, init, opt_kw, updates):
    """Each tensor's update (after − before) against JAX's, as
    `test_torch_port_train.py::test_trainer_matches_jax_trainer` holds
    them: every weight within twice the summed rates; at most one in a
    thousand (or one, in a tensor of fewer than a thousand weights, as the
    union's encoder's 384) beyond a quarter of them: a gradient near zero
    moves its weight by about ± the rate in Adam's first steps whatever
    its scale, so a difference far below the gradient's RMS can flip it.
    Measured on the union: weight [0, 34] of the encoder, whose gradient
    at the first noised step is 1.1e-7 under JAX's `ell` and `segment`
    and 3.17e-6 under JAX's `fused` and every method of the port (4.7e-3
    of the tensor's RMS apart), lands 8.7e-4 apart at a rate of 1e-3
    (ROADMAP Queue 3). The update's RMS error over the other weights
    within 1e-2 of its RMS. The first update runs at rate 0."""
    want = jax_param_grads(jtr.state.sim.params)
    sched = warmup_cosine_schedule(**opt_kw)
    rates = sum(sched(k) for k in range(updates))
    for k, p in ttr.sim.state_dict().items():
        w, p0 = want[k].numpy(), init[k].numpy()
        diff = np.abs(p.numpy() - w)
        assert diff.max() <= 2 * rates, k
        flips = diff > 0.25 * rates
        assert flips.sum() <= max(1, 1e-3 * diff.size), k
        keep = ~flips
        upd, upd_j = (p.numpy() - p0)[keep], (w - p0)[keep]
        rms = np.sqrt(np.mean(upd_j.astype(np.float64) ** 2))
        if rms == 0:  # a tensor with no gradient (an edgeless level's)
            assert not upd.any(), k
            continue
        err = np.sqrt(np.mean((upd - upd_j).astype(np.float64) ** 2))
        assert err <= 1e-2 * rms, f"{k}: update rms err {err:.3e} of {rms:.3e}"


def test_batched_trainer_on_ell_matches_jax_trainer(mesh):  # noqa: F811
    """B = 2 frames over one windowed hierarchy: the gate, then two
    updates, both trainers on `ell`."""
    hj, ht, jcfg, (node_in, target, mask) = mesh
    jtr = JaxTrainer(JaxConfig(model=dataclasses.replace(
        jcfg, accumulation_steps=1, aggregation="ell"),
        opt=JaxOptConfig(**OPT)), init_key=jax.random.PRNGKey(3))
    tcfg = ModelConfig(latent_dim=128, hidden_layer=jcfg.hidden_layer,
                       unet_depth=DEPTH, accumulation_steps=1)
    assert tcfg.aggregation == "ell"  # the default, as JAX's
    ttr = Trainer(Config(model=tcfg), OptConfig(**OPT), device="cpu")
    init = params_from_numpy(jax_to_nested(jtr.state.sim.params))
    ttr.sim.load_state_dict(init)
    _, losses = run_both(jtr, ttr, hj, ht, node_in, target, mask)
    assert len(set(losses)) == 3
    assert_updates_close(jtr, ttr, init, OPT, 2)


def test_union_trainer_on_ell_matches_jax_trainer():
    """B = 3 samples on the union of their bucketed hierarchies against
    JAX's trainer on the stacked hierarchies (vmapped), both on `ell`,
    with cylinder_flow's noise."""
    jcfg, tcfg, _, _ = model()
    hstack, _, hd, _, node_in, target, mask, _ = batch()
    opt_kw = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=4)
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, accumulation_steps=1, aggregation="ell"))
    jtr = JaxTrainer(JaxConfig(
        model=dataclasses.replace(jcfg, accumulation_steps=1,
                                  aggregation="ell"),
        datasets=JaxDatasetConfig(
            noise_level=list(tcfg.datasets.noise_level),
            noise_gamma=tcfg.datasets.noise_gamma),
        opt=JaxOptConfig(**opt_kw)), init_key=jax.random.PRNGKey(3))
    ttr = Trainer(tcfg, OptConfig(**opt_kw), device="cpu")
    init = params_from_numpy(jax_to_nested(jtr.state.sim.params))
    ttr.sim.load_state_dict(init)
    run_both(jtr, ttr, hstack, hd, node_in, target, mask)
    assert_updates_close(jtr, ttr, init, opt_kw, 2)
