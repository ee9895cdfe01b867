"""Training on a variable-mesh batch in the port: the masked RMSE of the
three samples of `test_torch_port_stacked.py`'s batch on the union of
their hierarchies and every parameter's gradient, then `Trainer` at B = 3
(a normalizer-warmup gate step, then two updates), against the JAX
package's stacked, vmapped path (`jax.value_and_grad` of the JAX
trainer's loss; the JAX `Trainer` fed the same noise). The batch and model
are `test_torch_port_stacked.py`'s; the JAX kernels run in interpret mode.

Tolerances (`test_torch_port_variable_mesh_grads.py`'s and `_train.py`'s):
each gradient within 1e-3 of its RMS, the loss 1e-5; the trainer's losses
1e-6 through the gate and 1e-4 after the updates, the normalizer states
1e-5, each tensor's update within 1e-2 of its RMS.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_stacked import batch
from test_torch_port_train import jax_param_grads
from test_torch_port_variable_mesh import model
from test_torch_port_weights import jax_to_nested, normalizer_to_dict

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import DatasetConfig as JaxDatasetConfig
from bsms_gnn_tpu.config import OptConfig as JaxOptConfig
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import OptConfig
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.ops.kernels import segment_sum_accum as ssa
from bsms_gnn_tpu_torch.training.trainer import Trainer, masked_rmse

GRAD_TOL = 1e-3


def assert_grads_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w, gk = w.numpy(), got[k].numpy()
        rms = np.sqrt(np.mean(w.astype(np.float64) ** 2))
        assert rms > 0, k
        err = np.abs(gk - w).max()
        assert err <= tol * rms, f"{k}: {err:.3e} vs rms {rms:.3e}"


def test_batched_loss_and_gradients_match_jax():
    """The masked RMSE over the three samples and every parameter's
    gradient on the union against `jax.value_and_grad` of the JAX
    trainer's loss on the stacked hierarchies (`simulator_forward_auto`
    vmaps the forward)."""
    jcfg, _, state, sim = model()
    hstack, _, hd, _, node_in, target, mask, _ = batch()
    jtr = JaxTrainer(JaxConfig(model=jcfg), init_key=jax.random.PRNGKey(0))
    args = tuple(jnp.asarray(a) for a in (node_in, target, mask))
    loss_j, grads_j = jax.jit(lambda p, h, *a: jax.value_and_grad(
        jtr._loss_fn)(p, state, h, *a))(state.params, hstack, *args)
    ni, nt, m = (torch.from_numpy(a) for a in (node_in, target, mask))
    ssa.segment_sum_accum_plain.calls = 0
    sim.zero_grad(set_to_none=True)
    try:
        loss = masked_rmse(sim(hd, ni, m), nt, m)
        loss.backward()
        # One call a route, as at B = 1: 4 forward, 2 in the adjoint convs
        # and 4 in the residual gathers' backwards (level 0).
        assert ssa.segment_sum_accum_plain.calls == 10
        np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
        assert_grads_close({k: p.grad for k, p in sim.named_parameters()},
                           jax_param_grads(grads_j), GRAD_TOL)
    finally:
        sim.zero_grad(set_to_none=True)


def test_trainer_on_the_union_matches_jax_trainer():
    """accumulation_steps=1: the gate step on the batch (its normalizer
    statistics over every sample's real rows), then two updates (the first
    at rate 0 fills Adam's moments), each side fed the same noise draw
    ([3, N_pad, 2], cylinder_flow's σ = 0.02): the losses, the normalizer
    states after the gate and each tensor's update."""
    jcfg, tcfg, _, _ = model()
    hstack, _, hd, _, node_in, target, mask, _ = batch()
    opt_kw = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=4)
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, accumulation_steps=1))
    jtr = JaxTrainer(JaxConfig(
        model=dataclasses.replace(jcfg, accumulation_steps=1),
        datasets=JaxDatasetConfig(
            noise_level=list(tcfg.datasets.noise_level),
            noise_gamma=tcfg.datasets.noise_gamma),
        opt=JaxOptConfig(**opt_kw)), init_key=jax.random.PRNGKey(3))
    ttr = Trainer(tcfg, OptConfig(**opt_kw), device="cpu")
    init = params_from_numpy(jax_to_nested(jtr.state.sim.params))
    ttr.sim.load_state_dict(init)

    key = jax.random.PRNGKey(7)
    losses_j, losses_t = [], []
    for i in range(3):
        k = jax.random.fold_in(key, i)
        z = jax.random.normal(k, target.shape, jnp.float32)
        losses_j.append(float(jtr.iter(hstack, *(jnp.asarray(a) for a in
                                                 (node_in, target, mask)),
                                       k)))
        losses_t.append(float(ttr.iter(
            hd, *(torch.from_numpy(a) for a in (node_in, target, mask)),
            torch.tensor(np.asarray(z)))))
        if i == 0:
            for name in ("norm_in", "norm_out"):
                want = normalizer_to_dict(getattr(jtr.state.sim, name))
                got = getattr(ttr.sim, name)
                for f in ("acc_weight", "num_accumulations", "e_x", "e_x2"):
                    np.testing.assert_allclose(
                        getattr(got, f).numpy(), want[f], rtol=1e-5,
                        atol=1e-7, err_msg=f"{name}.{f}")
    assert ttr.step == jtr.step == 3 and ttr.updates == 2
    np.testing.assert_allclose(losses_t[:1], losses_j[:1], rtol=1e-6)
    np.testing.assert_allclose(losses_t[1:], losses_j[1:], rtol=1e-4)
    want = jax_param_grads(jtr.state.sim.params)
    for k, p in ttr.sim.state_dict().items():
        upd = p.numpy() - init[k].numpy()
        upd_j = want[k].numpy() - init[k].numpy()
        rms = np.sqrt(np.mean(upd_j.astype(np.float64) ** 2))
        assert rms > 0, k
        err = np.sqrt(np.mean((upd - upd_j).astype(np.float64) ** 2))
        assert err <= 1e-2 * rms, f"{k}: update rms err {err:.3e} of {rms:.3e}"
