"""The rest of the port's trainer against the JAX package on the CPU:
`remat` (`ModelConfig.remat`, `remat_min_nodes`: `torch.utils.checkpoint`
around each GMP of a level of at least that many padded rows per sample,
as `jax.checkpoint` in `bsms_gnn_tpu/ops/bsgmp.py`) and
`gradient_accumulation_steps` (optax.MultiSteps), on
`test_torch_port_stacked.py`'s batch of three samples on the union of
their hierarchies (the JAX side stacked and vmapped; its kernels in
interpret mode).

remat recomputes the same values: the forward and every gradient are bit
for bit remat=False's, and each checkpointed GMP runs its forward kernels
once more in the backward (counted by the plain versions' calls). Against
JAX's remat=True: each gradient within 1e-3 of its RMS
(`test_torch_port_variable_mesh_grads.py`'s). MultiSteps: the losses
within 1e-4, the parameters unchanged (exactly) on the steps that apply
no update, each tensor's update within 1e-2 of its RMS after each update
(`test_torch_port_variable_mesh_train.py`'s), the step counts equal.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_stacked import batch
from test_torch_port_stacked_train import GRAD_TOL, assert_grads_close
from test_torch_port_train import jax_param_grads
from test_torch_port_variable_mesh import model
from test_torch_port_weights import jax_to_nested

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import DatasetConfig as JaxDatasetConfig
from bsms_gnn_tpu.config import OptConfig as JaxOptConfig
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import OptConfig
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp, node_mlp
from bsms_gnn_tpu_torch.ops.kernels import segment_sum_accum as ssa
from bsms_gnn_tpu_torch.training.trainer import Trainer, masked_rmse

# Level 1's padded rows per sample: levels 0 and 1 reach it, level 2 not.
LEVEL1_PAD = 384
PLAIN = (fused_gmp.fused_edge_phase_win_plain, node_mlp.fused_node_phase_plain,
         ssa.segment_sum_accum_plain)


@contextlib.contextmanager
def remat_config(sim, min_nodes):
    """The shared simulator with remat on at `min_nodes`, and its grads
    cleared after."""
    cfg = sim.cfg
    sim.cfg = dataclasses.replace(cfg, remat=True, remat_min_nodes=min_nodes)
    try:
        yield
    finally:
        sim.cfg = cfg
        sim.zero_grad(set_to_none=True)


def step(sim, hd, node_in, target, mask):
    """The loss, the prediction and every gradient of one step, and the
    plain versions' calls (kernels 4, 3, 9) it made."""
    for f in PLAIN:
        f.calls = 0
    sim.zero_grad(set_to_none=True)
    ni, nt, m = (torch.from_numpy(a) for a in (node_in, target, mask))
    pred = sim(hd, ni, m)
    loss = masked_rmse(pred, nt, m)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in sim.named_parameters()}
    sim.zero_grad(set_to_none=True)
    return loss, pred.detach(), grads, [f.calls for f in PLAIN]


@pytest.mark.parametrize("min_nodes,checkpointed,resid", [
    (0, 5, 2), (LEVEL1_PAD, 4, 2), (10**6, 0, 0)])
def test_remat_is_bit_identical_and_replays_the_forward(min_nodes,
                                                        checkpointed, resid):
    """remat at 0 (every GMP: 5 at depth 2), at level 1's per-sample pad
    (4: levels 0 and 1, not the bottom; the union's levels hold three
    times as many rows, which the threshold does not count) and above every
    level (none): the loss, the prediction and every gradient equal
    remat=False's bit for bit; each checkpointed GMP calls kernels 4 and 3
    once more, and each of them on level 0 kernel 9 too (its residual)."""
    _, _, _, sim = model()
    _, _, hd, _, node_in, target, mask, _ = batch()
    sim.zero_grad(set_to_none=True)
    want = step(sim, hd, node_in, target, mask)
    with remat_config(sim, min_nodes):
        got = step(sim, hd, node_in, target, mask)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert sorted(got[2]) == sorted(want[2])
    for k, g in want[2].items():
        assert torch.equal(got[2][k], g), k
    k4, k3, k9 = want[3]
    assert got[3] == [k4 + checkpointed, k3 + checkpointed, k9 + resid]


def test_remat_gradients_match_jax_remat():
    """remat at level 1's pad against `jax.value_and_grad` of the JAX
    trainer's loss with remat=True at the same `remat_min_nodes` (JAX's
    vmap reads each sample's N_pad)."""
    jcfg, _, state, sim = model()
    hstack, _, hd, _, node_in, target, mask, _ = batch()
    jcfg = dataclasses.replace(jcfg, remat=True, remat_min_nodes=LEVEL1_PAD)
    jtr = JaxTrainer(JaxConfig(model=jcfg), init_key=jax.random.PRNGKey(0))
    args = tuple(jnp.asarray(a) for a in (node_in, target, mask))
    loss_j, grads_j = jax.jit(lambda p, h, *a: jax.value_and_grad(
        jtr._loss_fn)(p, state, h, *a))(state.params, hstack, *args)
    with remat_config(sim, LEVEL1_PAD):
        loss, _, grads, _ = step(sim, hd, node_in, target, mask)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    assert_grads_close(grads, jax_param_grads(grads_j), GRAD_TOL)


def test_gradient_accumulation_matches_jax_multisteps():
    """gradient_accumulation_steps = 2 with a one-step gate, then six train
    steps on the batch, each side fed the same noise: updates on train
    steps 2, 4 and 6 only (rates schedule(0) = 0, then schedule(1) and
    schedule(2)), each of the mean of two steps' gradients; the losses,
    the parameters after every step and the step counts against JAX's
    `optax.MultiSteps` trainer (its mini-step and gradient step)."""
    jcfg, tcfg, _, _ = model()
    hstack, _, hd, _, node_in, target, mask, _ = batch()
    opt_kw = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=8,
                  gradient_accumulation_steps=2)
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

    key = jax.random.PRNGKey(11)
    before = {k: v.clone() for k, v in init.items()}
    before_j = before
    moved = []
    for i in range(7):
        k = jax.random.fold_in(key, i)
        z = jax.random.normal(k, target.shape, jnp.float32)
        loss_j = float(jtr.iter(hstack, *(jnp.asarray(a) for a in
                                          (node_in, target, mask)), k))
        loss_t = float(ttr.iter(
            hd, *(torch.from_numpy(a) for a in (node_in, target, mask)),
            torch.tensor(np.asarray(z))))
        np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4, err_msg=i)
        ms = jtr.state.opt_state
        assert ttr.step == int(jtr.state.step) == i + 1
        assert ttr.mini_step == int(ms.mini_step)
        assert ttr.updates == int(ms.gradient_step) == max(0, i // 2)
        want = jax_param_grads(jtr.state.sim.params)
        now = ttr.sim.state_dict()
        if i in (2, 4, 6):
            moved.append(any(not torch.equal(now[n], before[n]) for n in now))
        for n, p in now.items():
            if i not in (2, 4, 6):  # a step that applies nothing
                assert torch.equal(p, before[n]), (i, n)
                assert torch.equal(want[n], before_j[n]), (i, n)
                continue
            upd, upd_j = p - init[n], want[n] - init[n]
            rms = np.sqrt(np.mean(upd_j.numpy().astype(np.float64) ** 2))
            err = np.sqrt(np.mean((upd - upd_j).numpy().astype(np.float64)
                                  ** 2))
            assert err <= 1e-2 * rms, f"step {i} {n}: {err:.3e} of {rms:.3e}"
        before = {n: p.clone() for n, p in now.items()}
        before_j = want
    # The first update runs at rate 0; the next two move the parameters.
    assert moved == [False, True, True]
