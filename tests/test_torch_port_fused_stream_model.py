"""The port's `fused` method on unwindowed hierarchies against the JAX
package on the CPU, whole model: the simulator forward in f32 (with taps)
and bf16 and every f32 gradient against `jax.value_and_grad` on both
routes (kernel 12 on the `plain` case, kernel 11 on the `world` case);
rollout and `Trainer` against the JAX `Trainer` on the `world` case alone
(their glue does not depend on the route; the world case adds the moving
world positions and its noise). The cases and tolerances are
`test_torch_port_fused_stream.py`'s (the JAX kernels run in interpret
mode); the two files are apart so that test workers can run them side by
side.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_fused_stream import (  # noqa: F401 (fixture)
    BF16_REL,
    DEPTH,
    F32_TOL,
    GRAD_F32_TOL,
    _case,
    case,
)
from test_torch_port_train import jax_param_grads
from test_torch_port_weights import jax_to_nested, normalizer_to_dict

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import DatasetConfig as JaxDatasetConfig
from bsms_gnn_tpu.config import OptConfig as JaxOptConfig
from bsms_gnn_tpu.models.normalizer import normalize as jax_normalize
from bsms_gnn_tpu.models.simulator import simulator_forward, split_node_input
from bsms_gnn_tpu.ops.bsgmp import bsgmp_apply
from bsms_gnn_tpu.ops.dense import mlp_apply
from bsms_gnn_tpu.training.rollout import rollout_trajectory as jax_rollout
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import OptConfig
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.training.rollout import rollout_trajectory
from bsms_gnn_tpu_torch.training.trainer import Trainer, masked_rmse


@pytest.fixture
def world():
    c = _case("world")
    yield c
    c["sim"].zero_grad(set_to_none=True)


# -- the simulator -------------------------------------------------------------


def _jax_forward(case, node_in, cd=None):
    state, hj = case["state"], case["hj"]
    return np.asarray(jax.jit(
        lambda ni, m: simulator_forward(state.params, state.norm_in,
                                        state.norm_out, hj, ni, m,
                                        case["jcfg"], cd)
    )(jnp.asarray(node_in), jnp.asarray(case["mask"])))


def test_forward_f32_matches_jax_with_taps(case):
    """The prediction, and each GMP's output on the encoder's output (one
    JAX compile for both)."""
    node_in, mask, sim, ht = (case[k] for k in ("node_in", "mask", "sim",
                                                 "ht"))
    state, jcfg, hj = case["state"], case["jcfg"], case["hj"]

    def jax_forward_and_taps(ni, m):
        pred = simulator_forward(state.params, state.norm_in, state.norm_out,
                                 hj, ni, m, jcfg, None)
        latent, _, _ = split_node_input(ni, jcfg.pos_dim)
        x0 = mlp_apply(state.params.encode,
                       jax_normalize(state.norm_in, latent))
        taps = {}
        bsgmp_apply(state.params.process, hj, x0,
                    ni[:, :3] if case["dyn_dims"] else None, method="fused",
                    tap=taps.__setitem__, dyn_dims=case["dyn_dims"] or None)
        return pred, x0, taps

    want, x0, taps_j = jax.jit(jax_forward_and_taps)(
        jnp.asarray(node_in), jnp.asarray(mask))
    with torch.no_grad():
        got = sim(ht, torch.from_numpy(node_in), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    taps_t = {}
    with torch.no_grad():
        sim.process(ht, torch.tensor(np.asarray(x0)),
                    tap=lambda k, v: taps_t.__setitem__(k, v.numpy()),
                    pos=torch.from_numpy(node_in[:, :3]), method="fused")
    assert sorted(taps_j) == sorted(taps_t) and len(taps_t) == 2 * DEPTH + 1
    for k in taps_j:
        np.testing.assert_allclose(taps_t[k], np.asarray(taps_j[k]),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=k)


def test_forward_bf16_matches_jax(case):
    node_in, mask, sim, ht = (case[k] for k in ("node_in", "mask", "sim",
                                                 "ht"))
    want = _jax_forward(case, node_in, jnp.bfloat16)
    with torch.no_grad():
        got = sim(ht, torch.from_numpy(node_in), torch.from_numpy(mask),
                  torch.bfloat16).numpy()
    assert got.dtype == want.dtype == np.float32
    delta_scale = np.abs(want - node_in[:, :3]).max()
    assert delta_scale > 0
    assert np.abs(got - want).max() <= BF16_REL * delta_scale


def test_rollout_matches_jax(world):
    hj, ht, jcfg, state, sim = (world[k] for k in
                                ("hj", "ht", "jcfg", "state", "sim"))
    node_in, mask = world["node_in"], world["mask"]
    want = np.asarray(jax.jit(
        lambda ic, m: jax_rollout(state, hj, ic, m, 3, jcfg)
    )(jnp.asarray(node_in), jnp.asarray(mask)))
    got = rollout_trajectory(sim, ht, torch.from_numpy(node_in),
                             torch.from_numpy(mask), 3).numpy()
    assert got.shape == want.shape == (3, node_in.shape[0], 3)
    np.testing.assert_allclose(got, want, rtol=2 * F32_TOL, atol=2 * F32_TOL)


# -- training ------------------------------------------------------------------


def test_loss_and_gradients_match_jax(case):
    hj, ht, jcfg, state, sim = (case[k] for k in
                                ("hj", "ht", "jcfg", "state", "sim"))
    (node_in, target), mask = case["train"], case["mask"]
    jtr = JaxTrainer(JaxConfig(model=jcfg), init_key=jax.random.PRNGKey(0))
    args = tuple(jnp.asarray(a) for a in (node_in, target, mask))
    loss_j, grads_j = jax.jit(lambda p, *a: jax.value_and_grad(
        jtr._loss_fn)(p, state, hj, *a))(state.params, *args)
    want = jax_param_grads(grads_j)

    sim.zero_grad(set_to_none=True)
    ni, nt, m = (torch.from_numpy(a) for a in (node_in, target, mask))
    loss = masked_rmse(sim(ht, ni, m), nt, m)
    loss.backward()
    got = {k: p.grad for k, p in sim.named_parameters()}
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for k, w in want.items():
        w, g = w.numpy(), got[k].numpy()
        rms = np.sqrt(np.mean(w.astype(np.float64) ** 2))
        assert rms > 0, k
        err = np.abs(g - w).max()
        assert err <= GRAD_F32_TOL * rms, f"{k}: {err:.3e} vs rms {rms:.3e}"


def test_trainer_matches_jax_trainer(world):
    """accumulation_steps=2 (the warmup gate), then 3 updates, both fed
    the same noise draw each step (the inflating-font noise, σ = 0.003 on
    the world positions): per-step losses, normalizer states after the
    gate, and each tensor's update."""
    hj, ht, jcfg = world["hj"], world["ht"], world["jcfg"]
    tcfg = world["tcfg"]
    (node_in, target), mask = world["train"], world["mask"]
    opt_kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=6)
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, accumulation_steps=2))
    jtr = JaxTrainer(JaxConfig(
        model=dataclasses.replace(jcfg, accumulation_steps=2),
        datasets=JaxDatasetConfig(
            noise_level=list(tcfg.datasets.noise_level),
            noise_gamma=tcfg.datasets.noise_gamma),
        opt=JaxOptConfig(**opt_kw)), init_key=jax.random.PRNGKey(3))
    ttr = Trainer(tcfg, OptConfig(**opt_kw), device="cpu")
    init = params_from_numpy(jax_to_nested(jtr.state.sim.params))
    ttr.sim.load_state_dict(init)

    ni, nt, m = (jnp.asarray(a) for a in (node_in, target, mask))
    ti, tt, tm = (torch.from_numpy(a) for a in (node_in, target, mask))
    key = jax.random.PRNGKey(7)
    losses_j, losses_t = [], []
    for i in range(5):
        k = jax.random.fold_in(key, i)
        z = torch.tensor(np.asarray(jax.random.normal(k, nt.shape, nt.dtype)))
        losses_j.append(float(jtr.iter(hj, ni, nt, m, k)))
        losses_t.append(float(ttr.iter(ht, ti, tt, tm, z)))
    assert ttr.step == jtr.step == 5 and ttr.updates == 3
    np.testing.assert_allclose(losses_t[:2], losses_j[:2], rtol=1e-6)
    np.testing.assert_allclose(losses_t[2:], losses_j[2:], rtol=1e-4)
    assert len(set(losses_t[2:])) == 3

    for name in ("norm_in", "norm_out"):
        want = normalizer_to_dict(getattr(jtr.state.sim, name))
        got = getattr(ttr.sim, name)
        for f in ("acc_weight", "num_accumulations", "e_x", "e_x2"):
            np.testing.assert_allclose(getattr(got, f).numpy(), want[f],
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name}.{f}")
    want = jax_param_grads(jtr.state.sim.params)
    for k, p in ttr.sim.state_dict().items():
        upd, upd_j = p.numpy() - init[k].numpy(), want[k].numpy() - init[k].numpy()
        rms = np.sqrt(np.mean(upd_j.astype(np.float64) ** 2))
        assert rms > 0, k
        err = np.sqrt(np.mean((upd - upd_j).astype(np.float64) ** 2))
        assert err <= 1e-2 * rms, f"{k}: update rms err {err:.3e} of {rms:.3e}"
