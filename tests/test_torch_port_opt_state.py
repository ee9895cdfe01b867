"""The train state carried between the JAX package and the port
(`convert.train_state_from_jax` / `train_state_to_jax`): a JAX `Trainer`
past its warmup gate (the gate and two more steps) converted to the port,
and a port `Trainer` converted to JAX; then both take one more step on the
same batch and the same noise (JAX's draw, fed to the port's
`Trainer.iter(noise=...)`). The parameters, the Adam moments and every
count agree, plainly (optax.adamw) and under MultiSteps k = 2 converted at
mini-step 1, so the next step applies the running mean.

Both trainers run the `segment` method (JAX's parity oracle, a compile of
a few seconds) on a 300-node Delaunay mesh at depth 2, latent 32, hidden
2. Tolerances are `test_torch_port_ell_train.py::assert_updates_close`'s,
for one update: the two frameworks' gradients differ in f32 summation
order, so each weight's step lands within twice the rate, at most one in
a thousand beyond a quarter of it (a gradient near zero moves its weight
by about ± the rate whatever its scale), and each tensor's update within
1e-2 of its RMS in RMS. The moments, which add a tenth of the gradient
(a thousandth of its square), are held to 1e-2 of their RMS in RMS; the
counts, the step and the normalizers exactly."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_weights import (
    jax_to_nested,
    nested_to_jax,
    normalizer_to_dict,
)

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import ModelConfig as JaxModelConfig
from bsms_gnn_tpu.config import OptConfig as JaxOptConfig
from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.training.trainer import TrainState
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import Config, ModelConfig, OptConfig
from bsms_gnn_tpu_torch.convert import (
    params_from_numpy,
    train_state_from_jax,
    train_state_to_jax,
)
from bsms_gnn_tpu_torch.data.synthetic import make_delaunay_mesh
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.training.schedule import warmup_cosine_schedule
from bsms_gnn_tpu_torch.training.trainer import Trainer

MODEL = dict(latent_dim=32, hidden_layer=2, unet_depth=2,
             accumulation_steps=1, aggregation="segment")
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
PRE_STEPS = 3  # the gate, then two steps


@pytest.fixture(scope="module")
def mesh():
    rng = np.random.default_rng(5)
    pos, cells, node_type = make_delaunay_mesh(300, rng)
    pos = pos.astype(np.float64)
    n = len(pos)
    hj = jax_build(jax_flat_edge(cells, "tri"), 2, n, pos)
    ht = to_device(build_hierarchy(to_flat_edge(cells, "tri"), 2, n, pos),
                   "cpu")
    n_pad = ht.levels[0].n_pad_nodes
    node_in = np.zeros((2, n_pad, 6), np.float32)
    node_in[:, :n, :3] = rng.standard_normal((2, n, 3))
    node_in[:, :n, 3:5] = pos
    node_in[:, :n, 5] = node_type[:, 0]
    mask = np.zeros((2, n_pad, 1), np.float32)
    mask[:, :n, 0] = node_type[:, 0] == 0
    tar = (node_in[..., :3] + 0.1 * rng.standard_normal(
        (2, n_pad, 3))).astype(np.float32) * mask
    return hj, ht, (node_in, tar, mask)


@functools.lru_cache(maxsize=None)
def jax_trainer(k):
    """One JAX trainer per k (its step compiles once) and a copy of its
    initial state."""
    jtr = JaxTrainer(JaxConfig(model=JaxModelConfig(**MODEL),
                               opt=JaxOptConfig(**OPT,
                                                gradient_accumulation_steps=k)),
                     init_key=jax.random.PRNGKey(3))
    return jtr, jax.tree_util.tree_map(jnp.copy, jtr.state)


def trainers(k):
    jtr, init = jax_trainer(k)
    jtr.state = jax.tree_util.tree_map(jnp.copy, init)
    ttr = Trainer(Config(model=ModelConfig(**MODEL),
                         opt=OptConfig(**OPT, gradient_accumulation_steps=k)),
                  device="cpu")
    return jtr, ttr


def noise(i, shape):
    k = jax.random.fold_in(jax.random.PRNGKey(7), i)
    return k, jax.random.normal(k, shape, jnp.float32)


def step_jax(jtr, hj, batch, i):
    k, _ = noise(i, batch[1].shape)
    return float(jtr.iter(hj, *(jnp.asarray(a) for a in batch), k))


def step_port(ttr, ht, batch, i):
    _, z = noise(i, batch[1].shape)
    return float(ttr.iter(ht, *(torch.from_numpy(a) for a in batch),
                          torch.tensor(np.asarray(z))))


def jax_state_from_plain(template: TrainState, plain: dict) -> TrainState:
    """JAX's TrainState shaped like `template`, filled from
    `train_state_to_jax`'s plain data."""
    tp = template.sim.params

    def norm(t, d):
        return t.replace(**{f: jnp.asarray(d[f]) for f in
                            ("acc_weight", "num_accumulations", "e_x",
                             "e_x2")})

    def count(like, v):
        return jnp.asarray(v, like.dtype)

    opt = template.opt_state
    multi = hasattr(opt, "inner_opt_state")
    clip, (adam, wd, sched) = opt.inner_opt_state if multi else opt
    inner = (clip, (adam._replace(count=count(adam.count, plain["count"]),
                                  mu=nested_to_jax(tp, plain["mu"]),
                                  nu=nested_to_jax(tp, plain["nu"])),
                    wd, sched._replace(count=count(sched.count,
                                                   plain["count"]))))
    if multi:
        opt = opt._replace(
            mini_step=count(opt.mini_step, plain["mini_step"]),
            gradient_step=count(opt.gradient_step, plain["gradient_step"]),
            inner_opt_state=inner,
            acc_grads=nested_to_jax(tp, plain["acc_grads"]))
    else:
        opt = inner
    sim = template.sim.replace(
        params=nested_to_jax(tp, plain["params"]),
        norm_in=norm(template.sim.norm_in, plain["norm_in"]),
        norm_out=norm(template.sim.norm_out, plain["norm_out"]))
    return TrainState(sim=sim, opt_state=opt,
                      step=jnp.asarray(plain["step"], template.step.dtype))


def jax_adam(state: TrainState):
    opt = state.opt_state
    inner = opt.inner_opt_state if hasattr(opt, "inner_opt_state") else opt
    return inner[1][0]


def assert_states_agree(jtr, ttr, before, rate):
    """Counts and normalizers exact; parameters and moments as the module
    docstring says."""
    ts = ttr.state_dict()
    adam = jax_adam(jtr.state)
    assert ttr.step == jtr.step
    assert ttr.updates == int(adam.count) == int(jax_adam(jtr.state).count)
    opt = jtr.state.opt_state
    if hasattr(opt, "inner_opt_state"):
        assert ttr.mini_step == int(opt.mini_step)
        assert ttr.updates == int(opt.gradient_step)
    for name in ("norm_in", "norm_out"):
        want = normalizer_to_dict(getattr(jtr.state.sim, name))
        for f in ("acc_weight", "num_accumulations", "e_x", "e_x2"):
            np.testing.assert_array_equal(ts[name][f].numpy(), want[f])
    want = params_from_numpy(jax_to_nested(jtr.state.sim.params))
    mu = params_from_numpy(jax_to_nested(adam.mu))
    nu = params_from_numpy(jax_to_nested(adam.nu))
    for k, p in ts["params"].items():
        w, p0 = want[k].numpy(), before[k].numpy()
        diff = np.abs(p.numpy() - w)
        assert diff.max() <= 2 * rate, k
        flips = diff > 0.25 * rate
        assert flips.sum() <= max(1, 1e-3 * diff.size), k
        upd, upd_j = (p.numpy() - p0)[~flips], (w - p0)[~flips]
        rms = np.sqrt(np.mean(upd_j.astype(np.float64) ** 2))
        if rms == 0:
            assert not upd.any(), k
        else:
            err = np.sqrt(np.mean((upd - upd_j).astype(np.float64) ** 2))
            assert err <= 1e-2 * rms, f"{k}: update rms err {err:.3e}"
        st = ts["adam"][k]
        assert float(st["step"]) == ttr.updates
        for got, ref in ((st["exp_avg"], mu[k]), (st["exp_avg_sq"], nu[k])):
            ref = ref.numpy().astype(np.float64)
            rms = np.sqrt(np.mean(ref ** 2))
            err = np.sqrt(np.mean((got.numpy() - ref) ** 2))
            assert err <= 1e-2 * rms or err == 0, k


@pytest.mark.parametrize("k", [1, 2])
def test_jax_state_to_port_then_one_step(mesh, k):
    hj, ht, batch = mesh
    jtr, ttr = trainers(k)
    for i in range(PRE_STEPS + (k - 1)):
        step_jax(jtr, hj, batch, i)
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        jtr.state))
    ttr.load_state_dict(state)
    assert ttr.step == PRE_STEPS + k - 1
    assert ttr.updates == 2 // k and ttr.mini_step == (k - 1)
    before = {n: p.detach().clone() for n, p in ttr.sim.state_dict().items()}
    rate = warmup_cosine_schedule(**OPT)(ttr.updates)
    assert rate > 0
    i = PRE_STEPS + k - 1
    np.testing.assert_allclose(step_port(ttr, ht, batch, i),
                               step_jax(jtr, hj, batch, i), rtol=1e-4)
    assert_states_agree(jtr, ttr, before, rate)


@pytest.mark.parametrize("k", [1, 2])
def test_port_state_to_jax_then_one_step(mesh, k):
    hj, ht, batch = mesh
    jtr, ttr = trainers(k)
    for i in range(PRE_STEPS + (k - 1)):
        step_port(ttr, ht, batch, i)
    plain = train_state_to_jax(ttr.state_dict())
    jtr.state = jax_state_from_plain(jtr.state, plain)
    assert jtr.step == ttr.step and int(jax_adam(jtr.state).count) == ttr.updates
    # The round trip JAX → port gives back the port's state.
    back = train_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       jtr.state))
    mine = ttr.state_dict()
    for name in ("params", "acc_grads"):
        if mine[name] is not None:
            for n, v in mine[name].items():
                assert torch.equal(back[name][n], v), (name, n)
    for n, st in mine["adam"].items():
        for f in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(back["adam"][n][f], st[f]), (n, f)
    before = {n: p.detach().clone() for n, p in ttr.sim.state_dict().items()}
    rate = warmup_cosine_schedule(**OPT)(ttr.updates)
    i = PRE_STEPS + k - 1
    np.testing.assert_allclose(step_port(ttr, ht, batch, i),
                               step_jax(jtr, hj, batch, i), rtol=1e-4)
    assert_states_agree(jtr, ttr, before, rate)


def test_disagreeing_counts_raise(mesh):
    jtr, _ = trainers(1)
    state = jax.tree_util.tree_map(np.asarray, jtr.state)
    clip, (adam, wd, sched) = state.opt_state
    bad = dataclasses.replace(state, opt_state=(
        clip, (adam._replace(count=np.asarray(3, np.int32)), wd, sched)))
    with pytest.raises(ValueError, match="disagree"):
        train_state_from_jax(bad)
