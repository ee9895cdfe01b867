"""The port at the width and depth the TPU kernels take as parameters:
latent 256 and four tail layers (`hidden_layer=4`), against the JAX
package's `fused` method on the CPU, whose Pallas kernels run in
interpret mode at c = 256, n_layers = 4 (`_get_fwd3` / `_get_bwd3`, the
node phase's `_get_fwd` / `_get_bwd`, the windowed conv and send sum, the
compact accumulate).

- The forward with per-level taps (f32) and in bf16, a short rollout.
- The loss and every gradient of a train step, and a `Trainer` over its
  warmup gate and two updates, at (256, 4) and at (128, 4).
- Kernels 1-7's plain versions at C = 256 (L = 4) against their JAX
  getters' functions: the windowed conv in both forms, the compact
  accumulate, the node phase forward and its `jax.vjp`, the fused edge
  phase forward and backward, the send sum.
- The kernels' refusal functions (`fused_gmp.walk_plan`,
  `node_mlp.node_plan`): what they accept fits a block's shared memory,
  and the CUDA sources hold the same plans.
- `convert.py`'s round trip at (256, 4).

Mesh: `test_torch_port_slice.py`'s scrambled triangulated grid, 16×16 at
depth 2 (window 128, edge_block 512): its level 0 carries a compact
residual. Tolerances are those of `test_torch_port_slice.py` (forward,
rollout) and `test_torch_port_train.py` (kernels, gradients, trainer).
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from conftest import make_grid_mesh
from test_torch_port_slice import BF16_REL, F32_TOL
from test_torch_port_train import (
    DTYPES,
    GRAD_F32_TOL,
    KERNEL_TOL,
    SELECT_TOL,
    assert_close,
    both,
    jax_param_grads,
    leaf,
    port_param_grads,
)
from test_torch_port_weights import (
    jax_state_with_stats,
    jax_to_nested,
    nested_to_jax,
    normalizer_to_dict,
    port_simulator,
)

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import ModelConfig as JaxModelConfig
from bsms_gnn_tpu.config import OptConfig as JaxOptConfig
from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.models.normalizer import normalize as jax_normalize
from bsms_gnn_tpu.models.simulator import simulator_forward, split_node_input
from bsms_gnn_tpu.ops.bsgmp import bsgmp_apply
from bsms_gnn_tpu.ops.dense import mlp_apply
from bsms_gnn_tpu.ops.pallas import compact_resid as jax_cr
from bsms_gnn_tpu.ops.pallas.fused_gmp import fused_edge_phase_win as jax_edge
from bsms_gnn_tpu.ops.pallas.node_mlp import fused_node_phase as jax_node
from bsms_gnn_tpu.ops.pallas.windowed import (
    windowed_conv_raw,
    windowed_rect_conv_raw,
    windowed_send_sum_raw,
)
from bsms_gnn_tpu.training.rollout import rollout_trajectory as jax_rollout
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import Config, ModelConfig, OptConfig
from bsms_gnn_tpu_torch.convert import params_from_numpy, params_to_numpy
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.ops.kernels import compact_resid, fused_gmp
from bsms_gnn_tpu_torch.ops.kernels import node_mlp, windowed
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import fused_edge_phase_win
from bsms_gnn_tpu_torch.ops.kernels.node_mlp import fused_node_phase
from bsms_gnn_tpu_torch.training.rollout import rollout_trajectory
from bsms_gnn_tpu_torch.training.schedule import warmup_cosine_schedule
from bsms_gnn_tpu_torch.training.trainer import Trainer, masked_rmse

DEPTH = 2
C, L = 256, 4
SHAPES = [(256, 4), (128, 4)]
# The train step's frame. Every frame of this mesh holds a few hundred ReLU
# inputs within 3e-6 of zero at four tail layers (200-260 at latent 256,
# `tests/frame_seed_sweep.py wide` counts them); where the two frameworks'
# orders of f32 sums put one of them on different sides, a weight gradient
# moves by 1e-3 to 1e-1 of its RMS, so some frames miss GRAD_F32_TOL.
# Seed 23 misses at neither shape; the frames of SWEEP_SEEDS, missing or
# not, are held in `test_gradients_at_other_frames_miss_jax_only_at_kinks`.
FRAME_SEED = 23
SWEEP_SEEDS = range(21, 29)
# One-step nudges of a frame the kink test tries before it fails.
NUDGES = 30
CSRC = os.path.join(os.path.dirname(fused_gmp.__file__), "csrc")


@pytest.fixture(scope="module")
def mesh():
    """The scrambled 16×16 grid's hierarchies (JAX's, the port's) and a
    frame on it."""
    pos, cells = make_grid_mesh(16, 16)
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(pos))
    inv = np.empty(len(pos), np.int64)
    inv[perm] = np.arange(len(pos))
    pos, cells = pos[perm], inv[cells]
    n = len(pos)
    kw = dict(edge_block=512, window=128)
    hj = jax_build(jax_flat_edge(cells, "tri"), DEPTH, n, pos, **kw)
    ht = to_device(build_hierarchy(to_flat_edge(cells, "tri"), DEPTH, n, pos,
                                   **kw), "cpu")
    n_pad = hj.levels[0].n_pad_nodes
    node_in = np.zeros((n_pad, 6), np.float32)
    node_in[:n, :3] = rng.standard_normal((n, 3))
    node_in[:n, 3:5] = pos / 16.0
    node_type = np.where(rng.uniform(size=n) < 0.1, 4, 0)
    node_in[:n, 5] = node_type
    mask = np.zeros((n_pad, 1), np.float32)
    mask[:n, 0] = node_type == 0
    return dict(hj=hj, ht=ht, node_in=node_in, mask=mask)


_models = {}


def model(c, layers):
    """(JAX config, JAX state with filled normalizers, the port's
    simulator holding the same weights) at latent c and `layers` tail
    layers, made once per shape."""
    if (c, layers) not in _models:
        jcfg = JaxModelConfig(latent_dim=c, hidden_layer=layers,
                              unet_depth=DEPTH, aggregation="fused")
        tcfg = ModelConfig(latent_dim=c, hidden_layer=layers,
                           unet_depth=DEPTH, aggregation="fused")
        state = jax_state_with_stats(jcfg)
        _models[(c, layers)] = (jcfg, state, port_simulator(tcfg, state))
    return _models[(c, layers)]


# -- the forward, the rollout -------------------------------------------------


def test_the_wide_case_reaches_the_kernels_the_port_refused(mesh):
    """Every level of the mesh is windowed, level 0 carries a compact
    residual, and the wide model's edge and node MLPs have four [256, 256]
    tail layers: the configuration whose first kernel call raised `latent
    width 256 (only 128)`."""
    ht = mesh["ht"]
    assert all(lvl.window > 0 for lvl in ht.levels)
    assert ht.levels[0].cresid is not None
    sim = model(C, L)[2]
    for m in (sim.process.down_gmps[0].mlp_edge,
              sim.process.down_gmps[0].mlp_node):
        assert [tuple(w.shape) for w in list(m.weights)[1:]] == [(C, C)] * L


def test_forward_f32_matches_jax_with_taps(mesh):
    hj, ht, node_in, mask = (mesh[k] for k in ("hj", "ht", "node_in",
                                                "mask"))
    jcfg, state, sim = model(C, L)
    want = np.asarray(jax.jit(
        lambda ni, m: simulator_forward(state.params, state.norm_in,
                                        state.norm_out, hj, ni, m, jcfg)
    )(jnp.asarray(node_in), jnp.asarray(mask)))
    with torch.no_grad():
        got = sim(ht, torch.from_numpy(node_in), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)

    latent, _, _ = split_node_input(jnp.asarray(node_in), jcfg.pos_dim)
    x0 = mlp_apply(state.params.encode, jax_normalize(state.norm_in, latent))

    def jax_taps(x):
        taps = {}
        bsgmp_apply(state.params.process, hj, x, method="fused",
                    tap=taps.__setitem__)
        return taps

    taps_j = jax.jit(jax_taps)(x0)
    taps_t = {}
    with torch.no_grad():
        sim.process(ht, torch.tensor(np.asarray(x0)),
                    tap=lambda k, v: taps_t.__setitem__(k, v.numpy()))
    assert sorted(taps_j) == sorted(taps_t) and len(taps_t) == 2 * DEPTH + 1
    for k in taps_j:
        assert taps_t[k].shape[-1] == C
        np.testing.assert_allclose(taps_t[k], np.asarray(taps_j[k]),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=k)


def test_forward_bf16_matches_jax(mesh):
    hj, ht, node_in, mask = (mesh[k] for k in ("hj", "ht", "node_in",
                                                "mask"))
    jcfg, state, sim = model(C, L)
    want = np.asarray(jax.jit(
        lambda ni, m: simulator_forward(state.params, state.norm_in,
                                        state.norm_out, hj, ni, m, jcfg,
                                        jnp.bfloat16)
    )(jnp.asarray(node_in), jnp.asarray(mask)))
    with torch.no_grad():
        got = sim(ht, torch.from_numpy(node_in), torch.from_numpy(mask),
                  torch.bfloat16).numpy()
    assert got.dtype == want.dtype == np.float32
    delta_scale = np.abs(want - node_in[:, :3]).max()
    assert np.abs(got - want).max() <= BF16_REL * delta_scale


def test_rollout_matches_jax(mesh):
    hj, ht, node_in, mask = (mesh[k] for k in ("hj", "ht", "node_in",
                                                "mask"))
    jcfg, state, sim = model(C, L)
    want = np.asarray(jax.jit(
        lambda ic, m: jax_rollout(state, hj, ic, m, 2, jcfg)
    )(jnp.asarray(node_in), jnp.asarray(mask)))
    got = rollout_trajectory(sim, ht, torch.from_numpy(node_in),
                             torch.from_numpy(mask), 2).numpy()
    assert got.shape == want.shape == (2, node_in.shape[0], 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2 * F32_TOL, atol=2 * F32_TOL)


# -- the train step --------------------------------------------------------------


def train_frame(mesh, seed=FRAME_SEED):
    """`test_torch_port_train.py`'s frame recipe on this mesh: seeded
    output fields and a target near them."""
    rng = np.random.default_rng(seed)
    node_in, mask = mesh["node_in"].copy(), mesh["mask"]
    real = mesh["hj"].levels[0].node_mask[:, 0] > 0
    node_in[real, :3] = rng.standard_normal((int(real.sum()), 3))
    tar = node_in[:, :3] + 0.1 * rng.standard_normal(
        node_in[:, :3].shape).astype(np.float32)
    return node_in, tar * (mask > 0) + node_in[:, :3] * (mask == 0)


_jax_steps = {}


def jax_step(mesh, c, layers):
    """`jax.value_and_grad` of JAX's loss on its `fused` method
    (interpret mode) at (c, layers), jitted once per shape: (params, node
    input, target, mask) → (loss, gradients)."""
    if (c, layers) not in _jax_steps:
        jcfg, state, _ = model(c, layers)
        jtr = JaxTrainer(JaxConfig(model=jcfg), init_key=jax.random.PRNGKey(0))
        _jax_steps[(c, layers)] = jax.jit(lambda p, *a: jax.value_and_grad(
            jtr._loss_fn)(p, state, mesh["hj"], *a))
    return _jax_steps[(c, layers)]


def jax_loss_grads(mesh, c, layers, node_in, target):
    """JAX's loss and every parameter's gradient (numpy) on a frame."""
    state = model(c, layers)[1]
    loss, grads = jax_step(mesh, c, layers)(
        state.params, *(jnp.asarray(a) for a in (node_in, target,
                                                 mesh["mask"])))
    return float(loss), {k: v.numpy()
                         for k, v in jax_param_grads(grads).items()}


def port_loss_grads(mesh, c, layers, node_in, target):
    """The port's loss and every parameter's gradient (numpy) through the
    plain versions of kernels 1-7."""
    sim = model(c, layers)[2]
    sim.zero_grad(set_to_none=True)
    ni, nt, m = (torch.from_numpy(a) for a in (node_in, target, mesh["mask"]))
    loss = masked_rmse(sim(mesh["ht"], ni, m), nt, m)
    loss.backward()
    got = {k: g.numpy().copy() for k, g in port_param_grads(sim).items()}
    sim.zero_grad(set_to_none=True)
    return loss.item(), got


def grad_misses(got, want):
    """{parameter: largest error over RMS} of the gradients off by more
    than GRAD_F32_TOL of their RMS."""
    out = {}
    for k, w in want.items():
        rms = np.sqrt(np.mean(w.astype(np.float64) ** 2))
        assert rms > 0, k
        err = np.abs(got[k] - w).max() / rms
        if err > GRAD_F32_TOL:
            out[k] = err
    return out


@pytest.mark.parametrize("c,layers", SHAPES)
def test_loss_and_gradients_match_jax(mesh, c, layers):
    """The masked RMSE and every parameter's gradient through the plain
    versions of kernels 1-7 against `jax.value_and_grad` of JAX's loss on
    its `fused` method (interpret mode)."""
    node_in, target = train_frame(mesh)
    loss_j, want = jax_loss_grads(mesh, c, layers, node_in, target)
    loss, got = port_loss_grads(mesh, c, layers, node_in, target)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    misses = grad_misses(got, want)
    assert not misses, {k: f"{e:.3e} of rms" for k, e in misses.items()}


@pytest.mark.parametrize("seed", SWEEP_SEEDS)
@pytest.mark.parametrize("c,layers", SHAPES)
def test_gradients_at_other_frames_miss_jax_only_at_kinks(mesh, c, layers,
                                                          seed):
    """At other frames the loss agrees as above, and every gradient agrees
    within GRAD_F32_TOL of its RMS or, where one misses (a ReLU input
    within rounding of zero that the two frameworks' orders of sums put on
    different sides), on a copy of the frame whose fields and positions
    each move by at most one f32 step: the port's gradient there is JAX's,
    so the miss is the kink's and not the port's. Up to NUDGES draws of the
    nudge (`tests/frame_seed_sweep.py`'s)."""
    node_in, target = train_frame(mesh, seed)
    loss_j, want = jax_loss_grads(mesh, c, layers, node_in, target)
    loss, got = port_loss_grads(mesh, c, layers, node_in, target)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    misses = grad_misses(got, want)
    rng = np.random.default_rng(seed)
    tries = 0
    while misses and tries < NUDGES:
        ni = node_in.copy()
        f = ni[:, :5]
        step = rng.integers(-1, 2, size=f.shape)
        moved = np.where(step > 0, np.nextafter(f, np.float32(np.inf)),
                         np.nextafter(f, np.float32(-np.inf)))
        ni[:, :5] = np.where((step != 0) & (f != 0), moved, f)
        misses = grad_misses(port_loss_grads(mesh, c, layers, ni, target)[1],
                             want)
        tries += 1
    assert not misses, (f"seed {seed}: after {tries} nudges",
                        {k: f"{e:.3e} of rms" for k, e in misses.items()})


@pytest.mark.parametrize("c,layers", SHAPES)
def test_trainer_matches_jax_trainer(mesh, c, layers):
    """The warmup gate (accumulation_steps=2), then 2 updates at a
    warmup-cosine rate, both fed the same noise draw each step: the losses,
    the normalizers after the gate and each parameter's update, in
    `test_torch_port_train.py::test_trainer_matches_jax_trainer`'s
    measures. JAX's trainer runs its plain `segment` aggregation, as
    there; the kernels' plain versions are held against its interpret-mode
    kernels in the gradient test above."""
    hj, ht, mask = mesh["hj"], mesh["ht"], mesh["mask"]
    node_in, target = train_frame(mesh)
    jcfg = model(c, layers)[0]
    opt_kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=6)
    jtr = JaxTrainer(JaxConfig(model=dataclasses.replace(
        jcfg, accumulation_steps=2, aggregation="segment"),
        opt=JaxOptConfig(**opt_kw)), init_key=jax.random.PRNGKey(3))
    tcfg = ModelConfig(latent_dim=c, hidden_layer=layers, unet_depth=DEPTH,
                       accumulation_steps=2, aggregation="fused")
    ttr = Trainer(Config(model=tcfg), OptConfig(**opt_kw), device="cpu")
    init = params_from_numpy(jax_to_nested(jtr.state.sim.params))
    ttr.sim.load_state_dict(init)

    ni, nt, m = (jnp.asarray(a) for a in (node_in, target, mask))
    ti, tt, tm = (torch.from_numpy(a) for a in (node_in, target, mask))
    key = jax.random.PRNGKey(7)
    losses_j, losses_t = [], []
    for i in range(4):
        k = jax.random.fold_in(key, i)
        z = torch.tensor(np.asarray(jax.random.normal(k, nt.shape, nt.dtype)))
        losses_j.append(float(jtr.iter(hj, ni, nt, m, k)))
        losses_t.append(float(ttr.iter(ht, ti, tt, tm, z)))
    assert ttr.step == jtr.step == 4 and ttr.updates == 2
    np.testing.assert_allclose(losses_t[:2], losses_j[:2], rtol=1e-6)
    np.testing.assert_allclose(losses_t[2:], losses_j[2:], rtol=1e-4)
    assert losses_t[2] != losses_t[3]  # the first update moved the model

    for name in ("norm_in", "norm_out"):
        want = normalizer_to_dict(getattr(jtr.state.sim, name))
        got = getattr(ttr.sim, name)
        for f in ("acc_weight", "num_accumulations", "e_x", "e_x2"):
            np.testing.assert_allclose(getattr(got, f).numpy(), want[f],
                                       rtol=1e-5, err_msg=f"{name}.{f}")
    want = jax_param_grads(jtr.state.sim.params)
    rates = sum(warmup_cosine_schedule(**opt_kw)(k) for k in range(2))
    for k, p in ttr.sim.state_dict().items():
        w, p0 = want[k].numpy(), init[k].numpy()
        diff = np.abs(p.numpy() - w)
        assert diff.max() <= 2 * rates, k
        assert (diff > 0.25 * rates).mean() <= 1e-3, k
        upd, upd_j = p.numpy() - p0, w - p0
        rms = np.sqrt(np.mean(upd_j.astype(np.float64) ** 2))
        assert rms > 0, k  # every tensor moved
        err = np.sqrt(np.mean((upd - upd_j).astype(np.float64) ** 2))
        assert err <= 1e-2 * rms, f"{k}: update rms err {err:.3e} of {rms:.3e}"


# -- kernels 1-7's plain versions at C = 256 -----------------------------------


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("which", ["down", "up"])
def test_windowed_rect_conv_at_256(mesh, dt, which):
    """Kernel 1's rect form on T0's operators against JAX's
    `windowed_rect_conv_raw` (interpret mode)."""
    opj = getattr(mesh["hj"].transitions[0], f"{which}_op")
    opt = getattr(mesh["ht"].transitions[0], f"{which}_op")
    x = np.random.default_rng(31).standard_normal(
        (opt.n_in_pad, C)).astype(np.float32)
    xj, xt = both(x, dt)
    got = windowed.windowed_rect_conv(opt, xt)
    assert got.shape == (opt.n_pad_nodes, C) and got.dtype == torch.float32
    assert_close(got, windowed_rect_conv_raw(opj, xj), SELECT_TOL[dt])


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("lvl", [0, 1])
def test_windowed_level_conv_at_256(mesh, dt, lvl):
    """Kernel 1's level form (the level's `ew`) against JAX's
    `windowed_conv_raw`."""
    lj, lt = mesh["hj"].levels[lvl], mesh["ht"].levels[lvl]
    x = np.random.default_rng(32 + lvl).standard_normal(
        (lt.n_pad_nodes, C)).astype(np.float32)
    xj, xt = both(x, dt)
    got = windowed.windowed_conv(lt, xt, lt.ew)
    assert got.shape == (lt.n_pad_nodes, C)
    assert_close(got, windowed_conv_raw(lj, xj, lj.ew), SELECT_TOL[dt])


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_compact_accum_at_256(mesh, dt):
    """Kernel 2 on level 0's compact residual against JAX's
    `compact_accum_raw`."""
    crj, crt = mesh["hj"].levels[0].cresid, mesh["ht"].levels[0].cresid
    rng = np.random.default_rng(34)
    vals = rng.standard_normal((crt.n_rows, C)).astype(np.float32)
    acc = rng.standard_normal((crt.n_pad_nodes, C)).astype(np.float32)
    vj, vt = both(vals, dt)
    got = compact_resid.compact_accum_raw(crt, vt, torch.tensor(acc))
    assert_close(got, jax_cr.compact_accum_raw(crj, vj, jnp.asarray(acc)),
                 SELECT_TOL[dt])


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("lvl", [0, 2])
def test_windowed_send_sum_at_256(mesh, dt, lvl):
    """Kernel 7 against JAX's `windowed_send_sum_raw`."""
    lj, lt = mesh["hj"].levels[lvl], mesh["ht"].levels[lvl]
    vals = np.random.default_rng(35 + lvl).standard_normal(
        (lt.n_pad_edges, C)).astype(np.float32)
    vj, vt = both(vals, dt)
    got = windowed.windowed_send_sum(lt, vt)
    assert got.shape == (lt.n_pad_nodes, C)
    assert_close(got, windowed_send_sum_raw(lj, vj), SELECT_TOL[dt])


@pytest.mark.parametrize("x_dt,dt", [("f32", "f32"), ("bf16", "bf16"),
                                     ("f32", "bf16")])
def test_node_phase_forward_and_vjp_at_256(mesh, x_dt, dt):
    """Kernels 3 and 6 (plain versions, through the autograd Function)
    against JAX's `fused_node_phase` and its `jax.vjp`, on the wide
    model's level-0 node MLP (four tail layers)."""
    jcfg, state, sim = model(C, L)
    n = mesh["ht"].levels[0].n_pad_nodes
    rng = np.random.default_rng(36)
    x = rng.standard_normal((n, C)).astype(np.float32)
    aggr = (3 * rng.standard_normal((n, C))).astype(np.float32)
    g = rng.standard_normal((n, C)).astype(np.float32)
    cd_j, cd_t = (None, None) if dt == "f32" else DTYPES[dt]
    mj = state.params.process.down_gmps[0].mlp_node
    assert len(mj.weights) == L + 1

    def f(xx, aa, ws, bs):
        return jax_node(xx, aa, dataclasses.replace(mj, weights=ws, biases=bs),
                        cd_j)

    y, vjp = jax.vjp(f, both(x, x_dt)[0], jnp.asarray(aggr), mj.weights,
                     mj.biases)
    dx, daggr, dws, dbs = vjp(jnp.asarray(g).astype(y.dtype))

    mt = sim.process.down_gmps[0].mlp_node
    mt.zero_grad(set_to_none=True)
    xt, at = leaf(x, x_dt), leaf(aggr, "f32")
    out = fused_node_phase(xt, at, mt, cd_t)
    tol = KERNEL_TOL[dt]
    assert_close(out, y, tol, "out")
    out.backward(torch.tensor(g).to(out.dtype))
    assert xt.grad.dtype == xt.dtype
    assert_close(xt.grad, dx, tol, "dx")
    assert_close(at.grad, daggr, tol, "daggr")
    for i in range(len(mt.weights)):
        assert_close(mt.weights[i].grad, dws[i], tol, f"dW{i}")
        assert_close(mt.biases[i].grad, dbs[i], tol, f"db{i}")
    mt.zero_grad(set_to_none=True)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fused_edge_phase_forward_and_backward_at_256(mesh, dt):
    """Kernels 4 and 5 (plain versions) and kernel 7 on dpre, through the
    autograd Function, against JAX's `fused_edge_phase_win` and its
    `jax.vjp` at level 0, on the wide model's level-0 edge tail."""
    hj, ht = mesh["hj"], mesh["ht"]
    jcfg, state, sim = model(C, L)
    n = ht.levels[0].n_pad_nodes
    rng = np.random.default_rng(37)
    xwi, xj, g = (rng.standard_normal((n, C)).astype(np.float32)
                  for _ in range(3))
    wf8 = (0.3 * rng.standard_normal((8, C))).astype(np.float32)
    mj = state.params.process.down_gmps[0].mlp_edge
    mt = sim.process.down_gmps[0].mlp_edge
    assert len(mj.weights) == L + 1

    def f(a, b, w8, ws, bs):
        return jax_edge(hj.levels[0], a, b, w8, ws, bs)

    y, vjp = jax.vjp(f, both(xwi, dt)[0], both(xj, dt)[0], jnp.asarray(wf8),
                     tuple(mj.weights[1:]), tuple(mj.biases[1:]))
    dxwi, dxj, dwf8, dws, dbs = vjp(jnp.asarray(g))

    a, b, w8 = leaf(xwi, dt), leaf(xj, dt), leaf(wf8, "f32")
    ws = [w.detach().clone().requires_grad_() for w in list(mt.weights)[1:]]
    bs = [x.detach().clone().requires_grad_() for x in list(mt.biases)[1:]]
    out = fused_edge_phase_win(ht.levels[0], a, b, w8, ws, bs)
    tol = KERNEL_TOL[dt]
    assert out.shape == (n, C)
    assert_close(out, y, tol, "aggr")
    out.backward(torch.tensor(g))
    assert_close(a.grad, dxwi, tol, "dxwi")
    assert_close(b.grad, dxj, tol, "dxj")
    assert_close(w8.grad, dwf8, tol, "dwf8")
    for i, (w, x) in enumerate(zip(ws, bs)):
        assert_close(w.grad, dws[i], tol, f"dW{i}")
        assert_close(x.grad, dbs[i], tol, f"db{i}")


# -- the refusal functions ---------------------------------------------------------


def test_walk_plans_fit_a_block_and_take_128_and_256():
    """Every (C, L, front, dtype) `walk_plan` accepts, forward and
    backward, fits a block's 232,448 bytes, and at least C ∈ {128, 256} ×
    L ∈ {1, ..., 4} is accepted with every front; what it refuses raises
    NotImplementedError naming C and L."""
    accepted = set()
    for c in (128, 256, 384, 512):
        for layers in range(1, 13):
            for front in fused_gmp.FRONTS:
                for dtype in (torch.float32, torch.bfloat16):
                    for bwd in (True, False):
                        try:
                            plan = fused_gmp.walk_plan(c, layers, front,
                                                       dtype, bwd)
                        except NotImplementedError as e:
                            assert (f"latent width {c} with {layers} tail "
                                    f"layers") in str(e)
                            continue
                        assert plan[0] == c
                        assert fused_gmp.walk_smem(
                            *plan, layers, front, bwd) <= fused_gmp.SMEM_MAX
                        accepted.add((c, layers, front, bwd))
    for c in (128, 256):
        for layers in range(1, 5):
            for front in fused_gmp.FRONTS:
                assert {(c, layers, front, True),
                        (c, layers, front, False)} <= accepted
    # The plans the walks took before this width: 64-slot tiles up to
    # three tail layers at 128.
    for layers in (1, 2, 3):
        assert fused_gmp.walk_plan(128, layers, "win", torch.float32) == (
            128, fused_gmp.TILE_ROWS, 64)
    assert fused_gmp.walk_plan(128, 4, "win", torch.float32)[1] == 32
    assert fused_gmp.walk_plan(256, 4, "dyn", torch.bfloat16)[1] == 32
    with pytest.raises(NotImplementedError, match="256 with 5 tail layers"):
        fused_gmp.walk_plan(256, 5, "win", torch.float32)


def test_node_plans_fit_a_block_and_take_128_and_256():
    for c in (128, 256, 384):
        for layers in range(1, 21):
            try:
                cl = node_mlp.node_plan(c, layers)
            except NotImplementedError as e:
                assert f"latent width {c} with {layers} tail layers" in str(e)
                continue
            assert cl == c // 32 <= 8
            assert node_mlp.bwd_smem(c, layers) <= fused_gmp.SMEM_MAX
    for c in (128, 256):
        for layers in range(1, 5):
            node_mlp.node_plan(c, layers)
    assert node_mlp.bwd_smem(256, 4) == 181248  # one CTA an SM
    with pytest.raises(NotImplementedError):
        node_mlp.node_plan(256, 11)


@pytest.mark.parametrize("c", [64, 200, 96])
def test_widths_off_128_are_refused_naming_ell_and_segment(c):
    for refuse in (lambda: fused_gmp.walk_plan(c, 3, "win", torch.float32),
                   lambda: node_mlp.node_plan(c, 3),
                   lambda: fused_gmp.check_width(c)):
        with pytest.raises(NotImplementedError,
                           match=r"latent width .*`ell` or `segment`"):
            refuse()


def test_the_cuda_sources_hold_the_same_plans():
    """`fused_gmp.BWD_PLANS` / `FWD_PLANS` and `SMEM_MAX` are the plans
    and the limit `csrc/edge_bwd_tiles.cuh` walks with, in the order
    `with_bwd_plan` tries them; kernels 1-3, 6 and 7 instantiate the
    widths of `windowed.WIDTHS` (`csrc/common.cuh`'s `with_width`)."""
    with open(os.path.join(CSRC, "edge_bwd_tiles.cuh")) as f:
        src = f.read()
    plans = dict(re.findall(r"using (\w+) = Plan<(\d+, \d+, \d+)>;", src))
    as_tuple = {k: tuple(int(v) for v in p.split(", "))
                for k, p in plans.items()}
    assert as_tuple == {"Base": (128, 64, 64), "Deep": (128, 32, 64),
                        "Wide": (256, 32, 16), "WideFwd": (256, 32, 32)}
    assert fused_gmp.BWD_PLANS == {
        128: (as_tuple["Base"], as_tuple["Deep"]), 256: (as_tuple["Wide"],)}
    assert fused_gmp.FWD_PLANS == {128: (as_tuple["Base"],),
                                   256: (as_tuple["WideFwd"],)}
    assert f"SMEM_MAX = {fused_gmp.SMEM_MAX};" in src
    with open(os.path.join(CSRC, "common.cuh")) as f:
        widths = re.findall(r"if \(width == (\d+)\) return fn", f.read())
    assert tuple(int(w) for w in widths) == windowed.WIDTHS == node_mlp.WIDTHS
    for name in ("windowed.cu", "windowed_send.cu", "compact_resid.cu",
                 "node_mlp.cu", "node_mlp_bwd.cu"):
        with open(os.path.join(CSRC, name)) as f:
            assert "with_width(width, " in f.read(), name


# -- convert.py --------------------------------------------------------------------


def test_params_round_trip_jax_port_jax_at_256_4():
    """`test_torch_port_weights.py::test_params_round_trip_jax_port_jax`'s
    check at latent 256 and four tail layers."""
    jcfg, state, sim = model(C, L)
    back = nested_to_jax(state.params, params_to_numpy(sim.state_dict()))
    a, b = jax.tree_util.tree_leaves(state.params), jax.tree_util.tree_leaves(back)
    assert len(a) == len(b) == len(sim.state_dict())
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        state.params)
    assert sim.state_dict()["process.bottom_gmp.mlp_edge.weights.4"].shape == (
        C, C)
