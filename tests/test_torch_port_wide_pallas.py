"""The port's `pallas` path at the width and depth the TPU kernels take as
parameters, latent 256 and four tail layers (`hidden_layer=4`), against
the JAX package on the CPU: kernel 8 (receiver and sender forms) and
kernel 10 against the JAX Pallas kernels at C = 256 (`segment_sum.py:84`,
`agg_node.py:74`, interpret mode), kernel 10's refusal function, the
inflating-surface simulator forward in f32 (with taps) and bf16, a short
rollout, every f32 gradient against `jax.value_and_grad`, and `Trainer`
against the JAX `Trainer` over its warmup gate and two updates (on JAX's
plain `segment` aggregation, as `test_torch_port_pallas.py`'s).

Case: `test_torch_port_pallas.py`'s 600-node sphere, the default
unwindowed hierarchy of depth 3 with T0's dense forms dropped (so T0 runs
kernel 8), world edges, `inflating_font_config(latent_dim=256,
hidden_layer=4)`. The JAX results that several tests read are computed
once per module (fixtures). Tolerances are `test_torch_port_pallas.py`'s.
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

from test_torch_port_pallas import (
    BF16_REL,
    DTYPES,
    F32_TOL,
    GRAD_F32_TOL,
    KERNEL_TOL,
    SUM_TOL,
    sparse_t0,
)
from test_torch_port_train import assert_close, both, jax_param_grads, leaf
from test_torch_port_weights import (
    jax_state_with_stats,
    jax_to_nested,
    normalizer_to_dict,
    port_simulator,
)

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import DatasetConfig as JaxDatasetConfig
from bsms_gnn_tpu.config import ModelConfig as JaxModelConfig
from bsms_gnn_tpu.config import OptConfig as JaxOptConfig
from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.models.normalizer import normalize as jax_normalize
from bsms_gnn_tpu.models.simulator import simulator_forward, split_node_input
from bsms_gnn_tpu.ops.bsgmp import bsgmp_apply
from bsms_gnn_tpu.ops.dense import mlp_apply
from bsms_gnn_tpu.ops.pallas.agg_node import (
    fused_aggregate_node_phase as jax_agg_node,
)
from bsms_gnn_tpu.ops.pallas.segment_sum import (
    segment_sum_raw as jax_segment_sum,
)
from bsms_gnn_tpu.ops.pallas.segment_sum import segment_sum_send_pallas
from bsms_gnn_tpu.training.rollout import rollout_trajectory as jax_rollout
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import OptConfig, inflating_font_config
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.data.synthetic import (
    NT_NORMAL,
    generate_inflating_trajectory,
    make_sphere_mesh,
)
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.ops.kernels import agg_node
from bsms_gnn_tpu_torch.ops.kernels.agg_node import (
    fused_aggregate_node_phase,
    fused_aggregate_node_phase_plain,
)
from bsms_gnn_tpu_torch.ops.kernels.segment_sum import segment_sum_plain
from bsms_gnn_tpu_torch.training.rollout import rollout_trajectory
from bsms_gnn_tpu_torch.training.trainer import Trainer, masked_rmse

N_NODES, DEPTH, C, L = 600, 3, 256, 4
# One-step nudges of a frame the gradient comparison tries (see
# `gradients_meet_jax`).
NUDGES = 30


@pytest.fixture(scope="module")
def case():
    pos, cells, node_type = make_sphere_mesh(N_NODES, np.random.default_rng(0))
    n = len(pos)
    pos64 = pos.astype(np.float64)
    hj = jax_build(jax_flat_edge(cells, "tri"), DEPTH, n, pos64)
    hj = sparse_t0(hj, lambda o, **kw: o.replace(**kw))
    ht = build_hierarchy(to_flat_edge(cells, "tri"), DEPTH, n, pos64)
    ht = to_device(sparse_t0(ht, dataclasses.replace), "cpu")

    jcfg = JaxModelConfig(latent_dim=C, hidden_layer=L, unet_depth=DEPTH,
                          out_dim=3, pos_dim=3, world_edges=True,
                          aggregation="pallas")
    tcfg = inflating_font_config(unet_depth=DEPTH, latent_dim=C,
                                 hidden_layer=L).model
    state = jax_state_with_stats(jcfg)
    sim = port_simulator(tcfg, state)

    rng = np.random.default_rng(1)
    n_pad = ht.levels[0].n_pad_nodes
    node_in = np.zeros((n_pad, 7), np.float32)
    node_in[:n, :3] = 1.05 * pos + 0.02 * rng.standard_normal((n, 3))
    node_in[:n, 3:6] = pos
    node_in[:n, 6] = node_type[:, 0]
    mask = np.zeros((n_pad, 1), np.float32)
    mask[:n, 0] = node_type[:, 0] == NT_NORMAL
    return dict(hj=hj, ht=ht, jcfg=jcfg, state=state, sim=sim,
                node_in=node_in, mask=mask, n=n)


@pytest.fixture(autouse=True)
def _zero_grads(case):
    yield
    case["sim"].zero_grad(set_to_none=True)


def _level(case, where):
    """(JAX layout, port layout) by name: a level or T0's operators."""
    if where.startswith("level"):
        i = int(where[5:])
        return case["hj"].levels[i], case["ht"].levels[i]
    which = where.split("_")[1]
    return (getattr(case["hj"].transitions[0], f"{which}_op"),
            getattr(case["ht"].transitions[0], f"{which}_op"))


def test_the_wide_surface_reaches_the_kernels_at_256(case):
    """The wide model's node MLPs hold four [256, 256] tail layers and its
    first edge layer the world-edge rows; kernel 10's plan takes (256, 4)
    and T0 runs kernel 8 (no dense form)."""
    mlp = case["sim"].process.down_gmps[0].mlp_node
    assert mlp.weights[0].shape == (2 * C, C) and len(mlp.weights) == L + 1
    edge = case["sim"].process.down_gmps[0].mlp_edge
    assert edge.weights[0].shape == (2 * C + 8, C)
    assert agg_node.agg_plan(C, L) == tuple(agg_node.TILES)
    assert case["ht"].transitions[0].down_op.dense is None


# -- kernel 8 -----------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("form,where", [
    ("recv", "level0"), ("recv", "level3"), ("recv", "t0_down"),
    ("recv", "t0_up"), ("send", "level0"), ("send", "level2")])
def test_segment_sum_matches_jax_at_256(case, dt, form, where):
    """Every row, n_pad − 1 (the last block's pad slots) included."""
    lj, lt = _level(case, where)
    feat = np.random.default_rng(2).standard_normal(
        (lt.n_pad_edges, C)).astype(np.float32)
    fj, ft = both(feat, dt)
    if form == "send":
        want = segment_sum_send_pallas(lj, fj)
    else:
        want = jax_segment_sum(lj, fj)
    got = segment_sum_plain(lt, ft, send=form == "send")
    assert got.dtype == torch.float32 and got.shape == (lt.n_pad_nodes, C)
    assert_close(got, want, SUM_TOL, f"{form} {where}")


# -- kernel 10 ----------------------------------------------------------------


@pytest.mark.parametrize("x_dt,dt", [("f32", "f32"), ("bf16", "bf16"),
                                     ("f32", "bf16")])
@pytest.mark.parametrize("where", ["level0", "level2"])
def test_fused_aggregate_node_phase_matches_jax_at_256(case, x_dt, dt,
                                                       where):
    """dt is the compute dtype and the edge rows' (f32 x in bf16 compute
    is the level-0 GMP under io_dtype=float32); four tail layers."""
    lj, lt = _level(case, where)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    feat = (0.5 * rng.standard_normal((lt.n_pad_edges, C))).astype(np.float32)
    cd_j, cd_t = DTYPES[dt]
    lvl = int(where[5:])
    mj = case["state"].params.process.down_gmps[lvl].mlp_node
    mt = case["sim"].process.down_gmps[lvl].mlp_node
    want = jax_agg_node(lj, both(feat, dt)[0], both(x, x_dt)[0], mj, cd_j)
    with torch.no_grad():
        got = fused_aggregate_node_phase(lt, both(feat, dt)[1],
                                         both(x, x_dt)[1], mt, cd_t)
        plain = fused_aggregate_node_phase_plain(lt, both(feat, dt)[1],
                                                 both(x, x_dt)[1], mt, cd_t)
    assert str(want.dtype) == str(got.dtype).removeprefix("torch.")
    assert_close(got, want, KERNEL_TOL[dt], where)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


def test_fused_aggregate_node_phase_backward_at_256(case):
    """Through the autograd Function (kernel 8's plain version, kernel 6's,
    the gather): d_feat, dx and every node-MLP gradient against jax.vjp of
    the JAX kernel at C = 256, four tail layers, f32."""
    lj, lt = _level(case, "level1")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    feat = (0.5 * rng.standard_normal((lt.n_pad_edges, C))).astype(np.float32)
    g = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    mj = case["state"].params.process.down_gmps[1].mlp_node

    def f(ff, xx, ws, bs):
        return jax_agg_node(lj, ff, xx, dataclasses.replace(
            mj, weights=ws, biases=bs))

    _, vjp = jax.vjp(f, jnp.asarray(feat), jnp.asarray(x), mj.weights,
                     mj.biases)
    dfeat, dx, dws, dbs = vjp(jnp.asarray(g))
    mt = case["sim"].process.down_gmps[1].mlp_node
    ft, xt = leaf(feat, "f32"), leaf(x, "f32")
    fused_aggregate_node_phase(lt, ft, xt, mt).backward(torch.tensor(g))
    tol = KERNEL_TOL["f32"]
    assert_close(ft.grad, dfeat, tol, "dfeat")
    assert_close(xt.grad, dx, tol, "dx")
    for i in range(len(mt.weights)):
        assert_close(mt.weights[i].grad, dws[i], tol, f"dW{i}")
        assert_close(mt.biases[i].grad, dbs[i], tol, f"db{i}")


def test_agg_plan_takes_what_agg_node_cu_instantiates():
    """`agg_node.agg_plan` accepts exactly the widths `csrc/agg_node.cu`
    builds (its C entries dispatch on `with_width`, whose widths
    `csrc/common.cuh` lists) at every depth (the forward keeps no layer's
    activations: no depth bound in the source), on the tiles of the
    source's ROWS; a width that is not a multiple of 128 raises naming
    the kernel-free methods."""
    csrc = os.path.join(os.path.dirname(agg_node.__file__), "csrc")
    with open(os.path.join(csrc, "agg_node.cu")) as f:
        src = f.read()
    assert "return with_width(width, " in src
    rows = re.search(r"constexpr int ROWS\[3\] = \{(\d+), (\d+), RG \* "
                     r"CLUSTER_RT\};", src)
    assert rows and "constexpr int CLUSTER_RT = 1;" in src
    assert {k: v[1] for k, v in agg_node.TILES.items()} == {
        "block 64": int(rows[1]), "block 16": int(rows[2]),
        "cluster 16": 16}
    with open(os.path.join(csrc, "common.cuh")) as f:
        widths = re.findall(r"if \(width == (\d+)\) return fn", f.read())
    assert tuple(int(w) for w in widths) == agg_node.WIDTHS
    for c in range(128, 1025, 128):
        for layers in range(1, 21):
            if c in agg_node.WIDTHS:
                assert agg_node.agg_plan(c, layers) == tuple(agg_node.TILES)
            else:
                with pytest.raises(NotImplementedError,
                                   match=f"latent width {c} with {layers} "
                                         f"tail layers"):
                    agg_node.agg_plan(c, layers)
    with pytest.raises(NotImplementedError, match="`ell` or `segment`"):
        agg_node.agg_plan(200, 4)


@pytest.mark.parametrize("c", [384, 512])
def test_agg_plan_refuses_widths_the_kernel_is_not_built_for(c):
    """What `csrc/agg_node.cu` does not instantiate raises naming C and L
    before any launch (the kernel took 256 unchecked once)."""
    with pytest.raises(NotImplementedError,
                       match=f"latent width {c} with 4 tail layers"):
        agg_node.agg_plan(c, 4)


# -- the simulator ------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_forward(case):
    """JAX's f32 forward on the case's frame, and its per-level taps."""
    state, hj, jcfg = case["state"], case["hj"], case["jcfg"]
    node_in = jnp.asarray(case["node_in"])
    out = np.asarray(jax.jit(
        lambda ni, m: simulator_forward(state.params, state.norm_in,
                                        state.norm_out, hj, ni, m, jcfg)
    )(node_in, jnp.asarray(case["mask"])))
    latent, _, _ = split_node_input(node_in, jcfg.pos_dim)
    x0 = mlp_apply(state.params.encode, jax_normalize(state.norm_in, latent))

    def jax_taps(x, p):
        taps = {}
        bsgmp_apply(state.params.process, hj, x, p, method="pallas",
                    tap=taps.__setitem__, dyn_dims=(3,))
        return taps

    taps = jax.jit(jax_taps)(x0, node_in[:, :3])
    return out, np.asarray(x0), {k: np.asarray(v) for k, v in taps.items()}


def test_forward_f32_matches_jax_with_taps(case, jax_forward):
    node_in, mask, sim, ht = (case[k] for k in ("node_in", "mask", "sim",
                                                 "ht"))
    want, x0, taps_j = jax_forward
    with torch.no_grad():
        got = sim(ht, torch.from_numpy(node_in), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    taps_t = {}
    with torch.no_grad():
        sim.process(ht, torch.tensor(x0),
                    tap=lambda k, v: taps_t.__setitem__(k, v.numpy()),
                    pos=torch.from_numpy(node_in[:, :3]), method="pallas")
    assert sorted(taps_j) == sorted(taps_t) and len(taps_t) == 2 * DEPTH + 1
    for k in taps_j:
        np.testing.assert_allclose(taps_t[k], taps_j[k], rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=k)


def test_forward_bf16_matches_jax(case):
    node_in, mask, sim, ht = (case[k] for k in ("node_in", "mask", "sim",
                                                 "ht"))
    state, hj, jcfg = case["state"], case["hj"], case["jcfg"]
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
    assert delta_scale > 0
    assert np.abs(got - want).max() <= BF16_REL * delta_scale


def test_rollout_matches_jax(case):
    hj, ht, jcfg, state, sim = (case[k] for k in
                                ("hj", "ht", "jcfg", "state", "sim"))
    node_in, mask = case["node_in"], case["mask"]
    want = np.asarray(jax.jit(
        lambda ic, m: jax_rollout(state, hj, ic, m, 2, jcfg)
    )(jnp.asarray(node_in), jnp.asarray(mask)))
    got = rollout_trajectory(sim, ht, torch.from_numpy(node_in),
                             torch.from_numpy(mask), 2).numpy()
    assert got.shape == want.shape == (2, node_in.shape[0], 3)
    np.testing.assert_allclose(got, want, rtol=2 * F32_TOL, atol=2 * F32_TOL)


# -- training -----------------------------------------------------------------


@pytest.fixture(scope="module")
def frames(case):
    """A frame pair of `generate_inflating_trajectory` on the case's mesh:
    node_in at frame 0, the target frame 1 (world positions)."""
    traj = generate_inflating_trajectory(N_NODES, 2, np.random.default_rng(0))
    n, n_pad = case["n"], case["node_in"].shape[0]
    node_in = np.zeros((n_pad, 7), np.float32)
    node_in[:n, :3] = traj["world_pos"][0]
    node_in[:n, 3:] = case["node_in"][:n, 3:]
    target = np.zeros((n_pad, 3), np.float32)
    target[:n] = traj["world_pos"][1]
    return node_in, target


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


def nudged(frame, rng, fields):
    """The frame with each of its first `fields` columns' nonzero entries
    moved up, down or not by one f32 step, at random."""
    ni = frame.copy()
    f = ni[:, :fields]
    step = rng.integers(-1, 2, size=f.shape)
    moved = np.where(step > 0, np.nextafter(f, np.float32(np.inf)),
                     np.nextafter(f, np.float32(-np.inf)))
    ni[:, :fields] = np.where((step != 0) & (f != 0), moved, f)
    return ni


def meets_jax(misses_at, node_in, fields, nudges=NUDGES):
    """Whether the port meets JAX on the frame `node_in` itself or, where
    it misses, on one of up to `nudges` copies whose first `fields` columns
    move by one f32 step (`nudged`, seed 0), both frameworks on the same
    copy: `misses_at(frame)` gives what misses on a frame (empty: met). At
    latent 256 with four tail layers a frame holds ReLU inputs within f32
    rounding of zero that the two frameworks' orders of sums put on
    different sides, and JAX's own gradients and updates move by as much
    between the frame and such a copy (PERF.md §6). Asserts, naming what
    missed at the last copy tried."""
    misses = misses_at(node_in)
    rng, tries = np.random.default_rng(0), 0
    while misses and tries < nudges:
        misses = misses_at(nudged(node_in, rng, fields))
        tries += 1
    assert not misses, (f"after {tries} nudges", misses)


def gradients_meet_jax(jax_fn, port_fn, node_in, fields):
    """The loss and every gradient of the port against JAX's
    (GRAD_F32_TOL of each one's RMS), `meets_jax`."""
    def misses_at(ni):
        loss_j, want = jax_fn(ni)
        loss, got = port_fn(ni)
        np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
        assert sorted(got) == sorted(want)
        return {k: f"{e:.3e} of rms" for k, e in grad_misses(got,
                                                             want).items()}

    meets_jax(misses_at, node_in, fields)


def trainer_misses(case, tcfg, node_in, target):
    """What misses between the port's `Trainer` and JAX's on a frame: the
    warmup gate (accumulation_steps=2), then 2 updates, both fed the same
    noise draw each step (the config's noise); per-step losses (1e-6
    through the gate, 1e-4 after), the normalizer states after the gate,
    each tensor's update (its RMS error within 1e-2 of its RMS). JAX's
    trainer runs its plain `segment` aggregation."""
    hj, ht, jcfg, mask = case["hj"], case["ht"], case["jcfg"], case["mask"]
    opt_kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=6)
    jtr = JaxTrainer(JaxConfig(
        model=dataclasses.replace(jcfg, accumulation_steps=2,
                                  aggregation="segment"),
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
    for i in range(4):
        k = jax.random.fold_in(key, i)
        z = torch.tensor(np.asarray(jax.random.normal(k, nt.shape, nt.dtype)))
        losses_j.append(float(jtr.iter(hj, ni, nt, m, k)))
        losses_t.append(float(ttr.iter(ht, ti, tt, tm, z)))
    assert ttr.step == jtr.step == 4 and ttr.updates == 2
    np.testing.assert_allclose(losses_t[:2], losses_j[:2], rtol=1e-6)
    out = {}
    if not np.allclose(losses_t[2:], losses_j[2:], rtol=1e-4, atol=0):
        out["losses"] = (losses_t, losses_j)
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
        if err > 1e-2 * rms:
            out[k] = f"update rms err {err:.3e} of {rms:.3e}"
    return out


@pytest.fixture(scope="module")
def jax_step(case):
    """`jax.value_and_grad` of JAX's loss on its `pallas` method
    (interpret mode), jitted once."""
    jtr = JaxTrainer(JaxConfig(model=case["jcfg"]),
                     init_key=jax.random.PRNGKey(0))
    return jax.jit(lambda p, *a: jax.value_and_grad(jtr._loss_fn)(
        p, case["state"], case["hj"], *a))


def test_loss_and_gradients_match_jax(case, frames, jax_step):
    """The masked RMSE and every parameter's gradient (`gradients_meet_
    jax`). At the trajectory's frame JAX's own gradients of four edge
    tail weights move by 1.5e-3 to 2.8e-3 of their RMS under one-step
    nudges, and the port's miss it there by as much."""
    (node_in, target), mask = frames, case["mask"]
    sim, ht, state = case["sim"], case["ht"], case["state"]

    def jax_fn(ni):
        loss, grads = jax_step(state.params, *(
            jnp.asarray(a) for a in (ni, target, mask)))
        return float(loss), {k: v.numpy()
                             for k, v in jax_param_grads(grads).items()}

    def port_fn(ni):
        sim.zero_grad(set_to_none=True)
        ni, nt, m = (torch.from_numpy(a) for a in (ni, target, mask))
        loss = masked_rmse(sim(ht, ni, m), nt, m)
        loss.backward()
        got = {k: p.grad.numpy().copy() for k, p in sim.named_parameters()}
        sim.zero_grad(set_to_none=True)
        return loss.item(), got

    gradients_meet_jax(jax_fn, port_fn, node_in, 3)


def test_trainer_matches_jax_trainer(case, frames):
    """`trainer_misses` on the trajectory's frame (`meets_jax`): kernels 8
    and 10's plain versions are held against JAX's interpret-mode kernels
    above."""
    node_in, target = frames
    tcfg = inflating_font_config(unet_depth=DEPTH, latent_dim=C,
                                 hidden_layer=L, accumulation_steps=2)
    meets_jax(lambda ni: trainer_misses(case, tcfg, ni, target), node_in, 3)
