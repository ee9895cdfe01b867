"""The port's `ell` and `segment` methods (JAX's default aggregation and
its parity oracle) through the model against the JAX package on the CPU:
one GMP's output, input cotangent and every parameter gradient (with and
without a world-position stream); the `Simulator` forward, the masked
RMSE and every parameter's gradient at B = 1 and B = 2 on a windowed
hierarchy (the `ell` route ignores the windows, as JAX's does); world
edges through the explicit conv + pool transitions; a B = 3 bucketed
union against JAX's stacked, vmapped forward and each sample's own; and
`remat` on the `ell` route.

Cases: the GMPs and the world-edge model on a 16×16 grid (unwindowed,
depth 2, its level 0: 256 nodes); the simulator on
`test_torch_port_slice.py`'s scrambled 24×24 grid (depth 3, window 128,
edge_block 512, latent 128, hidden 2) with its frame and
`test_torch_port_batch_grads.py`'s B = 2 frames; the union on
`test_torch_port_stacked.py`'s batch (cylinder_flow cut to depth 2 and
hidden 1, meshes of 450, 600 and 450 nodes, window 256); JAX's side is
built with the plan's ELL widths (`for_mesh`) and the group's real
counts, as that file's is.

The GMP seeds leave every ReLU input of the real rows at least 3e-6 from
zero (asserted: the edge and node MLPs' hidden pre-activations), so no
unit lies within f32 rounding of its kink, where the two frameworks' sums
in other orders could flip it. The whole-model frames are the slice's
and the batch files', whose gradients land at the rounding level.

Tolerances, relative to the reference: the GMPs' outputs and gradients
1e-4 of the largest |value| (F32_TOL: f32 sums of up to 13 rows in other
orders through two MLPs); the prediction 5e-4 of its largest |value|
(the slice's); each gradient within 1e-3 of its RMS at its largest error
and the loss 1e-5 (`test_torch_port_train.py`'s); bf16 predictions within
2e-2 of the predicted delta's scale (BF16_REL). The pad rows (row
n_pad − 1 of each sample sums the pad slots under `segment`, which `ell`
leaves out) take no part in a real row and carry no loss; outputs are
compared on the real rows.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from conftest import make_grid_mesh
from test_torch_port_batch_grads import make_frames
from test_torch_port_slice import BF16_REL, F32_TOL as PRED_TOL
from test_torch_port_slice import case  # noqa: F401 (fixture)
from test_torch_port_stacked import ORDER, batch
from test_torch_port_train import GRAD_F32_TOL, jax_param_grads
from test_torch_port_variable_mesh import model
from test_torch_port_weights import (
    jax_state_with_stats,
    jax_to_nested,
    port_simulator,
)

from bsms_gnn_tpu.config import ModelConfig as JaxModelConfig
from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.models.simulator import (
    simulator_forward,
    simulator_forward_auto,
)
from bsms_gnn_tpu.ops.message import gmp_apply, init_gmp
from bsms_gnn_tpu.training.trainer import masked_rmse as jax_masked_rmse
from bsms_gnn_tpu_torch.config import flag_simple_config
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.ops.dense import dense, mlp_apply_tail
from bsms_gnn_tpu_torch.ops.message import GMP
from bsms_gnn_tpu_torch.ops.scatter import aggregate_recv
from bsms_gnn_tpu_torch.training.trainer import masked_rmse

C, HIDDEN, F32_TOL, LOSS_TOL = 128, 2, 1e-4, 1e-5
RELU_MARGIN = 3e-6
METHODS = ("ell", "segment")
WD = 3  # the world stream's width (flag_simple's)


@functools.lru_cache(maxsize=None)
def grid():
    """(JAX hierarchy, the port's on the CPU, positions) of a 16×16 grid,
    depth 2, unwindowed."""
    pos, cells = make_grid_mesh(16, 16)
    hj = jax_build(jax_flat_edge(cells, "tri"), 2, len(pos), pos)
    ht = to_device(build_hierarchy(to_flat_edge(cells, "tri"), 2, len(pos),
                                   pos), "cpu")
    return hj, ht, pos


def assert_close(got, want, tol, what):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    scale = max(1e-30, np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} * {scale:.3e}"


def assert_grads_close(got, want, tol=GRAD_F32_TOL):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w, g = w.numpy(), got[k].detach().numpy()
        rms = np.sqrt(np.mean(w.astype(np.float64) ** 2))
        if rms == 0:  # the bottom level's one node has no edge
            assert not g.any(), k
            continue
        err = np.abs(g - w).max()
        assert err <= tol * rms, f"{k}: {err:.3e} vs rms {rms:.3e}"


def _relu_inputs(mlp, pre):
    """The inputs of an MLP's ReLUs, its first layer's pre-activation
    `pre` first."""
    zs = [pre]
    for i in range(1, len(mlp.weights) - 1):
        zs.append(dense(torch.relu(zs[-1]), mlp.weights[i], mlp.biases[i]))
    return zs


def relu_margin(gmp, level, x, pos, method):
    """The smallest |ReLU input| of the GMP's edge and node MLPs over the
    real rows, from the port's own route."""
    pre = gmp._edge_pre(level, x, pos, None, method)
    aggr = aggregate_recv(level, mlp_apply_tail(gmp.mlp_edge, pre), method)
    wn = gmp.mlp_node.weights[0]
    node_pre = (dense(x, wn[:C], gmp.mlp_node.biases[0])
                + dense(aggr, wn[C:], 0.0))
    real_e, real_n = level.edge_mask > 0, level.node_mask[:, 0] > 0
    return float(min(
        [z[real_e].abs().min() for z in _relu_inputs(gmp.mlp_edge, pre)]
        + [z[real_n].abs().min()
           for z in _relu_inputs(gmp.mlp_node, node_pre)]))


@pytest.mark.parametrize("world", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_gmp_and_vjp_match_jax(method, world):
    """One GMP at level 0 (with `world`, fiber_dims (3, 2): the world
    stream's [Δworld, ‖Δworld‖] before the static fiber): the output on
    the real rows, the input cotangent and every parameter gradient (a
    seeded cotangent on the real rows) against `jax.vjp` of JAX's
    `gmp_apply` on the same method, f32."""
    hj, ht, _ = grid()
    lj, lt = hj.levels[0], ht.levels[0]
    fib = (WD, 2) if world else None
    pj = init_gmp(jax.random.PRNGKey(5 if world else 6), C, HIDDEN, 2, fib)
    gt = GMP(C, HIDDEN, 2, fiber_dims=fib)
    gt.load_state_dict(params_from_numpy(jax_to_nested(pj)))
    rng = np.random.default_rng(14)
    n, real = lt.n_pad_nodes, lt.n_nodes
    x = rng.standard_normal((n, C)).astype(np.float32)
    cot = np.zeros((n, C), np.float32)
    cot[:real] = rng.standard_normal((real, C))
    wpos = None
    if world:
        wpos = np.zeros((n, WD), np.float32)
        wpos[:real] = rng.standard_normal((real, WD))
    pos_t = None if wpos is None else torch.tensor(wpos)
    with torch.no_grad():
        margin = relu_margin(gt, lt, torch.tensor(x), pos_t, method)
    assert margin >= RELU_MARGIN, margin

    def out(xx, p):
        return gmp_apply(p, lj, xx, None if wpos is None else
                         jnp.asarray(wpos), method, None,
                         (WD,) if world else None)

    y, vjp = jax.vjp(out, jnp.asarray(x), pj)
    gx, gp = vjp(jnp.asarray(cot))
    gp = jax_to_nested(gp)
    xt = torch.tensor(x, requires_grad=True)
    got = gt(lt, xt, None, pos_t, method)
    assert_close(got[:real], y[:real], F32_TOL, "output")
    (got * torch.tensor(cot)).sum().backward()
    assert_close(xt.grad, gx, F32_TOL, "dx")
    for mlp in ("mlp_edge", "mlp_node"):
        mod = getattr(gt, mlp)
        for kind in ("weights", "biases"):
            for i, w in enumerate(gp[mlp][kind]):
                assert_close(getattr(mod, kind)[i].grad, w, F32_TOL,
                             f"{mlp}.{kind}.{i}")


def _jax_loss_and_grads(jcfg, state, h, node_in, target, mask):
    """((loss, prediction), gradients) of JAX's masked RMSE of
    `simulator_forward_auto` (the JAX trainer's loss), in one compile."""
    def loss(p, hh, ni, nt, m):
        pred = simulator_forward_auto(p, state.norm_in, state.norm_out, hh,
                                      ni, m, jcfg)
        return jax_masked_rmse(pred, nt, m), pred

    args = tuple(jnp.asarray(a) for a in (node_in, target, mask))
    (loss_j, pred_j), grads_j = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(state.params, h, *args)
    return float(loss_j), np.asarray(pred_j), grads_j


def _port_loss_and_grads(sim, h, node_in, target, mask):
    ni, nt, m = (torch.from_numpy(a) for a in (node_in, target, mask))
    sim.zero_grad(set_to_none=True)
    try:
        pred = sim(h, ni, m)
        loss = masked_rmse(pred, nt, m)
        loss.backward()
        return pred.detach(), loss.item(), {
            k: p.grad.detach().clone() for k, p in sim.named_parameters()}
    finally:
        sim.zero_grad(set_to_none=True)


@functools.lru_cache(maxsize=None)
def _slice_sims():
    """The slice case's model on each method, its weights and normalizers
    from one JAX state (`test_torch_port_slice.py`'s, with statistics)."""
    jcfg = JaxModelConfig(latent_dim=C, hidden_layer=2, unet_depth=3,
                          aggregation="ell")
    state = jax_state_with_stats(jcfg)
    from bsms_gnn_tpu_torch.config import ModelConfig

    sims = {m: port_simulator(ModelConfig(latent_dim=C, hidden_layer=2,
                                          unet_depth=3, aggregation=m),
                              state) for m in METHODS}
    return jcfg, state, sims


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("method", METHODS)
def test_simulator_loss_and_gradients_match_jax(case, method, b):  # noqa: F811
    """The `Simulator` forward on the slice's windowed hierarchy (one
    frame, or two frames over it: the batch axis), the masked RMSE and
    every parameter's gradient against `jax.value_and_grad` of the JAX
    trainer's loss, with `aggregation` set to `method` on both sides."""
    jcfg, state, sims = _slice_sims()
    jcfg = dataclasses.replace(jcfg, aggregation=method)
    hj, ht = case["hj"], case["ht"]
    node_in, target, mask = make_frames(
        case["node_in"], case["mask"],
        np.asarray(hj.levels[0].node_mask)[:, 0] > 0)
    if b == 1:
        node_in, target, mask = node_in[0], target[0], mask[0]
    loss_j, pred_j, grads_j = _jax_loss_and_grads(jcfg, state, hj, node_in,
                                                  target, mask)
    pred, loss, grads = _port_loss_and_grads(sims[method], ht, node_in,
                                             target, mask)
    real = np.asarray(ht.levels[0].node_mask)[:, 0] > 0
    np.testing.assert_allclose(pred.numpy()[..., real, :],
                               pred_j[..., real, :], rtol=PRED_TOL,
                               atol=PRED_TOL)
    np.testing.assert_allclose(loss, loss_j, rtol=LOSS_TOL)
    assert_grads_close(grads, jax_param_grads(grads_j))


@pytest.mark.parametrize("method", METHODS)
def test_simulator_bf16_matches_jax(case, method):  # noqa: F811
    """The bf16 forward (f32 weights, bf16 compute) against JAX's on the
    real rows, within BF16_REL of the predicted delta's scale."""
    jcfg, state, sims = _slice_sims()
    jcfg = dataclasses.replace(jcfg, aggregation=method)
    hj, ht = case["hj"], case["ht"]
    node_in, mask = case["node_in"], case["mask"]
    want = np.asarray(jax.jit(lambda ni, m: simulator_forward(
        state.params, state.norm_in, state.norm_out, hj, ni, m, jcfg,
        jnp.bfloat16))(jnp.asarray(node_in), jnp.asarray(mask)))
    with torch.no_grad():
        got = sims[method](ht, torch.from_numpy(node_in),
                           torch.from_numpy(mask), torch.bfloat16).numpy()
    real = np.asarray(ht.levels[0].node_mask)[:, 0] > 0
    scale = np.abs(want - node_in[:, :3])[real].max()
    assert np.abs(got - want)[real].max() <= BF16_REL * scale


@functools.lru_cache(maxsize=None)
def _world_case():
    """A world-edge model (flag_simple cut to depth 2, hidden 1) on the
    16×16 grid, one JAX state, and the contact recipe's frame: world x, y
    the mesh position, z = 0.05·N(0, 1); the target adds 0.1·sin(x) to
    z."""
    hj, ht, pos = grid()
    jcfg = JaxModelConfig(latent_dim=C, hidden_layer=1, unet_depth=2,
                          out_dim=3, pos_dim=2, world_edges=True,
                          world_dim=WD, aggregation="ell")
    state = jax_state_with_stats(jcfg)
    n, n_pad = len(pos), ht.levels[0].n_pad_nodes
    rng = np.random.default_rng(8)
    node_in = np.zeros((n_pad, 6), np.float32)
    node_in[:n, :2] = pos / 16.0
    node_in[:n, 2] = 0.05 * rng.standard_normal(n)
    node_in[:n, 3:5] = pos / 16.0
    target = node_in[:, :3].copy()
    target[:n, 2] += 0.1 * np.sin(node_in[:n, 0])
    mask = np.zeros((n_pad, 1), np.float32)
    mask[:n] = 1.0
    return hj, ht, jcfg, state, node_in, target, mask


@pytest.mark.parametrize("method", METHODS)
def test_world_edges_through_explicit_transitions_match_jax(method):
    """World edges on the `ell` / `segment` methods: the 3-wide world
    stream rides every down transition through the explicit conv + pool
    (JAX's `bsgmp.py:158-163`) and each up GMP reads its level's
    positions; the forward, the loss and every gradient against JAX's."""
    hj, ht, jcfg, state, node_in, target, mask = _world_case()
    jcfg = dataclasses.replace(jcfg, aggregation=method)
    tcfg = flag_simple_config(unet_depth=2, hidden_layer=1,
                              aggregation=method).model
    sim = port_simulator(tcfg, state)
    assert all(t.down_op is not None for t in ht.transitions)
    loss_j, pred_j, grads_j = _jax_loss_and_grads(jcfg, state, hj, node_in,
                                                  target, mask)
    pred, loss, grads = _port_loss_and_grads(sim, ht, node_in, target, mask)
    real = np.asarray(ht.levels[0].node_mask)[:, 0] > 0
    np.testing.assert_allclose(pred.numpy()[real], pred_j[real],
                               rtol=PRED_TOL, atol=PRED_TOL)
    np.testing.assert_allclose(loss, loss_j, rtol=LOSS_TOL)
    assert_grads_close(grads, jax_param_grads(grads_j))


@pytest.mark.parametrize("method", METHODS)
def test_bucketed_union_matches_jax_sample_by_sample(method):
    """A B = 3 batch on the union of its samples' bucketed hierarchies:
    the prediction against JAX's stacked, vmapped forward (real rows),
    the loss and every gradient against `jax.value_and_grad` on the stack;
    on `ell` also each sample against JAX's forward on its own mesh's
    hierarchy as built."""
    jcfg, tcfg, state, _ = model()
    jcfg = dataclasses.replace(jcfg, aggregation=method)
    sim = port_simulator(dataclasses.replace(tcfg.model, aggregation=method),
                         state)
    hstack, _, hd, jhs, node_in, target, mask, real = batch()
    loss_j, want, grads_j = _jax_loss_and_grads(jcfg, state, hstack,
                                                node_in, target, mask)
    pred, loss, grads = _port_loss_and_grads(sim, hd, node_in, target, mask)
    forward = jax.jit(lambda h, ni, m: simulator_forward(
        state.params, state.norm_in, state.norm_out, h, ni, m, jcfg))
    for s, i in enumerate(ORDER):
        k = real[s]
        np.testing.assert_allclose(pred.numpy()[s, :k], want[s, :k],
                                   rtol=PRED_TOL, atol=PRED_TOL)
        if method == "ell" and s == i:  # each mesh once
            own = np.asarray(forward(jhs[i], jnp.asarray(node_in[s]),
                                     jnp.asarray(mask[s])))
            np.testing.assert_allclose(pred.numpy()[s, :k], own[:k],
                                       rtol=PRED_TOL, atol=PRED_TOL)
    np.testing.assert_allclose(loss, loss_j, rtol=LOSS_TOL)
    assert_grads_close(grads, jax_param_grads(grads_j))


def test_remat_on_the_ell_route_changes_nothing(case):  # noqa: F811
    """`remat` (every GMP checkpointed) on the `ell` route: the forward and
    every gradient equal the step without it, bit for bit (the replayed
    forward is the same computation)."""
    _, _, sims = _slice_sims()
    sim = sims["ell"]
    ht, node_in, mask = case["ht"], case["node_in"], case["mask"]
    target = (node_in[:, :3] * 0.9).astype(np.float32)
    runs = []
    cfg = sim.cfg
    try:
        for remat in (False, True):
            sim.cfg = dataclasses.replace(cfg, remat=remat, remat_min_nodes=0)
            runs.append(_port_loss_and_grads(sim, ht, node_in, target, mask))
    finally:
        sim.cfg = cfg
    (p0, l0, g0), (p1, l1, g1) = runs
    assert l0 == l1
    torch.testing.assert_close(p0, p1, rtol=0, atol=0)
    for k in g0:
        torch.testing.assert_close(g0[k], g1[k], rtol=0, atol=0)
