"""The port's contact case (flag_simple's recipe: world-space edges on the
windowed `fused` method) at latent 256 with four tail layers
(`hidden_layer=4`), against the JAX package on the CPU: kernel 13's plain
forward (f32, bf16) and backward (f32) against JAX's v4 kernel at C = 256
(`fused_edge_phase_win_dyn`, interpret mode), the simulator forward in
f32 (with taps) and bf16, a short rollout, every f32 gradient against
`jax.value_and_grad`, `Trainer` against the JAX `Trainer` over its warmup
gate and two updates (on JAX's plain `segment` aggregation), and
`convert.py`'s round trip on the world-edge layout. Before latent 256
reached kernel 13, the port's first forward of this model raised
`latent width 256: kernel 13 takes 128` on the CPU too.

Case: `test_torch_port_contact.py`'s Morton-ordered 520-node strip (depth
2, window 256, edge_block 512; level 0 and T0's down operator carry a
compact residual) and its frames, `flag_simple_config(latent_dim=256,
hidden_layer=4)`. Tolerances are `test_torch_port_contact.py`'s; the
gradients are held as `test_torch_port_wide_pallas.py` holds them
(`gradients_meet_jax`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_contact import (
    BF16_REL,
    F32_TOL,
    KERNEL_TOL,
    LAYOUT,
    N_NODES,
    NY,
    WD,
    world_frames,
)
from test_torch_port_train import assert_close, jax_param_grads, leaf
from test_torch_port_weights import (
    jax_state_with_stats,
    nested_to_jax,
    port_simulator,
)
from test_torch_port_wide_pallas import (
    gradients_meet_jax,
    meets_jax,
    trainer_misses,
)

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import ModelConfig as JaxModelConfig
from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.models.normalizer import normalize as jax_normalize
from bsms_gnn_tpu.models.simulator import simulator_forward, split_node_input
from bsms_gnn_tpu.ops.bsgmp import bsgmp_apply
from bsms_gnn_tpu.ops.dense import mlp_apply
from bsms_gnn_tpu.ops.pallas.fused_gmp import (
    fused_edge_phase_win_dyn as jax_edge_dyn,
)
from bsms_gnn_tpu.training.rollout import rollout_trajectory as jax_rollout
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import flag_simple_config
from bsms_gnn_tpu_torch.convert import params_to_numpy
from bsms_gnn_tpu_torch.data.synthetic import NT_NORMAL, make_grid_strip_mesh
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.graph.order import reorder_mesh
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp_dyn import (
    fused_edge_phase_win_dyn,
    fused_edge_phase_win_dyn_bwd_plain,
    fused_edge_phase_win_dyn_plain,
)
from bsms_gnn_tpu_torch.ops.kernels.windowed import windowed_send_sum_plain
from bsms_gnn_tpu_torch.training.rollout import rollout_trajectory
from bsms_gnn_tpu_torch.training.trainer import masked_rmse

DEPTH, C, L = 2, 256, 4


@pytest.fixture(scope="module")
def case():
    pos, cells, node_type = make_grid_strip_mesh(N_NODES, ny=NY)
    pos, cells, (node_type,), _ = reorder_mesh(pos, cells, (node_type,))
    n = len(pos)
    pos64 = pos.astype(np.float64)
    hj = jax_build(jax_flat_edge(cells, "tri"), DEPTH, n, pos64, **LAYOUT)
    ht = to_device(build_hierarchy(to_flat_edge(cells, "tri"), DEPTH, n,
                                   pos64, **LAYOUT), "cpu")
    jcfg = JaxModelConfig(latent_dim=C, hidden_layer=L, unet_depth=DEPTH,
                          out_dim=3, pos_dim=2, world_edges=True,
                          world_dim=WD, aggregation="fused")
    tcfg = flag_simple_config(unet_depth=DEPTH, latent_dim=C,
                              hidden_layer=L).model
    state = jax_state_with_stats(jcfg)
    sim = port_simulator(tcfg, state)

    n_pad = ht.levels[0].n_pad_nodes
    world, target = world_frames(pos, n_pad)
    node_in = np.zeros((n_pad, 6), np.float32)
    node_in[:, :3] = world
    node_in[:n, 3:5] = pos
    node_in[:n, 5] = node_type[:, 0]
    mask = np.zeros((n_pad, 1), np.float32)
    mask[:n, 0] = node_type[:, 0] == NT_NORMAL
    return dict(hj=hj, ht=ht, jcfg=jcfg, state=state, sim=sim,
                node_in=node_in, target=target, mask=mask, n=n)


@pytest.fixture(autouse=True)
def _zero_grads(case):
    yield
    case["sim"].zero_grad(set_to_none=True)


def test_the_wide_flag_takes_kernel_13s_plans(case):
    """Four [256, 256] tail layers after the first edge layer's world-edge
    rows [Δworld 3, ‖Δworld‖, Δmesh 2, ‖Δmesh‖, x_i, x_j]; kernel 13's
    forward and backward walks hold (256, 4) (`WideFwd`, `Wide`)."""
    edge = case["sim"].process.down_gmps[0].mlp_edge
    assert edge.weights[0].shape == (2 * C + 7, C)
    assert len(edge.weights) == L + 1
    for bwd in (False, True):
        assert fused_gmp.walk_plan(C, L, "dyn", torch.float32, bwd)[:2] == (
            C, 32)


# -- kernel 13 ----------------------------------------------------------------


def _kernel_inputs(lt, seed):
    rng = np.random.default_rng(seed)
    n = lt.n_pad_nodes
    xwi, xj, g = (rng.standard_normal((n, C)).astype(np.float32)
                  for _ in range(3))
    wpos = np.zeros((n, WD), np.float32)
    wpos[:lt.n_nodes] = rng.standard_normal((lt.n_nodes, WD))
    wf8, wfd = ((0.3 * rng.standard_normal(s)).astype(np.float32)
                for s in ((8, C), (WD, C)))
    wfn = (0.3 * rng.standard_normal(C)).astype(np.float32)
    return xwi, xj, g, wpos, wf8, wfd, wfn


def _jax_dyn(lj, wpos, ws, bs):
    """JAX's v4 kernel at C = 256 as a function of (xwi, xj, wf8, wf_dyn
    [wd, C], wf_nrm [C]), on its extended [N, 2C] tables and [C, C] / [8,
    C] weight blocks, as `gmp_apply` builds them."""

    def f(xwi, xj, wf8, wfd, wfn):
        def ext(a):
            pad = jnp.zeros(a.shape[:-1] + (C - WD,), a.dtype)
            return jnp.concatenate([a, wpos.astype(a.dtype), pad], axis=-1)

        wfd_ext = jnp.zeros((C, C), jnp.float32).at[:WD].set(wfd)
        wfn8 = jnp.zeros((8, C), jnp.float32).at[0].set(wfn)
        return jax_edge_dyn(lj, ext(xwi), ext(xj), wf8, wfd_ext, wfn8, ws, bs,
                            WD)

    return f


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_kernel13_forward_matches_jax_at_256(case, dt):
    hj, ht, state, sim = (case[k] for k in ("hj", "ht", "state", "sim"))
    lj, lt = hj.levels[0], ht.levels[0]
    xwi, xj, _, wpos, wf8, wfd, wfn = _kernel_inputs(lt, 21)
    mj = state.params.process.down_gmps[0].mlp_edge
    mt = sim.process.down_gmps[0].mlp_edge
    jd = jnp.bfloat16 if dt == "bf16" else jnp.float32
    td = torch.bfloat16 if dt == "bf16" else torch.float32
    want = _jax_dyn(lj, jnp.asarray(wpos).astype(jd), tuple(mj.weights[1:]),
                    tuple(mj.biases[1:]))(
        jnp.asarray(xwi).astype(jd), jnp.asarray(xj).astype(jd),
        jnp.asarray(wf8), jnp.asarray(wfd), jnp.asarray(wfn))
    fused_edge_phase_win_dyn_plain.calls = 0
    with torch.no_grad():
        got = fused_edge_phase_win_dyn(
            lt, torch.tensor(xwi).to(td), torch.tensor(xj).to(td),
            torch.tensor(wpos).to(td), torch.tensor(wf8), torch.tensor(wfd),
            torch.tensor(wfn), list(mt.weights)[1:], list(mt.biases)[1:])
    assert fused_edge_phase_win_dyn_plain.calls == 1
    assert got.dtype == torch.float32 and got.shape == (lt.n_pad_nodes, C)
    assert_close(got, want, KERNEL_TOL[dt], dt)


def test_kernel13_backward_matches_jax_vjp_at_256(case):
    """The plain backward through the autograd Function (then kernel 7's
    plain version on dpre): dxwi, dxj, dwf8, dwf_dyn, dwf_nrm, dW, db
    against jax.vjp of JAX's v4 kernel at C = 256, four tail layers,
    f32; dpre is zero on masked slots and its sender sum is dxwi."""
    hj, ht, state, sim = (case[k] for k in ("hj", "ht", "state", "sim"))
    lj, lt = hj.levels[0], ht.levels[0]
    xwi, xj, g, wpos, wf8, wfd, wfn = _kernel_inputs(lt, 22)
    mj = state.params.process.down_gmps[0].mlp_edge
    mt = sim.process.down_gmps[0].mlp_edge
    args = tuple(jnp.asarray(a) for a in (xwi, xj, wf8, wfd, wfn))
    ws_j, bs_j = tuple(mj.weights[1:]), tuple(mj.biases[1:])

    def full(a, b, w8, wd_, wn, ws, bs):
        return _jax_dyn(lj, jnp.asarray(wpos), ws, bs)(a, b, w8, wd_, wn)

    _, vjp = jax.vjp(full, *args, ws_j, bs_j)
    dxwi, dxj, dwf8, dwfd, dwfn, dws, dbs = vjp(jnp.asarray(g))

    a, b = leaf(xwi, "f32"), leaf(xj, "f32")
    w8, wd_, wn = leaf(wf8, "f32"), leaf(wfd, "f32"), leaf(wfn, "f32")
    ws = [w.detach().clone().requires_grad_() for w in list(mt.weights)[1:]]
    bs = [x.detach().clone().requires_grad_() for x in list(mt.biases)[1:]]
    out = fused_edge_phase_win_dyn(lt, a, b, torch.tensor(wpos), w8, wd_, wn,
                                   ws, bs)
    out.backward(torch.tensor(g))
    tol = KERNEL_TOL["f32"]
    assert_close(a.grad, dxwi, tol, "dxwi")
    assert_close(b.grad, dxj, tol, "dxj")
    assert_close(w8.grad, dwf8, tol, "dwf8")
    assert_close(wd_.grad, dwfd, tol, "dwf_dyn")
    assert_close(wn.grad, dwfn, tol, "dwf_nrm")
    assert len(ws) == L
    for i, (w, x) in enumerate(zip(ws, bs)):
        assert_close(w.grad, dws[i], tol, f"dW{i}")
        assert_close(x.grad, dbs[i], tol, f"db{i}")

    with torch.no_grad():
        dpre = fused_edge_phase_win_dyn_bwd_plain(
            lt, a, b, torch.tensor(wpos), w8, wd_, wn, ws, bs,
            torch.tensor(g))[0]
    assert dpre.shape == (lt.n_pad_edges, C)
    assert (dpre[lt.send_win >= lt.window] == 0).all()
    torch.testing.assert_close(windowed_send_sum_plain(lt, dpre), a.grad,
                               rtol=1e-6, atol=1e-6)


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
        bsgmp_apply(state.params.process, hj, x, p, method="fused",
                    tap=taps.__setitem__, dyn_dims=(WD,))
        return taps

    taps = jax.jit(jax_taps)(x0, node_in[:, :WD])
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
                    pos=torch.from_numpy(node_in[:, :WD]), method="fused")
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


def test_loss_and_gradients_match_jax(case):
    """The masked RMSE and every parameter's gradient against JAX's on its
    `fused` method (v4 in interpret mode), `gradients_meet_jax`: the world
    frame's three columns nudged where a gradient misses."""
    hj, ht, jcfg, state, sim = (case[k] for k in
                                ("hj", "ht", "jcfg", "state", "sim"))
    target, mask = case["target"], case["mask"]
    jtr = JaxTrainer(JaxConfig(model=jcfg), init_key=jax.random.PRNGKey(0))
    step = jax.jit(lambda p, *a: jax.value_and_grad(jtr._loss_fn)(
        p, state, hj, *a))

    def jax_fn(ni):
        loss, grads = step(state.params, *(jnp.asarray(a)
                                           for a in (ni, target, mask)))
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

    gradients_meet_jax(jax_fn, port_fn, case["node_in"], WD)


def test_trainer_matches_jax_trainer(case):
    """`trainer_misses` with flag_simple's noise (`meets_jax`): on the
    case's frame JAX's own update of the first up GMP's first edge bias
    moves by 1.1e-2 of its RMS under a one-step nudge of the world frame,
    and the port's misses it there by 1.0e-2; kernel 13's plain version is
    held against JAX's interpret-mode v4 above."""
    tcfg = flag_simple_config(unet_depth=DEPTH, latent_dim=C, hidden_layer=L,
                              accumulation_steps=2)
    meets_jax(lambda ni: trainer_misses(case, tcfg, ni, case["target"]),
              case["node_in"], WD)


# -- convert.py ---------------------------------------------------------------


def test_params_round_trip_jax_port_jax_at_256_4_world_edges(case):
    """`test_torch_port_weights.py::test_params_round_trip_jax_port_jax`'s
    check on the world-edge layout at latent 256 and four tail layers:
    JAX → port → JAX gives every leaf back bit for bit, in JAX's tree."""
    state, sim = case["state"], case["sim"]
    back = nested_to_jax(state.params, params_to_numpy(sim.state_dict()))
    a = jax.tree_util.tree_leaves(state.params)
    b = jax.tree_util.tree_leaves(back)
    assert len(a) == len(b) == len(sim.state_dict())
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        state.params)
    sd = sim.state_dict()
    assert sd["process.down_gmps.0.mlp_edge.weights.0"].shape == (2 * C + 7, C)
    assert sd["process.bottom_gmp.mlp_edge.weights.4"].shape == (C, C)
