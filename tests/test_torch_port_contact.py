"""The port's contact case against the JAX package on the CPU: world-space
edges on the windowed `fused` method (flag_simple's recipe). Kernel 13's
plain forward (f32, bf16) and backward (f32) against the JAX v4 kernel
(`fused_edge_phase_win_dyn`, interpret mode), the world-edge GMP (output
and every gradient; and with a 6-wide stream, which the port routes to
v1, against JAX's v4), the 3-wide world stream through windowed transitions,
the simulator forward in f32 (with taps) and bf16, rollout, every f32
gradient against `jax.value_and_grad`, and `Trainer` against the JAX
`Trainer` (on JAX's plain `segment` aggregation) with flag_simple's noise
(σ 0.003, γ 0.1).

Case: a Morton-ordered cloth strip (`make_grid_strip_mesh(520, ny=13)`,
520 nodes), windowed hierarchy of depth 2 (window 256, edge_block 512),
the flag_simple model cut to latent 128, hidden 1, world 3, pos 2. Level 0
has a compact residual (148 rows) and so has T0's down operator, so the
residual's world-space term runs. World frames follow the JAX package's
contact recipe (`tests/test_windowed.py:546-559`): world x, y = the mesh
position, z = 0.05·N(0, 1); the target adds 0.1·sin(x) to z.

The JAX results are computed once per module (fixtures), since the v4
kernel runs in interpret mode.

Tolerances, relative to the largest |value| of the reference unless said
otherwise:
- kernel 13 and the GMP (`KERNEL_TOL`): f32 sums in another order through
  the MLPs (1e-4); in bf16 both sides round the same operands (the
  positions, Δ, the hidden activations), and an f32 sum in another order
  can put an intermediate on the other side of a bf16 rounding step (2^-8
  relative), so 2e-2;
- the world-stream transitions (`SUM_TOL`): sums of the same f32 products
  in another order;
- the forward and rollout, f32: 5e-4; bf16: 2e-2 of the predicted delta's
  scale;
- gradients: each within 1e-3 of its RMS (f32);
- the trainer: losses 1e-6 through the gate (no model runs), 1e-4 after
  the updates; each tensor's update within 1e-2 of its RMS.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

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
from bsms_gnn_tpu.data.synthetic import make_grid_strip_mesh as jax_strip
from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.models.normalizer import normalize as jax_normalize
from bsms_gnn_tpu.models.simulator import simulator_forward, split_node_input
from bsms_gnn_tpu.ops.bsgmp import bsgmp_apply
from bsms_gnn_tpu.ops.dense import mlp_apply
from bsms_gnn_tpu.ops.message import gmp_apply, init_gmp
from bsms_gnn_tpu.ops.pallas.fused_gmp import (
    fused_edge_phase_win_dyn as jax_edge_dyn,
)
from bsms_gnn_tpu.ops.transition import trans_down as jax_trans_down
from bsms_gnn_tpu.training.rollout import rollout_trajectory as jax_rollout
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import OptConfig, flag_simple_config
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.data.synthetic import NT_NORMAL, make_grid_strip_mesh
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.graph.order import reorder_mesh
from bsms_gnn_tpu_torch.ops import transition
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp_dyn import (
    fused_edge_phase_win_dyn,
    fused_edge_phase_win_dyn_bwd_plain,
    fused_edge_phase_win_dyn_plain,
)
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp_stream import (
    fused_edge_mlp_aggregate_bwd_plain,
    fused_edge_mlp_aggregate_plain,
)
from bsms_gnn_tpu_torch.ops.kernels.windowed import windowed_send_sum_plain
from bsms_gnn_tpu_torch.ops.message import GMP
from bsms_gnn_tpu_torch.ops.transition import trans_down
from bsms_gnn_tpu_torch.training.rollout import rollout_trajectory
from bsms_gnn_tpu_torch.training.trainer import Trainer, masked_rmse

N_NODES, NY, DEPTH, HIDDEN, C, WD = 520, 13, 2, 1, 128, 3
WIDE_WD = 6  # a world stream wider than kernel 13 takes (MAX_WD = 4)
LAYOUT = dict(edge_block=512, window=256)
SUM_TOL = 1e-5
KERNEL_TOL = {"f32": 1e-4, "bf16": 2e-2}
F32_TOL = 5e-4
BF16_REL = 2e-2
GRAD_F32_TOL = 1e-3


def world_frames(pos, n_pad, seed=0):
    """The contact recipe's frame pair on the strip, padded to n_pad:
    world (x, y, 0.05·N(0, 1)) and the target with 0.1·sin(x) added to
    z."""
    n = len(pos)
    world = np.zeros((n_pad, WD), np.float32)
    world[:n, :2] = pos
    world[:n, 2] = 0.05 * np.random.default_rng(seed).standard_normal(n)
    target = world.copy()
    target[:n, 2] += 0.1 * np.sin(pos[:, 0])
    return world, target


@pytest.fixture(scope="module")
def case():
    pos, cells, node_type = make_grid_strip_mesh(N_NODES, ny=NY)
    for a, b in zip(jax_strip(N_NODES, ny=NY), (pos, cells, node_type)):
        np.testing.assert_array_equal(a, b)
    pos, cells, (node_type,), _ = reorder_mesh(pos, cells, (node_type,))
    n = len(pos)
    pos64 = pos.astype(np.float64)
    hj = jax_build(jax_flat_edge(cells, "tri"), DEPTH, n, pos64, **LAYOUT)
    ht = to_device(build_hierarchy(to_flat_edge(cells, "tri"), DEPTH, n,
                                   pos64, **LAYOUT), "cpu")
    assert all(lvl.window > 0 for lvl in ht.levels)
    assert ht.levels[0].cresid is not None
    assert ht.transitions[0].down_op.cresid is not None

    jcfg = JaxModelConfig(latent_dim=C, hidden_layer=HIDDEN, unet_depth=DEPTH,
                          out_dim=3, pos_dim=2, world_edges=True,
                          world_dim=WD, aggregation="fused")
    tcfg = flag_simple_config(unet_depth=DEPTH, hidden_layer=HIDDEN).model
    state = jax_state_with_stats(jcfg)
    sim = port_simulator(tcfg, state)
    # [Δworld 3, ‖Δworld‖, Δmesh 2, ‖Δmesh‖, x_i, x_j]
    assert sim.process.down_gmps[0].mlp_edge.weights[0].shape == (2 * C + 7, C)

    n_pad = ht.levels[0].n_pad_nodes
    world, target = world_frames(pos, n_pad)
    node_in = np.zeros((n_pad, 6), np.float32)
    node_in[:, :3] = world
    node_in[:n, 3:5] = pos
    node_in[:n, 5] = node_type[:, 0]
    mask = np.zeros((n_pad, 1), np.float32)
    mask[:n, 0] = node_type[:, 0] == NT_NORMAL
    assert 0 < mask.sum() < n
    return dict(hj=hj, ht=ht, jcfg=jcfg, state=state, sim=sim,
                node_in=node_in, target=target, mask=mask, n=n)


@pytest.fixture(autouse=True)
def _zero_grads(case):
    yield
    case["sim"].zero_grad(set_to_none=True)


# -- kernel 13 ---------------------------------------------------------------


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
    """The JAX v4 kernel as a function of (xwi, xj, wf8, wf_dyn [wd, C],
    wf_nrm [C]), building its extended [N, 2C] tables and its [C, C] / [8,
    C] weight blocks as `gmp_apply` does."""

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
def test_kernel13_forward_matches_jax(case, dt):
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
    assert got.dtype == torch.float32
    assert_close(got, want, KERNEL_TOL[dt], dt)


def test_kernel13_backward_matches_jax_vjp(case):
    """The plain backward through the autograd Function (then kernel 7's
    plain version on dpre): dxwi, dxj, dwf8, dwf_dyn, dwf_nrm, dW, db
    against jax.vjp of the JAX v4 kernel, f32, with the JAX weight blocks
    mapped back to the port's shapes. dpre is zero on masked slots and its
    sender sum is dxwi."""
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


# -- the GMP, the transitions ------------------------------------------------


@pytest.fixture(scope="module")
def gmp_case(case):
    """Level 0's down GMP on seeded inputs, and JAX's f32 output, x
    gradient and parameter gradients of vdot(out, cot)."""
    hj, lt = case["hj"], case["ht"].levels[0]
    rng = np.random.default_rng(31)
    x = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    cot = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    wpos = np.zeros((lt.n_pad_nodes, WD), np.float32)
    wpos[:lt.n_nodes] = rng.standard_normal((lt.n_nodes, WD))
    pj = case["state"].params.process.down_gmps[0]

    def out(xx, p):
        return gmp_apply(p, hj.levels[0], xx, jnp.asarray(wpos), "fused",
                         None, (WD,))

    y, (gx, gp) = jax.value_and_grad(
        lambda xx, p: jnp.vdot(out(xx, p), jnp.asarray(cot)),
        argnums=(0, 1))(jnp.asarray(x), pj)
    return dict(x=x, cot=cot, wpos=wpos, y=np.asarray(out(jnp.asarray(x), pj)),
                gx=gx, gp=jax_to_nested(gp))


def test_world_edge_gmp_matches_jax(case, gmp_case):
    """Output, x gradient and every parameter gradient of level 0's down
    GMP (kernel 13's plain version, the compact residual with its world
    term, the node phase) against jax.grad of `gmp_apply(method="fused",
    dyn_dims=(3,))`, f32. The positions get no gradient."""
    gt, lt = case["sim"].process.down_gmps[0], case["ht"].levels[0]
    xt = leaf(gmp_case["x"], "f32")
    pos = torch.tensor(gmp_case["wpos"]).requires_grad_()
    out = gt(lt, xt, None, pos, "fused")
    assert_close(out, gmp_case["y"], KERNEL_TOL["f32"], "output")
    (out * torch.tensor(gmp_case["cot"])).sum().backward()
    assert pos.grad is None
    assert_close(xt.grad, gmp_case["gx"], KERNEL_TOL["f32"], "dx")
    for mlp in ("mlp_edge", "mlp_node"):
        want, mod = gmp_case["gp"][mlp], getattr(gt, mlp)
        for kind in ("weights", "biases"):
            for i, w in enumerate(want[kind]):
                assert_close(getattr(mod, kind)[i].grad, w,
                             KERNEL_TOL["f32"], f"{mlp}.{kind}.{i}")


def test_world_edge_gmp_bf16_matches_jax(case, gmp_case):
    hj, lt = case["hj"], case["ht"].levels[0]
    gj = case["state"].params.process.down_gmps[0]
    gt = case["sim"].process.down_gmps[0]
    xj, xt = both(gmp_case["x"], "bf16")
    want = gmp_apply(gj, hj.levels[0], xj, jnp.asarray(gmp_case["wpos"]),
                     "fused", jnp.bfloat16, (WD,))
    with torch.no_grad():
        got = gt(lt, xt, torch.bfloat16, torch.tensor(gmp_case["wpos"]),
                 "fused")
    assert str(want.dtype) == str(got.dtype).removeprefix("torch.")
    assert_close(got, want, KERNEL_TOL["bf16"], "bf16")


def test_wide_world_stream_gmp_matches_jax_v4(case):
    """A GMP with a 6-wide world stream (fiber_dims (6, 2)) on the windowed
    level 0: JAX's `gmp_apply` runs its v4 there (wd <= C), the port v1
    (kernel 11's plain version, over every edge of the level) since kernel
    13 takes wd <= 4. Output, x gradient and every parameter gradient
    against jax.grad, f32, at F32_TOL; kernel 13 does not run. The two
    routes differ on the pad rows: v1 sums every pad slot of the last
    block into row n_pad - 1 (3.3 there, at a scale of 6.4), where v4
    masks them. No real row reads a pad row, and the model gives pad rows
    no cotangent (its loss is masked), so the output is compared on the
    real rows and the cotangent is zero on the pad rows. The seeds leave
    every ReLU input of the real edges and nodes at least 3e-6 from zero
    (by the port's plain route), so no unit sits within f32 rounding of
    its kink, where the two sum orders could flip it (ROADMAP Queue 3)."""
    hj, lt = case["hj"], case["ht"].levels[0]
    pj = init_gmp(jax.random.PRNGKey(8), C, HIDDEN, 2, (WIDE_WD, 2))
    gt = GMP(C, HIDDEN, 2, fiber_dims=(WIDE_WD, 2))
    gt.load_state_dict(params_from_numpy(jax_to_nested(pj)))
    rng = np.random.default_rng(35)
    n = lt.n_pad_nodes
    x = rng.standard_normal((n, C)).astype(np.float32)
    cot = np.zeros((n, C), np.float32)
    cot[:lt.n_nodes] = rng.standard_normal((lt.n_nodes, C))
    wpos = np.zeros((n, WIDE_WD), np.float32)
    wpos[:lt.n_nodes] = rng.standard_normal((lt.n_nodes, WIDE_WD))

    def out(xx, p):
        return gmp_apply(p, hj.levels[0], xx, jnp.asarray(wpos), "fused",
                         None, (WIDE_WD,))

    y = out(jnp.asarray(x), pj)
    gx, gp = jax.grad(lambda xx, p: jnp.vdot(out(xx, p), jnp.asarray(cot)),
                      argnums=(0, 1))(jnp.asarray(x), pj)
    gp = jax_to_nested(gp)
    for f in (fused_edge_mlp_aggregate_plain,
              fused_edge_mlp_aggregate_bwd_plain,
              fused_edge_phase_win_dyn_plain):
        f.calls = 0
    xt = leaf(x, "f32")
    got = gt(lt, xt, None, torch.tensor(wpos), "fused")
    assert_close(got[:lt.n_nodes], y[:lt.n_nodes], F32_TOL, "output")
    (got * torch.tensor(cot)).sum().backward()
    assert fused_edge_mlp_aggregate_plain.calls == 1
    assert fused_edge_mlp_aggregate_bwd_plain.calls == 1
    assert fused_edge_phase_win_dyn_plain.calls == 0
    assert_close(xt.grad, gx, F32_TOL, "dx")
    for mlp in ("mlp_edge", "mlp_node"):
        mod = getattr(gt, mlp)
        for kind in ("weights", "biases"):
            for i, w in enumerate(gp[mlp][kind]):
                assert_close(getattr(mod, kind)[i].grad, w, F32_TOL,
                             f"{mlp}.{kind}.{i}")


@pytest.mark.parametrize("t", [0, 1])
def test_world_stream_transition_matches_jax(case, t):
    """The 3-wide world positions down a windowed transition take the
    narrow plain route over all the operator's slots (T0 has a compact
    residual: its entries are among those slots), as JAX's `trans_down(…,
    "fused")` falls back for the width; a 128-wide tensor takes kernel 1's
    route instead."""
    tj, tt = case["hj"].transitions[t], case["ht"].transitions[t]
    op = tt.down_op
    assert op.window > 0 and op.dense is None
    rng = np.random.default_rng(41 + t)
    x = rng.standard_normal((op.n_in_pad, WD)).astype(np.float32)
    want = jax_trans_down(tj, jnp.asarray(x), "fused")
    transition.narrow_apply.calls = 0
    got = trans_down(tt, torch.tensor(x))
    assert transition.narrow_apply.calls == 1
    assert got.dtype == torch.float32 and got.shape == (op.n_pad_nodes, WD)
    assert_close(got, want, SUM_TOL, f"T{t}")
    trans_down(tt, torch.zeros(op.n_in_pad, C))
    assert transition.narrow_apply.calls == 1
    with pytest.raises(ValueError, match="128-wide"):
        transition.narrow_apply(op, torch.zeros(op.n_in_pad, C))


# -- the simulator -----------------------------------------------------------


def _jax_forward(case, cd=None, cfg=None):
    state, hj = case["state"], case["hj"]
    cfg = case["jcfg"] if cfg is None else cfg
    return np.asarray(jax.jit(
        lambda ni, m: simulator_forward(state.params, state.norm_in,
                                        state.norm_out, hj, ni, m, cfg, cd)
    )(jnp.asarray(case["node_in"]), jnp.asarray(case["mask"])))


def test_forward_f32_matches_jax_with_taps(case):
    node_in, mask, sim, ht = (case[k] for k in ("node_in", "mask", "sim",
                                                 "ht"))
    want = _jax_forward(case)
    transition.narrow_apply.calls = 0
    with torch.no_grad():
        got = sim(ht, torch.from_numpy(node_in), torch.from_numpy(mask))
    assert transition.narrow_apply.calls == DEPTH  # world stream, down
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)

    state, jcfg = case["state"], case["jcfg"]
    latent, _, _ = split_node_input(jnp.asarray(node_in), jcfg.pos_dim)
    x0 = mlp_apply(state.params.encode, jax_normalize(state.norm_in, latent))
    dyn = jnp.asarray(node_in[:, :WD])

    def jax_taps(x, p):
        taps = {}
        bsgmp_apply(state.params.process, case["hj"], x, p, method="fused",
                    tap=taps.__setitem__, dyn_dims=(WD,))
        return taps

    taps_j = jax.jit(jax_taps)(x0, dyn)
    taps_t = {}
    with torch.no_grad():
        sim.process(ht, torch.tensor(np.asarray(x0)),
                    tap=lambda k, v: taps_t.__setitem__(k, v.numpy()),
                    pos=torch.from_numpy(node_in[:, :WD]), method="fused")
    assert sorted(taps_j) == sorted(taps_t) and len(taps_t) == 2 * DEPTH + 1
    for k in taps_j:
        np.testing.assert_allclose(taps_t[k], np.asarray(taps_j[k]),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=k)


@pytest.mark.parametrize("io_dtype", ["", "float32"])
def test_forward_bf16_matches_jax(case, io_dtype):
    node_in, mask, sim, ht = (case[k] for k in ("node_in", "mask", "sim",
                                                 "ht"))
    want = _jax_forward(case, jnp.bfloat16,
                        dataclasses.replace(case["jcfg"], io_dtype=io_dtype))
    cfg = sim.cfg
    sim.cfg = dataclasses.replace(cfg, io_dtype=io_dtype)
    try:
        with torch.no_grad():
            got = sim(ht, torch.from_numpy(node_in), torch.from_numpy(mask),
                      torch.bfloat16).numpy()
    finally:
        sim.cfg = cfg
    assert got.dtype == want.dtype == np.float32
    delta_scale = np.abs(want - node_in[:, :3]).max()
    assert delta_scale > 0
    assert np.abs(got - want).max() <= BF16_REL * delta_scale


def test_rollout_matches_jax(case):
    hj, ht, jcfg, state, sim = (case[k] for k in
                                ("hj", "ht", "jcfg", "state", "sim"))
    node_in, mask = case["node_in"], case["mask"]
    want = np.asarray(jax.jit(
        lambda ic, m: jax_rollout(state, hj, ic, m, 3, jcfg)
    )(jnp.asarray(node_in), jnp.asarray(mask)))
    got = rollout_trajectory(sim, ht, torch.from_numpy(node_in),
                             torch.from_numpy(mask), 3).numpy()
    assert got.shape == want.shape == (3, node_in.shape[0], 3)
    np.testing.assert_allclose(got, want, rtol=2 * F32_TOL, atol=2 * F32_TOL)


# -- training ----------------------------------------------------------------


def test_loss_and_gradients_match_jax(case):
    hj, ht, jcfg, state, sim = (case[k] for k in
                                ("hj", "ht", "jcfg", "state", "sim"))
    node_in, target, mask = case["node_in"], case["target"], case["mask"]
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


def test_trainer_matches_jax_trainer(case):
    """accumulation_steps=2 (the warmup gate), then 3 updates, both fed
    the same noise draw each step, with flag_simple's noise (σ = 0.003 on
    the world positions, γ = 0.1: the target absorbs 0.9 of it): per-step
    losses, normalizer states after the gate, and each tensor's update.
    JAX's trainer runs its plain `segment` aggregation (no Pallas kernel):
    kernel 13's plain version is held against JAX's interpret-mode v4
    kernel in the loss-and-gradient test above."""
    hj, ht, jcfg = case["hj"], case["ht"], case["jcfg"]
    node_in, target, mask = case["node_in"], case["target"], case["mask"]
    opt_kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=6)
    tcfg = flag_simple_config(unet_depth=DEPTH, hidden_layer=HIDDEN,
                              accumulation_steps=2)
    assert tcfg.datasets.noise_gamma == 0.1
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
