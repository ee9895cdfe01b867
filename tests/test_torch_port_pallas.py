"""The port's `pallas` path against the JAX package on the CPU: kernel 8
(receiver and sender forms) and kernel 10 against the JAX Pallas kernels
(interpret mode), the edge gathers' and the unwindowed transitions'
backwards, the world-edge GMP, the inflating-surface simulator forward in
f32 (with taps) and bf16, rollout, every f32 gradient against
`jax.value_and_grad`, and `Trainer` against the JAX `Trainer`. The JAX
weights reach the port through `convert.params_from_numpy` unchanged: the
world-edge layout needs nothing new there.

Case: a 600-node sphere (`make_sphere_mesh`), the default unwindowed
hierarchy of depth 3 (edge_block 128), the inflating-font model cut to
latent 128, hidden 1, world edges (fiber_dims (3, 3)). At this size every
transition has a dense form; the fixture drops T0's on both sides, so T0
runs the gather + segment-sum branch and T1, T2 the dense one, as on the
16k surface (T0–T2 sparse, T3–T6 dense).

Tolerances, relative to the largest |value| of the reference:
- the segment sums (`SUM_TOL`): sums of the same f32 values in another
  order; bf16 rows add exactly into f32 on both sides;
- kernel 10 and the GMP (`KERNEL_TOL`): f32 sums in another order through
  the MLPs (1e-4); in bf16 both sides round the same operands, and an f32
  sum in another order can put an intermediate on the other side of a bf16
  rounding step (2^-8 relative), so 2e-2;
- the forward and rollout, f32: 5e-4 (~20 dense layers and LayerNorms);
  bf16: 2e-2 of the predicted delta's scale, as the windowed slice holds it;
- gradients: each within 1e-3 of its RMS (f32), as the windowed slice's;
- the trainer: losses 1e-6 through the gate (no model runs), 1e-4 after
  the updates; each tensor's update within 1e-2 of its RMS.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from bsms_gnn_tpu.data.synthetic import make_sphere_mesh as jax_sphere
from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.models.normalizer import normalize as jax_normalize
from bsms_gnn_tpu.models.simulator import simulator_forward, split_node_input
from bsms_gnn_tpu.ops.bsgmp import bsgmp_apply
from bsms_gnn_tpu.ops.dense import mlp_apply
from bsms_gnn_tpu.ops.message import gmp_apply
from bsms_gnn_tpu.ops.pallas.agg_node import (
    fused_aggregate_node_phase as jax_agg_node,
)
from bsms_gnn_tpu.ops.pallas.segment_sum import (
    segment_sum_raw as jax_segment_sum,
)
from bsms_gnn_tpu.ops.pallas.segment_sum import (
    segment_sum_pallas,
    segment_sum_send_pallas,
)
from bsms_gnn_tpu.ops.scatter import gather_recv as jax_gather_recv
from bsms_gnn_tpu.ops.scatter import gather_send as jax_gather_send
from bsms_gnn_tpu.ops.transition import trans_down as jax_trans_down
from bsms_gnn_tpu.ops.transition import trans_up as jax_trans_up
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
from bsms_gnn_tpu_torch.ops.kernels.agg_node import (
    fused_aggregate_node_phase,
    fused_aggregate_node_phase_plain,
)
from bsms_gnn_tpu_torch.ops.kernels.segment_sum import (
    segment_sum,
    segment_sum_plain,
    segment_sum_send,
)
from bsms_gnn_tpu_torch.ops.scatter import gather_recv, gather_send
from bsms_gnn_tpu_torch.ops.transition import trans_down, trans_up
from bsms_gnn_tpu_torch.training.rollout import rollout_trajectory
from bsms_gnn_tpu_torch.training.trainer import Trainer, masked_rmse

N_NODES, DEPTH, HIDDEN, C = 600, 3, 1, 128
SUM_TOL = 1e-5
KERNEL_TOL = {"f32": 1e-4, "bf16": 2e-2}
F32_TOL = 5e-4
BF16_REL = 2e-2
GRAD_F32_TOL = 1e-3
DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def sparse_t0(h, replace):
    """The hierarchy with T0's dense forms dropped (`replace` is the
    package's dataclass replace)."""
    t0 = h.transitions[0]
    t0 = replace(t0, down_op=replace(t0.down_op, dense=None),
                 up_op=replace(t0.up_op, dense=None))
    return replace(h, transitions=(t0,) + tuple(h.transitions[1:]))


@pytest.fixture(scope="module")
def case():
    pos, cells, node_type = make_sphere_mesh(N_NODES, np.random.default_rng(0))
    for a, b in zip(jax_sphere(N_NODES, np.random.default_rng(0)),
                    (pos, cells, node_type)):
        np.testing.assert_array_equal(a, b)
    n = len(pos)
    pos64 = pos.astype(np.float64)
    hj = jax_build(jax_flat_edge(cells, "tri"), DEPTH, n, pos64)
    hj = sparse_t0(hj, lambda o, **kw: o.replace(**kw))
    ht = build_hierarchy(to_flat_edge(cells, "tri"), DEPTH, n, pos64)
    ht = to_device(sparse_t0(ht, dataclasses.replace), "cpu")
    assert all(lvl.window == 0 for lvl in ht.levels)
    assert [t.down_op.dense is None for t in ht.transitions] == [
        True, False, False]

    jcfg = JaxModelConfig(latent_dim=C, hidden_layer=HIDDEN, unet_depth=DEPTH,
                          out_dim=3, pos_dim=3, world_edges=True,
                          aggregation="pallas")
    tcfg = inflating_font_config(unet_depth=DEPTH, hidden_layer=HIDDEN).model
    state = jax_state_with_stats(jcfg)
    sim = port_simulator(tcfg, state)
    assert sim.process.down_gmps[0].mlp_edge.weights[0].shape == (2 * C + 8, C)

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


# -- kernel 8 ----------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("form,where", [
    ("recv", "level0"), ("recv", "level3"), ("recv", "t0_down"),
    ("recv", "t0_up"), ("send", "level0"), ("send", "level2")])
def test_segment_sum_matches_jax(case, dt, form, where):
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
    last = lt.n_pad_nodes - 1
    assert lt.row_ptr[last + 1] > lt.row_ptr[last]  # pad slots land there
    np.testing.assert_allclose(got[last].numpy(), np.asarray(want)[last],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", ["recv", "send"])
def test_segment_sum_backward_is_the_gather(case, form):
    lj, lt = _level(case, "level1")
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((lt.n_pad_edges, C)).astype(np.float32)
    g = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    jfn = segment_sum_send_pallas if form == "send" else segment_sum_pallas
    _, vjp = jax.vjp(lambda f: jfn(lj, f), jnp.asarray(feat))
    (want,) = vjp(jnp.asarray(g))
    x = leaf(feat, "f32")
    (segment_sum_send if form == "send" else segment_sum)(lt, x).backward(
        torch.tensor(g))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("form", ["send", "recv"])
def test_gather_backward_runs_the_segment_sum(case, form):
    """gather_send / gather_recv: the row selection, and its backward
    against jax.vjp of the JAX `pallas` gathers (kernel 8 in both)."""
    lj, lt = _level(case, "level0")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    g = rng.standard_normal((lt.n_pad_edges, C)).astype(np.float32)
    jfn = jax_gather_send if form == "send" else jax_gather_recv
    y, vjp = jax.vjp(lambda a: jfn(lj, a, "pallas"), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = leaf(x, "f32")
    out = (gather_send if form == "send" else gather_recv)(lt, xt)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    out.backward(torch.tensor(g))
    assert_close(xt.grad, want, SUM_TOL, form)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("which", ["down", "up"])
def test_sparse_transition_and_adjoint(case, dt, which):
    """T0 without its dense form: gather, scale, kernel 8; the backward
    is the other operator through the same branch."""
    tj, tt = case["hj"].transitions[0], case["ht"].transitions[0]
    fj, ft = {"down": (jax_trans_down, trans_down),
              "up": (jax_trans_up, trans_up)}[which]
    op = getattr(tt, f"{which}_op")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((op.n_in_pad, C)).astype(np.float32)
    g = rng.standard_normal((op.n_pad_nodes, C)).astype(np.float32)
    y, vjp = jax.vjp(lambda a: fj(tj, a, "pallas"), both(x, dt)[0])
    (want,) = vjp(jnp.asarray(g).astype(y.dtype))
    xt = leaf(x, dt)
    out = ft(tt, xt)
    assert out.dtype == xt.dtype
    # bf16: the scaled messages round to bf16 on both sides, then sum in
    # f32 in another order and round again.
    tol = SUM_TOL if dt == "f32" else 1e-2
    assert_close(out, y, tol, "forward")
    out.backward(torch.tensor(g).to(out.dtype))
    assert xt.grad.dtype == xt.dtype
    assert_close(xt.grad, want, tol, "backward")


# -- kernel 10 ---------------------------------------------------------------


@pytest.mark.parametrize("x_dt,dt", [("f32", "f32"), ("bf16", "bf16"),
                                     ("f32", "bf16")])
@pytest.mark.parametrize("where", ["level0", "level2"])
def test_fused_aggregate_node_phase_matches_jax(case, x_dt, dt, where):
    """dt is the compute dtype and the edge rows' (f32 x in bf16 compute
    is the level-0 GMP under io_dtype=float32)."""
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


def test_fused_aggregate_node_phase_backward(case):
    """Through the autograd Function (kernel 8's plain version, kernel 6's,
    the gather): d_feat, dx and every node-MLP gradient against jax.vjp of
    the JAX kernel, f32."""
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


# -- the GMP, the simulator --------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("lvl", [0, 3])
def test_world_edge_gmp_matches_jax(case, dt, lvl):
    lj, lt = _level(case, f"level{lvl}")
    rng = np.random.default_rng(8 + lvl)
    x = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    wpos = rng.standard_normal((lt.n_pad_nodes, 3)).astype(np.float32)
    cd_j, cd_t = DTYPES[dt]
    pj, pt = case["state"].params.process, case["sim"].process
    gj, gt = ((pj.down_gmps[lvl], pt.down_gmps[lvl]) if lvl < DEPTH
              else (pj.bottom_gmp, pt.bottom_gmp))
    want = gmp_apply(gj, lj, both(x, dt)[0], jnp.asarray(wpos), "pallas",
                     cd_j, (3,))
    with torch.no_grad():
        got = gt(lt, both(x, dt)[1], cd_t, torch.tensor(wpos), "pallas")
    assert str(want.dtype) == str(got.dtype).removeprefix("torch.")
    assert_close(got, want, KERNEL_TOL[dt], f"level {lvl}")


def _jax_forward(case, node_in, cd=None, cfg=None):
    state, hj = case["state"], case["hj"]
    cfg = case["jcfg"] if cfg is None else cfg
    return np.asarray(jax.jit(
        lambda ni, m: simulator_forward(state.params, state.norm_in,
                                        state.norm_out, hj, ni, m, cfg, cd)
    )(jnp.asarray(node_in), jnp.asarray(case["mask"])))


def test_forward_f32_matches_jax_with_taps(case):
    node_in, mask, sim, ht = (case[k] for k in ("node_in", "mask", "sim",
                                                 "ht"))
    want = _jax_forward(case, node_in)
    with torch.no_grad():
        got = sim(ht, torch.from_numpy(node_in), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)

    state, jcfg = case["state"], case["jcfg"]
    latent, _, _ = split_node_input(jnp.asarray(node_in), jcfg.pos_dim)
    x0 = mlp_apply(state.params.encode, jax_normalize(state.norm_in, latent))
    dyn = jnp.asarray(node_in[:, :3])

    def jax_taps(x, p):
        taps = {}
        bsgmp_apply(state.params.process, case["hj"], x, p, method="pallas",
                    tap=taps.__setitem__, dyn_dims=(3,))
        return taps

    taps_j = jax.jit(jax_taps)(x0, dyn)
    taps_t = {}
    with torch.no_grad():
        sim.process(ht, torch.tensor(np.asarray(x0)),
                    tap=lambda k, v: taps_t.__setitem__(k, v.numpy()),
                    pos=torch.from_numpy(node_in[:, :3]), method="pallas")
    assert sorted(taps_j) == sorted(taps_t) and len(taps_t) == 2 * DEPTH + 1
    for k in taps_j:
        np.testing.assert_allclose(taps_t[k], np.asarray(taps_j[k]),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=k)


@pytest.mark.parametrize("io_dtype", ["", "float32"])
def test_forward_bf16_matches_jax(case, io_dtype):
    node_in, mask, sim, ht = (case[k] for k in ("node_in", "mask", "sim",
                                                 "ht"))
    want = _jax_forward(case, node_in, jnp.bfloat16,
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


@pytest.fixture(scope="module")
def frames(case):
    """A frame pair of `generate_inflating_trajectory` on the case's mesh:
    node_in at frame 0, the target frame 1 (world positions)."""
    traj = generate_inflating_trajectory(N_NODES, 2, np.random.default_rng(0))
    n, n_pad = case["n"], case["node_in"].shape[0]
    np.testing.assert_array_equal(traj["mesh_pos"][0], case["node_in"][:n, 3:6])
    node_in = np.zeros((n_pad, 7), np.float32)
    node_in[:n, :3] = traj["world_pos"][0]
    node_in[:n, 3:] = case["node_in"][:n, 3:]
    target = np.zeros((n_pad, 3), np.float32)
    target[:n] = traj["world_pos"][1]
    return node_in, target


def test_loss_and_gradients_match_jax(case, frames):
    hj, ht, jcfg, state, sim = (case[k] for k in
                                ("hj", "ht", "jcfg", "state", "sim"))
    (node_in, target), mask = frames, case["mask"]
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


def test_trainer_matches_jax_trainer(case, frames):
    """accumulation_steps=2 (the warmup gate), then 3 updates, both fed
    the same noise draw each step (the inflating-font noise, σ = 0.003 on
    the world positions): per-step losses, normalizer states after the
    gate, and each tensor's update."""
    hj, ht, jcfg = case["hj"], case["ht"], case["jcfg"]
    (node_in, target), mask = frames, case["mask"]
    opt_kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=6)
    tcfg = inflating_font_config(unet_depth=DEPTH, hidden_layer=HIDDEN,
                                 accumulation_steps=2)
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
            # Means of world positions on a sphere about the origin nearly
            # cancel: f32 sums in another order differ by ~1e-8 absolute.
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

