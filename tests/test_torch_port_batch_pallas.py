"""The batch axis on the `pallas` path (world edges on an unwindowed
hierarchy: kernels 8 and 10, the kernel-8 transition route, the gathers)
against the JAX package on the CPU, and against itself.

The case is `test_torch_port_pallas.py`'s (a 600-node sphere, the default
unwindowed hierarchy of depth 3 with T0's dense forms dropped, so T0 runs
the gather + kernel-8 route; the inflating-font model cut to latent 128,
hidden 1, world edges), at B = 2. JAX's Pallas kernels run in interpret
mode and vmap themselves over a batch (`segment_sum.py:360,371,399`,
`agg_node.py:225`), as the JAX package runs them on a consistent mesh.

- Kernel 8's batched plain version, both forms, f32 and bf16, against
  JAX's `segment_sum_raw` / `segment_sum_send_pallas` on the batch, each
  sample bit for bit its unbatched call; its backward (the gather on dim
  -2) against `jax.vjp`.
- Kernel 10's batched plain version (f32, bf16, bf16 on f32 x) against
  JAX's `fused_aggregate_node_phase` on the batch, each sample bit for bit;
  its backward through the autograd Function against `jax.vjp` (d_feat,
  dx and every node-MLP gradient), the node MLP's ReLU inputs at least
  RELU_MARGIN from zero (asserted), so no unit sits within f32 rounding of
  its kink.
- The gathers (`gather_send`, `gather_recv`) and the kernel-8 transition
  route (T0, down and up, and their adjoints) at B against JAX's, each
  sample bit for bit.
- The model's forward at B against JAX's, each sample bit for bit the
  port's forward on that frame alone; the masked RMSE over the batch and
  every gradient against one JAX compile; `Trainer.iter` at B against
  JAX's `Trainer` on its plain `segment` aggregation (the kernels are held
  against interpret mode above).

Tolerances are `test_torch_port_pallas.py`'s (SUM_TOL, KERNEL_TOL,
F32_TOL, GRAD_F32_TOL, the trainer's) and `test_torch_port_batch.py`'s
(the backward in bf16, SUM_TOL for the sums over the batch).

The frames' seed is fixed for the reason `test_torch_port_batch_grads.py`
gives: across a whole model's ReLU inputs some lie within f32 rounding of
zero, where the two orders of sums can take a unit on different sides. At
FRAME_SEED every gradient lands within 1e-5 of its RMS."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_batch import KERNEL_TOL as BWD_TOL
from test_torch_port_batch import SUM_TOL as BATCH_SUM_TOL
from test_torch_port_pallas import (  # noqa: F401 (fixture)
    DEPTH,
    F32_TOL,
    GRAD_F32_TOL,
    HIDDEN,
    KERNEL_TOL,
    N_NODES,
    SUM_TOL,
    case,
)
from test_torch_port_train import assert_close, jax_param_grads
from test_torch_port_weights import jax_to_nested, normalizer_to_dict

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import DatasetConfig as JaxDatasetConfig
from bsms_gnn_tpu.config import OptConfig as JaxOptConfig
from bsms_gnn_tpu.models.simulator import simulator_forward_auto
from bsms_gnn_tpu.ops.pallas.agg_node import (
    fused_aggregate_node_phase as jax_agg_node,
)
from bsms_gnn_tpu.ops.pallas.segment_sum import (
    segment_sum_pallas,
    segment_sum_send_pallas,
)
from bsms_gnn_tpu.ops.pallas.segment_sum import (
    segment_sum_raw as jax_segment_sum,
)
from bsms_gnn_tpu.ops.scatter import gather_recv as jax_gather_recv
from bsms_gnn_tpu.ops.scatter import gather_send as jax_gather_send
from bsms_gnn_tpu.ops.transition import trans_down as jax_trans_down
from bsms_gnn_tpu.ops.transition import trans_up as jax_trans_up
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu.training.trainer import masked_rmse as jax_masked_rmse
from bsms_gnn_tpu_torch.config import OptConfig, inflating_font_config
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.data.synthetic import generate_inflating_trajectory
from bsms_gnn_tpu_torch.ops import transition
from bsms_gnn_tpu_torch.ops.kernels import agg_node, node_mlp, segment_sum
from bsms_gnn_tpu_torch.ops.scatter import gather_recv, gather_send
from bsms_gnn_tpu_torch.ops.transition import trans_down, trans_up
from bsms_gnn_tpu_torch.training.trainer import Trainer, masked_rmse

B = 2
C = 128
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# The node MLP's ReLU inputs in the backward test lie at least this far
# from zero (the tile tests' margin).
RELU_MARGIN = 3e-6
FRAME_SEED = 3


@pytest.fixture(autouse=True)
def _zero_grads(case):
    yield
    case["sim"].zero_grad(set_to_none=True)


def _layouts(case, where):
    """(JAX layout, port layout) by name: a level or T0's operators."""
    if where.startswith("level"):
        i = int(where[5:])
        return case["hj"].levels[i], case["ht"].levels[i]
    which = where.split("_")[1]
    return (getattr(case["hj"].transitions[0], f"{which}_op"),
            getattr(case["ht"].transitions[0], f"{which}_op"))


def _rand(seed, *shape, s=1.0):
    return (s * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _both(a, dt):
    jd, td = DTYPES[dt]
    return jnp.asarray(a).astype(jd), torch.tensor(a).to(td)


# -- kernel 8 ----------------------------------------------------------------


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("form,where", [
    ("recv", "level0"), ("recv", "level3"), ("recv", "t0_down"),
    ("send", "level0"), ("send", "level2")])
def test_segment_sum_batched_matches_jax(case, dt, form, where):
    """Every row of every sample, n_pad − 1 (the last block's pad slots)
    included; each sample bit for bit the unbatched call."""
    lj, lt = _layouts(case, where)
    fj, ft = _both(_rand(20, B, lt.n_pad_edges, C), dt)
    send = form == "send"
    want = (segment_sum_send_pallas if send else jax_segment_sum)(lj, fj)
    got = segment_sum.segment_sum_raw(lt, ft, send=send)
    assert got.dtype == torch.float32
    assert got.shape == (B, lt.n_pad_nodes, C)
    assert_close(got, want, SUM_TOL, f"{form} {where}")
    for s in range(B):
        assert torch.equal(got[s], segment_sum.segment_sum_raw(
            lt, ft[s], send=send))


@pytest.mark.parametrize("form", ["recv", "send"])
def test_segment_sum_batched_backward_is_the_gather(case, form):
    lj, lt = _layouts(case, "level1")
    feat = _rand(21, B, lt.n_pad_edges, C)
    g = _rand(22, B, lt.n_pad_nodes, C)
    jfn = segment_sum_send_pallas if form == "send" else segment_sum_pallas
    _, vjp = jax.vjp(lambda f: jfn(lj, f), jnp.asarray(feat))
    (want,) = vjp(jnp.asarray(g))
    x = torch.tensor(feat).requires_grad_()
    fn = (segment_sum.segment_sum_send if form == "send"
          else segment_sum.segment_sum)
    fn(lt, x).backward(torch.tensor(g))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))


# -- the gathers and the kernel-8 transition route --------------------------


@pytest.mark.parametrize("form", ["send", "recv"])
def test_gathers_batched_match_jax(case, form):
    """gather_send / gather_recv at B: the row selection on dim -2, and its
    backward (kernel 8 at B) against jax.vjp of the JAX `pallas` gathers;
    each sample's gradient bit for bit the unbatched backward."""
    lj, lt = _layouts(case, "level0")
    x = _rand(23, B, lt.n_pad_nodes, C)
    g = _rand(24, B, lt.n_pad_edges, C)
    jfn = jax_gather_send if form == "send" else jax_gather_recv
    y, vjp = jax.vjp(lambda a: jfn(lj, a, "pallas"), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    fn = gather_send if form == "send" else gather_recv
    xt = torch.tensor(x).requires_grad_()
    out = fn(lt, xt)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    out.backward(torch.tensor(g))
    assert_close(xt.grad, want, SUM_TOL, form)
    for s in range(B):
        one = torch.tensor(x[s]).requires_grad_()
        fn(lt, one).backward(torch.tensor(g[s]))
        assert torch.equal(xt.grad[s], one.grad)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("which", ["down", "up"])
def test_sparse_transition_batched_and_adjoint(case, dt, which):
    """T0 without its dense form at B: gather on dim -2, scale, kernel 8 at
    B; its backward is the other operator through the same route. Against
    JAX's `trans_down` / `trans_up` (which sum on axis -2) and their
    `jax.vjp`; each sample bit for bit the unbatched call."""
    tj, tt = case["hj"].transitions[0], case["ht"].transitions[0]
    fj, ft = {"down": (jax_trans_down, trans_down),
              "up": (jax_trans_up, trans_up)}[which]
    op = getattr(tt, f"{which}_op")
    assert op.window <= 0 and op.dense is None
    x = _rand(25, B, op.n_in_pad, C)
    g = _rand(26, B, op.n_pad_nodes, C)
    y, vjp = jax.vjp(lambda a: fj(tj, a, "pallas"), _both(x, dt)[0])
    (want,) = vjp(jnp.asarray(g).astype(y.dtype))
    xt = _both(x, dt)[1].requires_grad_()
    out = ft(tt, xt)
    assert out.dtype == xt.dtype and out.shape == (B, op.n_pad_nodes, C)
    # bf16: the scaled messages round to bf16 on both sides, then sum in
    # f32 in another order and round again.
    tol = SUM_TOL if dt == "f32" else 1e-2
    assert_close(out, y, tol, "forward")
    gt = torch.tensor(g).to(out.dtype)
    out.backward(gt)
    assert xt.grad.dtype == xt.dtype
    assert_close(xt.grad, want, tol, "backward")
    for s in range(B):
        one = _both(x[s], dt)[1].requires_grad_()
        o = ft(tt, one)
        assert torch.equal(out[s], o)
        o.backward(gt[s])
        assert torch.equal(xt.grad[s], one.grad)


def test_world_positions_down_a_sparse_transition_at_b(case):
    """The 3-wide world positions of B frames down T0's kernel-8 route:
    kernel 8's plain version on the leading dims (one narrow call at any
    B), against JAX's `trans_down`."""
    tj, tt = case["hj"].transitions[0], case["ht"].transitions[0]
    x = _rand(27, B, tt.down_op.n_in_pad, 3)
    want = jax_trans_down(tj, jnp.asarray(x), "pallas")
    segment_sum.segment_sum_plain.calls = 0
    got = trans_down(tt, torch.tensor(x))
    assert segment_sum.segment_sum_plain.calls == 1
    assert got.shape == (B, tt.down_op.n_pad_nodes, 3)
    assert_close(got, want, SUM_TOL, "positions")


# -- kernel 10 ---------------------------------------------------------------


def _mlps(case, lvl):
    return (case["state"].params.process.down_gmps[lvl].mlp_node,
            case["sim"].process.down_gmps[lvl].mlp_node)


@pytest.mark.parametrize("x_dt,dt", [("f32", "f32"), ("bf16", "bf16"),
                                     ("f32", "bf16")])
@pytest.mark.parametrize("where", ["level0", "level2"])
def test_agg_node_batched_matches_jax(case, x_dt, dt, where):
    """dt is the compute dtype and the edge rows' (f32 x in bf16 compute
    is the level-0 GMP under io_dtype=float32). Each sample bit for bit
    the unbatched call."""
    lj, lt = _layouts(case, where)
    x = _rand(30, B, lt.n_pad_nodes, C)
    feat = _rand(31, B, lt.n_pad_edges, C, s=0.5)
    cd_j, cd_t = (None, None) if dt == "f32" else DTYPES[dt]
    mj, mt = _mlps(case, int(where[5:]))
    want = jax_agg_node(lj, _both(feat, dt)[0], _both(x, x_dt)[0], mj, cd_j)
    ft, xt = _both(feat, dt)[1], _both(x, x_dt)[1]
    with torch.no_grad():
        got = agg_node.fused_aggregate_node_phase(lt, ft, xt, mt, cd_t)
        assert got.shape == (B, lt.n_pad_nodes, C)
        assert str(want.dtype) == str(got.dtype).removeprefix("torch.")
        assert_close(got, want, KERNEL_TOL[dt], where)
        for s in range(B):
            assert torch.equal(got[s], agg_node.fused_aggregate_node_phase(
                lt, ft[s], xt[s], mt, cd_t))


def _node_relu_margin(lt, feat, x, mlp):
    """The smallest |ReLU input| of kernel 10's node MLP (the plain
    version's arithmetic) over every row of the batch."""
    aggr = segment_sum.segment_sum_plain(lt, feat)
    pre = node_mlp._node_pre(node_mlp._rows(x), node_mlp._rows(aggr), mlp,
                             False)[0]
    ins, h = [pre], torch.relu(pre)
    ws, bs = node_mlp._tail(mlp)
    for w, b in zip(ws[:-1], bs[:-1]):
        ins.append(h @ w + b)
        h = torch.relu(ins[-1])
    return min(float(z.abs().min()) for z in ins)


def test_agg_node_batched_backward(case):
    """Through the autograd Function at B (kernel 8's plain version at B,
    kernel 6's, the gather on dim -2): d_feat, dx and every node-MLP
    gradient (summed over the batch) against jax.vjp of the JAX kernel on
    the batch, f32 (`test_torch_port_batch.py`'s backward tolerance)."""
    lj, lt = _layouts(case, "level1")
    x = _rand(32, B, lt.n_pad_nodes, C)
    feat = _rand(33, B, lt.n_pad_edges, C, s=0.5)
    g = _rand(34, B, lt.n_pad_nodes, C)
    mj, mt = _mlps(case, 1)
    with torch.no_grad():
        assert _node_relu_margin(lt, torch.tensor(feat), torch.tensor(x),
                                 mt) >= RELU_MARGIN

    def f(ff, xx, ws, bs):
        return jax_agg_node(lj, ff, xx, dataclasses.replace(
            mj, weights=ws, biases=bs))

    _, vjp = jax.vjp(f, jnp.asarray(feat), jnp.asarray(x), mj.weights,
                     mj.biases)
    dfeat, dx, dws, dbs = vjp(jnp.asarray(g))
    ft = torch.tensor(feat).requires_grad_()
    xt = torch.tensor(x).requires_grad_()
    agg_node.fused_aggregate_node_phase(lt, ft, xt, mt).backward(
        torch.tensor(g))
    tol = BWD_TOL["f32"]
    assert_close(ft.grad, dfeat, tol, "dfeat")
    assert_close(xt.grad, dx, tol, "dx")
    for i in range(len(mt.weights)):
        assert_close(mt.weights[i].grad, dws[i], tol, f"dW{i}")
        assert_close(mt.biases[i].grad, dbs[i], tol, f"db{i}")
    grads = [p.grad.clone() for p in (*mt.weights, *mt.biases)]
    ones = []
    for s in range(B):
        for p in (*mt.weights, *mt.biases):
            p.grad = None
        f1 = torch.tensor(feat[s]).requires_grad_()
        x1 = torch.tensor(x[s]).requires_grad_()
        agg_node.fused_aggregate_node_phase(lt, f1, x1, mt).backward(
            torch.tensor(g[s]))
        assert torch.equal(ft.grad[s], f1.grad)
        assert torch.equal(xt.grad[s], x1.grad)
        ones.append([p.grad.clone() for p in (*mt.weights, *mt.biases)])
    for got, *each in zip(grads, *ones):
        want = sum(each)
        torch.testing.assert_close(got, want, rtol=BATCH_SUM_TOL,
                                   atol=BATCH_SUM_TOL * float(
                                       want.abs().max()))


# -- the simulator -----------------------------------------------------------


@pytest.fixture(scope="module")
def frames(case):
    """B frames around a frame pair of `generate_inflating_trajectory` on
    the case's mesh: sample s's world positions are frame 0's plus
    0.02·N(0, 1) from seed FRAME_SEED + s on the real rows, its target frame
    1's plus the same offset. Returns ([B, N_pad, 7] input, [B, N_pad, 3]
    target, [B, N_pad, 1] mask)."""
    traj = generate_inflating_trajectory(N_NODES, 2, np.random.default_rng(0))
    n, n_pad = case["n"], case["node_in"].shape[0]
    np.testing.assert_array_equal(traj["mesh_pos"][0], case["node_in"][:n, 3:6])
    ins, tars = [], []
    for s in range(B):
        shift = 0.02 * np.random.default_rng(FRAME_SEED + s).standard_normal(
            (n, 3))
        ni = case["node_in"].copy()
        ni[:n, :3] = traj["world_pos"][0] + shift
        tar = np.zeros((n_pad, 3), np.float32)
        tar[:n] = traj["world_pos"][1] + shift
        ins.append(ni)
        tars.append(tar)
    return (np.stack(ins).astype(np.float32), np.stack(tars),
            np.repeat(case["mask"][None], B, axis=0))


@pytest.fixture(scope="module")
def jax_ref(case, frames):
    """(prediction, loss, gradients) of JAX's f32 model on the batch, from
    one compile: `jax.value_and_grad` of the masked RMSE with the
    prediction as its aux output."""
    hj, jcfg, state = case["hj"], case["jcfg"], case["state"]

    def loss_fn(params, ni, nt, m):
        pred = simulator_forward_auto(params, state.norm_in, state.norm_out,
                                      hj, ni, m, jcfg, None)
        return jax_masked_rmse(pred, nt, m), pred

    args = tuple(jnp.asarray(a) for a in frames)
    (loss, pred), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(state.params, *args)
    return np.asarray(pred), float(loss), jax_param_grads(grads)


def test_forward_batched_matches_jax(case, frames, jax_ref):
    """The model's forward on [B, N_pad, 7] against JAX's (F32_TOL), kernel
    10 once per GMP and kernel 8 once per sparse transition application at
    any B (the world positions' narrow calls among them), each sample bit
    for bit the port's forward on that frame alone."""
    ht, sim = case["ht"], case["sim"]
    node_in, _, mask = frames
    want = jax_ref[0]
    with torch.no_grad():
        agg_node.fused_aggregate_node_phase_plain.calls = 0
        segment_sum.segment_sum_plain.calls = 0
        got = sim(ht, torch.from_numpy(node_in), torch.from_numpy(mask))
        assert agg_node.fused_aggregate_node_phase_plain.calls == 2 * DEPTH + 1
        # T0 down (h and the positions) and up: one call each.
        assert segment_sum.segment_sum_plain.calls == 2 * DEPTH + 1 + 3
        assert got.shape == want.shape == (B, ht.levels[0].n_pad_nodes, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL)
        for s in range(B):
            one = sim(ht, torch.from_numpy(node_in[s]),
                      torch.from_numpy(mask[s]))
            assert torch.equal(got[s], one)


def test_batched_loss_and_gradients_match_jax(case, frames, jax_ref):
    """The masked RMSE over the batch (1e-5) and every parameter's
    gradient (GRAD_F32_TOL of its RMS) against JAX's, f32."""
    ht, sim = case["ht"], case["sim"]
    _, loss_j, want = jax_ref
    sim.zero_grad(set_to_none=True)
    ni, nt, m = (torch.from_numpy(a) for a in frames)
    loss = masked_rmse(sim(ht, ni, m), nt, m)
    loss.backward()
    got = {k: p.grad for k, p in sim.named_parameters()}
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    for k, w in want.items():
        w, g = w.numpy(), got[k].numpy()
        rms = np.sqrt(np.mean(w.astype(np.float64) ** 2))
        assert rms > 0, k
        err = np.abs(g - w).max()
        assert err <= GRAD_F32_TOL * rms, f"{k}: {err:.3e} vs rms {rms:.3e}"


# -- training ----------------------------------------------------------------


def test_batched_trainer_matches_jax_trainer(case, frames):
    """`Trainer.iter` on [B, N_pad, ...] with the inflating-font noise (σ =
    0.003 on the world positions): accumulation_steps=1 (the warmup gate
    over both frames), then 2 updates, both trainers fed the same noise
    draw (JAX's, in the batch's shape) each step: the losses, the
    normalizer states after the gate and each tensor's update, as
    `test_torch_port_pallas.py`'s trainer test holds them. JAX's trainer
    runs its plain `segment` aggregation."""
    hj, ht, jcfg = case["hj"], case["ht"], case["jcfg"]
    node_in, target, mask = frames
    opt_kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=6)
    tcfg = inflating_font_config(unet_depth=DEPTH, hidden_layer=HIDDEN,
                                 accumulation_steps=1)
    jtr = JaxTrainer(JaxConfig(
        model=dataclasses.replace(jcfg, accumulation_steps=1,
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
    for i in range(3):
        k = jax.random.fold_in(key, i)
        z = torch.tensor(np.asarray(jax.random.normal(k, nt.shape, nt.dtype)))
        losses_j.append(float(jtr.iter(hj, ni, nt, m, k)))
        losses_t.append(float(ttr.iter(ht, ti, tt, tm, z)))
    assert ttr.step == jtr.step == 3 and ttr.updates == 2
    np.testing.assert_allclose(losses_t[:1], losses_j[:1], rtol=1e-6)
    np.testing.assert_allclose(losses_t[1:], losses_j[1:], rtol=1e-4)
    assert len(set(losses_t)) == 3

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
