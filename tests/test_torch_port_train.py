"""The port's training slice against the JAX package on the CPU: each
backward kernel's plain version against `jax.vjp` of the JAX kernel's
function, the transitions' adjoints, the whole simulator's loss and
gradients against `jax.value_and_grad(Trainer._loss_fn)`, the trainer over
a warmup gate and three updates, and the schedule and clip against JAX and
optax.

The case is `test_torch_port_slice.py`'s: a 24×24 grid with scrambled ids,
depth 3, window 128, edge_block 512, latent 128, hidden 2. The JAX side
runs its Pallas kernels in interpret mode, but for the trainer, which
runs JAX's plain `segment` aggregation.

Tolerances, each relative to the scale of the reference value:
- f32 kernels (`KERNEL_TOL`): both sides compute in true f32 and differ in
  summation order only; 1e-4 of the largest |value|, as the forward kernel
  tests use.
- bf16 kernels: both sides round the same operands to bf16 and sum in
  f32, so an f32 sum in another order can put an intermediate on the other
  side of a bf16 rounding step (2^-8 relative); the cotangent passes
  through more rounded dots than the forward (the LN backward, then two
  dots per tail layer), so 3e-2 of the largest |value|.
- Whole-model f32 gradients: at most 1e-3 of each gradient's RMS, as the
  acceptance asks: the backward sums over ~30 dense layers and 7 GMPs.
- Whole-model bf16 gradients: the two frameworks round at other places
  outside the kernels (PyTorch's autograd of a cast and a bf16 matmul
  rounds the cotangent where JAX's transpose of a bf16 dot with f32
  accumulation does not), so only gross faults can be caught: the loss
  within 1e-2, and each gradient's RMS error within 0.1 of its RMS (an
  unrelated gradient of the same scale is off by about 1.4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_slice import DEPTH, case  # noqa: F401 (fixture)
from test_torch_port_weights import jax_to_nested, normalizer_to_dict

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import OptConfig as JaxOptConfig
from bsms_gnn_tpu.ops.pallas.fused_gmp import fused_edge_phase_win as jax_edge
from bsms_gnn_tpu.ops.pallas.node_mlp import fused_node_phase as jax_node
from bsms_gnn_tpu.ops.pallas.windowed import windowed_send_sum_raw
from bsms_gnn_tpu.ops.transition import trans_down as jax_trans_down
from bsms_gnn_tpu.ops.transition import trans_up as jax_trans_up
from bsms_gnn_tpu.training.schedule import (
    warmup_cosine_schedule as jax_schedule,
)
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import Config, ModelConfig, OptConfig
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import fused_edge_phase_win
from bsms_gnn_tpu_torch.ops.kernels.node_mlp import fused_node_phase
from bsms_gnn_tpu_torch.ops.kernels.windowed import windowed_send_sum_plain
from bsms_gnn_tpu_torch.ops.transition import trans_down, trans_up
from bsms_gnn_tpu_torch.training.schedule import warmup_cosine_schedule
from bsms_gnn_tpu_torch.training.trainer import (
    Trainer,
    clip_by_global_norm,
    masked_rmse,
)

C = 128
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
KERNEL_TOL = {"f32": 1e-4, "bf16": 3e-2}
SELECT_TOL = {"f32": 1e-5, "bf16": 1e-5}  # sums of rows, no rounding
GRAD_F32_TOL = 1e-3
GRAD_BF16_RMS_TOL = 1e-1
LOSS_BF16_TOL = 1e-2


def both(a, dt):
    jd, td = DTYPES[dt]
    return jnp.asarray(a).astype(jd), torch.tensor(a).to(td)


def assert_close(got, want, tol, what=""):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    scale = max(1e-30, np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} * {scale:.3e}"


def leaf(x, dt):
    """A torch leaf requiring grad in dtype dt."""
    return torch.tensor(x).to(DTYPES[dt][1]).requires_grad_()


def port_param_grads(module):
    return {k: p.grad for k, p in module.named_parameters()}


def jax_param_grads(tree):
    return params_from_numpy(jax_to_nested(tree))


# -- (a) each backward kernel's plain version -------------------------------


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fused_edge_phase_backward(case, dt):
    """Kernel 5's plain version, then kernel 7's on dpre, through the
    autograd Function: dxwi, dxj, dwf8, dW, db against jax.vjp of the JAX
    fused_edge_phase_win at level 0 (windowed, with a compact residual)."""
    hj, ht, state, sim = (case[k] for k in ("hj", "ht", "state", "sim"))
    assert ht.levels[0].cresid is not None
    n = ht.levels[0].n_pad_nodes
    rng = np.random.default_rng(11)
    xwi, xj, g = (rng.standard_normal((n, C)).astype(np.float32)
                  for _ in range(3))
    wf8 = (0.3 * rng.standard_normal((8, C))).astype(np.float32)
    mj = state.params.process.down_gmps[0].mlp_edge
    mt = sim.process.down_gmps[0].mlp_edge

    def f(a, b, w8, ws, bs):
        return jax_edge(hj.levels[0], a, b, w8, ws, bs)

    args = (both(xwi, dt)[0], both(xj, dt)[0], jnp.asarray(wf8),
            tuple(mj.weights[1:]), tuple(mj.biases[1:]))
    _, vjp = jax.vjp(f, *args)
    dxwi, dxj, dwf8, dws, dbs = vjp(jnp.asarray(g))

    a, b, w8 = leaf(xwi, dt), leaf(xj, dt), leaf(wf8, "f32")
    ws = [w.detach().clone().requires_grad_() for w in list(mt.weights)[1:]]
    bs = [x.detach().clone().requires_grad_() for x in list(mt.biases)[1:]]
    out = fused_edge_phase_win(ht.levels[0], a, b, w8, ws, bs)
    out.backward(torch.tensor(g))
    tol = KERNEL_TOL[dt]
    assert a.grad.dtype == a.dtype and b.grad.dtype == b.dtype
    assert_close(a.grad, dxwi, tol, "dxwi")
    assert_close(b.grad, dxj, tol, "dxj")
    assert_close(w8.grad, dwf8, tol, "dwf8")
    for i, (w, x) in enumerate(zip(ws, bs)):
        assert_close(w.grad, dws[i], tol, f"dW{i}")
        assert_close(x.grad, dbs[i], tol, f"db{i}")


@pytest.mark.parametrize("x_dt,dt", [("f32", "f32"), ("bf16", "bf16"),
                                     ("f32", "bf16")])
def test_fused_node_phase_backward(case, x_dt, dt):
    """Kernel 6's plain version through the autograd Function against
    jax.vjp of the JAX fused_node_phase; dt is the compute dtype (f32 x in
    bf16 compute is the level-0 GMP under io_dtype=float32)."""
    state, sim, ht = case["state"], case["sim"], case["ht"]
    n = ht.levels[0].n_pad_nodes
    rng = np.random.default_rng(12)
    x = rng.standard_normal((n, C)).astype(np.float32)
    aggr = (3 * rng.standard_normal((n, C))).astype(np.float32)
    g = rng.standard_normal((n, C)).astype(np.float32)
    cd_j, cd_t = (None, None) if dt == "f32" else DTYPES[dt]
    mj = state.params.process.down_gmps[0].mlp_node

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
    out.backward(torch.tensor(g).to(out.dtype))
    tol = KERNEL_TOL[dt]
    assert xt.grad.dtype == xt.dtype
    assert_close(xt.grad, dx, tol, "dx")
    assert_close(at.grad, daggr, tol, "daggr")
    for i in range(len(mt.weights)):
        assert_close(mt.weights[i].grad, dws[i], tol, f"dW{i}")
        assert_close(mt.biases[i].grad, dbs[i], tol, f"db{i}")
    mt.zero_grad(set_to_none=True)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("lvl", [0, 2])
def test_windowed_send_sum(case, dt, lvl):
    """Kernel 7's plain version against the JAX windowed_send_sum_raw."""
    hj, ht = case["hj"], case["ht"]
    vals = np.random.default_rng(13).standard_normal(
        (ht.levels[lvl].n_pad_edges, C)).astype(np.float32)
    vj, vt = both(vals, dt)
    got = windowed_send_sum_plain(ht.levels[lvl], vt)
    assert got.dtype == torch.float32
    assert_close(got, windowed_send_sum_raw(hj.levels[lvl], vj), SELECT_TOL[dt])


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_send_window_tables_walk_gives_the_send_sum(case, lvl):
    """Kernel 7's gather on the card, emulated in numpy from the level's
    `send_row_ptr` / `send_row_slots` tables alone: sender row n adds the
    rows of its listed slots in list order. Every slot with send_win < W
    is listed exactly once, at its sender row, in slot order within the
    row, and the walk equals the plain version and JAX's
    windowed_send_sum_raw."""
    hj, level = case["hj"], case["ht"].levels[lvl]
    w, eb = level.window, level.edge_block
    sw = level.send_win.numpy()
    ptr, slots = level.send_row_ptr.numpy(), level.send_row_slots.numpy()
    live = np.flatnonzero(sw < w)
    np.testing.assert_array_equal(np.sort(slots), live)
    sender = (np.repeat(level.win_base.numpy(), eb) * (w // 2) + sw)
    vals = np.random.default_rng(14).standard_normal(
        (level.n_pad_edges, C)).astype(np.float32)
    out = np.zeros((level.n_pad_nodes, C), np.float32)
    for n in range(level.n_pad_nodes):
        mine = slots[ptr[n]:ptr[n + 1]]
        assert (sender[mine] == n).all() and (np.diff(mine) > 0).all()
        for e in mine:
            out[n] += vals[e]
    want = windowed_send_sum_plain(level, torch.tensor(vals)).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        out, np.asarray(windowed_send_sum_raw(hj.levels[lvl],
                                              jnp.asarray(vals))),
        rtol=1e-6, atol=1e-5)


# -- (b) the transitions' adjoints ---------------------------------------------


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("which", ["down", "up"])
def test_transition_gradients(case, dt, which):
    hj, ht = case["hj"], case["ht"]
    fj, ft = {"down": (jax_trans_down, trans_down),
              "up": (jax_trans_up, trans_up)}[which]
    tj, tt = hj.transitions[0], ht.transitions[0]
    op_in = tt.down_op if which == "down" else tt.up_op
    assert op_in.cresid is not None
    rng = np.random.default_rng(15)
    x = rng.standard_normal((op_in.n_in_pad, C)).astype(np.float32)
    g = rng.standard_normal((op_in.n_pad_nodes, C)).astype(np.float32)
    y, vjp = jax.vjp(lambda a: fj(tj, a, "fused"), both(x, dt)[0])
    (want,) = vjp(jnp.asarray(g).astype(y.dtype))
    xt = leaf(x, dt)
    out = ft(tt, xt)
    assert out.dtype == xt.dtype
    out.backward(torch.tensor(g).to(out.dtype))
    assert xt.grad.dtype == xt.dtype
    assert_close(xt.grad, want, SELECT_TOL[dt] if dt == "f32" else 1e-2)


# -- (c) the whole simulator -------------------------------------------------


FRAME_SEED = 21


@pytest.fixture(scope="module")
def frame(case):
    """A training frame on the case's mesh: seeded output fields (the
    slice's positions and node types) and a target near them. Its own
    seed: at the slice's frame one edge's first-layer pre-activation in
    the level-2 up GMP lies 6e-8 from zero, within f32 rounding, so which
    side of the ReLU it falls on, and with it that GMP's edge-weight
    gradient (by 3.7e-3 of its RMS), depends on the order of f32 sums. JAX
    shows the same spread between its own `fused` and `pallas` methods
    there; an f64 finite difference confirms the kink."""
    rng = np.random.default_rng(FRAME_SEED)
    node_in, mask = case["node_in"].copy(), case["mask"]
    real = case["hj"].levels[0].node_mask[:, 0] > 0
    node_in[real, :3] = rng.standard_normal((int(real.sum()), 3))
    tar = node_in[:, :3] + 0.1 * rng.standard_normal(
        node_in[:, :3].shape).astype(np.float32)
    return node_in, tar * (mask > 0) + node_in[:, :3] * (mask == 0)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_loss_and_gradients_match_jax(case, frame, dt):
    hj, ht, jcfg, state, sim = (case[k] for k in
                                ("hj", "ht", "jcfg", "state", "sim"))
    (node_in, target), mask = frame, case["mask"]
    cd_j, cd_t = (None, None) if dt == "f32" else DTYPES[dt]
    jtr = JaxTrainer(JaxConfig(model=jcfg), init_key=jax.random.PRNGKey(0),
                     compute_dtype=cd_j)
    args = tuple(jnp.asarray(a) for a in (node_in, target, mask))
    loss_j, grads_j = jax.jit(lambda p, *a: jax.value_and_grad(
        jtr._loss_fn)(p, state, hj, *a))(state.params, *args)
    want = jax_param_grads(grads_j)

    sim.zero_grad(set_to_none=True)
    ni, nt, m = (torch.from_numpy(a) for a in (node_in, target, mask))
    loss = masked_rmse(sim(ht, ni, m, cd_t), nt, m)
    loss.backward()
    got = port_param_grads(sim)
    sim.zero_grad(set_to_none=True)
    assert sorted(got) == sorted(want)
    if dt == "f32":
        np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    else:
        np.testing.assert_allclose(loss.item(), float(loss_j),
                                   rtol=LOSS_BF16_TOL)
    for k, w in want.items():
        w, g = w.numpy(), got[k].numpy()
        rms = np.sqrt(np.mean(w.astype(np.float64) ** 2))
        assert rms > 0, k
        if dt == "f32":
            err = np.abs(g - w).max()
            assert err <= GRAD_F32_TOL * rms, f"{k}: {err:.3e} vs rms {rms:.3e}"
        else:
            err = np.sqrt(np.mean((g - w).astype(np.float64) ** 2))
            assert err <= GRAD_BF16_RMS_TOL * rms, (
                f"{k}: rms err {err:.3e} vs rms {rms:.3e}")


# -- (d) the trainer ---------------------------------------------------------


def test_trainer_matches_jax_trainer(case, frame):
    """accumulation_steps=2 (the warmup gate), then 3 updates at a
    warmup-cosine rate, both fed the same noise draw each step: the
    per-step losses, the normalizer states after the gate and the
    parameters after the last update. JAX's trainer runs its plain
    `segment` aggregation (no Pallas kernel, a compile of ~5 s against
    ~25 s in interpret mode): the port's kernels' plain versions are held
    against JAX's interpret-mode kernels in the loss-and-gradient test
    above."""
    hj, ht, jcfg = case["hj"], case["ht"], case["jcfg"]
    (node_in, target), mask = frame, case["mask"]
    opt_kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=6)
    jtr = JaxTrainer(JaxConfig(model=dataclasses.replace(
        jcfg, accumulation_steps=2, aggregation="segment"),
        opt=JaxOptConfig(**opt_kw)), init_key=jax.random.PRNGKey(3))
    tcfg = ModelConfig(latent_dim=128, hidden_layer=jcfg.hidden_layer,
                       unet_depth=DEPTH, accumulation_steps=2,
                       aggregation="fused")
    ttr = Trainer(Config(model=tcfg), OptConfig(**opt_kw), device="cpu")
    init = params_from_numpy(jax_to_nested(jtr.state.sim.params))
    ttr.sim.load_state_dict(init)

    ni, nt, m = (jnp.asarray(a) for a in (node_in, target, mask))
    ti, tt, tm = (torch.from_numpy(a) for a in (node_in, target, mask))
    key = jax.random.PRNGKey(7)
    losses_j, losses_t = [], []
    for i in range(5):
        k = jax.random.fold_in(key, i)
        z = jax.random.normal(k, nt.shape, nt.dtype)
        if i == 0:  # the noise the port is fed is JAX's own injection's
            want = jtr._inject_noise(k, ni, nt, m)
            got = ttr.inject_noise(ti, tt, tm, torch.tensor(np.asarray(z)))
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-6)
        losses_j.append(float(jtr.iter(hj, ni, nt, m, k)))
        losses_t.append(float(ttr.iter(ht, ti, tt, tm,
                                       torch.tensor(np.asarray(z)))))
    assert ttr.step == jtr.step == 5 and ttr.updates == 3
    np.testing.assert_allclose(losses_t[:2], losses_j[:2], rtol=1e-6)
    np.testing.assert_allclose(losses_t[2:], losses_j[2:], rtol=1e-4)
    assert len(set(losses_t[2:])) == 3  # the updates moved the model

    for name in ("norm_in", "norm_out"):
        want = normalizer_to_dict(getattr(jtr.state.sim, name))
        got = getattr(ttr.sim, name)
        for f in ("acc_weight", "num_accumulations", "e_x", "e_x2"):
            np.testing.assert_allclose(getattr(got, f).numpy(), want[f],
                                       rtol=1e-5, err_msg=f"{name}.{f}")
    want = jax_param_grads(jtr.state.sim.params)
    # Adam moves a weight by up to about the learning rate per update
    # whatever its gradient's scale, so a weight whose gradient is near
    # zero moves by a share of the rate more or less when the two gradients
    # differ in their last f32 bits. Measured: column 13 of
    # `up_gmps.1.mlp_edge.weights.0` belongs to a hidden unit that no edge
    # activates until the last update, where one edge gives its rows a
    # gradient of ~1e-7 (2e-5 of the tensor's RMS) whose sign the order of
    # f32 sums decides; its first Adam step is then ±0.64 of the rate on
    # either side (6.3e-4 apart). So each tensor's update (after − before)
    # is held to 1e-2 of its RMS in RMS; every weight but one in a thousand
    # to a quarter of the summed rates; and every weight to twice the
    # summed rates (a gradient of the wrong sign at every update).
    sched = warmup_cosine_schedule(**opt_kw)
    rates = sum(sched(k) for k in range(3))
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


# -- (e) the schedule and the clip -----------------------------------------------


def test_schedule_matches_jax():
    for peak, warm, decay in ((1e-4, 20000, 200000), (1e-3, 2, 6),
                              (5e-4, 0, 10)):
        js, ts = jax_schedule(peak, warm, decay), warmup_cosine_schedule(
            peak, warm, decay)
        for k in (0, 1, 2, 3, 5, warm, warm + 1, decay // 2, decay - 1,
                  decay, decay + 7, 3 * decay):
            np.testing.assert_allclose(ts(k), float(js(k)), rtol=1e-6,
                                       atol=1e-12, err_msg=f"{peak} {k}")
    assert warmup_cosine_schedule(1e-3, 2, 6)(0) == 0.0


@pytest.mark.parametrize("norm", [0.3, 1.0, 2.5, 40.0])
def test_clip_by_global_norm_matches_optax(norm):
    rng = np.random.default_rng(17)
    shapes = [(128, 128), (128,), (3, 128), (7,)]
    raw = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    scale = norm / np.sqrt(sum(float((r.astype(np.float64) ** 2).sum())
                               for r in raw))
    raw = [(r * scale).astype(np.float32) for r in raw]
    tx = optax.clip_by_global_norm(1.0)
    want, _ = tx.update([jnp.asarray(r) for r in raw], tx.init(None))
    got = [torch.tensor(r) for r in raw]
    n = clip_by_global_norm(got, 1.0)
    np.testing.assert_allclose(float(n), norm, rtol=1e-5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)
