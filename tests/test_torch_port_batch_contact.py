"""The batch axis on the world-edge path (flag_simple's recipe: world-space
edges on the windowed `fused` method, kernel 13) against the JAX package
on the CPU, and against itself.

The case is `test_torch_port_contact.py`'s (a Morton-ordered 520-node
cloth strip, depth 2, window 256, edge_block 512, latent 128, hidden 1,
world 3, pos 2), at B = 2 frames of the contact recipe, each from its own
seed. JAX's v4 kernel runs in interpret mode, vmapped over the batch as
the JAX package runs it on a consistent mesh (`fused_gmp.py:870-876`).

- Kernel 13's batched plain forward and, through the autograd Function,
  its backward and kernel 7 against JAX's vmapped
  `fused_edge_phase_win_dyn` and its `jax.vjp`, f32 and bf16.
- Kernel 13's batched plain versions sample by sample bit for bit the
  unbatched calls (aggr, dpre, dxj); dwf8, dwf_dyn, dwf_nrm, dW and db
  against the sum of the unbatched calls'.
- `narrow_apply` (the 3-wide world positions down a windowed transition)
  at B against JAX's `trans_down`, which sums on axis -2.
- The flag model's forward at B against JAX's, each sample bit for bit
  the port's forward on that frame alone; the masked RMSE over the batch
  and every gradient against one JAX compile.
- `Trainer.iter` at B over a warmup-gate step and two updates against
  JAX's `Trainer` on its plain `segment` aggregation (the kernels are held
  against interpret mode above), fed JAX's noise on the world positions.

Tolerances are `test_torch_port_contact.py`'s (forward, gradients,
trainer) and `test_torch_port_batch.py`'s (the backward kernel in bf16,
the sums over the batch).

The frames' seed is fixed for the reason `test_torch_port_batch_grads.py`
gives: a ReLU input within f32 rounding of zero lands on the side its
order of sums picks. `frame_seed_sweep.py contact` in this directory runs
the seeds of this file's frames against JAX: at seeds 0-20 every gradient
lands within 1.2e-5 of its RMS (6 to 34 ReLU inputs of the port's
forward within 3e-6 of zero, none on a kink that flips); seed 5 holds
14."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_batch import KERNEL_TOL as BWD_TOL
from test_torch_port_batch import SUM_TOL
from test_torch_port_contact import (
    DEPTH,
    F32_TOL,
    GRAD_F32_TOL,
    HIDDEN,
    KERNEL_TOL,
    WD,
    _jax_dyn,
    case,  # noqa: F401 (fixture)
)
from test_torch_port_contact import SUM_TOL as TRANS_TOL
from test_torch_port_train import assert_close, jax_param_grads
from test_torch_port_weights import jax_to_nested, normalizer_to_dict

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import DatasetConfig as JaxDatasetConfig
from bsms_gnn_tpu.config import OptConfig as JaxOptConfig
from bsms_gnn_tpu.models.simulator import simulator_forward_auto
from bsms_gnn_tpu.ops.transition import trans_down as jax_trans_down
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu.training.trainer import masked_rmse as jax_masked_rmse
from bsms_gnn_tpu_torch.config import OptConfig, flag_simple_config
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.ops import transition
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp_dyn
from bsms_gnn_tpu_torch.ops.transition import trans_down
from bsms_gnn_tpu_torch.training.schedule import warmup_cosine_schedule
from bsms_gnn_tpu_torch.training.trainer import Trainer, masked_rmse

B = 2
C = 128
FRAME_SEED = 5
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def make_frames(node_in, target, n, seed=None):
    """B frames of the contact recipe on the case's strip (its frame
    `node_in` and `target`, n real rows): sample s's world z =
    0.05·N(0, 1) from seed + s, the target adding 0.1·sin(x) to z as the
    case's does. Returns ([B, N_pad, 6] input, [B, N_pad, 3] target)."""
    seed = FRAME_SEED if seed is None else seed
    ins, tars = [], []
    for s in range(B):
        ni = node_in.copy()
        ni[:n, 2] = 0.05 * np.random.default_rng(seed + s).standard_normal(n)
        tar = target.copy()
        tar[:n, 2] = ni[:n, 2] + (target[:n, 2] - node_in[:n, 2])
        ins.append(ni)
        tars.append(tar)
    return np.stack(ins), np.stack(tars)


@pytest.fixture(scope="module")
def frames(case):
    node_in, target = make_frames(case["node_in"], case["target"], case["n"])
    return node_in, target, np.repeat(case["mask"][None], B, axis=0)


def _kernel_inputs(lt, seed):
    """Kernel 13's arguments at level 0 for a batch: xwi, xj, g [B, n_pad,
    C], world positions [B, n_pad, 3] (zero on pad rows), and wf8, wf_dyn,
    wf_nrm."""
    rng = np.random.default_rng(seed)
    n = lt.n_pad_nodes
    xwi, xj, g = (rng.standard_normal((B, n, C)).astype(np.float32)
                  for _ in range(3))
    wpos = np.zeros((B, n, WD), np.float32)
    wpos[:, :lt.n_nodes] = rng.standard_normal((B, lt.n_nodes, WD))
    wf8, wfd = ((0.3 * rng.standard_normal(s)).astype(np.float32)
                for s in ((8, C), (WD, C)))
    wfn = (0.3 * rng.standard_normal(C)).astype(np.float32)
    return xwi, xj, g, wpos, wf8, wfd, wfn


# -- kernel 13 ---------------------------------------------------------------


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_kernel13_batched_matches_jax(case, dt):
    """Kernel 13's plain forward and, through the autograd Function, its
    backward and kernel 7's at B = 2 against JAX's v4 kernel (interpret
    mode), which vmaps itself over a batch, and its `jax.vjp`: aggr, dxwi,
    dxj, dwf8, dwf_dyn, dwf_nrm, dW, db."""
    hj, ht, state, sim = (case[k] for k in ("hj", "ht", "state", "sim"))
    lj, lt = hj.levels[0], ht.levels[0]
    xwi, xj, g, wpos, wf8, wfd, wfn = _kernel_inputs(lt, 51)
    jd, td = DTYPES[dt]
    mj = state.params.process.down_gmps[0].mlp_edge
    mt = sim.process.down_gmps[0].mlp_edge

    def full(a, b, w8, wd_, wn, ws, bs):
        return _jax_dyn(lj, jnp.asarray(wpos).astype(jd), ws, bs)(
            a, b, w8, wd_, wn)

    args = (jnp.asarray(xwi).astype(jd), jnp.asarray(xj).astype(jd),
            jnp.asarray(wf8), jnp.asarray(wfd), jnp.asarray(wfn),
            tuple(mj.weights[1:]), tuple(mj.biases[1:]))
    y, vjp = jax.vjp(full, *args)
    dxwi, dxj, dwf8, dwfd, dwfn, dws, dbs = vjp(jnp.asarray(g))

    a = torch.tensor(xwi).to(td).requires_grad_()
    b = torch.tensor(xj).to(td).requires_grad_()
    w8, wd_, wn = (torch.tensor(v).requires_grad_() for v in (wf8, wfd, wfn))
    ws = [w.detach().clone().requires_grad_() for w in list(mt.weights)[1:]]
    bs = [x.detach().clone().requires_grad_() for x in list(mt.biases)[1:]]
    fused_gmp_dyn.fused_edge_phase_win_dyn_plain.calls = 0
    fused_gmp_dyn.fused_edge_phase_win_dyn_bwd_plain.calls = 0
    out = fused_gmp_dyn.fused_edge_phase_win_dyn(
        lt, a, b, torch.tensor(wpos).to(td), w8, wd_, wn, ws, bs)
    assert out.shape == (B, lt.n_pad_nodes, C) and out.dtype == torch.float32
    assert_close(out, y, KERNEL_TOL[dt], "aggr")
    out.backward(torch.tensor(g))
    assert fused_gmp_dyn.fused_edge_phase_win_dyn_plain.calls == 1
    assert fused_gmp_dyn.fused_edge_phase_win_dyn_bwd_plain.calls == 1
    tol = BWD_TOL[dt]
    assert a.grad.dtype == a.dtype and b.grad.dtype == b.dtype
    for got, want, what in ((a.grad, dxwi, "dxwi"), (b.grad, dxj, "dxj"),
                            (w8.grad, dwf8, "dwf8"), (wd_.grad, dwfd,
                                                      "dwf_dyn"),
                            (wn.grad, dwfn, "dwf_nrm")):
        assert_close(got, want, tol, what)
    for i, (w, x) in enumerate(zip(ws, bs)):
        assert_close(w.grad, dws[i], tol, f"dW{i}")
        assert_close(x.grad, dbs[i], tol, f"db{i}")


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_kernel13_batched_plain_equals_each_sample(case, dt):
    """Kernel 13's batched plain forward and backward, sample b bit for
    bit the unbatched call on sample b (aggr, dpre, dxj) at both levels;
    dwf8, dwf_dyn, dwf_nrm, dW and db against the sum of the unbatched
    calls'."""
    ht, sim = case["ht"], case["sim"]
    td = DTYPES[dt][1]
    with torch.no_grad():
        for lvl in (0, 1):
            lt = ht.levels[lvl]
            xwi, xj, g, wpos, wf8, wfd, wfn = _kernel_inputs(lt, 52 + lvl)
            mt = sim.process.down_gmps[lvl].mlp_edge
            batch = [torch.tensor(v).to(td) for v in (xwi, xj, wpos)]
            rest = [torch.tensor(v) for v in (wf8, wfd, wfn)] + [
                list(mt.weights)[1:], list(mt.biases)[1:]]
            gt = torch.tensor(g)
            got = fused_gmp_dyn.fused_edge_phase_win_dyn_plain(lt, *batch,
                                                               *rest)
            bwd = fused_gmp_dyn.fused_edge_phase_win_dyn_bwd_plain(
                lt, *batch, *rest, gt)
            ones = []
            for s in range(B):
                one = [v[s] for v in batch]
                assert torch.equal(got[s], fused_gmp_dyn.
                                   fused_edge_phase_win_dyn_plain(
                                       lt, *one, *rest))
                ones.append(fused_gmp_dyn.fused_edge_phase_win_dyn_bwd_plain(
                    lt, *one, *rest, gt[s]))
                for i in (0, 1):  # dpre, dxj
                    assert torch.equal(bwd[i][s], ones[s][i]), (lvl, i, s)
            for i in range(2, 7):  # dwf8, dwf_dyn, dwf_nrm, dW, db
                want = sum(o[i] for o in ones)
                assert bwd[i].shape == ones[0][i].shape
                torch.testing.assert_close(
                    bwd[i], want, rtol=SUM_TOL,
                    atol=SUM_TOL * float(want.abs().max()))


@pytest.mark.parametrize("t", [0, 1])
def test_narrow_apply_batched_matches_jax(case, t):
    """The 3-wide world positions of B frames down a windowed transition:
    `narrow_apply` on the leading dims (one call) against JAX's
    `trans_down(…, "fused")` on the batch, and each sample bit for bit
    the call on that sample alone."""
    tj, tt = case["hj"].transitions[t], case["ht"].transitions[t]
    op = tt.down_op
    rng = np.random.default_rng(61 + t)
    x = rng.standard_normal((B, op.n_in_pad, WD)).astype(np.float32)
    want = jax_trans_down(tj, jnp.asarray(x), "fused")
    transition.narrow_apply.calls = 0
    got = trans_down(tt, torch.tensor(x))
    assert transition.narrow_apply.calls == 1
    assert got.shape == (B, op.n_pad_nodes, WD)
    assert_close(got, want, TRANS_TOL, f"T{t}")
    for s in range(B):
        assert torch.equal(got[s], transition.narrow_apply(
            op, torch.tensor(x[s])))


# -- the simulator -----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ref(case, frames):
    """(prediction, loss, gradients) of JAX's f32 flag model on the
    batch, from one compile: `jax.value_and_grad` of `Trainer._loss_fn`'s
    body with the prediction as its aux output."""
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
    """The flag model's forward on [B, N_pad, 6] against JAX's (F32_TOL),
    the world positions down the transitions by `narrow_apply` (one call
    per down transition at any B), each sample bit for bit the port's
    forward on that frame alone."""
    ht, sim = case["ht"], case["sim"]
    node_in, _, mask = frames
    want = jax_ref[0]
    with torch.no_grad():
        transition.narrow_apply.calls = 0
        got = sim(ht, torch.from_numpy(node_in), torch.from_numpy(mask))
        assert transition.narrow_apply.calls == DEPTH
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
    """`Trainer.iter` on [B, N_pad, ...] with flag_simple's noise (σ =
    0.003 on the world positions, γ = 0.1): accumulation_steps=1 (the
    warmup gate over both frames), then 2 updates, both trainers fed the
    same noise draw (JAX's, in the batch's shape) each step: the losses,
    the normalizer states after the gate and each tensor's update, as
    `test_torch_port_contact.py`'s trainer test holds them."""
    hj, ht, jcfg = case["hj"], case["ht"], case["jcfg"]
    node_in, target, mask = frames
    opt_kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=6)
    tcfg = flag_simple_config(unet_depth=DEPTH, hidden_layer=HIDDEN,
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
            np.testing.assert_allclose(getattr(got, f).numpy(), want[f],
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name}.{f}")
    want = jax_param_grads(jtr.state.sim.params)
    sched = warmup_cosine_schedule(**opt_kw)
    assert sched(0) == 0.0  # the first update runs at rate 0
    for k, p in ttr.sim.state_dict().items():
        upd, upd_j = p.numpy() - init[k].numpy(), want[k].numpy() - init[k].numpy()
        rms = np.sqrt(np.mean(upd_j.astype(np.float64) ** 2))
        assert rms > 0, k
        err = np.sqrt(np.mean((upd - upd_j).astype(np.float64) ** 2))
        assert err <= 1e-2 * rms, f"{k}: update rms err {err:.3e} of {rms:.3e}"
