"""The batch axis of the port on its main path (a shared windowed mesh, the
`fused` method) against the JAX package on the CPU, and against itself.

The case is `test_torch_port_slice.py`'s (a 24×24 grid with scrambled ids,
depth 3, window 128, edge_block 512, latent 128, hidden 2), at B = 2
frames drawn from numpy seeds. JAX's Pallas kernels run in interpret mode,
vmapped over the batch as the JAX package runs them on a consistent mesh.

- Each batched plain version of kernels 1-7 and 14 (`"fused4"`, K = 2)
  against JAX's vmapped kernel function on one level, at the tolerances
  of `test_torch_port_kernels.py` (forward) and `test_torch_port_train.py`
  (backward).
- Each batched plain version sample by sample equal, bit for bit, to the
  unbatched plain call on that sample (the per-row outputs); the weight
  gradients of kernels 5, 6 and 14 against the sum of the unbatched
  calls'.
- Every wrapper off the batched path still raises
  NotImplementedError("batch axis") on a batch; those that took the batch
  in later slices (kernels 8 and 10-14, the kernel-8 and narrow transition
  routes, the gathers on a block-aligned level) return its shape.

The forward, the loss and the gradients at B = 2 are in
`test_torch_port_batch_grads.py`, the `Trainer` in
`test_torch_port_batch_train.py`; the world-edge path (kernel 13) at B in
`test_torch_port_batch_contact.py`."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_slice import case  # noqa: F401 (fixture)

from bsms_gnn_tpu.ops.pallas import compact_resid as jax_cr
from bsms_gnn_tpu.ops.pallas.fused_gmp import fused_edge_phase_win as jax_edge
from bsms_gnn_tpu.ops.pallas.fused_gmp import fused_edge_phase_win_k as jax_v5
from bsms_gnn_tpu.ops.pallas.node_mlp import fused_node_phase as jax_node
from bsms_gnn_tpu.ops.pallas.windowed import (
    windowed_rect_conv_raw,
    windowed_send_sum_raw,
)
from bsms_gnn_tpu_torch.ops import message, scatter, transition
from bsms_gnn_tpu_torch.ops.kernels import (
    agg_node,
    compact_resid,
    fused_gmp,
    fused_gmp_dyn,
    fused_gmp_k,
    fused_gmp_stream,
    node_mlp,
    segment_sum,
    segment_sum_accum,
    subwin_conv,
    windowed,
)

B = 2
C = 128
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# test_torch_port_kernels.py's forward tolerances (of max(1, the largest
# |value|)) and test_torch_port_train.py's backward ones (of the largest
# |value|).
MLP_TOL = {"f32": 1e-4, "bf16": 2e-2}
SELECT_TOL = {"f32": 1e-4, "bf16": 1e-5}
KERNEL_TOL = {"f32": 1e-4, "bf16": 3e-2}
# The weight gradients of one batched call against the sum of the
# unbatched calls': the same f32 terms summed in another order.
SUM_TOL = 1e-5


def rand(rng, *shape, s=1.0):
    return (s * rng.standard_normal(shape)).astype(np.float32)


def both(a, dt):
    jd, td = DTYPES[dt]
    return jnp.asarray(a).astype(jd), torch.tensor(a).to(td)


def assert_close(got, want, tol, scale_floor=1.0, what=""):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    scale = max(scale_floor, np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} * {scale:.3e}"


def edge_args(case, lvl, rng, dt):
    """Kernel 4's / 5's arguments at level lvl for a batch: xwi, xj [B,
    n_pad, C], wf8 and the tail of that level's down GMP, numpy and
    torch."""
    ht, state, sim = case["ht"], case["state"], case["sim"]
    n = ht.levels[lvl].n_pad_nodes
    xwi, xj = rand(rng, B, n, C), rand(rng, B, n, C)
    wf8 = rand(rng, 8, C, s=0.3)
    mj = state.params.process.down_gmps[lvl].mlp_edge
    mt = sim.process.down_gmps[lvl].mlp_edge
    return (xwi, xj, wf8, mj, list(mt.weights)[1:], list(mt.biases)[1:])


# -- (a) each batched plain version against JAX's vmapped kernel ------------


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_rect_conv_and_compact_accum_batched_match_jax(case, dt):
    """Kernel 1 (T0 down, B = 2) and kernel 2 (its compact residual and
    level 0's) against JAX's vmapped `windowed_rect_conv_raw` and
    `compact_accum_raw`."""
    hj, ht = case["hj"], case["ht"]
    rng = np.random.default_rng(31)
    opj, opt = hj.transitions[0].down_op, ht.transitions[0].down_op
    xj, xt = both(rand(rng, B, opt.n_in_pad, C), dt)
    got = windowed.windowed_rect_conv(opt, xt)
    assert got.shape == (B, opt.n_pad_nodes, C) and got.dtype == torch.float32
    assert_close(got, windowed_rect_conv_raw(opj, xj), SELECT_TOL[dt])
    for crj, crt in ((opj.cresid, opt.cresid),
                     (hj.levels[0].cresid, ht.levels[0].cresid)):
        vj, vt = both(rand(rng, B, crt.n_rows, C), dt)
        acc = rand(rng, B, crt.n_pad_nodes, C)
        acc_t = torch.tensor(acc)
        out = compact_resid.compact_accum_raw(crt, vt, acc_t)
        assert out is acc_t  # in place
        assert_close(out, jax_cr.compact_accum_raw(crj, vj, jnp.asarray(acc)),
                     SELECT_TOL[dt])


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_node_phase_batched_matches_jax(case, dt):
    """Kernel 3 and, through the autograd Function, kernel 6 at B = 2
    against the vmapped JAX `fused_node_phase` and its `jax.vjp`."""
    state, sim, ht = case["state"], case["sim"], case["ht"]
    n = ht.levels[0].n_pad_nodes
    rng = np.random.default_rng(32)
    x, aggr, g = rand(rng, B, n, C), rand(rng, B, n, C, s=3.0), rand(
        rng, B, n, C)
    cd_j, cd_t = (None, None) if dt == "f32" else DTYPES[dt]
    mj = state.params.process.down_gmps[0].mlp_node

    def f(xx, aa, ws, bs):
        return jax_node(xx, aa, dataclasses.replace(mj, weights=ws, biases=bs),
                        cd_j)

    y, vjp = jax.vjp(f, both(x, dt)[0], jnp.asarray(aggr), mj.weights,
                     mj.biases)
    dx, daggr, dws, dbs = vjp(jnp.asarray(g).astype(y.dtype))

    mt = sim.process.down_gmps[0].mlp_node
    mt.zero_grad(set_to_none=True)
    xt = both(x, dt)[1].requires_grad_()
    at = torch.tensor(aggr).requires_grad_()
    out = node_mlp.fused_node_phase(xt, at, mt, cd_t)
    assert out.shape == (B, n, C)
    assert_close(out, y, MLP_TOL[dt], what="out")
    out.backward(torch.tensor(g).to(out.dtype))
    tol = KERNEL_TOL[dt]
    assert_close(xt.grad, dx, tol, 1e-30, "dx")
    assert_close(at.grad, daggr, tol, 1e-30, "daggr")
    for i in range(len(mt.weights)):
        assert_close(mt.weights[i].grad, dws[i], tol, 1e-30, f"dW{i}")
        assert_close(mt.biases[i].grad, dbs[i], tol, 1e-30, f"db{i}")
    mt.zero_grad(set_to_none=True)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_edge_phase_batched_matches_jax(case, dt):
    """Kernel 4 and, through the autograd Function, kernels 5 and 7 at
    level 0 (windowed, with a compact residual) at B = 2 against the
    vmapped JAX `fused_edge_phase_win` and its `jax.vjp`; kernel 7 also
    alone against JAX's vmapped `windowed_send_sum_raw`."""
    hj, ht = case["hj"], case["ht"]
    rng = np.random.default_rng(33)
    xwi, xj, wf8, mj, ws_t, bs_t = edge_args(case, 0, rng, dt)
    n = ht.levels[0].n_pad_nodes
    g = rand(rng, B, n, C)

    def f(a, b, w8, ws, bs):
        return jax_edge(hj.levels[0], a, b, w8, ws, bs)

    args = (both(xwi, dt)[0], both(xj, dt)[0], jnp.asarray(wf8),
            tuple(mj.weights[1:]), tuple(mj.biases[1:]))
    y, vjp = jax.vjp(f, *args)
    dxwi, dxj, dwf8, dws, dbs = vjp(jnp.asarray(g))

    a = both(xwi, dt)[1].requires_grad_()
    b = both(xj, dt)[1].requires_grad_()
    w8 = torch.tensor(wf8).requires_grad_()
    ws = [w.detach().clone().requires_grad_() for w in ws_t]
    bs = [x.detach().clone().requires_grad_() for x in bs_t]
    out = fused_gmp.fused_edge_phase_win(ht.levels[0], a, b, w8, ws, bs)
    assert out.shape == (B, n, C) and out.dtype == torch.float32
    assert_close(out, y, MLP_TOL[dt], what="aggr")
    out.backward(torch.tensor(g))
    tol = KERNEL_TOL[dt]
    assert a.grad.dtype == a.dtype and b.grad.dtype == b.dtype
    assert_close(a.grad, dxwi, tol, 1e-30, "dxwi")
    assert_close(b.grad, dxj, tol, 1e-30, "dxj")
    assert_close(w8.grad, dwf8, tol, 1e-30, "dwf8")
    for i, (w, x) in enumerate(zip(ws, bs)):
        assert_close(w.grad, dws[i], tol, 1e-30, f"dW{i}")
        assert_close(x.grad, dbs[i], tol, 1e-30, f"db{i}")

    vals = rand(rng, B, ht.levels[0].n_pad_edges, C)
    vj, vt = both(vals, dt)
    got = windowed.windowed_send_sum(ht.levels[0], vt)
    assert got.shape == (B, n, C)
    assert_close(got, windowed_send_sum_raw(hj.levels[0], vj), SELECT_TOL[dt])


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_kernel14_batched_matches_jax_v5(case, dt):
    """Kernel 14 (`fused_edge_phase_win_k`, K = 2, the density gate off:
    `min_density=0`) and, through the autograd Function, its backward and
    kernel 7 at level 0 at B = 2 against JAX's v5 at K = 2, which vmaps
    itself over a batch (`fused_gmp.py:1545-1550`), and its `jax.vjp`;
    kernel 14's plain versions run, not kernel 4's."""
    hj, ht = case["hj"], case["ht"]
    rng = np.random.default_rng(35)
    xwi, xj, wf8, mj, ws_t, bs_t = edge_args(case, 0, rng, dt)
    n = ht.levels[0].n_pad_nodes
    g = rand(rng, B, n, C)

    def f(a, b, w8, ws, bs):
        return jax_v5(hj.levels[0], a, b, w8, ws, bs, 2, min_density=0)

    args = (both(xwi, dt)[0], both(xj, dt)[0], jnp.asarray(wf8),
            tuple(mj.weights[1:]), tuple(mj.biases[1:]))
    y, vjp = jax.vjp(f, *args)
    dxwi, dxj, dwf8, dws, dbs = vjp(jnp.asarray(g))

    a = both(xwi, dt)[1].requires_grad_()
    b = both(xj, dt)[1].requires_grad_()
    w8 = torch.tensor(wf8).requires_grad_()
    ws = [w.detach().clone().requires_grad_() for w in ws_t]
    bs = [x.detach().clone().requires_grad_() for x in bs_t]
    for fn in (fused_gmp_k.fused_edge_phase_win_k_plain,
               fused_gmp_k.fused_edge_phase_win_k_bwd_plain,
               fused_gmp.fused_edge_phase_win_plain):
        fn.calls = 0
    out = fused_gmp_k.fused_edge_phase_win_k(ht.levels[0], a, b, w8, ws, bs,
                                             2, min_density=0)
    assert out.shape == (B, n, C) and out.dtype == torch.float32
    assert_close(out, y, MLP_TOL[dt], what="aggr")
    out.backward(torch.tensor(g))
    assert fused_gmp_k.fused_edge_phase_win_k_plain.calls == 1
    assert fused_gmp_k.fused_edge_phase_win_k_bwd_plain.calls == 1
    assert fused_gmp.fused_edge_phase_win_plain.calls == 0
    tol = KERNEL_TOL[dt]
    assert a.grad.dtype == a.dtype and b.grad.dtype == b.dtype
    assert_close(a.grad, dxwi, tol, 1e-30, "dxwi")
    assert_close(b.grad, dxj, tol, 1e-30, "dxj")
    assert_close(w8.grad, dwf8, tol, 1e-30, "dwf8")
    for i, (w, x) in enumerate(zip(ws, bs)):
        assert_close(w.grad, dws[i], tol, 1e-30, f"dW{i}")
        assert_close(x.grad, dbs[i], tol, 1e-30, f"db{i}")


# -- (b) each batched plain version, sample by sample ----------------------


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_batched_plain_versions_equal_each_sample(case, dt):
    """Each batched plain version of kernels 1-7 and 14 (and the compact
    gather), sample b bit for bit the unbatched call on sample b, at levels
    0 and 1 and T0's operators; kernels 5's, 6's and 14's weight gradients
    against the sum of the unbatched calls'."""
    ht, sim = case["ht"], case["sim"]
    torch.set_grad_enabled(False)
    try:
        _plain_versions_per_sample(case, ht, sim, dt)
    finally:
        torch.set_grad_enabled(True)


def _plain_versions_per_sample(case, ht, sim, dt):
    td = DTYPES[dt][1]
    cd = td if dt == "bf16" else None
    rng = np.random.default_rng(34)

    def t(a):
        return torch.tensor(a).to(td)

    def per_sample(fn, *args, batched=(), out=None):
        """fn on the batch and on each sample (the arguments at the indices
        in `batched` split by sample); the outputs at the indices in `out`
        (every output when None) compared bit for bit per sample. Returns
        (the batched outputs, each sample's)."""
        got = fn(*args)
        got = got if isinstance(got, tuple) else (got,)
        ones = []
        for s in range(B):
            a = [x[s] if i in batched else x for i, x in enumerate(args)]
            one = fn(*a)
            one = one if isinstance(one, tuple) else (one,)
            ones.append(one)
            for i in (range(len(got)) if out is None else out):
                assert torch.equal(got[i][s], one[i]), (fn.__name__, i, s)
        return got, ones

    t0 = ht.transitions[0]
    for op in (t0.down_op, t0.up_op):
        per_sample(windowed.windowed_rect_conv_plain, op,
                   t(rand(rng, B, op.n_in_pad, C)), batched=(1,))
    for cr in (ht.levels[0].cresid, t0.down_op.cresid):
        vals = t(rand(rng, B, cr.n_rows, C))
        acc = torch.tensor(rand(rng, B, cr.n_pad_nodes, C))
        got = compact_resid.compact_accum_plain(cr, vals, acc.clone())
        for s in range(B):
            one = compact_resid.compact_accum_plain(cr, vals[s], acc[s].clone())
            assert torch.equal(got[s], one)
    cr = ht.levels[0].cresid
    x0 = t(rand(rng, B, ht.levels[0].n_pad_nodes, C))
    for by in ("send", "recv"):
        per_sample(compact_resid.compact_gather, cr, x0, by, batched=(1,))
    for lvl in (0, 1):
        level = ht.levels[lvl]
        n = level.n_pad_nodes
        gmp = sim.process.down_gmps[lvl]
        xwi, xj, wf8, _, ws, bs = edge_args(case, lvl, rng, dt)
        eargs = (level, t(xwi), t(xj), torch.tensor(wf8), ws, bs)
        per_sample(fused_gmp.fused_edge_phase_win_plain, *eargs,
                   batched=(1, 2))
        per_sample(fused_gmp_k.fused_edge_phase_win_k_plain, *eargs, 2,
                   batched=(1, 2))
        g = torch.tensor(rand(rng, B, n, C))
        for bwd in (fused_gmp.fused_edge_phase_win_bwd_plain,
                    functools.partial(
                        fused_gmp_k.fused_edge_phase_win_k_bwd_plain, k=2)):
            got, ones = per_sample(bwd, *eargs, g, batched=(1, 2, 6),
                                   out=(0, 1))
            for i in (2, 3, 4):  # dwf8, dW, db: summed over the batch
                want = sum(o[i] for o in ones)
                torch.testing.assert_close(
                    got[i], want, rtol=SUM_TOL,
                    atol=SUM_TOL * float(want.abs().max()))
        per_sample(windowed.windowed_send_sum_plain, level,
                   t(rand(rng, B, level.n_pad_edges, C)), batched=(1,))
        x, aggr = t(rand(rng, B, n, C)), torch.tensor(rand(rng, B, n, C, s=3.0))
        per_sample(node_mlp.fused_node_phase_plain, x, aggr, gmp.mlp_node, cd,
                   batched=(0, 1))
        got, ones = per_sample(node_mlp.fused_node_phase_bwd_plain, x, aggr,
                               gmp.mlp_node, g, cd, batched=(0, 1, 3),
                               out=(0, 1))
        for i in range(2, 7):  # dWa, dWb, db0, dW, db
            want = sum(o[i] for o in ones)
            torch.testing.assert_close(got[i], want, rtol=SUM_TOL,
                                       atol=SUM_TOL * float(want.abs().max()))


# -- (f) what stays at B = 1 ---------------------------------------------


def test_off_path_wrappers_refuse_a_batch(case):
    """Every wrapper off the batched path raises
    NotImplementedError("batch axis") on a [B, ...] input: kernels 9 and
    15 and the gathers on a skip-empty layout (their backward is kernel 9).
    Kernels 8 (both forms), 10, 11, 12, 13 and 14 (the autograd entries
    and kernel 14's forward), kernel 1's level form and the explicit conv
    on a level with a compact residual (a shard's ghost conv on a batch of
    frames), the kernel-8 and narrow transition routes and the gathers on
    a block-aligned level take the batch: each returns its [B, ...]
    shape."""
    ht, sim = case["ht"], case["sim"]
    lvl = ht.levels[0]
    n, e = lvl.n_pad_nodes, lvl.n_pad_edges
    x = torch.zeros(B, n, C)
    feat = torch.zeros(B, e, C)
    acc = torch.zeros(B, n, C)
    gmp = sim.process.down_gmps[0]
    ws, bs = list(gmp.mlp_edge.weights)[1:], list(gmp.mlp_edge.biases)[1:]
    wf8 = torch.zeros(8, C)
    op = ht.transitions[0].down_op
    unwindowed = dataclasses.replace(op, window=0)
    skip_empty = dataclasses.replace(lvl, skip_empty=True)
    calls = {
        "kernel 9": lambda: segment_sum_accum.segment_sum_accum_raw(
            lvl, feat, acc),
        "kernel 9 autograd": lambda: segment_sum_accum.segment_sum_accum(
            lvl, feat, acc),
        "kernel 15": lambda: subwin_conv.subwin_conv(
            lvl, x, torch.zeros(e), None, None),
        "gather_send skip-empty": lambda: scatter.gather_send(skip_empty, x),
        "gather_recv skip-empty": lambda: scatter.gather_recv(skip_empty, x),
    }
    for what, call in calls.items():
        with pytest.raises(NotImplementedError, match="batch axis"):
            call()
    runs = {
        "kernel 8": (lambda: segment_sum.segment_sum_raw(lvl, feat),
                     (B, n, C)),
        "kernel 1 level form": (lambda: windowed.windowed_conv(lvl, x, lvl.ew),
                                (B, n, C)),
        "explicit conv": (lambda: message.edge_conv_down(lvl, x), (B, n, C)),
        "kernel 8 send": (lambda: segment_sum.segment_sum_send(lvl, feat),
                          (B, n, C)),
        "kernel 10": (lambda: agg_node.fused_aggregate_node_phase(
            lvl, feat, x, gmp.mlp_node), (B, n, C)),
        "kernel 11": (lambda: fused_gmp_stream.fused_edge_mlp_aggregate(
            lvl, feat, ws, bs), (B, n, C)),
        "kernel 12": (lambda: fused_gmp_stream.fused_edge_phase(
            lvl, feat, x, ws, bs), (B, n, C)),
        "kernel 13": (lambda: fused_gmp_dyn.fused_edge_phase_win_dyn(
            lvl, x, x, torch.zeros(B, n, 3), wf8, torch.zeros(3, C),
            torch.zeros(C), ws, bs), (B, n, C)),
        "kernel 14": (lambda: fused_gmp_k.fused_edge_phase_win_k(
            lvl, x, x, wf8, ws, bs, 2, min_density=0), (B, n, C)),
        "kernel 14 forward": (lambda: fused_gmp_k.fused_edge_phase_win_k_fwd(
            lvl, x, x, wf8, ws, bs, 2), (B, n, C)),
        "kernel-8 transition": (lambda: transition._apply(
            unwindowed, torch.zeros(B, op.n_in_pad, C)),
            (B, op.n_pad_nodes, C)),
        "narrow transition": (lambda: transition.narrow_apply(
            op, torch.zeros(B, op.n_in_pad, 3)), (B, op.n_pad_nodes, 3)),
        "gather_send": (lambda: scatter.gather_send(lvl, x), (B, e, C)),
        "gather_recv": (lambda: scatter.gather_recv(lvl, x), (B, e, C)),
    }
    with torch.no_grad():
        for what, (call, shape) in runs.items():
            assert call().shape == shape, what
