"""The batch axis on the streamed `fused` routes of unwindowed hierarchies
(v2: kernel 12; v1 with world edges: kernel 11) against the JAX package on
the CPU, and against itself.

The cases are `test_torch_port_fused_stream.py`'s (`plain`: a 300-node
airfoil, v2; `world`: a 600-node sphere with world edges, v1; depth 2,
latent 128, hidden 1, T0 without its dense forms), at B = 2. JAX's v2 and
v1 kernels run in interpret mode and vmap themselves over a batch
(`fused_gmp.py:1179`, `:1255`), as the JAX package runs them on a
consistent mesh.

- Kernels 12's and 11's batched plain forwards against JAX's on the batch
  (f32, bf16), every row of each sample (row n_pad − 1, where the last
  block's pad slots land, included), each sample bit for bit the
  unbatched call.
- Their backwards through the autograd Functions at B against `jax.vjp`
  (dzi and dxj, or dpre; dW and db summed over the batch); the batched
  plain backwards sample by sample bit for bit the unbatched calls (dzi,
  dxj, dpre), the weight gradients against the sum of theirs. The draws
  leave every ReLU input of the tail on the counted slots at least
  RELU_MARGIN from zero (asserted), so no unit sits within f32 rounding of
  its kink.
- A CPU emulation of the kernels' batched tile walk (`csrc/edge_fwd_tiles.
  cuh`, `csrc/edge_bwd_tiles.cuh` with the kStream front): B·T tiles, tile
  t of sample ⌊t / T⌋, each sample's streamed rows read E_pad rows after
  the last's and its xj and cotangent rows n_pad after, its messages and
  dpre stored E_pad rows after, then the receiver gather over each
  sample's lists, against the plain versions; the same walk with the
  streamed rows moving by n_pad rows (the node rows' stride) agrees on
  sample 0 and misses on sample 1, so the emulation tells the two strides
  apart.
- The fused-v2 airfoil's and the fused surface's models at B: the forward
  against JAX's (each sample bit for bit the port's forward on that frame
  alone), the masked RMSE over the batch and every gradient against one
  JAX compile.

Tolerances are `test_torch_port_fused_stream.py`'s (KERNEL_TOL, F32_TOL,
GRAD_F32_TOL) and `test_torch_port_batch.py`'s (SUM_TOL for the sums over
the batch); the emulation against the plain versions 1e-5 of the largest
|value| (the same f32 terms summed in other orders).

The frames' seed is fixed for the reason `test_torch_port_batch_grads.py`
gives (a whole model's ReLU inputs hold some within f32 rounding of zero);
at FRAME_SEED every gradient of both cases lands within 1e-5 of its RMS."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_batch import SUM_TOL
from test_torch_port_fused_stream import (
    CASES,
    DTYPES,
    F32_TOL,
    GRAD_F32_TOL,
    KERNEL_TOL,
    _case,
    _jax_kernel,
    _port_kernel,
)
from test_torch_port_train import assert_close, jax_param_grads

from bsms_gnn_tpu.models.simulator import simulator_forward_auto
from bsms_gnn_tpu.training.trainer import masked_rmse as jax_masked_rmse
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp_stream as fgs
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import (
    TILE_ROWS,
    dot,
    mlp_tail_bwd,
    mlp_tail_fwd_save,
)
from bsms_gnn_tpu_torch.training.trainer import masked_rmse

B = 2
C = 128
RELU_MARGIN = 3e-6
WALK_TOL = 1e-5
# The seed of the backward tests' draws: every ReLU input of the hidden
# tail layer on the counted slots at least RELU_MARGIN from zero, in f32
# and in bf16, in both cases (asserted).
SEED = 41
FRAME_SEED = 2


@pytest.fixture(scope="module", params=CASES)
def case(request):
    c = _case(request.param)
    yield c
    c["sim"].zero_grad(set_to_none=True)


def _inputs(case, seed, lvl=0):
    """Level lvl (JAX, port), seeded batch inputs: the streamed rows [B,
    E_pad, C] (zi for v2, pre for v1), xj [B, n_pad, C] (v2 only) and a
    cotangent g [B, n_pad, C]; and a two-layer tail (weights, biases as
    numpy): a seeded hidden layer, then the last layer of level lvl's down
    GMP. The hidden layer makes a ReLU input a sum of products, whose
    order differs between the two sides (the first layer's is an input,
    or one addition, on both)."""
    lj, lt = case["hj"].levels[lvl], case["ht"].levels[lvl]
    rng = np.random.default_rng(seed)
    rows = [rng.standard_normal((B, lt.n_pad_edges, C)).astype(np.float32)]
    if not case["dyn_dims"]:
        rows.append(rng.standard_normal((B, lt.n_pad_nodes, C)).astype(
            np.float32))
    g = rng.standard_normal((B, lt.n_pad_nodes, C)).astype(np.float32)
    mt = case["sim"].process.down_gmps[lvl].mlp_edge
    ws = [rng.standard_normal((C, C)).astype(np.float32),
          mt.weights[-1].detach().numpy()]
    bs = [(0.1 * rng.standard_normal(C)).astype(np.float32),
          mt.biases[-1].detach().numpy()]
    return lj, lt, rows, g, (ws, bs)


def _torch_rows(rows, td):
    return [torch.tensor(r).to(td) for r in rows]


def _jax_tail(tail):
    return tuple(tuple(jnp.asarray(a) for a in t) for t in tail)


def _torch_tail(tail, grad=False):
    return [[torch.tensor(a).requires_grad_(grad) for a in t] for t in tail]


def _relu_margin(lt, rows, weights, biases):
    """The smallest |ReLU input| of the tail's hidden layers over the
    counted slots (a receiver in the chunk's block) of every sample, in the
    plain version's arithmetic."""
    src, xj = rows[0], rows[1] if len(rows) > 1 else None
    bf16 = src.dtype == torch.bfloat16
    pre, _, inb = fgs._stream_pre(lt, src, xj)
    zs, h = [], torch.relu(pre)
    for w, b in zip(weights[:-1], biases[:-1]):
        zs.append(dot(h, w.float(), bf16) + b.float())
        h = torch.relu(zs[-1])
    return min(float(z[..., inb, :].abs().min()) for z in zs)


# -- kernels 12 and 11 --------------------------------------------------------


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_stream_kernel_batched_forward_matches_jax(case, dt):
    lj, lt, rows, _, tail = _inputs(case, 40)
    jd, td = DTYPES[dt]
    want = _jax_kernel(case)(lj, *(jnp.asarray(r).astype(jd) for r in rows),
                             *_jax_tail(tail))
    entry, plain, _ = _port_kernel(case)
    trows = _torch_rows(rows, td)
    tail = _torch_tail(tail)
    plain.calls = 0
    with torch.no_grad():
        got = entry(lt, *trows, *tail)
        assert plain.calls == 1
        assert got.dtype == torch.float32
        assert got.shape == (B, lt.n_pad_nodes, C)
        assert_close(got, want, KERNEL_TOL[dt], dt)
        last = lt.n_pad_nodes - 1
        for s in range(B):
            assert_close(got[s, last], np.asarray(want)[s, last],
                         KERNEL_TOL[dt], f"sample {s} row n_pad - 1")
            assert torch.equal(got[s], entry(lt, *(r[s] for r in trows),
                                             *tail))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_stream_kernel_batched_backward_matches_jax(case, dt):
    """Through the autograd Function at B: the streamed rows' and (v2) xj's
    cotangents and dW, db against jax.vjp of the JAX kernel on the batch;
    then the batched plain backward sample by sample."""
    lj, lt, rows, g, tail = _inputs(case, SEED)
    jd, td = DTYPES[dt]
    with torch.no_grad():
        assert _relu_margin(lt, _torch_rows(rows, td),
                            *_torch_tail(tail)) >= RELU_MARGIN
    fn = _jax_kernel(case)
    _, vjp = jax.vjp(lambda *a: fn(lj, *a), *(jnp.asarray(r).astype(jd)
                                              for r in rows), *_jax_tail(tail))
    *d_rows, dws, dbs = vjp(jnp.asarray(g))

    entry, _, bwd_plain = _port_kernel(case)
    leaves = [r.requires_grad_() for r in _torch_rows(rows, td)]
    ws, bs = _torch_tail(tail, grad=True)
    bwd_plain.calls = 0
    entry(lt, *leaves, ws, bs).backward(torch.tensor(g))
    assert bwd_plain.calls == 1
    tol = KERNEL_TOL[dt]
    for x, want, what in zip(leaves, d_rows, ("d_edge_rows", "dxj")):
        assert x.grad.dtype == td and x.grad.shape == x.shape
        assert_close(x.grad, want, tol, what)
    for i, (w, b) in enumerate(zip(ws, bs)):
        assert_close(w.grad, dws[i], tol, f"dW{i}")
        assert_close(b.grad, dbs[i], tol, f"db{i}")
    _, inb = fgs.in_block(lt)
    assert (leaves[0].grad[:, ~inb] == 0).all()

    with torch.no_grad():
        trows, gt = _torch_rows(rows, td), torch.tensor(g)
        tail = _torch_tail(tail)
        got = bwd_plain(lt, *trows, *tail, gt)
        ones = [bwd_plain(lt, *(r[s] for r in trows), *tail, gt[s])
                for s in range(B)]
        n_rows = len(got) - 2  # dzi, dxj or dpre; then dW, db
        for s in range(B):
            for i in range(n_rows):
                assert torch.equal(got[i][s], ones[s][i]), (i, s)
        for i in (n_rows, n_rows + 1):
            want = sum(o[i] for o in ones)
            torch.testing.assert_close(got[i], want, rtol=SUM_TOL,
                                       atol=SUM_TOL * float(want.abs().max()))


# -- the batched tile walk, emulated -------------------------------------------


def _walk(lt, src, xj, ws, bs, g=None, src_rows=None):
    """The kStream walk over B·T tiles on flat arrays, as the kernels run
    it: tile t is tile t mod T of sample ⌊t / T⌋; sample s's streamed rows
    start at row s·`src_rows` of src (E_pad in the kernels), its xj and g
    rows at s·n_pad, its messages (forward) or dpre (backward, with g) at
    s·E_pad. Then the receiver gather of each sample's messages (or, v2,
    of its bf16-rounded dpre for dxj) over the level's lists. Returns the
    aggregate, or (dpre, dxj, dW, db)."""
    e_pad, n_pad = lt.n_pad_edges, lt.n_pad_nodes
    src_rows = e_pad if src_rows is None else src_rows
    n_tiles = e_pad // TILE_ROWS
    recv, inb = fgs.in_block(lt)
    src_f = src.reshape(-1, C).float()
    xj_f = None if xj is None else xj.reshape(-1, C).float()
    out_f = torch.full((B * e_pad, C), float("nan"))
    dw = db = 0.0
    for t in range(B * n_tiles):
        smp, t0 = t // n_tiles, (t % n_tiles) * TILE_ROWS
        e = torch.arange(t0, t0 + TILE_ROWS)
        live = inb[e]
        if not bool(live.any()):
            if g is not None:  # a dead tile's dpre rows are zero
                out_f[smp * e_pad + e] = 0.0
            continue
        pre = src_f[smp * src_rows + e]
        if xj_f is not None:
            pre = pre + torch.where(live[:, None],
                                    xj_f[smp * n_pad + recv[e]], 0.0)
        normed, inv, hs = mlp_tail_fwd_save(pre, ws, bs, False)
        if g is None:
            out_f[smp * e_pad + e[live]] = normed[live]
            continue
        ge = torch.where(live[:, None], g.reshape(-1, C)[smp * n_pad
                                                         + recv[e]], 0.0)
        dpre, dw_t, db_t = mlp_tail_bwd(pre, hs, normed, inv, ge, ws, False)
        out_f[smp * e_pad + e] = dpre
        dw, db = dw + dw_t, db + db_t
    rows = out_f.reshape(B, e_pad, C)
    # The receiver gather over `row_ptr` / `row_slots`: exactly the counted
    # slots, so no unwritten (NaN) message row is read.
    lists = torch.repeat_interleave(torch.arange(n_pad),
                                    torch.diff(lt.row_ptr.long()))
    slots = lt.row_slots.long()
    summed = torch.zeros(B, n_pad, C).index_add_(
        1, lists, rows.index_select(1, slots))
    if g is None:
        return summed
    return rows, (summed if xj is not None else None), dw, db


def test_walk_emulation_matches_the_plain_versions(case):
    """f32 at level 0 (v2 with xj, v1 without): the emulated batched walk
    against the batched plain forward and backward; with the streamed rows
    moving by n_pad rows instead of E_pad, sample 0 still agrees and
    sample 1 does not."""
    _, lt, rows, g, tail = _inputs(case, SEED)
    src = torch.tensor(rows[0])
    xj = torch.tensor(rows[1]) if len(rows) > 1 else None
    ws, bs = _torch_tail(tail)
    gt = torch.tensor(g)
    _, plain, bwd_plain = _port_kernel(case)
    args = (src,) if xj is None else (src, xj)
    with torch.no_grad():
        assert _relu_margin(lt, [src] + ([] if xj is None else [xj]), ws,
                            bs) >= RELU_MARGIN
        want = plain(lt, *args, ws, bs)
        got = _walk(lt, src, xj, ws, bs)
        assert_close(got, want, WALK_TOL, "aggregate")
        bwd = bwd_plain(lt, *args, ws, bs, gt)
        dpre, dxj, dw, db = _walk(lt, src, xj, ws, bs, gt)
        assert_close(dpre, bwd[0], WALK_TOL, "dpre")
        if xj is not None:
            assert_close(dxj, bwd[1], WALK_TOL, "dxj")
        assert_close(dw, bwd[-2], WALK_TOL, "dW")
        assert_close(db, bwd[-1], WALK_TOL, "db")
        assert lt.n_pad_nodes != lt.n_pad_edges
        wrong = _walk(lt, src, xj, ws, bs, src_rows=lt.n_pad_nodes)
        assert_close(wrong[0], want[0], WALK_TOL, "sample 0, node stride")
        scale = float(want[1].abs().max())
        assert float((wrong[1] - want[1]).abs().max()) > 0.1 * scale


# -- the models -----------------------------------------------------------------


def _frames(case):
    """B frames of the case's model: the plain case's seeded output fields
    on the real rows with targets a seeded step away; the world case's
    train frame pair (the inflating trajectory's frames 0 and 1) with
    sample s's world positions and target moved by 0.02·N(0, 1) on the
    real rows. Sample s draws from seed FRAME_SEED + s; the case's mask,
    repeated."""
    node_in, target = case["train"]
    mask = case["mask"]
    n = case["ht"].levels[0].n_nodes
    ins, tars = [], []
    for s in range(B):
        rng = np.random.default_rng(FRAME_SEED + s)
        ni, tar = node_in.copy(), target.copy()
        if case["dyn_dims"]:
            shift = 0.02 * rng.standard_normal((n, 3))
            ni[:n, :3] += shift
            tar[:n] += shift
        else:
            ni[:n, :3] = rng.standard_normal((n, 3))
            tar = ni[:, :3] + 0.1 * rng.standard_normal(
                ni[:, :3].shape).astype(np.float32) * mask
        ins.append(ni)
        tars.append(tar)
    return (np.stack(ins).astype(np.float32),
            np.stack(tars).astype(np.float32),
            np.repeat(mask[None], B, axis=0))


@pytest.fixture(scope="module")
def model_ref(case):
    """The case's frames and (prediction, loss, gradients) of JAX's f32
    model on them, from one compile."""
    hj, jcfg, state = case["hj"], case["jcfg"], case["state"]
    frames = _frames(case)

    def loss_fn(params, ni, nt, m):
        pred = simulator_forward_auto(params, state.norm_in, state.norm_out,
                                      hj, ni, m, jcfg, None)
        return jax_masked_rmse(pred, nt, m), pred

    (loss, pred), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(state.params,
                                *(jnp.asarray(a) for a in frames))
    return frames, np.asarray(pred), float(loss), jax_param_grads(grads)


def test_model_forward_batched_matches_jax(case, model_ref):
    """The forward on [B, N_pad, ...] against JAX's (F32_TOL): kernel 12
    (or 11) once per GMP at any B, each sample bit for bit the port's
    forward on that frame alone."""
    ht, sim = case["ht"], case["sim"]
    (node_in, _, mask), want = model_ref[0], model_ref[1]
    _, plain, _ = _port_kernel(case)
    with torch.no_grad():
        plain.calls = 0
        got = sim(ht, torch.from_numpy(node_in), torch.from_numpy(mask))
        assert plain.calls == 2 * len(sim.process.down_gmps) + 1
        assert got.shape == want.shape == (B, ht.levels[0].n_pad_nodes, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL)
        for s in range(B):
            assert torch.equal(got[s], sim(ht, torch.from_numpy(node_in[s]),
                                           torch.from_numpy(mask[s])))


def test_model_loss_and_gradients_batched_match_jax(case, model_ref):
    """The masked RMSE over the batch (1e-5) and every parameter's
    gradient (GRAD_F32_TOL of its RMS) against JAX's, f32."""
    ht, sim = case["ht"], case["sim"]
    frames, _, loss_j, want = model_ref
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
        if rms == 0:  # the bottom GMP's edge MLP: its level has no edge
            assert np.abs(g).max() == 0, k
            continue
        err = np.abs(g - w).max()
        assert err <= GRAD_F32_TOL * rms, f"{k}: {err:.3e} vs rms {rms:.3e}"
