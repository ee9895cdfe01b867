"""The port's `ell` and `segment` scatter forms (`ops/scatter.py`) and what
the explicit transitions build on them against the JAX package on the
CPU: `gather_send`, `gather_recv`, `aggregate_recv` and `aggregate_send`,
forward and VJP against `jax.vjp` of JAX's, on one frame [N, C] and a
batch [B, N, C], f32 and bf16; `cal_ew`; `edge_conv_down` / `edge_conv_up`
with a runtime `ew` on 3-wide rows (a world-position stream's width) on
every method, at B = 1 and B = 2, forward and VJP; the kernel route's
runtime-`ew` pair (kernel 8's plain version here) against the `ell` form;
and pool / unpool on the batch axis.

The level: level 1 of `test_torch_port_hierarchy.py`'s scrambled 24×24
grid (depth 3, unwindowed: 384 rows, 128-slot chunks, pad slots in every
block), where rows of up to 13 edges sum. The inputs are drawn from
seeded numpy generators.

Tolerances, relative to the largest |value| of the reference: the
gathers move values and are exact; f32 sums run in other orders on the
two sides, 1e-6 (F32_TOL); bf16 sums: the `ell` sums add in f32 and
round once on both sides, the `segment` sums round every add to bf16 on
both sides (XLA's scatter and `index_add`), in another order, so a row
may land a few bf16 steps (2^-8 relative) apart: 2e-2 (BF16_TOL).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_hierarchy import scrambled_grid

from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.ops import scatter as jax_scatter
from bsms_gnn_tpu.ops.message import cal_ew as jax_cal_ew
from bsms_gnn_tpu.ops.message import edge_conv_down as jax_conv_down
from bsms_gnn_tpu.ops.message import edge_conv_up as jax_conv_up
from bsms_gnn_tpu.ops.pool import pool_nodes as jax_pool
from bsms_gnn_tpu.ops.pool import unpool_nodes as jax_unpool
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.ops import scatter
from bsms_gnn_tpu_torch.ops.message import cal_ew, edge_conv_down, edge_conv_up
from bsms_gnn_tpu_torch.ops.pool import pool_nodes, unpool_nodes

C, B, LEVEL = 128, 2, 1
F32_TOL, BF16_TOL = 1e-6, 2e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
OPS = ("gather_send", "gather_recv", "aggregate_recv", "aggregate_send")


@functools.lru_cache(maxsize=None)
def grid():
    """(JAX hierarchy, the port's on the CPU) of the scrambled grid."""
    pos, cells = scrambled_grid()
    hj = jax_build(jax_flat_edge(cells, "tri"), 3, len(pos), pos)
    ht = to_device(build_hierarchy(to_flat_edge(cells, "tri"), 3, len(pos),
                                   pos), "cpu")
    return hj, ht


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_close(got, want, tol, what):
    want = _np(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    scale = max(1e-30, np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} * {scale:.3e}"


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("method", ["ell", "segment"])
@pytest.mark.parametrize("op", OPS)
def test_scatter_op_and_vjp_match_jax(op, method, dt, batched):
    """The op's output and its VJP (a seeded cotangent) against `jax.vjp`
    of JAX's op of the same method; no kernel runs. Gathers are exact
    both ways round; sums to F32_TOL / BF16_TOL."""
    hj, ht = grid()
    lj, lt = hj.levels[LEVEL], ht.levels[LEVEL]
    gather = op.startswith("gather")
    rows_in = lt.n_pad_nodes if gather else lt.n_pad_edges
    rows_out = lt.n_pad_edges if gather else lt.n_pad_nodes
    lead = (B,) if batched else ()
    rng = np.random.default_rng(OPS.index(op) + 7 * batched)
    x = rng.standard_normal(lead + (rows_in, C)).astype(np.float32)
    g = rng.standard_normal(lead + (rows_out, C)).astype(np.float32)
    jd, td = DTYPES[dt]
    fj = getattr(jax_scatter, op)
    want, vjp = jax.vjp(lambda a: fj(lj, a, method), jnp.asarray(x).astype(jd))
    (want_dx,) = vjp(jnp.asarray(g).astype(jd))
    xt = torch.tensor(x).to(td).requires_grad_()
    got = getattr(scatter, op)(lt, xt, method)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    got.backward(torch.tensor(g).to(td))
    # A gather selects and its VJP sums; an aggregate the other way round.
    tol_fwd = 0.0 if gather else (F32_TOL if dt == "f32" else BF16_TOL)
    tol_bwd = 0.0 if not gather else (F32_TOL if dt == "f32" else BF16_TOL)
    assert_close(got, want, tol_fwd, f"{op} {method} {dt}")
    assert_close(xt.grad, want_dx, tol_bwd, f"d{op} {method} {dt}")


def test_ell_functions_keep_only_index_tables():
    """The `ell` gather and aggregate save no activation for their
    backward: the autograd graph holds no tensor of [..., N, K, C] (or
    any float tensor) besides the inputs, as JAX's custom VJPs keep the
    index tables alone."""
    _, ht = grid()
    lt = ht.levels[LEVEL]
    x = torch.randn(B, lt.n_pad_nodes, C, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        e = scatter.gather_send(lt, x, "ell")
        y = scatter.aggregate_recv(lt, e, "ell")
    assert not [t for t in saved if t.is_floating_point()]
    # ... nor on the Functions' contexts: every tensor they hold is an
    # index table.
    nodes, held = [y.grad_fn], []
    while nodes:
        node = nodes.pop()
        held += [v for v in getattr(node, "__dict__", {}).values()
                 if torch.is_tensor(v)]
        nodes += [f for f, _ in node.next_functions if f is not None]
    assert len(held) == 2 and not any(t.is_floating_point() for t in held)


@pytest.mark.parametrize("method", ["ell", "segment"])
def test_cal_ew_matches_jax(method):
    """`cal_ew` of seeded positive node weights (zero on the pad rows):
    the slot weights ec and the receiver sums aggr_w against JAX's, f32;
    both detached."""
    hj, ht = grid()
    lj, lt = hj.levels[LEVEL], ht.levels[LEVEL]
    rng = np.random.default_rng(3)
    w = (rng.uniform(0.5, 2.0, (lt.n_pad_nodes, 1))
         * np.asarray(lt.node_mask)).astype(np.float32)
    ec_j, aw_j = jax_cal_ew(lj, jnp.asarray(w), method)
    wt = torch.tensor(w, requires_grad=True)
    ec, aw = cal_ew(lt, wt, method)
    assert not ec.requires_grad and not aw.requires_grad
    assert_close(ec, ec_j, F32_TOL, "ec")
    assert_close(aw, aw_j, F32_TOL, "aggr_w")
    # The kernel methods take the `ell` form on these one-wide rows.
    for m in ("fused", "pallas"):
        ec_k, aw_k = cal_ew(lt, wt, m)
        torch.testing.assert_close(ec_k, cal_ew(lt, wt, "ell")[0], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("method", ["ell", "segment", "fused", "pallas"])
@pytest.mark.parametrize("up", [False, True])
def test_narrow_conv_with_runtime_ew_matches_jax(up, method, batched):
    """`edge_conv_down` / `edge_conv_up` on 3-wide rows with a runtime
    slot weight `ew` (cal_ew's, of seeded node weights): the output and
    its VJP against JAX's on the same method, which takes such rows
    through its generic form on every method (`_conv_fast_ok` fails). The
    kernel methods' generic form is `ell`, as JAX's."""
    hj, ht = grid()
    lj, lt = hj.levels[LEVEL], ht.levels[LEVEL]
    rng = np.random.default_rng(20 + up + 2 * batched)
    w = (rng.uniform(0.5, 2.0, (lt.n_pad_nodes, 1))
         * np.asarray(lt.node_mask)).astype(np.float32)
    ew = np.asarray(jax_cal_ew(lj, jnp.asarray(w))[0])
    lead = (B,) if batched else ()
    x = rng.standard_normal(lead + (lt.n_pad_nodes, 3)).astype(np.float32)
    g = rng.standard_normal(lead + (lt.n_pad_nodes, 3)).astype(np.float32)
    fj, ft = (jax_conv_up, edge_conv_up) if up else (jax_conv_down,
                                                      edge_conv_down)
    want, vjp = jax.vjp(lambda a: fj(lj, a, jnp.asarray(ew), method),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    got = ft(lt, xt, torch.tensor(ew), method)
    got.backward(torch.tensor(g))
    assert_close(got, want, F32_TOL, "conv")
    assert_close(xt.grad, want_dx, F32_TOL, "dconv")


@pytest.mark.parametrize("up", [False, True])
def test_level_weights_conv_ell_matches_jax(up):
    """With the level's own weights (`ew=None`), on 128-wide rows at B =
    2: the `ell` and `segment` forms against JAX's."""
    hj, ht = grid()
    lj, lt = hj.levels[LEVEL], ht.levels[LEVEL]
    rng = np.random.default_rng(40 + up)
    x = rng.standard_normal((B, lt.n_pad_nodes, C)).astype(np.float32)
    fj, ft = (jax_conv_up, edge_conv_up) if up else (jax_conv_down,
                                                      edge_conv_down)
    for method in ("ell", "segment"):
        want = fj(lj, jnp.asarray(x), None, method)
        got = ft(lt, torch.tensor(x), None, method)
        assert_close(got, want, F32_TOL, method)


@pytest.mark.parametrize("up", [False, True])
def test_kernel_route_runtime_ew_matches_the_ell_form(up):
    """On 128-wide rows the kernel methods take the gathered conv with a
    runtime `ew` (`_make_conv_pair`: kernel 8, its plain version on the
    CPU; the up conv through ew[reverse_perm]), each direction the
    other's adjoint: the output and the VJP against the `ell` form."""
    hj, ht = grid()
    lj, lt = hj.levels[LEVEL], ht.levels[LEVEL]
    rng = np.random.default_rng(50 + up)
    w = (rng.uniform(0.5, 2.0, (lt.n_pad_nodes, 1))
         * np.asarray(lt.node_mask)).astype(np.float32)
    ew = torch.tensor(np.asarray(jax_cal_ew(lj, jnp.asarray(w))[0]))
    x = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    g = torch.tensor(rng.standard_normal((lt.n_pad_nodes, C)),
                     dtype=torch.float32)
    ft = edge_conv_up if up else edge_conv_down
    outs = []
    for method in ("fused", "ell"):
        xt = torch.tensor(x, requires_grad=True)
        y = ft(lt, xt, ew, method)
        y.backward(g)
        outs.append((y.detach(), xt.grad))
    for (a, da), (b, db) in zip(outs[:1], outs[1:]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(da, db, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", ["pool", "unpool"])
def test_pool_unpool_on_the_batch_axis_match_jax(op):
    """pool / unpool at B = 2 (the explicit transitions of the `ell`
    method on a shared hierarchy select on dim -2): output and VJP
    against JAX's, exactly (they move values)."""
    hj, ht = grid()
    tj, tt = hj.transitions[LEVEL], ht.transitions[LEVEL]
    n = ht.levels[LEVEL].n_pad_nodes
    m = ht.levels[LEVEL + 1].n_pad_nodes
    rows_in, rows_out = (n, m) if op == "pool" else (m, n)
    rng = np.random.default_rng(60)
    x = rng.standard_normal((B, rows_in, C)).astype(np.float32)
    g = rng.standard_normal((B, rows_out, C)).astype(np.float32)
    fj, ft = (jax_pool, pool_nodes) if op == "pool" else (jax_unpool,
                                                          unpool_nodes)
    want, vjp = jax.vjp(lambda a: fj(tj, a), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    got = ft(tt, xt)
    got.backward(torch.tensor(g))
    assert_close(got, want, 0.0, op)
    assert_close(xt.grad, want_dx, 0.0, f"d{op}")
