"""Kernel 6's cluster design (`csrc/node_mlp_bwd.cu`: CLUSTER CTAs per
64-row tile, each owning a slice of every product's output columns) on the
CPU, where the CUDA kernel cannot run.

- (d1) The partition (`bwd_partition`, the kernel's split of every output
  by `node_mlp.CLUSTER`): every element of dx and daggr written once, and
  every element of each tile's weight-gradient partial once (the weight
  gradients by rows, the biases by columns).
- (d2) Its order of sums, emulated from the plain version's per-row
  operands: each CTA's slice of each layer (its own output columns from the
  full input), the partial of a tile assembled from its CTAs' row blocks,
  each element summed over the tile's rows in row order, the tiles'
  partials in tile order; against the plain version (chip_smoke.py's f32
  `BWD_TOL` for kernel 6: only the grouping of f32 sums changes) and jax.vjp
  of the JAX `fused_node_phase` (`F32_TOL` of the largest |value|).

Shapes: the partition at 64, 256 and 5,248 rows (the 5k airfoil's level
0) and one to three tail layers; the sums on 256 rows (4 tiles) of random
x, aggr and g through node MLPs of one and three tail layers at 0.08
(latent 128).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsms_gnn_tpu.ops.dense import MLPParams
from bsms_gnn_tpu.ops.pallas.node_mlp import fused_node_phase as jax_node
from bsms_gnn_tpu_torch.ops.kernels import node_mlp
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import mlp_tail_fwd_save

C, ROWS = 128, node_mlp.ROWS
F32_TOL = 5e-4  # test_torch_port_slice.py's, of the largest |value|
PLAIN_TOL = (2e-5, 2e-6)  # chip_smoke.py's f32 BWD_TOL for kernel 6
N_ROWS = 256


# -- (d1) --------------------------------------------------------------------


def bwd_partition(n_rows, n_layers):
    """What each CTA of kernel 6 writes, as (tile, rank, {name: (rows,
    cols)}) with each entry a pair of ranges: of dx and daggr ([n_rows, C],
    rows and columns), and of its tile's partial, whose weight gradients
    dWa, dWb, dW[l] ([C, C]) CTA q owns by rows and biases db0, db[l] ([C])
    by columns (rows None): its own SW = C / CLUSTER columns
    [q·SW, (q+1)·SW) of every product's output."""
    sw = C // node_mlp.CLUSTER
    for t in range(n_rows // ROWS):
        rows = range(t * ROWS, (t + 1) * ROWS)
        for q in range(node_mlp.CLUSTER):
            own = range(q * sw, (q + 1) * sw)
            parts = {"dx": (rows, own), "daggr": (rows, own),
                     "dWa": (own, range(C)), "dWb": (own, range(C)),
                     "db0": (None, own)}
            for l in range(n_layers):
                parts[f"dW[{l}]"] = (own, range(C))
                parts[f"db[{l}]"] = (None, own)
            yield t, q, parts


@pytest.mark.parametrize("n_rows", [64, 256, 5248])
@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_partition_covers_every_output_once(n_rows, n_layers):
    assert C % node_mlp.CLUSTER == 0
    rows_x = np.zeros((n_rows, C), int)
    parts = {}
    n_ctas = 0
    for t, q, writes in bwd_partition(n_rows, n_layers):
        n_ctas += 1
        for name, (rows, cols) in writes.items():
            if name in ("dx", "daggr"):
                assert rows.start >= t * ROWS and rows.stop <= (t + 1) * ROWS
                if name == "dx":
                    rows_x[rows.start:rows.stop, cols.start:cols.stop] += 1
                continue
            shape = (C,) if rows is None else (C, C)
            p = parts.setdefault((t, name), np.zeros(shape, int))
            if rows is None:
                p[cols.start:cols.stop] += 1
            else:
                p[rows.start:rows.stop, cols.start:cols.stop] += 1
    assert n_ctas == n_rows // ROWS * node_mlp.CLUSTER
    assert (rows_x == 1).all()
    names = {"dWa", "dWb", "db0", *(f"dW[{l}]" for l in range(n_layers)),
             *(f"db[{l}]" for l in range(n_layers))}
    for t in range(n_rows // ROWS):
        assert {k[1] for k in parts if k[0] == t} == names
    assert all((p == 1).all() for p in parts.values())


# -- (d2) --------------------------------------------------------------------


def make_inputs(n_layers, seed=21):
    rng = np.random.default_rng(seed + n_layers)
    x = rng.standard_normal((N_ROWS, C)).astype(np.float32)
    aggr = (3 * rng.standard_normal((N_ROWS, C))).astype(np.float32)
    g = rng.standard_normal((N_ROWS, C)).astype(np.float32)
    ws = [(0.08 * rng.standard_normal((2 * C, C))).astype(np.float32)]
    ws += [(0.08 * rng.standard_normal((C, C))).astype(np.float32)
           for _ in range(n_layers)]
    bs = [(0.08 * rng.standard_normal(C)).astype(np.float32)
          for _ in range(n_layers + 1)]
    return x, aggr, g, ws, bs


def emulate(x, aggr, g, ws, bs):
    """Kernel 6's outputs in its order: per tile, each CTA's column slice
    of every row product (full input, its own columns), the weight
    gradients' row blocks from the CTA's slice of the layer input and the
    full cotangent, summed over the tile's rows in row order; the tiles'
    partials added in tile order."""
    sw = C // node_mlp.CLUSTER
    n = len(ws) - 1
    w0, tail_w, tail_b = ws[0], ws[1:], bs[1:]
    dx, daggr = torch.empty_like(x), torch.empty_like(aggr)
    total = None

    def sliced(a, w):  # each CTA's output columns, assembled
        return torch.cat([a @ w[:, q * sw:(q + 1) * sw]
                          for q in range(node_mlp.CLUSTER)], dim=1)

    def tn(h, d):  # the CTAs' row blocks of hᵀ·d, rows summed in order
        out = torch.zeros(C, C)
        for q in range(node_mlp.CLUSTER):
            blk = torch.zeros(sw, C)
            for r in range(h.shape[0]):
                blk = blk + torch.outer(h[r, q * sw:(q + 1) * sw], d[r])
            out[q * sw:(q + 1) * sw] = blk
        return out

    def colsum(d):  # each column over the rows in row order
        s = torch.zeros(C)
        for r in range(d.shape[0]):
            s = s + d[r]
        return s

    for t in range(x.shape[0] // ROWS):
        rows = slice(t * ROWS, (t + 1) * ROWS)
        xt, at, gt = x[rows], aggr[rows], g[rows]
        pre = sliced(xt, w0[:C]) + sliced(at, w0[C:]) + bs[0]
        normed, inv, hs = mlp_tail_fwd_save(pre, tail_w, tail_b, False)
        d = (gt - gt.mean(-1, keepdim=True)
             - normed * (gt * normed).mean(-1, keepdim=True)) * inv
        part = {}
        for l in range(n - 1, -1, -1):
            part[f"db[{l}]"] = colsum(d)
            part[f"dW[{l}]"] = tn(hs[l], d)
            d = sliced(d, tail_w[l].t().contiguous()) * (hs[l] > 0)
        part["db0"] = colsum(d)
        dx[rows] = sliced(d, w0[:C].t().contiguous()) + gt
        daggr[rows] = sliced(d, w0[C:].t().contiguous())
        part["dWa"], part["dWb"] = tn(xt, d), tn(at, d)
        total = part if total is None else {k: total[k] + v
                                            for k, v in part.items()}
    dw = torch.stack([total[f"dW[{l}]"] for l in range(n)])
    db = torch.stack([total[f"db[{l}]"] for l in range(n)])
    return dx, daggr, total["dWa"], total["dWb"], total["db0"], dw, db


def assert_plain_close(got, want, what):
    err = (got - want).abs()
    rms = want.square().mean().sqrt()
    assert err.max() <= PLAIN_TOL[0] * rms, what
    assert err.square().mean().sqrt() <= PLAIN_TOL[1] * rms, what


def assert_jax_close(got, want, what):
    want = np.asarray(want, np.float32)
    assert np.abs(got.numpy() - want).max() <= F32_TOL * np.abs(want).max(), \
        what


@pytest.mark.parametrize("n_layers", [1, 3])
def test_kernel6_order_of_sums(n_layers):
    x, aggr, g, ws, bs = make_inputs(n_layers)
    t = torch.from_numpy
    tws, tbs = [t(w) for w in ws], [t(b) for b in bs]
    got = emulate(t(x), t(aggr), t(g), tws, tbs)
    mlp = types.SimpleNamespace(weights=tws, biases=tbs,
                                layer_normalized=True)
    plain = node_mlp.fused_node_phase_bwd_plain(t(x), t(aggr), mlp, t(g))
    names = ("dx", "daggr", "dWa", "dWb", "db0", "dW", "db")
    for a, b, what in zip(got, plain, names):
        assert_plain_close(a, b, what)

    def f(xx, aa, w, b):
        return jax_node(xx, aa, MLPParams(weights=w, biases=b))

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(aggr),
                     tuple(jnp.asarray(w) for w in ws),
                     tuple(jnp.asarray(b) for b in bs))
    dx, daggr, dws, dbs = vjp(jnp.asarray(g))
    dx_, daggr_, dwa, dwb, db0, dw, db = got
    assert_jax_close(dx_, dx, "dx")
    assert_jax_close(daggr_, daggr, "daggr")
    assert_jax_close(torch.cat([dwa, dwb]), dws[0], "dW0")
    assert_jax_close(db0, dbs[0], "db0")
    for l in range(n_layers):
        assert_jax_close(dw[l], dws[l + 1], f"dW{l + 1}")
        assert_jax_close(db[l], dbs[l + 1], f"db{l + 1}")
