"""Kernel 3's cluster design (`csrc/node_mlp.cu`: CLUSTER CTAs per 64-row
tile, each owning a quarter of every product's output columns) on the CPU,
where the CUDA kernel cannot run.

- (a) The partition: every output element written once, by the CTA that
  owns its columns, and within a CTA by one thread of the row products
  (128 threads of 4 rows by 4 columns: `node_mlp.cu`'s NT3 and RT) and one
  lane of the LayerNorm's output (lane l holds columns 4l .. 4l + 3).
- (b) Its order: per tile, each CTA's column quarter of every layer from
  the full input rows (four 32-column quarter products per layer), the
  cluster's quarters assembled into the next layer's full input, the
  LayerNorm over the assembled rows, each quarter writing its own columns
  of LN + x; against the plain version (chip_smoke.py's f32 `TOL` for
  kernel 3: only the grouping of f32 sums changes) and the JAX
  `fused_node_phase` (interpret mode) in f32 at `F32_TOL` and in bf16 at
  the port's bf16 limit for the MLP kernels (`test_torch_port_kernels.py`'s
  `MLP_TOL`), with bf16 compute on bf16 and on f32 x.

Shapes: 64 rows (one tile), 192 rows (3 tiles: not a multiple of the 4 CTAs
a cluster takes, nor of JAX's 128-row blocks, so JAX runs on 256 rows and
the first 192 are compared: rows are independent) and 5,248 rows (82 tiles:
the 5k airfoil's level 0), through node MLPs of one and three tail layers
at 0.08 (latent 128), x unit normal, aggr 3·N(0, 1).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from bsms_gnn_tpu.ops.dense import MLPParams
from bsms_gnn_tpu.ops.pallas.node_mlp import fused_node_phase as jax_node
from bsms_gnn_tpu_torch.ops.kernels import node_mlp
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import LN_EPS, dot, round_bf16

C, ROWS, CL = 128, node_mlp.ROWS, node_mlp.CLUSTER
SW = C // CL
NT3, RT = 128, 4  # node_mlp.cu's threads per CTA and rows per thread
F32_TOL = 5e-4  # test_torch_port_slice.py's, of the largest |value|
BF16_TOL = 2e-2  # test_torch_port_kernels.py's MLP_TOL["bf16"]
PLAIN_TOL = (2e-5, 1e-6)  # chip_smoke.py's f32 TOL for kernel 3
JAX_BLOCK = 128  # the JAX kernel's smallest row block


# -- (a) ---------------------------------------------------------------------


@pytest.mark.parametrize("n_rows", [64, 192, 5248])
def test_partition_covers_every_output_once(n_rows):
    assert C % CL == 0 and ROWS % RT == 0
    rg_count = ROWS // RT
    assert NT3 == 8 * rg_count and SW == 4 * 8  # 8 column groups of 4
    count = np.zeros((n_rows, C), int)
    for t in range(n_rows // ROWS):
        for q in range(CL):
            # The row products: thread tid owns rows rg + rg_count·i and
            # columns 4·cg .. 4·cg + 3 of the CTA's slice.
            slice_count = np.zeros((ROWS, SW), int)
            for tid in range(NT3):
                rg, cg = tid // 8, tid % 8
                for i in range(RT):
                    slice_count[rg + rg_count * i, 4 * cg:4 * cg + 4] += 1
            assert (slice_count == 1).all()
            # The output: lane l of each row's warp holds columns 4l ..
            # 4l + 3; the lanes 8q .. 8q + 7 write CTA q's columns.
            for lane in range(32):
                cols = range(4 * lane, 4 * lane + 4)
                if lane // 8 == q:
                    assert all(q * SW <= c < (q + 1) * SW for c in cols)
                    count[t * ROWS:(t + 1) * ROWS, cols.start:cols.stop] += 1
    assert (count == 1).all()


# -- (b) ---------------------------------------------------------------------


def make_inputs(n_rows, n_layers, seed=11):
    rng = np.random.default_rng(seed + n_layers + n_rows)
    x = rng.standard_normal((n_rows, C)).astype(np.float32)
    aggr = (3 * rng.standard_normal((n_rows, C))).astype(np.float32)
    ws = [(0.08 * rng.standard_normal((2 * C, C))).astype(np.float32)]
    ws += [(0.08 * rng.standard_normal((C, C))).astype(np.float32)
           for _ in range(n_layers)]
    bs = [(0.08 * rng.standard_normal(C)).astype(np.float32)
          for _ in range(n_layers + 1)]
    return x, aggr, ws, bs


def emulate(x, aggr, ws, bs, bf16):
    """Kernel 3's outputs in its order: per tile, each CTA's column quarter
    of every row product from the full input rows, the quarters assembled
    into the next layer's input, the LayerNorm over the assembled rows
    (1/sqrt, f32), and each quarter's columns of LN + x written by its
    CTA. bf16: every dot operand rounded, the output stored in bf16."""
    w0, tail_w, tail_b = ws[0], ws[1:], bs[1:]
    x32 = x.float()
    out = torch.empty(x.shape, dtype=torch.bfloat16 if bf16 else x.dtype)

    def assembled(a, w):  # the cluster's quarters of a·w
        return torch.cat([dot(a, w[:, q * SW:(q + 1) * SW], bf16)
                          for q in range(CL)], dim=1)

    def operand(h):
        return round_bf16(h) if bf16 else h

    for t in range(x.shape[0] // ROWS):
        rows = slice(t * ROWS, (t + 1) * ROWS)
        h = torch.relu(assembled(x32[rows], w0[:C])
                       + assembled(aggr[rows], w0[C:]) + bs[0])
        for l, (w, b) in enumerate(zip(tail_w, tail_b)):
            z = assembled(operand(h), w) + b
            h = z if l == len(tail_w) - 1 else torch.relu(z)
        mean = h.mean(-1, keepdim=True)
        d = h - mean
        inv = 1.0 / torch.sqrt(d.square().mean(-1, keepdim=True) + LN_EPS)
        full = d * inv + x32[rows]
        for q in range(CL):
            cols = slice(q * SW, (q + 1) * SW)
            out[rows, cols] = full[:, cols].to(out.dtype)
    return out


def jax_reference(x, aggr, ws, bs, x_dt, bf16):
    """JAX's fused_node_phase on the rows padded to its row block (rows
    are independent), the first rows returned (f32 numpy)."""
    n = x.shape[0]
    pad = -n % JAX_BLOCK
    rng = np.random.default_rng(0)
    xp = np.concatenate([x, rng.standard_normal((pad, C)).astype(np.float32)])
    ap = np.concatenate([aggr,
                         rng.standard_normal((pad, C)).astype(np.float32)])
    jx = jnp.asarray(xp).astype(x_dt)
    got = jax_node(jx, jnp.asarray(ap), MLPParams(
        weights=tuple(jnp.asarray(w) for w in ws),
        biases=tuple(jnp.asarray(b) for b in bs)),
        jnp.bfloat16 if bf16 else None)
    assert got is not None
    return np.asarray(got.astype(jnp.float32))[:n]


@pytest.mark.parametrize("n_rows", [64, 192, 5248])
@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16 on f32 x"])
def test_kernel3_order_of_sums(n_rows, n_layers, mode):
    bf16 = mode != "f32"
    x_dt = (torch.bfloat16, jnp.bfloat16) if mode == "bf16" else (
        torch.float32, jnp.float32)
    x, aggr, ws, bs = make_inputs(n_rows, n_layers)
    if mode == "bf16":  # the values bf16 x holds
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    t = torch.from_numpy
    tx, ta = t(x).to(x_dt[0]), t(aggr)
    tws, tbs = [t(w) for w in ws], [t(b) for b in bs]
    got = emulate(tx, ta, tws, tbs, bf16)
    cd = torch.bfloat16 if bf16 else None
    mlp = types.SimpleNamespace(weights=tws, biases=tbs,
                                layer_normalized=True)
    plain = node_mlp.fused_node_phase_plain(tx, ta, mlp, cd)
    assert got.dtype == plain.dtype
    want = jax_reference(x, aggr, ws, bs, x_dt[1], bf16)
    err = np.abs(got.float().numpy() - want).max()
    tol = (BF16_TOL if bf16 else F32_TOL) * np.abs(want).max()
    assert err <= tol, f"{mode}: {err:.3e} > {tol:.3e} vs JAX"
    if not bf16:
        d = (got - plain).abs()
        rms = plain.square().mean().sqrt()
        assert d.max() <= PLAIN_TOL[0] * rms
        assert d.square().mean().sqrt() <= PLAIN_TOL[1] * rms
    else:
        # Both sides round the same operands: they agree but for a rare
        # intermediate that an f32 sum in another order moves across a
        # bf16 rounding step (one step of a bf16 output).
        step = 2.0 ** -7 * plain.float().abs().max()
        assert (got.float() - plain.float()).abs().max() <= 2 * step
