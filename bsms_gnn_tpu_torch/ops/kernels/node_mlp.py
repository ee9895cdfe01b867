"""Kernel 3: the fused GMP node phase.

Replaces the TPU kernel `bsms_gnn_tpu/ops/pallas/node_mlp.py::
fused_node_phase` (forward, `_get_fwd` → `_make_fwd_kernel`):

    out = LN(tail(relu(x·Wa + aggr·Wb + b0))) + x

per row, with Wa/Wb the x and aggr halves of the node MLP's [2C, C] first
layer. Output in bf16 in bf16 mode, else in x's dtype; x may be f32 in
bf16 mode (the level-0 GMP when the encoder runs in f32).

CUDA design (`csrc/node_mlp.cu`, on kernel 6's cluster,
`csrc/node_cluster.cuh`; its device code, `csrc/node_cluster_fwd.cuh`, is
shared with kernel 10's deep levels, `agg_node.py`, which feed it an
aggregate summed on chip): a thread-block cluster of CLUSTER CTAs per
ROWS-row tile, CTA q computing the output columns [32q, 32q + 32) of every
product from the full input tile, which the cluster's CTAs assemble from
each other's column slices through distributed shared memory after the
first layer and after each tail layer; the LayerNorm runs whole in every
CTA and each CTA writes its own columns of LN + x. So each tile's serial
chain of 2 + L products is CLUSTER times shorter and a level of n tiles
runs CLUSTER·n CTAs (the 5k airfoil's levels hold 82 tiles down to 2; one
block per tile left every level on fewer SMs than the card has). Each CTA
runs 128 threads of 4 rows by 4 output columns, stages a quarter of every
weight, in 64-row slabs double-buffered with cp.async, and holds 65 KB of
shared memory, so three fit on an SM (`occupancy`). Every output element is summed over k in the order of the
one-block kernel this replaces: the same arithmetic, no atomics. The only
device-memory traffic is x and aggr in (each read by the cluster's four
CTAs, L2-hot), out out, and the weights (L2-resident). What bounds it on
the card: operations, (2 + L)·2·128·128 FLOP per row against 768 bytes
per row in f32 (f32 FMA on the CUDA cores, no TF32).

bf16 mode rounds every dot operand to bf16 (x, aggr, the hidden
activations, the weights: those once per call, on the host,
`build.stacked(..., to_bf16=True)`) and accumulates in f32; LN and the
residual add run in f32 and the sum is stored in bf16.

Kernel 6 replaces the TPU kernel's backward (`_get_bwd` →
`_make_bwd_kernel`): given the output's cotangent g [n_pad, C] f32 it
recomputes each row tile's forward and returns dx (in x's dtype; it
includes the residual's g), daggr (f32), dWa, dWb [C, C], db0 [C] and the
tail's dW [L, C, C], db [L, C]. What bounds it: operations, about three
times kernel 3's (fifteen 64×128×128 products per 64-row tile at L = 3).
CUDA design (`csrc/node_mlp_bwd.cu`): kernel 3's cluster, the layer
inputs and cotangents exchanged after each layer; the LayerNorm and its
backward run whole in every CTA. Each weight gradient splits by its rows
(dW[l] = h_lᵀ·d: CTA q needs only its own columns of h_l), so the CTAs of
a tile write disjoint parts of the tile's one partial, each element summed
over the tile's rows in row order, and `grad_sum_kernel` adds the partials
in tile order: deterministic, no atomics, the same arithmetic as one
block per tile. bf16 mode rounds
every dot operand as the forward does (the weights once per call, on the
host: `build.stacked(..., to_bf16=True)`), and in the backward the running
cotangent and dpre too; g itself enters the LayerNorm backward in f32, as
on the TPU.

Width and depth: kernels 3 and 6 take a latent width C of 128 or 256
(`node_plan`): CTA q of a tile's cluster keeps SW = 32 output columns, so
a cluster is C / 32 CTAs (4, or 8 at 256: the portable cluster limit), and
kernel 6 keeps one 64×32 slice per tail layer, any L whose slices fit a
block (L ≤ 18 at 128, ≤ 10 at 256). Its partials grow with C²·L (1.58 MB
at (256, 4)), so `p_max` caps them by bytes (PART_BYTES) as well as by
waves. A (C, L) no kernel holds raises NotImplementedError naming C and L
before any launch, on the card only (the plain versions take any C and
L); a width that is not a multiple of 128 raises everywhere.

The batch axis (a shared mesh): the node phase is row-wise, so x, aggr
[B, n_pad, 128] are one launch over their B·n_pad rows as [B·n_pad, 128]
(kernels 3 and 6 unchanged per tile). Kernel 6 caps its weight-gradient
partials: one 330 KB partial per 64-row tile would be 1.3 GB at B = 48 on
the 5k airfoil's level 0 (3,936 tiles), so P = min(T, P_max) clusters
each walk a contiguous range of ⌊p·T/P⌋ .. ⌊(p+1)·T/P⌋ tiles in order,
the first stored into the cluster's partial and each later one added onto
it, and `grad_sum_kernel` adds the P partials in order. P_max (`p_max`)
is the fewest whole waves of the clusters the card holds at once that
hold P_MIN partials: a range of tiles then splits evenly over full waves
(a last wave of a few clusters walking their whole ranges alone doubled
the time, PERF.md §6), and every level the port runs at B = 1 (at most
P_MIN tiles) keeps one tile a partial: the arithmetic and the bits of the
one-partial-per-tile kernel.

`fused_node_phase` is the differentiable entry: an autograd Function whose
forward launches kernel 3 and whose backward launches kernel 6.
"""

from __future__ import annotations

import ctypes

import torch

from bsms_gnn_tpu_torch.ops.kernels import build
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import (
    BN,
    SMEM_MAX,
    check_width,
    dot,
    mlp_tail_bwd,
    mlp_tail_fwd_save,
    mlp_tail_plain,
)
from bsms_gnn_tpu_torch.ops.kernels.windowed import WIDTHS

# (x dtype, bf16 compute) → C entry.
_FN = {(torch.float32, False): "fused_node_phase_f32",
       (torch.bfloat16, True): "fused_node_phase_bf16",
       (torch.float32, True): "fused_node_phase_f32_bf16"}
_SIGS = {**{f: [build.P] * 7 + [build.I] * 3 + [build.P]
            for f in _FN.values()},
         **{f + "_occupancy": [build.I] + [build.P] * 2
            for f in _FN.values()}}
_BWD_FN = {(torch.float32, False): "fused_node_phase_bwd_f32",
           (torch.bfloat16, True): "fused_node_phase_bwd_bf16",
           (torch.float32, True): "fused_node_phase_bwd_f32_bf16"}
_BWD_SIGS = {**{f: [build.P] * 10 + [build.I] * 4 + [build.P] * 4
                for f in _BWD_FN.values()},
             **{f + "_occupancy": [build.I, build.I, build.P, build.P]
                for f in _BWD_FN.values()}}
# Rows of a tile (`csrc/node_cluster.cuh`'s TILE), output columns of one
# CTA of kernels 3's and 6's cluster (its SW) and CTAs per tile at C = 128
# (its CL; C / SW at width C: `cluster_of`); held to these values by a
# static_assert there.
ROWS = 64
SW = 32
CLUSTER = BN // SW
# The fewest partials kernel 6's cap holds: the most 64-row tiles of any
# level the port runs at B = 1 (the 16k surface's level 0, 16,128 rows).
P_MIN = 252
# The most bytes kernel 6's partials take (1.58 MB each at (256, 4)).
PART_BYTES = 256 << 20
_clusters = {}


def cluster_of(c: int) -> int:
    """CTAs of kernels 3's and 6's cluster at latent width c."""
    return c // SW


def bwd_smem(c: int, n_layers: int) -> int:
    """Bytes of shared memory of a kernel 6 CTA (`csrc/node_mlp_bwd.cu`'s
    `smem_bytes`): the full tile, the kept slices, two exchange slices,
    two weight slices."""
    return 4 * (ROWS * (c + 4) + (max(n_layers, 2) + 2) * ROWS * SW
                + 2 * c * SW)


def node_plan(c: int, n_layers: int, backward: bool = True) -> int:
    """The cluster size (CTAs a tile) kernels 3 and 6 run at latent width
    c with n_layers tail layers; raises NotImplementedError naming C and L
    where the kernels take neither, as the card's entries refuse them. A
    pure function of its arguments."""
    check_width(c)
    if n_layers < 1:
        raise ValueError(f"{n_layers} tail layers")
    if c not in WIDTHS or (backward and bwd_smem(c, n_layers) > SMEM_MAX):
        raise NotImplementedError(
            f"latent width {c} with {n_layers} tail layers: the node phase "
            f"kernels take widths {WIDTHS} and, in the backward, the tail "
            f"layers whose slices fit a block's {SMEM_MAX} bytes (see "
            f"node_mlp.node_plan)")
    return cluster_of(c)


def bwd_clusters(x_dtype, compute_dtype, n_layers, device,
                 width: int = BN) -> int:
    """The clusters of kernel 6's entry for x_dtype and compute_dtype at
    n_layers and the latent width that the card holds at once (its
    occupancy calculator, asked once per device and entry)."""
    fn = _BWD_FN[(x_dtype, compute_dtype == torch.bfloat16)] + "_occupancy"
    key = (fn, n_layers, device, width)
    if key not in _clusters:
        lib = build.library("node_mlp_bwd", _BWD_SIGS)
        per_sm, clusters = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(device):
            build.check(getattr(lib, fn)(width, n_layers,
                                         ctypes.addressof(per_sm),
                                         ctypes.addressof(clusters)), fn)
        if clusters.value < 1:
            raise RuntimeError(f"{fn}: no cluster fits on the card")
        _clusters[key] = clusters.value
    return _clusters[key]


def p_max(x_dtype, compute_dtype, n_layers, device, width: int = BN) -> int:
    """The cap on kernel 6's partials: the fewest whole waves of the
    clusters the card holds at once (`bwd_clusters`) that hold P_MIN, or
    the whole waves whose partials take at most PART_BYTES where that is
    fewer (never less than one wave)."""
    c = bwd_clusters(x_dtype, compute_dtype, n_layers, device, width)
    part = 4 * ((2 + n_layers) * width * width + (1 + n_layers) * width)
    return min(c * -(-P_MIN // c), max(c, PART_BYTES // part // c * c))


def _check(x, aggr, mlp, compute_dtype):
    """Raise on what the kernels do not take (aggr None: x and mlp only)."""
    build.check_batch(x, True)
    n_pad, c = x.shape[-2:]
    check_width(c)
    if aggr is not None and (aggr.shape != x.shape
                             or aggr.dtype != torch.float32):
        raise ValueError(f"aggr must be f32 {tuple(x.shape)}")
    if n_pad % ROWS:
        raise ValueError(f"rows {n_pad} not a multiple of {ROWS}")
    if not mlp.layer_normalized or len(mlp.weights) < 2:
        raise NotImplementedError("node MLP needs LayerNorm and a tail")
    ws = list(mlp.weights)
    if ws[0].shape != (2 * c, c) or any(w.shape != (c, c) for w in ws[1:]):
        raise NotImplementedError("node MLP widths")
    if (x.dtype, compute_dtype == torch.bfloat16) not in _FN:
        raise NotImplementedError(
            f"x dtype {x.dtype} with compute dtype {compute_dtype}")


def _node_pre(x, aggr, mlp, bf16):
    c = x.shape[-1]
    w0 = mlp.weights[0].float()
    x32, a32 = x.float(), aggr.float()
    pre = dot(x32, w0[:c], bf16) + dot(a32, w0[c:], bf16) + mlp.biases[0]
    return pre, x32, a32, w0[:c], w0[c:]


def _tail(mlp):
    return ([w.float() for w in list(mlp.weights)[1:]],
            [b.float() for b in list(mlp.biases)[1:]])


def _rows(t):
    """A [..., n, C] tensor as [rows, C]: the node phase is row-wise."""
    return t.reshape(-1, t.shape[-1])


def fused_node_phase_plain(x, aggr, mlp, compute_dtype=None):
    """Kernel 3's function in plain PyTorch, on any leading dims."""
    fused_node_phase_plain.calls += 1
    bf16 = compute_dtype == torch.bfloat16
    pre, x32, _, _, _ = _node_pre(_rows(x), _rows(aggr), mlp, bf16)
    e = mlp_tail_plain(pre, *_tail(mlp), bf16)
    return (e + x32).to(torch.bfloat16 if bf16 else x.dtype).reshape(
        x.shape)


fused_node_phase_plain.calls = 0


def fused_node_phase_fwd(x, aggr, mlp, compute_dtype=None):
    """LN(MLP_node([x, aggr])) + x, no autograd. `mlp` is the GMP's node
    MLP (weights stored [in, out]); x, aggr [n_pad, C] or a batch [B,
    n_pad, C] (one launch over its rows). CPU tensors take the plain
    version; CUDA tensors launch kernel 3 (C 128 or 256)."""
    _check(x, aggr, mlp, compute_dtype)
    if x.device.type == "cpu":
        return fused_node_phase_plain(x, aggr, mlp, compute_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    c = x.shape[-1]
    node_plan(c, len(mlp.weights) - 1, backward=False)
    lib = build.library("node_mlp", _SIGS)
    ws, bs = list(mlp.weights), list(mlp.biases)
    bf16 = compute_dtype == torch.bfloat16
    w0 = build.stacked(ws[:1], to_bf16=bf16)
    b0 = bs[0].detach().float().contiguous()
    w_stack = build.stacked(ws[1:], to_bf16=bf16)
    b_stack = build.stacked(bs[1:])
    x, aggr = x.contiguous(), aggr.contiguous()
    out = torch.empty_like(x, dtype=torch.bfloat16 if bf16 else x.dtype)
    err = getattr(lib, _FN[(x.dtype, bf16)])(
        x.data_ptr(), aggr.data_ptr(), w0.data_ptr(), b0.data_ptr(),
        w_stack.data_ptr(), b_stack.data_ptr(), out.data_ptr(), c,
        len(mlp.weights) - 1, x.numel() // (c * ROWS),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "fused_node_phase")
    fused_node_phase_fwd.launches += 1
    return out


fused_node_phase_fwd.launches = 0


def occupancy(x_dtype=torch.float32, compute_dtype=None, width: int = BN):
    """(CTAs per SM, clusters on the card at once) of kernel 3's entry for
    x_dtype and compute_dtype at the latent width, as the card's occupancy
    calculator reports them on the current device."""
    lib = build.library("node_mlp", _SIGS)
    fn = _FN[(x_dtype, compute_dtype == torch.bfloat16)] + "_occupancy"
    per_sm, clusters = ctypes.c_int(), ctypes.c_int()
    build.check(getattr(lib, fn)(width, ctypes.addressof(per_sm),
                                 ctypes.addressof(clusters)), fn)
    return per_sm.value, clusters.value


def fused_node_phase_bwd_plain(x, aggr, mlp, g, compute_dtype=None):
    """Kernel 6's function in plain PyTorch, on any leading dims (the
    weight gradients summed over every row)."""
    fused_node_phase_bwd_plain.calls += 1
    bf16 = compute_dtype == torch.bfloat16
    pre, x32, a32, wa, wb = _node_pre(_rows(x), _rows(aggr), mlp, bf16)
    ws, bs = _tail(mlp)
    normed, inv, hs = mlp_tail_fwd_save(pre, ws, bs, bf16)
    g = _rows(g).float()
    dpre, dw, db = mlp_tail_bwd(pre, hs, normed, inv, g, ws, bf16)
    dx = (dot(dpre, wa.t(), bf16) + g).to(x.dtype).reshape(x.shape)
    daggr = dot(dpre, wb.t(), bf16).to(aggr.dtype).reshape(aggr.shape)
    return (dx, daggr, dot(x32.t(), dpre, bf16), dot(a32.t(), dpre, bf16),
            dpre.sum(0), dw, db)


fused_node_phase_bwd_plain.calls = 0


def fused_node_phase_bwd(x, aggr, mlp, g, compute_dtype=None):
    """(dx in x's dtype, daggr f32, dWa, dWb [C, C], db0 [C], dW [L, C,
    C], db [L, C]) for the output's cotangent g, no autograd; a batch is
    one launch over its rows, the weight gradients summed over it. CPU
    tensors take the plain version; CUDA tensors launch kernel 6 (C 128 or
    256, L as `node_plan` allows)."""
    _check(x, aggr, mlp, compute_dtype)
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} != {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_node_phase_bwd_plain(x, aggr, mlp, g, compute_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    n_layers = len(mlp.weights) - 1
    node_plan(x.shape[-1], n_layers)
    lib = build.library("node_mlp_bwd", _BWD_SIGS)
    ws, bs = list(mlp.weights), list(mlp.biases)
    c, dev = x.shape[-1], x.device
    bf16 = compute_dtype == torch.bfloat16
    w0 = build.stacked(ws[:1], to_bf16=bf16)
    w0_t = build.stacked(ws[:1], transpose=True, to_bf16=bf16)
    b0 = bs[0].detach().float().contiguous()
    w_stack = build.stacked(ws[1:], to_bf16=bf16)
    wt_stack = build.stacked(ws[1:], transpose=True, to_bf16=bf16)
    b_stack = build.stacked(bs[1:])
    x, aggr = x.contiguous(), aggr.contiguous()
    g = g.detach().float().contiguous()
    n_tiles = x.numel() // (c * ROWS)
    parts = min(n_tiles, p_max(x.dtype, compute_dtype, n_layers, dev, c))
    grad_size = (2 + n_layers) * c * c + (1 + n_layers) * c
    gpart = torch.empty(parts, grad_size, dtype=torch.float32, device=dev)
    grads = torch.empty(grad_size, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    daggr = torch.empty_like(aggr)
    err = getattr(lib, _BWD_FN[(x.dtype, bf16)])(
        x.data_ptr(), aggr.data_ptr(), w0.data_ptr(), b0.data_ptr(),
        w_stack.data_ptr(), b_stack.data_ptr(), w0_t.data_ptr(),
        wt_stack.data_ptr(), g.data_ptr(), gpart.data_ptr(), c, n_layers,
        n_tiles, parts, dx.data_ptr(), daggr.data_ptr(), grads.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "fused_node_phase_bwd")
    fused_node_phase_bwd.launches += 1
    dwa, dwb, dw, db0, db = grads.split(
        [c * c, c * c, n_layers * c * c, c, n_layers * c])
    return (dx, daggr, dwa.view(c, c), dwb.view(c, c), db0,
            dw.view(n_layers, c, c), db.view(n_layers, c))


fused_node_phase_bwd.launches = 0


class _NodePhase(torch.autograd.Function):
    """Kernel 3 forward, kernel 6 backward; a gradient for x, aggr and
    every weight and bias of the node MLP."""

    @staticmethod
    def forward(ctx, mlp, compute_dtype, x, aggr, *params):
        ctx.mlp, ctx.compute_dtype = mlp, compute_dtype
        ctx.save_for_backward(x, aggr, *params)
        return fused_node_phase_fwd(x, aggr, mlp, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        x, aggr, *params = ctx.saved_tensors
        dx, daggr, dwa, dwb, db0, dw, db = fused_node_phase_bwd(
            x, aggr, ctx.mlp, g, ctx.compute_dtype)
        grads = ([torch.cat([dwa, dwb])] + list(dw.unbind(0))
                 + [db0] + list(db.unbind(0)))
        return (None, None, dx, daggr,
                *(d.to(p.dtype) for d, p in zip(grads, params)))


def fused_node_phase(x, aggr, mlp, compute_dtype=None):
    """LN(MLP_node([x, aggr])) + x, differentiable in x, aggr and the node
    MLP's weights and biases. Output in bf16 in bf16 compute, else in x's
    dtype."""
    _check(x, aggr, mlp, compute_dtype)
    return _NodePhase.apply(mlp, compute_dtype, x, aggr, *mlp.weights,
                            *mlp.biases)
