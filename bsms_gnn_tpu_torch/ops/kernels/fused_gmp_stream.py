"""Kernels 12 and 11: the fused GMP edge phase on a streamed first layer,
and their backwards.

Kernel 12 replaces the TPU kernel `bsms_gnn_tpu/ops/pallas/fused_gmp.py::
fused_edge_phase` (v2, `_get_fwd2` → `_make_fwd2_kernel`, and `_get_bwd2`
→ `_make_bwd2_kernel`):

    aggr[n] = Σ_{e: recv(e)=n} LN(tail(relu(zi[e] + xj[recv_e])))

with zi [E_pad, C] the sender side of each slot's first-layer
pre-activation (x@W_i gathered, the fiber term, the first bias) and xj
[n_pad, C] the receiver transform x@W_j, gathered in the kernel. Kernel 11
replaces `fused_edge_mlp_aggregate` (v1, `_get_fwd` → `_make_fwd_kernel`,
`_get_bwd` → `_make_bwd_kernel`): the same with the whole pre-activation
streamed,

    aggr[n] = Σ_{e: recv(e)=n} LN(tail(relu(pre[e]))).

The backwards return (dzi [E_pad, C] in zi's dtype, dxj [n_pad, C] f32,
dW [L, C, C], db [L, C]) and (dpre [E_pad, C] in pre's dtype, dW, db).

Which slots count: the TPU kernels scatter a chunk through a one-hot of its
own 128-row output block, so a slot adds to the aggregate iff its receiver
lies in that block (`in_block`); no window mask applies. The pad slots of
the last block land on row n_pad − 1; those of every other block (receiver
n_pad − 1, outside the block) add nothing, take no receiver row (kernel
12's zj is 0, not xj[n_pad − 1]) and get a zero edge cotangent, so they add
nothing to dW, db or dxj. The plain versions apply the same mask:
`index_add_` over all slots would disagree at row n_pad − 1.

CUDA design (`csrc/fused_gmp_stream.cu`, `csrc/fused_gmp_stream_bwd.cu`).
Both directions run the persistent tile walks of kernels 4 and 5 with the
streamed front (kernel 12's adds the receiver row xj of each slot in its
chunk's block): G blocks (`walk_grid`: the SMs times the blocks per SM the
kernel reaches, at most the level's tiles) over the level's 64-slot tiles,
a tile with no slot in its chunk's block skipped. The forwards
(`csrc/edge_fwd_tiles.cuh`) store each live slot's message (the LN output,
bf16-rounded in bf16 mode) into a transient `msg [E_pad, 128]`, two
blocks of 256 threads per SM, the tail on the walks' `gemm_rows`; the
backwards (`csrc/edge_bwd_tiles.cuh`) write zero dzi / dpre rows on dead
tiles and one weight-gradient partial per block, summed in block order by
grad_sum_kernel. The forwards' aggregate and kernel 12's dxj are the
row-ordered gather of `csrc/row_gather.cuh` (`recv_gather_kernel`) over
msg or dzi and the level's receiver lists (`row_ptr`, `row_slots`,
`row_long`), which hold exactly the slots with a receiver in their chunk's
block, in slot order, the last block's pad slots on row n_pad − 1: no
output block, no per-chunk part and no chunk sum. No atomics anywhere: the
same result from run to run. The chunk is the level's edge_block: 128
slots on unwindowed levels, 512 where kernel 11 runs on a windowed level.
What bounds it on the card: operations, L·2·128·128 FLOP per slot in the
tail on the CUDA cores (about three times that in the backward), against
a few hundred bytes per slot of traffic.

bf16 mode (zi, xj or pre in bf16) follows the TPU kernels: every dot's
operands are rounded to bf16 (the hidden activations, the weights, and in
the backward the edge cotangent g[recv], the running cotangent and, before
the dxj sum, dpre) and accumulated in f32; the LN output is rounded to bf16
before the f32 scatter sum; dzi / dpre are stored in bf16.

`fused_edge_phase` and `fused_edge_mlp_aggregate` are the differentiable
entries: autograd Functions whose forwards launch kernels 12 and 11 and
whose backwards launch their backward kernels.
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.graph.hierarchy import GATHER_PIECE
from bsms_gnn_tpu_torch.ops.kernels import build
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import (
    BN,
    MAX_BWD_LAYERS,
    mlp_tail_bwd,
    mlp_tail_fwd_save,
    mlp_tail_plain,
    round_bf16,
    walk_grid,
    walk_sigs,
)

_LIB = "fused_gmp_stream"
_BWD_LIB = "fused_gmp_stream_bwd"
_FN = {torch.float32: "fused_edge_phase_f32",
       torch.bfloat16: "fused_edge_phase_bf16"}
_AGG_FN = {torch.float32: "fused_edge_mlp_aggregate_f32",
           torch.bfloat16: "fused_edge_mlp_aggregate_bf16"}
_BWD_FN = {torch.float32: "fused_edge_phase_bwd_f32",
           torch.bfloat16: "fused_edge_phase_bwd_bf16"}
_AGG_BWD_FN = {torch.float32: "fused_edge_mlp_aggregate_bwd_f32",
               torch.bfloat16: "fused_edge_mlp_aggregate_bwd_bf16"}
_SIGS = {
    _LIB: {**walk_sigs(_FN, 9, 8, 3), **walk_sigs(_AGG_FN, 8, 8, 3)},
    _BWD_LIB: {**{f: [build.P] * 11 + [build.I] * 8 + [build.P] * 5
                  for f in _BWD_FN.values()},
               **{f: [build.P] * 7 + [build.I] * 5 + [build.P] * 4
                  for f in _AGG_BWD_FN.values()},
               **{f + "_blocks_per_sm": [build.I, build.P]
                  for f in (*_BWD_FN.values(), *_AGG_BWD_FN.values())}},
}


def _check(level, src, xj, weights, biases):
    """src: zi or pre [E_pad, 128]; xj: [n_pad, 128] in src's dtype, or
    None (kernel 11)."""
    if src.dim() != 2:
        raise NotImplementedError("batch axis")
    c = src.shape[-1]
    if c != BN:
        raise NotImplementedError(f"latent width {c} (only 128)")
    if src.shape != (level.n_pad_edges, c) or src.dtype not in _FN:
        raise ValueError(f"edge rows {tuple(src.shape)} {src.dtype} must be "
                         f"({level.n_pad_edges}, {c}) in f32 or bf16")
    if xj is not None and (xj.shape != (level.n_pad_nodes, c)
                           or xj.dtype != src.dtype):
        raise ValueError(f"xj {tuple(xj.shape)} {xj.dtype} must be "
                         f"({level.n_pad_nodes}, {c}) in {src.dtype}")
    if any(w.shape != (c, c) for w in weights):
        raise ValueError("the tail weights must be [C, C]")
    if len(weights) != len(biases) or not weights:
        raise ValueError("tail weights and biases differ in count")


def in_block(level):
    """Each slot's receiver, and whether it lies in the 128-row output
    block of the slot's chunk (the slots the TPU kernels' one-hot counts)."""
    recv = level.receivers.long()
    block = level.chunk_block.long().repeat_interleave(level.edge_block)
    return recv, recv // BN == block


def _stream_pre(level, src, xj):
    """Each slot's first-layer pre-activation src[e] (+ xj[recv_e] on the
    slots in block) in f32, the receivers and the in-block mask."""
    recv, inb = in_block(level)
    pre = src.float()
    if xj is not None:
        pre = pre + torch.where(inb[:, None],
                                xj.float().index_select(0, recv), 0.0)
    return pre, recv, inb


def _aggregate_plain(level, src, xj, weights, biases):
    bf16 = src.dtype == torch.bfloat16
    pre, recv, inb = _stream_pre(level, src, xj)
    e = mlp_tail_plain(pre, [w.float() for w in weights],
                       [b.float() for b in biases], bf16)
    if bf16:
        e = round_bf16(e)
    e = torch.where(inb[:, None], e, 0.0)
    out = torch.zeros(level.n_pad_nodes, BN, dtype=torch.float32,
                      device=src.device)
    return out.index_add_(0, recv, e)


def _backward_plain(level, src, xj, weights, biases, g):
    """(dpre f32, receivers, in-block mask, dW, db)."""
    bf16 = src.dtype == torch.bfloat16
    pre, recv, inb = _stream_pre(level, src, xj)
    ws, bs = [w.float() for w in weights], [b.float() for b in biases]
    normed, inv, hs = mlp_tail_fwd_save(pre, ws, bs, bf16)
    ge = torch.where(inb[:, None], g.float().index_select(0, recv), 0.0)
    if bf16:
        ge = round_bf16(ge)
    dpre, dw, db = mlp_tail_bwd(pre, hs, normed, inv, ge, ws, bf16)
    return dpre, recv, inb, dw, db


def _launch_fwd(fn_table, level, src, xj, weights, biases, what):
    """aggr [n_pad, 128] f32 by the forward tile walk with the streamed
    front, then the receiver gather over `row_*`, on CUDA tensors."""
    build.require(what, src.device, level.receivers, level.chunk_block,
                  level.row_ptr, level.row_slots, level.row_long)
    lib = build.library(_LIB, _SIGS[_LIB])
    fn, dev = fn_table[src.dtype], src.device
    n_tiles, grid = walk_grid(lib, fn, len(weights), level)
    # The tile walk takes the weights already rounded in bf16 mode.
    bf16 = src.dtype == torch.bfloat16
    w_stack = build.stacked(weights, to_bf16=bf16)
    b_stack = build.stacked(biases)
    rows = [src.contiguous()] + ([] if xj is None else [xj.contiguous()])
    msg = torch.empty(level.n_pad_edges, BN, dtype=src.dtype, device=dev)
    out = torch.empty(level.n_pad_nodes, BN, dtype=torch.float32, device=dev)
    err = getattr(lib, fn)(
        *(t.data_ptr() for t in rows), w_stack.data_ptr(), b_stack.data_ptr(),
        level.receivers.data_ptr(), level.chunk_block.data_ptr(),
        level.row_ptr.data_ptr(), level.row_slots.data_ptr(),
        level.row_long.data_ptr(), len(weights), grid, n_tiles,
        level.n_pad_edges, level.edge_block, level.n_pad_nodes,
        level.row_long.numel(), GATHER_PIECE, msg.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, what)
    return out


def _launch_bwd(fn_table, level, src, xj, weights, biases, g, what):
    """(dsrc in src's dtype, dxj f32 or None, dW, db)."""
    if len(weights) > MAX_BWD_LAYERS:
        raise NotImplementedError(f"{len(weights)} tail layers (the backward "
                                  f"kernels take {MAX_BWD_LAYERS})")
    build.require(what, src.device, level.receivers, level.chunk_block,
                  *(() if xj is None else (level.row_ptr, level.row_slots,
                                           level.row_long)))
    lib = build.library(_BWD_LIB, _SIGS[_BWD_LIB])
    fn = fn_table[src.dtype]
    dev, n_layers = src.device, len(weights)
    n_tiles, grid = walk_grid(lib, fn, n_layers, level)
    # The tile walk takes the weights already rounded in bf16 mode.
    bf16 = src.dtype == torch.bfloat16
    w_stack = build.stacked(weights, to_bf16=bf16)
    wt_stack = build.stacked(weights, transpose=True, to_bf16=bf16)
    b_stack = build.stacked(biases)
    src = src.contiguous()
    g = g.detach().float().contiguous()
    sizes = [n_layers * BN * BN, n_layers * BN]
    f32 = dict(dtype=torch.float32, device=dev)
    dsrc = torch.empty(level.n_pad_edges, BN, dtype=src.dtype, device=dev)
    gpart = torch.empty(grid, sum(sizes), **f32)
    grads = torch.empty(sum(sizes), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    common = (w_stack.data_ptr(), b_stack.data_ptr(), wt_stack.data_ptr(),
              g.data_ptr(), level.receivers.data_ptr(),
              level.chunk_block.data_ptr())
    dxj = None
    if xj is not None:
        xj = xj.contiguous()
        dxj = torch.empty(level.n_pad_nodes, BN, **f32)
        err = getattr(lib, fn)(
            src.data_ptr(), xj.data_ptr(), *common, level.row_ptr.data_ptr(),
            level.row_slots.data_ptr(), level.row_long.data_ptr(), n_layers,
            grid, n_tiles, level.n_pad_edges, level.edge_block,
            level.n_pad_nodes, level.row_long.numel(), GATHER_PIECE,
            gpart.data_ptr(), dsrc.data_ptr(), dxj.data_ptr(),
            grads.data_ptr(), stream)
    else:
        err = getattr(lib, fn)(
            src.data_ptr(), *common, n_layers, grid, n_tiles,
            level.n_pad_edges, level.edge_block, gpart.data_ptr(),
            dsrc.data_ptr(), grads.data_ptr(), stream)
    build.check(err, what)
    dw, db = grads.split(sizes)
    return dsrc, dxj, dw.view(n_layers, BN, BN), db.view(n_layers, BN)


# -- kernel 12 ----------------------------------------------------------------


def fused_edge_phase_plain(level, zi, xj, weights, biases):
    """Kernel 12's function in plain PyTorch (index_select / matmul /
    index_add_)."""
    fused_edge_phase_plain.calls += 1
    return _aggregate_plain(level, zi, xj, weights, biases)


fused_edge_phase_plain.calls = 0


def fused_edge_phase_fwd(level, zi, xj, weights, biases):
    """aggr [n_pad, 128] f32, no autograd. CPU tensors take the plain
    version; CUDA tensors launch kernel 12."""
    _check(level, zi, xj, weights, biases)
    if zi.device.type == "cpu":
        return fused_edge_phase_plain(level, zi, xj, weights, biases)
    if zi.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {zi.device}")
    out = _launch_fwd(_FN, level, zi, xj, weights, biases, "fused_edge_phase")
    fused_edge_phase_fwd.launches += 1
    return out


fused_edge_phase_fwd.launches = 0


def fused_edge_phase_bwd_plain(level, zi, xj, weights, biases, g):
    """Kernel 12's backward in plain PyTorch."""
    fused_edge_phase_bwd_plain.calls += 1
    dpre, recv, inb, dw, db = _backward_plain(level, zi, xj, weights, biases,
                                              g)
    dpre_op = round_bf16(dpre) if zi.dtype == torch.bfloat16 else dpre
    dxj = torch.zeros(level.n_pad_nodes, BN, dtype=torch.float32,
                      device=zi.device).index_add_(
        0, recv, torch.where(inb[:, None], dpre_op, 0.0))
    return dpre.to(zi.dtype), dxj, dw, db


fused_edge_phase_bwd_plain.calls = 0


def fused_edge_phase_bwd(level, zi, xj, weights, biases, g):
    """(dzi [E_pad, 128] in zi's dtype, dxj [n_pad, 128] f32, dW [L, 128,
    128], db [L, 128]) for the aggregate's cotangent g, no autograd. CPU
    tensors take the plain version; CUDA tensors launch kernel 12's
    backward."""
    _check(level, zi, xj, weights, biases)
    if g.shape != (level.n_pad_nodes, BN):
        raise ValueError(f"g {tuple(g.shape)} != ({level.n_pad_nodes}, {BN})")
    if zi.device.type == "cpu":
        return fused_edge_phase_bwd_plain(level, zi, xj, weights, biases, g)
    if zi.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {zi.device}")
    out = _launch_bwd(_BWD_FN, level, zi, xj, weights, biases, g,
                      "fused_edge_phase_bwd")
    fused_edge_phase_bwd.launches += 1
    return out


fused_edge_phase_bwd.launches = 0


class _EdgePhase(torch.autograd.Function):
    """Kernel 12 forward; its backward kernel backward. A gradient for zi,
    xj and every tail weight and bias."""

    @staticmethod
    def forward(ctx, level, n_layers, zi, xj, *params):
        ctx.level, ctx.n_layers = level, n_layers
        ctx.save_for_backward(zi, xj, *params)
        return fused_edge_phase_fwd(level, zi, xj, params[:n_layers],
                                    params[n_layers:])

    @staticmethod
    def backward(ctx, g):
        zi, xj, *params = ctx.saved_tensors
        n = ctx.n_layers
        weights, biases = params[:n], params[n:]
        dzi, dxj, dw, db = fused_edge_phase_bwd(ctx.level, zi, xj, weights,
                                                biases, g)
        return (None, None, dzi, dxj.to(xj.dtype),
                *(d.to(w.dtype) for d, w in zip(dw.unbind(0), weights)),
                *(d.to(b.dtype) for d, b in zip(db.unbind(0), biases)))


def fused_edge_phase(level, zi, xj, weights, biases):
    """aggr [n_pad, 128] f32, differentiable in zi, xj and every tail
    weight and bias. zi: [E_pad, 128] the sender side of each slot's
    first-layer pre-activation; xj: [n_pad, 128] the receiver transform, in
    zi's dtype; `weights`/`biases` the tail layers ([C, C] stored [in,
    out])."""
    _check(level, zi, xj, weights, biases)
    return _EdgePhase.apply(level, len(weights), zi, xj, *weights, *biases)


# -- kernel 11 ----------------------------------------------------------------


def fused_edge_mlp_aggregate_plain(level, pre, weights, biases):
    """Kernel 11's function in plain PyTorch (matmul / index_add_)."""
    fused_edge_mlp_aggregate_plain.calls += 1
    return _aggregate_plain(level, pre, None, weights, biases)


fused_edge_mlp_aggregate_plain.calls = 0


def fused_edge_mlp_aggregate_fwd(level, pre, weights, biases):
    """aggr [n_pad, 128] f32, no autograd. CPU tensors take the plain
    version; CUDA tensors launch kernel 11."""
    _check(level, pre, None, weights, biases)
    if pre.device.type == "cpu":
        return fused_edge_mlp_aggregate_plain(level, pre, weights, biases)
    if pre.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {pre.device}")
    out = _launch_fwd(_AGG_FN, level, pre, None, weights, biases,
                      "fused_edge_mlp_aggregate")
    fused_edge_mlp_aggregate_fwd.launches += 1
    return out


fused_edge_mlp_aggregate_fwd.launches = 0


def fused_edge_mlp_aggregate_bwd_plain(level, pre, weights, biases, g):
    """Kernel 11's backward in plain PyTorch."""
    fused_edge_mlp_aggregate_bwd_plain.calls += 1
    dpre, _, _, dw, db = _backward_plain(level, pre, None, weights, biases, g)
    return dpre.to(pre.dtype), dw, db


fused_edge_mlp_aggregate_bwd_plain.calls = 0


def fused_edge_mlp_aggregate_bwd(level, pre, weights, biases, g):
    """(dpre [E_pad, 128] in pre's dtype, dW [L, 128, 128], db [L, 128])
    for the aggregate's cotangent g, no autograd. CPU tensors take the plain
    version; CUDA tensors launch kernel 11's backward."""
    _check(level, pre, None, weights, biases)
    if g.shape != (level.n_pad_nodes, BN):
        raise ValueError(f"g {tuple(g.shape)} != ({level.n_pad_nodes}, {BN})")
    if pre.device.type == "cpu":
        return fused_edge_mlp_aggregate_bwd_plain(level, pre, weights, biases,
                                                  g)
    if pre.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {pre.device}")
    dpre, _, dw, db = _launch_bwd(_AGG_BWD_FN, level, pre, None, weights,
                                  biases, g, "fused_edge_mlp_aggregate_bwd")
    fused_edge_mlp_aggregate_bwd.launches += 1
    return dpre, dw, db


fused_edge_mlp_aggregate_bwd.launches = 0


class _EdgeMlpAggregate(torch.autograd.Function):
    """Kernel 11 forward; its backward kernel backward. A gradient for pre
    and every tail weight and bias."""

    @staticmethod
    def forward(ctx, level, n_layers, pre, *params):
        ctx.level, ctx.n_layers = level, n_layers
        ctx.save_for_backward(pre, *params)
        return fused_edge_mlp_aggregate_fwd(level, pre, params[:n_layers],
                                            params[n_layers:])

    @staticmethod
    def backward(ctx, g):
        pre, *params = ctx.saved_tensors
        n = ctx.n_layers
        weights, biases = params[:n], params[n:]
        dpre, dw, db = fused_edge_mlp_aggregate_bwd(ctx.level, pre, weights,
                                                    biases, g)
        return (None, None, dpre,
                *(d.to(w.dtype) for d, w in zip(dw.unbind(0), weights)),
                *(d.to(b.dtype) for d, b in zip(db.unbind(0), biases)))


def fused_edge_mlp_aggregate(level, pre, weights, biases):
    """aggr [n_pad, 128] f32, differentiable in pre and every tail weight
    and bias. pre: [E_pad, 128] each slot's first-layer pre-activation (f32,
    or bf16 in bf16 compute); `weights`/`biases` the tail layers."""
    _check(level, pre, None, weights, biases)
    return _EdgeMlpAggregate.apply(level, len(weights), pre, *weights,
                                   *biases)
