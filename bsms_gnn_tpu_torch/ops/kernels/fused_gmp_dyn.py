"""Kernel 13: the windowed fused GMP edge phase with a dynamic world-space
fiber (the contact cases), and its backward.

Replaces the TPU kernel `bsms_gnn_tpu/ops/pallas/fused_gmp.py::
fused_edge_phase_win_dyn` (v4, `_get_fwd4` → `_make_fwd4_kernel`, and
`_get_bwd4` → `_make_bwd4_kernel`): kernel 4's function plus the world-space
term of the first edge layer,

    aggr[n] = Σ_{in-window e: recv(e)=n} LN(tail(relu(
                fiber_t[:, e]ᵀ·wf8 + xwi[send_e] + xj[recv_e]
                + Δ_e·wf_dyn + ‖Δ_e‖·wf_nrm)))
    Δ_e = pos[send_e] − pos[recv_e]   (sender minus receiver)

with the sender row `win_base[chunk]·W/2 + send_win[e]`; out-of-window and
pad slots (sentinel `send_win == W`) add nothing, and the caller adds the
compact residual. The backward returns dpre (zero on masked slots), dxj,
dwf8, dwf_dyn [wd, C], dwf_nrm [C], dW and db, and no cotangent for the
positions, which the caller detaches (JAX's `stop_gradient`).

The TPU kernel reads the positions as extra lanes of [N, 2C] sender and
receiver tables (a lane-alignment device) and keeps wf_dyn as a [C, C]
block. Here the positions are their own [n_pad, wd] tensor and wf_dyn stays
[wd, C].

CUDA design (`csrc/fused_gmp_dyn.cu`, `csrc/fused_gmp_dyn_bwd.cu`): kernels
4 and 5's chunk walks (`csrc/edge_phase.cuh`, `csrc/edge_phase_bwd.cuh`,
shared through templates, with their own entry points and CUDA kernel
names). Per 64-slot tile, the threads that fill the slot tables also read
the wd position components of both ends and keep Δ (wd rows) and ‖Δ‖ in
shared memory (1 KB a tile); wf_dyn and wf_nrm join wf8 in shared memory.
The backward adds Δᵀ·dpre to the fiber-weighted sums that give dwf8 and
Σ ‖Δ‖·dpre to each chunk's weight-gradient partial, which grad_sum_kernel
adds in chunk order as before. Kernel 5's 220 KB of shared memory grows by
3.8 KB to 224 KB (of 227 KB), with the 64-slot tile kept. What bounds it on
the card: operations, as kernel 4 (and kernel 5 for the backward), plus
2·(wd+1)·C per slot; the positions add a few bytes per slot.

bf16 mode follows the TPU kernel: the positions are bf16 (the caller casts
them to the activations' dtype), Δ is taken in f32 from those values and
rounded to bf16 as the operand of the wf_dyn dot (wf_dyn rounded too),
‖Δ‖·wf_nrm is an f32 product with nothing rounded; in the backward dwf_dyn
takes bf16 operands (Δ and dpre), while dwf_nrm sums ‖Δ‖·dpre in f32 with
dpre not yet rounded (`fused_gmp.py:1103-1105`).

`fused_edge_phase_win_dyn` is the differentiable entry: an autograd
Function whose forward launches kernel 13 and whose backward launches
kernel 13's backward and then kernel 7 (`windowed.py::windowed_send_sum`)
on dpre for the sender side, as `fused_gmp.py:840-868` does.
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.ops.kernels import build
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import (
    BN,
    MAX_BWD_LAYERS,
    _check,
    _edge_pre,
    dot,
    mlp_tail_bwd,
    mlp_tail_fwd_save,
    mlp_tail_plain,
    round_bf16,
    sender_rows,
)
from bsms_gnn_tpu_torch.ops.kernels.windowed import windowed_send_sum

# Widest world-position stream the CUDA kernels take (`csrc/edge_tile.cuh`).
MAX_WD = 4
_SIG = [build.P] * 14 + [build.I] * 7 + [build.P] * 3
_FN = {torch.float32: "fused_edge_phase_win_dyn_f32",
       torch.bfloat16: "fused_edge_phase_win_dyn_bf16"}
_BWD_SIG = [build.P] * 16 + [build.I] * 7 + [build.P] * 6
_BWD_FN = {torch.float32: "fused_edge_phase_win_dyn_bwd_f32",
           torch.bfloat16: "fused_edge_phase_win_dyn_bwd_bf16"}


def _check_dyn(level, xwi, xj, pos, wf8, wfd, wfn, weights, biases):
    _check(level, xwi, xj, wf8, weights, biases)
    wd = wfd.shape[0] if wfd.dim() == 2 else -1
    if not 0 < wd <= BN or wfd.shape != (wd, BN) or wfn.shape != (BN,):
        raise ValueError(f"wf_dyn {tuple(wfd.shape)} must be [wd, {BN}] with "
                         f"0 < wd <= {BN}, wf_nrm {tuple(wfn.shape)} [{BN}]")
    if pos.shape != (level.n_pad_nodes, wd) or pos.dtype != xwi.dtype:
        raise ValueError(f"pos {tuple(pos.shape)} {pos.dtype} must be "
                         f"({level.n_pad_nodes}, {wd}) in {xwi.dtype}")


def _edge_pre_dyn(level, xwi, xj, pos, wf8, wfd, wfn, bf16):
    """Kernel 4's pre-activation plus Δ·wf_dyn + ‖Δ‖·wf_nrm (f32), the
    in-window mask, the receivers, Δ (f32, unrounded) and ‖Δ‖."""
    pre, covered, recv = _edge_pre(level, xwi, xj, wf8, bf16)
    rows, _ = sender_rows(level)
    p = pos.float()
    ps = torch.where(covered[:, None], p.index_select(0, rows), 0.0)
    delta = ps - p.index_select(0, recv)
    nrm = delta.square().sum(-1).sqrt()
    pre = pre + dot(delta, wfd.float(), bf16) + nrm[:, None] * wfn.float()
    return pre, covered, recv, delta, nrm


def fused_edge_phase_win_dyn_plain(level, xwi, xj, pos, wf8, wfd, wfn,
                                   weights, biases):
    """Kernel 13's function in plain PyTorch (index_select / matmul /
    index_add_)."""
    fused_edge_phase_win_dyn_plain.calls += 1
    bf16 = xwi.dtype == torch.bfloat16
    pre, covered, recv, _, _ = _edge_pre_dyn(level, xwi, xj, pos, wf8, wfd,
                                             wfn, bf16)
    e = mlp_tail_plain(pre, [x.float() for x in weights],
                       [x.float() for x in biases], bf16)
    if bf16:
        e = round_bf16(e)
    e = torch.where(covered[:, None], e, 0.0)
    out = torch.zeros(level.n_pad_nodes, BN, dtype=torch.float32,
                      device=xwi.device)
    return out.index_add_(0, recv, e)


fused_edge_phase_win_dyn_plain.calls = 0


def _kernel_wd(wfd):
    wd = wfd.shape[0]
    if wd > MAX_WD:
        raise NotImplementedError(
            f"world stream of width {wd} (kernel 13 takes up to {MAX_WD})")
    return wd


def fused_edge_phase_win_dyn_fwd(level, xwi, xj, pos, wf8, wfd, wfn,
                                 weights, biases):
    """aggr [n_pad, 128] f32 of the in-window edges, no autograd. CPU
    tensors take the plain version; CUDA tensors launch kernel 13."""
    _check_dyn(level, xwi, xj, pos, wf8, wfd, wfn, weights, biases)
    if xwi.device.type == "cpu":
        return fused_edge_phase_win_dyn_plain(level, xwi, xj, pos, wf8, wfd,
                                              wfn, weights, biases)
    if xwi.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {xwi.device}")
    wd = _kernel_wd(wfd)
    build.require("fused_edge_phase_win_dyn", xwi.device, level.send_win,
                  level.win_base, level.receivers, level.chunk_block,
                  level.chunk_ptr)
    lib = build.library("fused_gmp_dyn", {f: _SIG for f in _FN.values()})
    w_stack, b_stack = build.stacked(weights), build.stacked(biases)
    xwi, xj, pos = xwi.contiguous(), xj.contiguous(), pos.contiguous()
    wf8, wfd, wfn = (t.detach().float().contiguous() for t in (wf8, wfd, wfn))
    n_chunks = level.n_pad_edges // level.edge_block
    part = torch.empty(n_chunks, BN, BN, dtype=torch.float32,
                       device=xwi.device)
    out = torch.empty(level.n_pad_nodes, BN, dtype=torch.float32,
                      device=xwi.device)
    err = getattr(lib, _FN[xwi.dtype])(
        level.fiber_t.data_ptr(), xwi.data_ptr(), xj.data_ptr(),
        pos.data_ptr(), wf8.data_ptr(), wfd.data_ptr(), wfn.data_ptr(),
        w_stack.data_ptr(), b_stack.data_ptr(), level.send_win.data_ptr(),
        level.win_base.data_ptr(), level.receivers.data_ptr(),
        level.chunk_block.data_ptr(), level.chunk_ptr.data_ptr(),
        len(weights), wd, n_chunks, level.n_pad_nodes // BN,
        level.n_pad_edges, level.edge_block, level.window, part.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(xwi.device).cuda_stream,
    )
    build.check(err, "fused_edge_phase_win_dyn")
    fused_edge_phase_win_dyn_fwd.launches += 1
    return out


fused_edge_phase_win_dyn_fwd.launches = 0


def fused_edge_phase_win_dyn_bwd_plain(level, xwi, xj, pos, wf8, wfd, wfn,
                                       weights, biases, g):
    """Kernel 13's backward in plain PyTorch."""
    fused_edge_phase_win_dyn_bwd_plain.calls += 1
    bf16 = xwi.dtype == torch.bfloat16
    pre, covered, recv, delta, nrm = _edge_pre_dyn(level, xwi, xj, pos, wf8,
                                                   wfd, wfn, bf16)
    ws, bs = [w.float() for w in weights], [b.float() for b in biases]
    normed, inv, hs = mlp_tail_fwd_save(pre, ws, bs, bf16)
    ge = torch.where(covered[:, None], g.float().index_select(0, recv), 0.0)
    if bf16:
        ge = round_bf16(ge)
    dpre, dw, db = mlp_tail_bwd(pre, hs, normed, inv, ge, ws, bf16)
    dpre_op = round_bf16(dpre) if bf16 else dpre
    dxj = torch.zeros(level.n_pad_nodes, BN, dtype=torch.float32,
                      device=xwi.device).index_add_(0, recv, dpre_op)
    dwf8 = dot(level.fiber_t, dpre, bf16)
    dwfd = dot(delta.t(), dpre, bf16)
    dwfn = (nrm[:, None] * dpre).sum(0)
    return dpre.to(xwi.dtype), dxj, dwf8, dwfd, dwfn, dw, db


fused_edge_phase_win_dyn_bwd_plain.calls = 0


def fused_edge_phase_win_dyn_bwd(level, xwi, xj, pos, wf8, wfd, wfn, weights,
                                 biases, g):
    """(dpre [E_pad, 128] in xwi's dtype, dxj [n_pad, 128] f32, dwf8 [8,
    128], dwf_dyn [wd, 128], dwf_nrm [128], dW [L, 128, 128], db [L, 128])
    for the aggregate's cotangent g, no autograd. CPU tensors take the plain
    version; CUDA tensors launch kernel 13's backward."""
    _check_dyn(level, xwi, xj, pos, wf8, wfd, wfn, weights, biases)
    if g.shape != (level.n_pad_nodes, BN):
        raise ValueError(f"g {tuple(g.shape)} != ({level.n_pad_nodes}, {BN})")
    if xwi.device.type == "cpu":
        return fused_edge_phase_win_dyn_bwd_plain(level, xwi, xj, pos, wf8,
                                                  wfd, wfn, weights, biases, g)
    if xwi.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {xwi.device}")
    if len(weights) > MAX_BWD_LAYERS:
        raise NotImplementedError(f"{len(weights)} tail layers (kernel 13's "
                                  f"backward takes {MAX_BWD_LAYERS})")
    wd = _kernel_wd(wfd)
    build.require("fused_edge_phase_win_dyn_bwd", xwi.device, level.send_win,
                  level.win_base, level.receivers, level.chunk_block,
                  level.chunk_ptr)
    lib = build.library("fused_gmp_dyn_bwd",
                        {f: _BWD_SIG for f in _BWD_FN.values()})
    dev, n_layers = xwi.device, len(weights)
    w_stack, b_stack = build.stacked(weights), build.stacked(biases)
    wt_stack = build.stacked(weights, transpose=True)
    xwi, xj, pos = xwi.contiguous(), xj.contiguous(), pos.contiguous()
    wf8, wfd, wfn = (t.detach().float().contiguous() for t in (wf8, wfd, wfn))
    g = g.detach().float().contiguous()
    n_chunks = level.n_pad_edges // level.edge_block
    sizes = [n_layers * BN * BN, n_layers * BN, 8 * BN, wd * BN, BN]
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.empty(n_chunks, BN, BN, **f32)
    gpart = torch.empty(n_chunks, sum(sizes), **f32)
    dpre = torch.empty(level.n_pad_edges, BN, dtype=xwi.dtype, device=dev)
    dxj = torch.empty(level.n_pad_nodes, BN, **f32)
    grads = torch.empty(sum(sizes), **f32)
    err = getattr(lib, _BWD_FN[xwi.dtype])(
        level.fiber_t.data_ptr(), xwi.data_ptr(), xj.data_ptr(),
        pos.data_ptr(), wf8.data_ptr(), wfd.data_ptr(), wfn.data_ptr(),
        w_stack.data_ptr(), b_stack.data_ptr(), wt_stack.data_ptr(),
        g.data_ptr(), level.send_win.data_ptr(), level.win_base.data_ptr(),
        level.receivers.data_ptr(), level.chunk_block.data_ptr(),
        level.chunk_ptr.data_ptr(), n_layers, wd, n_chunks,
        level.n_pad_nodes // BN, level.n_pad_edges, level.edge_block,
        level.window, part.data_ptr(), gpart.data_ptr(), dpre.data_ptr(),
        dxj.data_ptr(), grads.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "fused_edge_phase_win_dyn_bwd")
    fused_edge_phase_win_dyn_bwd.launches += 1
    dw, db, dwf8, dwfd, dwfn = grads.split(sizes)
    return (dpre, dxj, dwf8.view(8, BN), dwfd.view(wd, BN), dwfn,
            dw.view(n_layers, BN, BN), db.view(n_layers, BN))


fused_edge_phase_win_dyn_bwd.launches = 0


class _DynEdgePhase(torch.autograd.Function):
    """Kernel 13 forward; its backward, then kernel 7 on dpre for xwi's
    cotangent, backward. No cotangent for the positions."""

    @staticmethod
    def forward(ctx, level, n_layers, xwi, xj, pos, wf8, wfd, wfn, *params):
        weights, biases = params[:n_layers], params[n_layers:]
        ctx.level, ctx.n_layers = level, n_layers
        ctx.save_for_backward(xwi, xj, pos, wf8, wfd, wfn, *params)
        return fused_edge_phase_win_dyn_fwd(level, xwi, xj, pos, wf8, wfd,
                                            wfn, weights, biases)

    @staticmethod
    def backward(ctx, g):
        xwi, xj, pos, wf8, wfd, wfn, *params = ctx.saved_tensors
        n = ctx.n_layers
        weights, biases = params[:n], params[n:]
        dpre, dxj, dwf8, dwfd, dwfn, dw, db = fused_edge_phase_win_dyn_bwd(
            ctx.level, xwi, xj, pos, wf8, wfd, wfn, weights, biases, g)
        dxwi = windowed_send_sum(ctx.level, dpre)
        return (None, None, dxwi.to(xwi.dtype), dxj.to(xj.dtype), None,
                dwf8.to(wf8.dtype), dwfd.to(wfd.dtype), dwfn.to(wfn.dtype),
                *(d.to(w.dtype) for d, w in zip(dw.unbind(0), weights)),
                *(d.to(b.dtype) for d, b in zip(db.unbind(0), biases)))


def fused_edge_phase_win_dyn(level, xwi, xj, pos, wf8, wfd, wfn, weights,
                             biases):
    """aggr [n_pad, 128] f32 of the in-window edges, differentiable in xwi,
    xj, wf8, wf_dyn, wf_nrm and every tail weight and bias. `pos` [n_pad,
    wd] are the world positions in xwi's dtype (no gradient reaches them);
    `wf8` rows [0, sfw) are the static-fiber rows of the first edge layer,
    row sfw its bias; `wfd` [wd, C] its Δworld rows and `wfn` [C] its
    ‖Δworld‖ row; `weights`/`biases` are the tail layers."""
    _check_dyn(level, xwi, xj, pos, wf8, wfd, wfn, weights, biases)
    return _DynEdgePhase.apply(level, len(weights), xwi, xj, pos.detach(),
                               wf8, wfd, wfn, *weights, *biases)
