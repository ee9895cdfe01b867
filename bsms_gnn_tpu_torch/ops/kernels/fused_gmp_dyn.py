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

CUDA design. Both directions run the tile walks of kernels 4 and 5 with the
kDyn front, under kernel 13's own names: G blocks (SMs × the blocks per SM
the kernel reaches, `fused_gmp.walk_fill`, at most the level's tiles) walk
the level's 64-slot tiles (block b the tiles b, b + G, ... forward, the
range `tile_ranges(T, G)[b] .. [b + 1]` backward), so a level of few
chunks (the flag's hold 25 down to one 512-slot chunk, 200 down to 8
tiles) still spreads over the card. Per tile, the
threads that fill the slot tables also read the wd position components of
both ends and keep Δ (wd rows) and ‖Δ‖ in shared memory (1 KB a tile);
wf_dyn and wf_nrm join wf8 in shared memory once per block.
- Forward (`csrc/fused_gmp_dyn.cu` over `csrc/edge_fwd_tiles.cuh`, two
  blocks per SM at about 107 KB of shared memory each): dead tiles
  skipped, each live slot's message stored into a transient `msg [E_pad,
  128]` in the activations' dtype, then `recv_gather_kernel` sums the
  aggregate over the receiver lists `win_row_*` in list order: no
  shared-memory output block, no per-chunk part, no block sum.
- Backward (`csrc/fused_gmp_dyn_bwd.cu` over `csrc/edge_bwd_tiles.cuh`,
  one block per SM: 207,360 bytes of shared memory at three tail layers,
  kernel 5's 203,520 plus 3,840 for Δ, ‖Δ‖, wf_dyn and wf_nrm): a tile
  with no live slot writes zero dpre rows and skips the walk. Each block
  adds Δᵀ·dpre and Σ ‖Δ‖·dpre, beside the fiber-weighted sums that give
  dwf8, to its own weight-gradient partial [dW | db | dwf8 | dwf_dyn |
  dwf_nrm], and `grad_sum_kernel` adds the G partials in block order (no
  atomics); dxj is the row-ordered gather (`recv_gather_kernel`) of dpre
  over the same receiver lists, which hold exactly the slots the walk
  gives a cotangent.
In bf16 mode the tail weights come already rounded (`build.stacked(...,
to_bf16=True)`). What bounds it on the card: operations, as kernel 4 (and
kernel 5 for the backward), plus 2·(wd+1)·C per slot; the positions add a
few bytes per slot.

The batch axis (a shared mesh: xwi, xj [B, n_pad, 128], pos [B, n_pad,
wd]), as kernels 4 and 5 take it: one launch of the forward walks the B·T
tiles in the same stride order (tile t is tile t mod T of sample ⌊t / T⌋,
which reads sample ⌊t / T⌋'s positions), one launch of the backward the
B·T tiles in its G ranges (still G partials, the weight gradients summed
over the batch), and each gather takes the sample from its grid's y index.
Every per-row output of sample b is the bits of a call on sample b alone.

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

from bsms_gnn_tpu_torch.graph.hierarchy import GATHER_PIECE
from bsms_gnn_tpu_torch.ops.kernels import build
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import (
    BN,
    _edge_pre,
    check_narrow,
    dot,
    flat_rows,
    mlp_tail_bwd,
    mlp_tail_fwd_save,
    mlp_tail_plain,
    round_bf16,
    sender_rows,
    walk_grid,
    walk_plan,
    walk_sigs,
)
from bsms_gnn_tpu_torch.ops.kernels.windowed import windowed_send_sum

# Widest world-position stream the CUDA kernels take (`csrc/edge_tile.cuh`).
MAX_WD = 4
_FN = {torch.float32: "fused_edge_phase_win_dyn_f32",
       torch.bfloat16: "fused_edge_phase_win_dyn_bf16"}
_BWD_FN = {torch.float32: "fused_edge_phase_win_dyn_bwd_f32",
           torch.bfloat16: "fused_edge_phase_win_dyn_bwd_bf16"}


def _check_dyn(level, xwi, xj, pos, wf8, wfd, wfn, weights, biases):
    check_narrow("kernel 13", level, xwi, xj, wf8, weights, biases)
    wd = wfd.shape[0] if wfd.dim() == 2 else -1
    if not 0 < wd <= BN or wfd.shape != (wd, BN) or wfn.shape != (BN,):
        raise ValueError(f"wf_dyn {tuple(wfd.shape)} must be [wd, {BN}] with "
                         f"0 < wd <= {BN}, wf_nrm {tuple(wfn.shape)} [{BN}]")
    want = (*xwi.shape[:-2], level.n_pad_nodes, wd)
    if pos.shape != want or pos.dtype != xwi.dtype:
        raise ValueError(f"pos {tuple(pos.shape)} {pos.dtype} must be "
                         f"{want} in {xwi.dtype}")


def _edge_pre_dyn(level, xwi, xj, pos, wf8, wfd, wfn, bf16):
    """Kernel 4's pre-activation plus Δ·wf_dyn + ‖Δ‖·wf_nrm (f32), the
    in-window mask, the receivers, Δ (f32, unrounded) and ‖Δ‖, on xwi's
    leading dims."""
    pre, covered, recv = _edge_pre(level, xwi, xj, wf8, bf16)
    rows, _ = sender_rows(level)
    p = pos.float()
    ps = torch.where(covered[:, None], p.index_select(-2, rows), 0.0)
    delta = ps - p.index_select(-2, recv)
    nrm = delta.square().sum(-1).sqrt()
    pre = pre + dot(delta, wfd.float(), bf16) + nrm[..., None] * wfn.float()
    return pre, covered, recv, delta, nrm


def fused_edge_phase_win_dyn_plain(level, xwi, xj, pos, wf8, wfd, wfn,
                                   weights, biases):
    """Kernel 13's function in plain PyTorch (index_select / matmul /
    index_add_), on any leading dims."""
    fused_edge_phase_win_dyn_plain.calls += 1
    bf16 = xwi.dtype == torch.bfloat16
    pre, covered, recv, _, _ = _edge_pre_dyn(level, xwi, xj, pos, wf8, wfd,
                                             wfn, bf16)
    e = mlp_tail_plain(pre, [x.float() for x in weights],
                       [x.float() for x in biases], bf16)
    if bf16:
        e = round_bf16(e)
    e = torch.where(covered[:, None], e, 0.0)
    out = torch.zeros(*xwi.shape[:-2], level.n_pad_nodes, BN,
                      dtype=torch.float32, device=xwi.device)
    return out.index_add_(-2, recv, e)


fused_edge_phase_win_dyn_plain.calls = 0


def _kernel_wd(wfd):
    wd = wfd.shape[0]
    if wd > MAX_WD:
        raise NotImplementedError(
            f"world stream of width {wd} (kernel 13 takes up to {MAX_WD})")
    return wd


def fused_edge_phase_win_dyn_fwd(level, xwi, xj, pos, wf8, wfd, wfn,
                                 weights, biases):
    """aggr [..., n_pad, 128] f32 of the in-window edges (xwi, xj [n_pad,
    128] and pos [n_pad, wd], or a batch [B, ...] in one launch), no
    autograd. CPU tensors take the plain version; CUDA tensors launch
    kernel 13."""
    _check_dyn(level, xwi, xj, pos, wf8, wfd, wfn, weights, biases)
    if xwi.device.type == "cpu":
        return fused_edge_phase_win_dyn_plain(level, xwi, xj, pos, wf8, wfd,
                                              wfn, weights, biases)
    if xwi.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {xwi.device}")
    wd = _kernel_wd(wfd)
    build.require("fused_edge_phase_win_dyn", xwi.device, level.send_win,
                  level.win_base, level.receivers, level.chunk_block,
                  level.win_row_ptr, level.win_row_slots, level.win_long)
    lib = build.library("fused_gmp_dyn", walk_sigs(_FN, 16, 12, 3))
    fn, dev = _FN[xwi.dtype], xwi.device
    n_batch = xwi.shape[0] if xwi.dim() == 3 else 1
    n_tiles, grid = walk_grid(lib, fn, BN, len(weights), level, n_batch)
    bf16 = xwi.dtype == torch.bfloat16
    w_stack = build.stacked(weights, to_bf16=bf16)
    b_stack = build.stacked(biases)
    xwi, xj, pos = xwi.contiguous(), xj.contiguous(), pos.contiguous()
    wf8, wfd, wfn = (t.detach().float().contiguous() for t in (wf8, wfd, wfn))
    lead = xwi.shape[:-2]
    msg = torch.empty(*lead, level.n_pad_edges, BN, dtype=xwi.dtype,
                      device=dev)
    out = torch.empty(*lead, level.n_pad_nodes, BN, dtype=torch.float32,
                      device=dev)
    err = getattr(lib, fn)(
        level.fiber_t.data_ptr(), xwi.data_ptr(), xj.data_ptr(),
        pos.data_ptr(), wf8.data_ptr(), wfd.data_ptr(), wfn.data_ptr(),
        w_stack.data_ptr(), b_stack.data_ptr(), level.send_win.data_ptr(),
        level.win_base.data_ptr(), level.receivers.data_ptr(),
        level.chunk_block.data_ptr(), level.win_row_ptr.data_ptr(),
        level.win_row_slots.data_ptr(), level.win_long.data_ptr(),
        BN, len(weights), wd, grid, n_tiles, level.n_pad_edges,
        level.edge_block, level.window, level.n_pad_nodes,
        level.win_long.numel(),
        GATHER_PIECE, n_batch, msg.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "fused_edge_phase_win_dyn")
    fused_edge_phase_win_dyn_fwd.launches += 1
    return out


fused_edge_phase_win_dyn_fwd.launches = 0


def fused_edge_phase_win_dyn_bwd_plain(level, xwi, xj, pos, wf8, wfd, wfn,
                                       weights, biases, g):
    """Kernel 13's backward in plain PyTorch, on any leading dims (the
    weight gradients summed over them)."""
    fused_edge_phase_win_dyn_bwd_plain.calls += 1
    bf16 = xwi.dtype == torch.bfloat16
    pre, covered, recv, delta, nrm = _edge_pre_dyn(level, xwi, xj, pos, wf8,
                                                   wfd, wfn, bf16)
    ws, bs = [w.float() for w in weights], [b.float() for b in biases]
    normed, inv, hs = mlp_tail_fwd_save(pre, ws, bs, bf16)
    ge = torch.where(covered[:, None], g.float().index_select(-2, recv), 0.0)
    if bf16:
        ge = round_bf16(ge)
    dpre, dw, db = mlp_tail_bwd(flat_rows(pre), [flat_rows(h) for h in hs],
                                flat_rows(normed), flat_rows(inv),
                                flat_rows(ge), ws, bf16)
    dpre = dpre.reshape(pre.shape)
    dpre_op = round_bf16(dpre) if bf16 else dpre
    dxj = torch.zeros(*xwi.shape[:-2], level.n_pad_nodes, BN,
                      dtype=torch.float32,
                      device=xwi.device).index_add_(-2, recv, dpre_op)
    dwf8 = dot(level.fiber_t, dpre, bf16)
    dwfd = dot(delta.transpose(-1, -2), dpre, bf16)
    dwfn = flat_rows(nrm[..., None] * dpre).sum(0)
    if dpre.dim() == 3:
        dwf8, dwfd = dwf8.sum(0), dwfd.sum(0)
    return dpre.to(xwi.dtype), dxj, dwf8, dwfd, dwfn, dw, db


fused_edge_phase_win_dyn_bwd_plain.calls = 0


def fused_edge_phase_win_dyn_bwd(level, xwi, xj, pos, wf8, wfd, wfn, weights,
                                 biases, g):
    """(dpre [..., E_pad, 128] in xwi's dtype, dxj [..., n_pad, 128] f32,
    dwf8 [8, 128], dwf_dyn [wd, 128], dwf_nrm [128], dW [L, 128, 128], db
    [L, 128]) for the aggregate's cotangent g [..., n_pad, 128] (a batch
    [B, ...] in one launch, the weight gradients summed over it), no
    autograd. CPU tensors take the plain version; CUDA tensors launch
    kernel 13's backward."""
    _check_dyn(level, xwi, xj, pos, wf8, wfd, wfn, weights, biases)
    if g.shape != xwi.shape:
        raise ValueError(f"g {tuple(g.shape)} != {tuple(xwi.shape)}")
    if xwi.device.type == "cpu":
        return fused_edge_phase_win_dyn_bwd_plain(level, xwi, xj, pos, wf8,
                                                  wfd, wfn, weights, biases, g)
    if xwi.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {xwi.device}")
    tr = walk_plan(BN, len(weights), "dyn", xwi.dtype)[1]
    wd = _kernel_wd(wfd)
    build.require("fused_edge_phase_win_dyn_bwd", xwi.device, level.send_win,
                  level.win_base, level.receivers, level.chunk_block,
                  level.win_row_ptr, level.win_row_slots, level.win_long)
    lib = build.library("fused_gmp_dyn_bwd", walk_sigs(_BWD_FN, 18, 12, 5))
    fn = _BWD_FN[xwi.dtype]
    dev, n_layers = xwi.device, len(weights)
    n_batch = xwi.shape[0] if xwi.dim() == 3 else 1
    n_tiles, grid = walk_grid(lib, fn, BN, n_layers, level, n_batch, tr)
    bf16 = xwi.dtype == torch.bfloat16
    w_stack = build.stacked(weights, to_bf16=bf16)
    wt_stack = build.stacked(weights, transpose=True, to_bf16=bf16)
    b_stack = build.stacked(biases)
    xwi, xj, pos = xwi.contiguous(), xj.contiguous(), pos.contiguous()
    wf8, wfd, wfn = (t.detach().float().contiguous() for t in (wf8, wfd, wfn))
    g = g.detach().float().contiguous()
    sizes = [n_layers * BN * BN, n_layers * BN, 8 * BN, wd * BN, BN]
    f32 = dict(dtype=torch.float32, device=dev)
    gpart = torch.empty(grid, sum(sizes), **f32)
    lead = xwi.shape[:-2]
    dpre = torch.empty(*lead, level.n_pad_edges, BN, dtype=xwi.dtype,
                       device=dev)
    dxj = torch.empty(*lead, level.n_pad_nodes, BN, **f32)
    grads = torch.empty(sum(sizes), **f32)
    err = getattr(lib, fn)(
        level.fiber_t.data_ptr(), xwi.data_ptr(), xj.data_ptr(),
        pos.data_ptr(), wf8.data_ptr(), wfd.data_ptr(), wfn.data_ptr(),
        w_stack.data_ptr(), b_stack.data_ptr(), wt_stack.data_ptr(),
        g.data_ptr(), level.send_win.data_ptr(), level.win_base.data_ptr(),
        level.receivers.data_ptr(), level.chunk_block.data_ptr(),
        level.win_row_ptr.data_ptr(), level.win_row_slots.data_ptr(),
        level.win_long.data_ptr(), BN, n_layers, wd, grid, n_tiles,
        level.n_pad_edges, level.edge_block, level.window, level.n_pad_nodes,
        level.win_long.numel(), GATHER_PIECE, n_batch, gpart.data_ptr(),
        dpre.data_ptr(), dxj.data_ptr(), grads.data_ptr(),
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
    """aggr [..., n_pad, 128] f32 of the in-window edges (xwi, xj [n_pad,
    128] or a batch [B, n_pad, 128]), differentiable in xwi, xj, wf8,
    wf_dyn, wf_nrm and every tail weight and bias. `pos` [..., n_pad, wd]
    are the world positions in xwi's dtype (no gradient reaches them);
    `wf8` rows [0, sfw) are the static-fiber rows of the first edge layer,
    row sfw its bias; `wfd` [wd, C] its Δworld rows and `wfn` [C] its
    ‖Δworld‖ row; `weights`/`biases` are the tail layers."""
    _check_dyn(level, xwi, xj, pos, wf8, wfd, wfn, weights, biases)
    return _DynEdgePhase.apply(level, len(weights), xwi, xj, pos.detach(),
                               wf8, wfd, wfn, *weights, *biases)
