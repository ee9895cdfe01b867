"""Kernels 4 and 5: the windowed fused GMP edge phase and its backward.

Kernel 4 replaces the TPU kernel `bsms_gnn_tpu/ops/pallas/fused_gmp.py::
fused_edge_phase_win` (v3 forward, `_get_fwd3` → `_make_fwd3_kernel`):

    aggr[n] = Σ_{in-window e: recv(e)=n}
              LN(tail(relu(fiber_t[:, e]ᵀ·wf8 + xwi[send_e] + xj[recv_e])))

with the sender row `win_base[chunk]·W/2 + send_win[e]`, read only when
`send_win[e] < W`. Out-of-window and pad slots (sentinel `send_win == W`)
still run the edge MLP but are masked from the scatter; the caller adds the
compact residual (`compact_resid.py`).

CUDA design (`csrc/fused_gmp.cu` over the chunk walk of
`csrc/edge_phase.cuh`, which kernels 11, 12 and 13 share): one thread block
per edge chunk walks the chunk in 64-edge tiles. Per tile it loads the selected sender rows and
receiver rows directly (no one-hot selection), runs the tail MLP and
LayerNorm in shared memory, and adds each edge into a shared-memory copy
of the chunk's 128-row output block, which it writes to a per-chunk part;
each column is owned by one thread and edges are added in slot order. A
second kernel adds the parts of each output block in chunk order (the
layout is receiver-block-sorted, so a block's chunks are one contiguous
range, `chunk_ptr`): the sum is deterministic, needs no atomics, and a
block with no chunk comes out zero. One block per output block would leave
the deep levels, whose few output blocks hold many chunks each (level 5 of
the 5k mesh: 24 chunks in 2 blocks), running on a handful of SMs.
What bounds it on the card: operations. Each slot costs
L·2·128·128 FLOP in the tail (≈ 4.1 GFLOP at the 5k mesh's level 0),
against a few MB of traffic; in f32 that runs on the CUDA cores (FMA, no
TF32). The tile GEMM stages 32-row slabs of each weight in shared memory
and gives every thread an 8×4 register tile. Level 0 of the 5k mesh has
82 chunks for 132 SMs. `wgmma` tiles for the GEMMs are later work.

Kernel 5 replaces the TPU kernel's backward (`_get_bwd3` →
`_make_bwd3_kernel`): given the aggregate's cotangent g [n_pad, C] f32 it
recomputes each chunk's forward (remat in the kernel) and returns

    dpre [E_pad, C]  the cotangent of each slot's first-layer
                     pre-activation (zero on masked slots, whose cotangent
                     is zero: their output never entered the aggregate)
    dxj  [n_pad, C]  Σ_{e: recv(e)=n} dpre_e
    dwf8 [8, C]      fiber_tᵀ-weighted sums of dpre
    dW [L, C, C], db [L, C]   the tail layers' weight and bias gradients

CUDA design (`csrc/fused_gmp_bwd.cu` over the chunk walk of
`csrc/edge_phase_bwd.cuh`, which kernels 11, 12 and 13 share): one thread
block per chunk, 64-slot
tiles as in kernel 4, keeping each layer's input, the LayerNorm output and
the running cotangent in shared memory; dxj takes kernel 4's per-chunk part
and chunk-ordered block sum. The TPU carries dW, db and dwf8 in scratch
across its sequential grid; on the card blocks run in no order, so each
chunk writes its own partial and a second pass sums the partials in chunk
order: every gradient is the same from run to run, with no atomics. What
bounds it: operations, about three times kernel 4's (the recompute, the
cotangent GEMMs and the weight-gradient GEMMs).

bf16 mode (xwi, xj in bf16) follows the TPU kernels: every dot's operands
are rounded to bf16 (fiber_t, wf8, the hidden activations, the weights,
and in the backward the edge cotangent g[recv], the running cotangent and
dpre) and accumulated in f32; the LN output is rounded to bf16 before the
f32 scatter sum, and dpre is stored in bf16.

`fused_edge_phase_win` is the differentiable entry: an autograd Function
whose forward launches kernel 4 and whose backward launches kernel 5 and
then kernel 7 (`windowed.py::windowed_send_sum`) on dpre for the sender
side, as `fused_gmp.py:942-967` does.
"""

from __future__ import annotations

from typing import Sequence

import torch

from bsms_gnn_tpu_torch.ops.kernels import build
from bsms_gnn_tpu_torch.ops.kernels.windowed import windowed_send_sum

BN = 128
LN_EPS = 1e-5
# Kernel 5 keeps one activation tile per tail layer in shared memory.
MAX_BWD_LAYERS = 3
_SIG = [build.P] * 11 + [build.I] * 6 + [build.P] * 3
_FN = {torch.float32: "fused_edge_phase_win_f32",
       torch.bfloat16: "fused_edge_phase_win_bf16"}
_BWD_SIG = [build.P] * 12 + [build.I] * 6 + [build.P] * 7
_BWD_FN = {torch.float32: "fused_edge_phase_win_bwd_f32",
           torch.bfloat16: "fused_edge_phase_win_bwd_bf16"}


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def dot(a: torch.Tensor, w: torch.Tensor, bf16: bool) -> torch.Tensor:
    """a @ w in f32; in bf16 mode both operands are rounded to bf16 first
    (bf16 operands, f32 accumulation)."""
    if bf16:
        return round_bf16(a) @ round_bf16(w)
    return a @ w


def mlp_tail_fwd_save(pre, weights: Sequence[torch.Tensor],
                      biases: Sequence[torch.Tensor], bf16: bool):
    """relu(pre) → hidden Linear+ReLU layers → final Linear → non-affine
    LayerNorm (1/sqrt, not rsqrt, as the kernels compute it), all f32.
    Returns (normed, inv, hs): the LN output, its 1/std, and each tail
    layer's input."""
    h = torch.relu(pre)
    hs = [h]
    for w, b in zip(weights[:-1], biases[:-1]):
        h = torch.relu(dot(h, w, bf16) + b)
        hs.append(h)
    out = dot(h, weights[-1], bf16) + biases[-1]
    mean = out.mean(dim=-1, keepdim=True)
    var = (out - mean).square().mean(dim=-1, keepdim=True)
    inv = 1.0 / torch.sqrt(var + LN_EPS)
    return (out - mean) * inv, inv, hs


def mlp_tail_plain(pre, weights, biases, bf16: bool) -> torch.Tensor:
    return mlp_tail_fwd_save(pre, weights, biases, bf16)[0]


def mlp_tail_bwd(pre, hs, normed, inv, g, weights, bf16: bool):
    """The transpose chain of `mlp_tail_fwd_save` for the output cotangent
    g: LN backward, the tail layers in reverse, then the leading ReLU.
    Returns (dpre, dW [L, C, C], db [L, C])."""
    dout = (g - g.mean(dim=-1, keepdim=True)
            - normed * (g * normed).mean(dim=-1, keepdim=True)) * inv
    n = len(weights)
    dws, dbs = [None] * n, [None] * n
    dws[-1], dbs[-1] = dot(hs[-1].t(), dout, bf16), dout.sum(0)
    dh = dot(dout, weights[-1].t(), bf16)
    for l in range(n - 2, -1, -1):
        dh = dh * (hs[l + 1] > 0)
        dws[l], dbs[l] = dot(hs[l].t(), dh, bf16), dh.sum(0)
        dh = dot(dh, weights[l].t(), bf16)
    return dh * (pre > 0), torch.stack(dws), torch.stack(dbs)


def _check(level, xwi, xj, wf8, weights, biases):
    if level.window <= 0:
        raise NotImplementedError("fused edge phase needs a windowed level")
    if xwi.dim() != 2:
        raise NotImplementedError("batch axis")
    n_pad, c = level.n_pad_nodes, xwi.shape[-1]
    if c != BN:
        raise NotImplementedError(f"latent width {c} (only 128)")
    if xwi.shape != (n_pad, c) or xj.shape != xwi.shape:
        raise ValueError(f"xwi/xj {tuple(xwi.shape)}/{tuple(xj.shape)} "
                         f"!= ({n_pad}, {c})")
    if xj.dtype != xwi.dtype or xwi.dtype not in _FN:
        raise ValueError(f"xwi/xj dtypes {xwi.dtype}/{xj.dtype}")
    if wf8.shape != (8, c) or any(w.shape != (c, c) for w in weights):
        raise ValueError("wf8 must be [8, C] and the tail weights [C, C]")
    if len(weights) != len(biases) or not weights:
        raise ValueError("tail weights and biases differ in count")


def sender_rows(level):
    """Each slot's sender row `win_base[chunk]·W/2 + send_win` (0 where the
    slot is out of window) and the in-window mask."""
    w = level.window
    sw = level.send_win.long()
    covered = sw < w
    base = level.win_base.long().repeat_interleave(level.edge_block)
    return torch.where(covered, base * (w // 2) + sw, 0), covered


def _edge_pre(level, xwi, xj, wf8, bf16):
    """Each slot's first-layer pre-activation fiber·wf8 + xwi[send] +
    xj[recv] (f32), the in-window mask and the receivers."""
    rows, covered = sender_rows(level)
    sel = torch.where(covered[:, None], xwi.float().index_select(0, rows), 0.0)
    recv = level.receivers.long()
    zj = xj.float().index_select(0, recv)
    fib = dot(level.fiber_t.t(), wf8.float(), bf16)
    return fib + sel + zj, covered, recv


def fused_edge_phase_win_plain(level, xwi, xj, wf8, weights, biases):
    """Kernel 4's function in plain PyTorch (index_select / matmul /
    index_add_)."""
    fused_edge_phase_win_plain.calls += 1
    return win_fwd_plain(level, xwi, xj, wf8, weights, biases)


fused_edge_phase_win_plain.calls = 0


def win_fwd_plain(level, xwi, xj, wf8, weights, biases):
    """The windowed edge phase's forward (kernels 4 and 14), uncounted."""
    bf16 = xwi.dtype == torch.bfloat16
    pre, covered, recv = _edge_pre(level, xwi, xj, wf8, bf16)
    e = mlp_tail_plain(pre, [x.float() for x in weights],
                       [x.float() for x in biases], bf16)
    if bf16:
        e = round_bf16(e)
    e = torch.where(covered[:, None], e, 0.0)
    out = torch.zeros(level.n_pad_nodes, xwi.shape[-1], dtype=torch.float32,
                      device=xwi.device)
    return out.index_add_(0, recv, e)


def fused_edge_phase_win_fwd(level, xwi, xj, wf8, weights, biases):
    """aggr [n_pad, 128] f32 of the in-window edges, no autograd. CPU
    tensors take the plain version; CUDA tensors launch kernel 4."""
    _check(level, xwi, xj, wf8, weights, biases)
    if xwi.device.type == "cpu":
        return fused_edge_phase_win_plain(level, xwi, xj, wf8, weights,
                                          biases)
    if xwi.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {xwi.device}")
    build.require("fused_edge_phase_win", xwi.device, level.send_win,
                  level.win_base, level.receivers, level.chunk_block,
                  level.chunk_ptr)
    lib = build.library("fused_gmp", {f: _SIG for f in _FN.values()})
    w_stack, b_stack = build.stacked(weights), build.stacked(biases)
    xwi, xj = xwi.contiguous(), xj.contiguous()
    wf8 = wf8.detach().float().contiguous()
    n_chunks = level.n_pad_edges // level.edge_block
    part = torch.empty(n_chunks, BN, BN, dtype=torch.float32,
                       device=xwi.device)
    out = torch.empty(level.n_pad_nodes, BN, dtype=torch.float32,
                      device=xwi.device)
    err = getattr(lib, _FN[xwi.dtype])(
        level.fiber_t.data_ptr(), xwi.data_ptr(), xj.data_ptr(),
        wf8.data_ptr(), w_stack.data_ptr(), b_stack.data_ptr(),
        level.send_win.data_ptr(), level.win_base.data_ptr(),
        level.receivers.data_ptr(), level.chunk_block.data_ptr(),
        level.chunk_ptr.data_ptr(), len(weights), n_chunks,
        level.n_pad_nodes // BN, level.n_pad_edges, level.edge_block,
        level.window, part.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(xwi.device).cuda_stream,
    )
    build.check(err, "fused_edge_phase_win")
    fused_edge_phase_win_fwd.launches += 1
    return out


fused_edge_phase_win_fwd.launches = 0


def fused_edge_phase_win_bwd_plain(level, xwi, xj, wf8, weights, biases, g):
    """Kernel 5's function in plain PyTorch."""
    fused_edge_phase_win_bwd_plain.calls += 1
    return win_bwd_plain(level, xwi, xj, wf8, weights, biases, g)


fused_edge_phase_win_bwd_plain.calls = 0


def win_bwd_plain(level, xwi, xj, wf8, weights, biases, g):
    """The windowed edge phase's backward (kernels 5 and 14), uncounted."""
    bf16 = xwi.dtype == torch.bfloat16
    pre, covered, recv = _edge_pre(level, xwi, xj, wf8, bf16)
    ws, bs = [w.float() for w in weights], [b.float() for b in biases]
    normed, inv, hs = mlp_tail_fwd_save(pre, ws, bs, bf16)
    ge = torch.where(covered[:, None], g.float().index_select(0, recv), 0.0)
    if bf16:
        ge = round_bf16(ge)
    dpre, dw, db = mlp_tail_bwd(pre, hs, normed, inv, ge, ws, bf16)
    dpre_op = round_bf16(dpre) if bf16 else dpre
    dxj = torch.zeros(level.n_pad_nodes, xwi.shape[-1], dtype=torch.float32,
                      device=xwi.device).index_add_(0, recv, dpre_op)
    dwf8 = dot(level.fiber_t, dpre, bf16)
    return dpre.to(xwi.dtype), dxj, dwf8, dw, db


def fused_edge_phase_win_bwd(level, xwi, xj, wf8, weights, biases, g):
    """(dpre [E_pad, 128] in xwi's dtype, dxj [n_pad, 128] f32, dwf8 [8,
    128], dW [L, 128, 128], db [L, 128]) for the aggregate's cotangent g,
    no autograd. CPU tensors take the plain version; CUDA tensors launch
    kernel 5."""
    _check(level, xwi, xj, wf8, weights, biases)
    if g.shape != (level.n_pad_nodes, BN):
        raise ValueError(f"g {tuple(g.shape)} != ({level.n_pad_nodes}, {BN})")
    if xwi.device.type == "cpu":
        return fused_edge_phase_win_bwd_plain(level, xwi, xj, wf8, weights,
                                              biases, g)
    if xwi.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {xwi.device}")
    if len(weights) > MAX_BWD_LAYERS:
        raise NotImplementedError(
            f"{len(weights)} tail layers (kernel 5 takes {MAX_BWD_LAYERS})")
    build.require("fused_edge_phase_win_bwd", xwi.device, level.send_win,
                  level.win_base, level.receivers, level.chunk_block,
                  level.chunk_ptr)
    lib = build.library("fused_gmp_bwd", {f: _BWD_SIG for f in _BWD_FN.values()})
    dev, n_layers = xwi.device, len(weights)
    w_stack, b_stack = build.stacked(weights), build.stacked(biases)
    wt_stack = build.stacked(weights, transpose=True)
    xwi, xj = xwi.contiguous(), xj.contiguous()
    wf8 = wf8.detach().float().contiguous()
    g = g.detach().float().contiguous()
    n_chunks = level.n_pad_edges // level.edge_block
    grad_size = n_layers * BN * BN + n_layers * BN + 8 * BN
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.empty(n_chunks, BN, BN, **f32)
    gpart = torch.empty(n_chunks, grad_size, **f32)
    dpre = torch.empty(level.n_pad_edges, BN, dtype=xwi.dtype, device=dev)
    dxj = torch.empty(level.n_pad_nodes, BN, **f32)
    grads = torch.empty(grad_size, **f32)
    err = getattr(lib, _BWD_FN[xwi.dtype])(
        level.fiber_t.data_ptr(), xwi.data_ptr(), xj.data_ptr(),
        wf8.data_ptr(), w_stack.data_ptr(), b_stack.data_ptr(),
        wt_stack.data_ptr(), g.data_ptr(), level.send_win.data_ptr(),
        level.win_base.data_ptr(), level.receivers.data_ptr(),
        level.chunk_block.data_ptr(), n_layers, n_chunks,
        level.n_pad_nodes // BN, level.n_pad_edges, level.edge_block,
        level.window, level.chunk_ptr.data_ptr(), part.data_ptr(),
        gpart.data_ptr(), dpre.data_ptr(), dxj.data_ptr(),
        grads.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "fused_edge_phase_win_bwd")
    fused_edge_phase_win_bwd.launches += 1
    dw, rest = grads.split([n_layers * BN * BN, grad_size - n_layers * BN * BN])
    db, dwf8 = rest.split([n_layers * BN, 8 * BN])
    return (dpre, dxj, dwf8.view(8, BN), dw.view(n_layers, BN, BN),
            db.view(n_layers, BN))


fused_edge_phase_win_bwd.launches = 0


class EdgePhase(torch.autograd.Function):
    """The windowed edge phase: `kernels` = (forward, backward), each
    called as forward(level, xwi, xj, wf8, weights, biases) and
    backward(..., g); kernel 7 on dpre then gives xwi's cotangent. Returns
    a gradient for every weight and bias."""

    @staticmethod
    def forward(ctx, level, kernels, n_layers, xwi, xj, wf8, *params):
        weights, biases = params[:n_layers], params[n_layers:]
        ctx.level, ctx.kernels, ctx.n_layers = level, kernels, n_layers
        ctx.save_for_backward(xwi, xj, wf8, *params)
        return kernels[0](level, xwi, xj, wf8, weights, biases)

    @staticmethod
    def backward(ctx, g):
        xwi, xj, wf8, *params = ctx.saved_tensors
        n = ctx.n_layers
        weights, biases = params[:n], params[n:]
        dpre, dxj, dwf8, dw, db = ctx.kernels[1](
            ctx.level, xwi, xj, wf8, weights, biases, g)
        dxwi = windowed_send_sum(ctx.level, dpre)
        return (None, None, None, dxwi.to(xwi.dtype), dxj.to(xj.dtype),
                dwf8.to(wf8.dtype),
                *(d.to(w.dtype) for d, w in zip(dw.unbind(0), weights)),
                *(d.to(b.dtype) for d, b in zip(db.unbind(0), biases)))


# Kernels 4 and 5, looked up at each call (so that a caller may swap in
# the plain versions).
_V3 = (lambda *a: fused_edge_phase_win_fwd(*a),
       lambda *a: fused_edge_phase_win_bwd(*a))


def fused_edge_phase_win(level, xwi, xj, wf8, weights, biases):
    """aggr [n_pad, 128] f32 of the in-window edges, differentiable in xwi,
    xj, wf8 and every tail weight and bias. `wf8` rows [0, pd1) are the
    static-fiber rows of the first edge layer, row pd1 its bias;
    `weights`/`biases` are the tail layers ([C, C] stored [in, out])."""
    _check(level, xwi, xj, wf8, weights, biases)
    return EdgePhase.apply(level, _V3, len(weights), xwi, xj, wf8, *weights,
                           *biases)
