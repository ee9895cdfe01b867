"""Kernel 4: the windowed fused GMP edge phase.

Replaces the TPU kernel `bsms_gnn_tpu/ops/pallas/fused_gmp.py::
fused_edge_phase_win` (v3 forward, `_get_fwd3` → `_make_fwd3_kernel`):

    aggr[n] = Σ_{in-window e: recv(e)=n}
              LN(tail(relu(fiber_t[:, e]ᵀ·wf8 + xwi[send_e] + xj[recv_e])))

with the sender row `win_base[chunk]·W/2 + send_win[e]`, read only when
`send_win[e] < W`. Out-of-window and pad slots (sentinel `send_win == W`)
still run the edge MLP but are masked from the scatter; the caller adds the
compact residual (`compact_resid.py`).

CUDA design (`csrc/fused_gmp.cu`): one thread block per edge chunk walks
the chunk in 64-edge tiles. Per tile it loads the selected sender rows and
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

bf16 mode (xwi, xj in bf16) follows the TPU kernel: every dot's operands
are rounded to bf16 (fiber_t, wf8, the hidden activations, the weights)
and accumulated in f32; the LN output is rounded to bf16 before the f32
scatter sum.
"""

from __future__ import annotations

from typing import Sequence

import torch

from bsms_gnn_tpu_torch.ops.kernels import build

BN = 128
LN_EPS = 1e-5
_SIG = [build.P] * 11 + [build.I] * 6 + [build.P] * 3
_FN = {torch.float32: "fused_edge_phase_win_f32",
       torch.bfloat16: "fused_edge_phase_win_bf16"}


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def dot(a: torch.Tensor, w: torch.Tensor, bf16: bool) -> torch.Tensor:
    """a @ w in f32; in bf16 mode both operands are rounded to bf16 first
    (bf16 operands, f32 accumulation)."""
    if bf16:
        return round_bf16(a) @ round_bf16(w)
    return a @ w


def layer_norm_kernel(x: torch.Tensor) -> torch.Tensor:
    """Non-affine LayerNorm as the kernels compute it: 1/sqrt, not rsqrt."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * (1.0 / torch.sqrt(var + LN_EPS))


def mlp_tail_plain(pre: torch.Tensor, weights: Sequence[torch.Tensor],
                   biases: Sequence[torch.Tensor], bf16: bool) -> torch.Tensor:
    """relu(pre) → hidden Linear+ReLU layers → final Linear → LN, all f32."""
    h = torch.relu(pre)
    for w, b in zip(weights[:-1], biases[:-1]):
        h = torch.relu(dot(h, w, bf16) + b)
    return layer_norm_kernel(dot(h, weights[-1], bf16) + biases[-1])


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


def fused_edge_phase_win_plain(level, xwi, xj, wf8, weights, biases):
    """The same function in plain PyTorch (index_select / matmul /
    index_add_)."""
    bf16 = xwi.dtype == torch.bfloat16
    w = level.window
    sw = level.send_win.long()
    covered = sw < w
    base = level.win_base.long().repeat_interleave(level.edge_block)
    rows = torch.where(covered, base * (w // 2) + sw, 0)
    sel = torch.where(covered[:, None], xwi.float().index_select(0, rows), 0.0)
    recv = level.receivers.long()
    zj = xj.float().index_select(0, recv)
    fib = dot(level.fiber_t.t(), wf8.float(), bf16)
    e = mlp_tail_plain(fib + sel + zj, [x.float() for x in weights],
                       [x.float() for x in biases], bf16)
    if bf16:
        e = round_bf16(e)
    e = torch.where(covered[:, None], e, 0.0)
    out = torch.zeros(level.n_pad_nodes, xwi.shape[-1], dtype=torch.float32,
                      device=xwi.device)
    return out.index_add_(0, recv, e)


def fused_edge_phase_win(level, xwi, xj, wf8, weights, biases):
    """aggr [n_pad, 128] f32 of the in-window edges. `wf8` rows [0, pd1)
    are the static-fiber rows of the first edge layer, row pd1 its bias;
    `weights`/`biases` are the tail layers ([C, C] stored [in, out]). CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    _check(level, xwi, xj, wf8, weights, biases)
    build.forward_only("fused_edge_phase_win", xwi, xj, wf8, *weights,
                       *biases)
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
    wf8 = wf8.float().contiguous()
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
    fused_edge_phase_win.launches += 1
    return out


fused_edge_phase_win.launches = 0
