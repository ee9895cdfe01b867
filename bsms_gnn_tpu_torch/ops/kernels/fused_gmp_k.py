"""Kernel 14: the K-way interleaved windowed fused GMP edge phase and its
backward, the `"fusedK"` aggregation method's kernel on its densest
levels.

Replaces the TPU kernels `bsms_gnn_tpu/ops/pallas/fused_gmp.py::
fused_edge_phase_win_k` (v5: `_get_fwd5` → `_make_fwd5_kernel`,
`_get_bwd5` → `_make_bwd5_kernel`). They compute kernel 4's and kernel
5's functions (`fused_gmp.py`):

    aggr[n] = Σ_{in-window e: recv(e)=n}
              LN(tail(relu(fiber_t[:, e]ᵀ·wf8 + xwi[send_e] + xj[recv_e])))

and, for the aggregate's cotangent g, dpre, dxj, dwf8, dW and db. On the
TPU, K chunks share each grid step (K streams of one sequential grid, so
that Mosaic can interleave K dot chains), each stream accumulates its own
output, and the K outputs are summed under visited-block masks. K changes
only the order of the sums.

CUDA design (`csrc/fused_gmp_k.cu`; the backward `csrc/fused_gmp_k_bwd.cu`
over kernel 5's chunk walk, `csrc/edge_phase_bwd.cuh`). The card needs no
interleaved streams (its warps interleave) and no masked combine (the
chunk-ordered block sum already adds each output block's shares, in a
fixed order). What carries over is "K chunks per step": a group of up to
S = min(K, 4) consecutive chunks of one output block is one unit of work.
- Forward: one block of 512 threads per group. Step j stacks tile j (64
  slots) of each chunk of the group into one [S·64, 128] tile and runs the
  tail MLP and the LayerNorm on it, 4·S rows per warp, so that each weight
  slab staged in shared memory serves S tiles; the rows are added, in
  stacked order, into the group's 128-row output block in shared memory
  (one thread per column and quarter of the rows), the group's part. At
  S = 4 the block holds 223 KB of shared memory (the output block 64 KB,
  the stacked tile 128 KB) of the 227 KB a block may have: K = 4 is the
  widest stack, and K > 4 runs as K = 4 (the same function).
- Backward: kernel 5 keeps every tail layer's input, the LayerNorm output
  and the cotangent of one 64-slot tile (128 KB at 3 tail layers) beside
  the dxj block (64 KB), so a block has no room for a second tile. The
  group is a thread block cluster of S blocks instead, one per chunk, each
  walking its chunk as kernel 5 does; then, through distributed shared
  memory, each block of the cluster sums its share of the group's dxj
  blocks and weight-gradient partials, in chunk order, into one part and
  one partial per group, so the final sum of the partials reads S times
  fewer.
- The block (cluster) of a chunk that does not start a group returns at
  once; the block sum (stride S) and the partials' sum read only the
  groups' first chunks, in chunk order. Deterministic, no atomics.
What bounds it on the card: operations, as kernels 4 and 5. The gated
levels hold far fewer chunks than the card has SMs (the 5k airfoil's
levels 3–5: 34, 30 and 24 chunks for 132 SMs), so the forward's S chunks
in one block trade SMs for weight-slab reuse and warps per SM; on the H100
that trade loses (PERF.md).

`fused_edge_phase_win_k` follows JAX's entry (`fused_gmp.py:1429-1460`)
gate by gate: K ≤ 1, or fewer than `min_density` chunks per 128-node
output block (`:1445`), takes kernel 4 (v3); a skip-empty layout (`:1453`)
returns None, and the caller takes v2 (kernel 12). Where JAX returns None
for a shape it refuses, the port raises, as kernel 4's wrapper does.

bf16 mode rounds where kernels 4 and 5 round (`fused_gmp.py`); the plain
versions are kernel 4's and 5's.
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.ops.kernels import build
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import (
    BN,
    MAX_BWD_LAYERS,
    EdgePhase,
    _check,
    fused_edge_phase_win,
    win_bwd_plain,
    win_fwd_plain,
)

# JAX's gate: v5 only where a level has at least this many edge chunks per
# 128-node output block (`fused_edge_phase_win_k`'s `min_density`).
MIN_DENSITY = 6
# The widest stack of chunk tiles one block takes (its shared memory).
MAX_STACK = 4
_SIG = [build.P] * 11 + [build.I] * 7 + [build.P] * 3
_FN = {torch.float32: "fused_edge_phase_win_k_f32",
       torch.bfloat16: "fused_edge_phase_win_k_bf16"}
_BWD_SIG = [build.P] * 13 + [build.I] * 7 + [build.P] * 6
_BWD_FN = {torch.float32: "fused_edge_phase_win_k_bwd_f32",
           torch.bfloat16: "fused_edge_phase_win_k_bwd_bf16"}


def passes_gate(level, min_density: int = MIN_DENSITY) -> bool:
    """JAX's density gate (`fused_gmp.py:1445`): at least `min_density`
    edge chunks per 128-node output block."""
    return (level.n_pad_edges // level.edge_block
            >= min_density * (level.n_pad_nodes // BN))


def stack_width(k: int) -> int:
    """The chunks one block of kernel 14 takes for the method's K."""
    if k < 2:
        raise ValueError(f"kernel 14 takes K >= 2, not {k}")
    return min(k, MAX_STACK)


def fused_edge_phase_win_k_plain(level, xwi, xj, wf8, weights, biases, k):
    """Kernel 14's function in plain PyTorch: kernel 4's (K orders only
    the kernel's sums)."""
    fused_edge_phase_win_k_plain.calls += 1
    return win_fwd_plain(level, xwi, xj, wf8, weights, biases)


fused_edge_phase_win_k_plain.calls = 0


def _level_tables(what, level, device):
    build.require(what, device, level.send_win, level.win_base,
                  level.receivers, level.chunk_block, level.chunk_ptr)


def fused_edge_phase_win_k_fwd(level, xwi, xj, wf8, weights, biases, k):
    """aggr [n_pad, 128] f32 of the in-window edges, no autograd. CPU
    tensors take the plain version; CUDA tensors launch kernel 14."""
    _check(level, xwi, xj, wf8, weights, biases)
    stack = stack_width(k)
    if xwi.device.type == "cpu":
        return fused_edge_phase_win_k_plain(level, xwi, xj, wf8, weights,
                                            biases, k)
    if xwi.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {xwi.device}")
    _level_tables("fused_edge_phase_win_k", level, xwi.device)
    lib = build.library("fused_gmp_k", {f: _SIG for f in _FN.values()})
    w_stack, b_stack = build.stacked(weights), build.stacked(biases)
    xwi, xj = xwi.contiguous(), xj.contiguous()
    wf8 = wf8.detach().float().contiguous()
    n_chunks = level.n_pad_edges // level.edge_block
    # One part per group, at its first chunk's index; the rest unwritten.
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
        level.window, stack, part.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(xwi.device).cuda_stream,
    )
    build.check(err, "fused_edge_phase_win_k")
    fused_edge_phase_win_k_fwd.launches += 1
    return out


fused_edge_phase_win_k_fwd.launches = 0


def fused_edge_phase_win_k_bwd_plain(level, xwi, xj, wf8, weights, biases,
                                     g, k):
    """Kernel 14's backward in plain PyTorch: kernel 5's function."""
    fused_edge_phase_win_k_bwd_plain.calls += 1
    return win_bwd_plain(level, xwi, xj, wf8, weights, biases, g)


fused_edge_phase_win_k_bwd_plain.calls = 0


def fused_edge_phase_win_k_bwd(level, xwi, xj, wf8, weights, biases, g, k):
    """(dpre [E_pad, 128] in xwi's dtype, dxj [n_pad, 128] f32, dwf8 [8,
    128], dW [L, 128, 128], db [L, 128]) for the aggregate's cotangent g,
    no autograd. CPU tensors take the plain version; CUDA tensors launch
    kernel 14's backward."""
    _check(level, xwi, xj, wf8, weights, biases)
    stack = stack_width(k)
    if g.shape != (level.n_pad_nodes, BN):
        raise ValueError(f"g {tuple(g.shape)} != ({level.n_pad_nodes}, {BN})")
    if xwi.device.type == "cpu":
        return fused_edge_phase_win_k_bwd_plain(level, xwi, xj, wf8, weights,
                                                biases, g, k)
    if xwi.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {xwi.device}")
    if len(weights) > MAX_BWD_LAYERS:
        raise NotImplementedError(
            f"{len(weights)} tail layers (kernel 14's backward takes "
            f"{MAX_BWD_LAYERS})")
    _level_tables("fused_edge_phase_win_k_bwd", level, xwi.device)
    lib = build.library("fused_gmp_k_bwd",
                        {f: _BWD_SIG for f in _BWD_FN.values()})
    dev, n_layers = xwi.device, len(weights)
    w_stack, b_stack = build.stacked(weights), build.stacked(biases)
    wt_stack = build.stacked(weights, transpose=True)
    xwi, xj = xwi.contiguous(), xj.contiguous()
    wf8 = wf8.detach().float().contiguous()
    g = g.detach().float().contiguous()
    n_chunks = level.n_pad_edges // level.edge_block
    grad_size = n_layers * BN * BN + n_layers * BN + 8 * BN
    f32 = dict(dtype=torch.float32, device=dev)
    # One dxj part per group, at its first chunk's index; a partial per
    # chunk, summed into its group's first.
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
        level.chunk_block.data_ptr(), level.chunk_ptr.data_ptr(), n_layers,
        n_chunks, level.n_pad_nodes // BN, level.n_pad_edges,
        level.edge_block, level.window, stack, part.data_ptr(),
        gpart.data_ptr(), dpre.data_ptr(), dxj.data_ptr(), grads.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "fused_edge_phase_win_k_bwd")
    fused_edge_phase_win_k_bwd.launches += 1
    dw, rest = grads.split([n_layers * BN * BN, grad_size - n_layers * BN * BN])
    db, dwf8 = rest.split([n_layers * BN, 8 * BN])
    return (dpre, dxj, dwf8.view(8, BN), dw.view(n_layers, BN, BN),
            db.view(n_layers, BN))


fused_edge_phase_win_k_bwd.launches = 0


def fused_edge_phase_win_k(level, xwi, xj, wf8, weights, biases, k,
                           min_density: int = MIN_DENSITY):
    """`fused_edge_phase_win`'s contract (aggr [n_pad, 128] f32 of the
    in-window edges, differentiable in xwi, xj, wf8 and every tail weight
    and bias) on the `"fusedK"` method: kernel 14 forward, its backward and
    kernel 7 backward on a level with at least `min_density` chunks per
    128-node output block, kernel 4 (v3) on the others and for K ≤ 1, and
    None on a skip-empty layout (the caller takes v2)."""
    if k <= 1 or not passes_gate(level, min_density):
        return fused_edge_phase_win(level, xwi, xj, wf8, weights, biases)
    if level.skip_empty:
        return None
    _check(level, xwi, xj, wf8, weights, biases)
    # Kernel 14 and its backward, looked up at each call (so that a caller
    # may swap in the plain versions).
    kernels = (lambda *a: fused_edge_phase_win_k_fwd(*a, k),
               lambda *a: fused_edge_phase_win_k_bwd(*a, k))
    return EdgePhase.apply(level, kernels, len(weights), xwi, xj, wf8,
                           *weights, *biases)
