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

CUDA design. The card needs no interleaved streams (its warps interleave)
and no masked combine: every sum runs in an order fixed by the layout, and
K orders nothing. Both directions run kernel 4's and kernel 5's tile walks
under kernel 14's own names (so the profiler tells them apart): a
persistent grid of G blocks (`walk_grid`: the SMs times the blocks per SM
the kernel reaches, at most the level's tiles) over the level's 64-slot
tiles (block b the tiles b, b + G, ... forward, the range
`tile_ranges(T, G)[b] .. [b + 1]` backward), so the gated levels' few
chunks (the 5k airfoil's levels 3–5: 34, 30 and 24 chunks of 512 slots,
272, 240 and 192 tiles, for 132 SMs) spread over every SM.
- Forward (`csrc/fused_gmp_k.cu` over `csrc/edge_fwd_tiles.cuh`, two
  blocks per SM): dead tiles skipped, each live slot's message stored into
  a transient `msg [E_pad, 128]`, then the receiver gather
  (`recv_gather_kernel` over `win_row_*`, which list exactly those slots)
  sums the aggregate in list order. A step that stacked K tiles on 512
  threads, so that each staged weight slab served them all, read slower
  on an H100 at the 5k airfoil's gated levels (one block per SM;
  PERF.md).
- Backward (`csrc/fused_gmp_k_bwd.cu` over `csrc/edge_bwd_tiles.cuh`, one
  block per SM): a tile with no live slot writes zero dpre rows; a live
  tile recomputes the forward and runs the LayerNorm backward and the tail
  in reverse, and each block adds its tiles into its own weight-gradient
  partial [dW | db | dwf8] (`gpart [G, grad_size]`, freed after the call);
  then `recv_gather_kernel` sums dxj from dpre over the same receiver
  lists and `grad_sum_kernel` sums the G partials in block order. In bf16
  mode the tail stacks W and Wᵀ come already rounded
  (`build.stacked(..., to_bf16=True)`). Deterministic, no atomics.
What bounds it on the card: operations, as kernels 4 and 5.

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

from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import (
    BN,
    MAX_BWD_LAYERS,
    EdgePhase,
    _check,
    fused_edge_phase_win,
    win_bwd_launch,
    win_bwd_plain,
    win_fwd_launch,
    win_fwd_plain,
)

# JAX's gate: v5 only where a level has at least this many edge chunks per
# 128-node output block (`fused_edge_phase_win_k`'s `min_density`).
MIN_DENSITY = 6
_FN = {torch.float32: "fused_edge_phase_win_k_f32",
       torch.bfloat16: "fused_edge_phase_win_k_bf16"}
_BWD_FN = {torch.float32: "fused_edge_phase_win_k_bwd_f32",
           torch.bfloat16: "fused_edge_phase_win_k_bwd_bf16"}


def passes_gate(level, min_density: int = MIN_DENSITY) -> bool:
    """JAX's density gate (`fused_gmp.py:1445`): at least `min_density`
    edge chunks per 128-node output block."""
    return (level.n_pad_edges // level.edge_block
            >= min_density * (level.n_pad_nodes // BN))


def _check_k(k: int) -> None:
    if k < 2:
        raise ValueError(f"kernel 14 takes K >= 2, not {k}")


def fused_edge_phase_win_k_plain(level, xwi, xj, wf8, weights, biases, k):
    """Kernel 14's function in plain PyTorch: kernel 4's (K orders only
    the kernel's sums)."""
    fused_edge_phase_win_k_plain.calls += 1
    return win_fwd_plain(level, xwi, xj, wf8, weights, biases)


fused_edge_phase_win_k_plain.calls = 0


def fused_edge_phase_win_k_fwd(level, xwi, xj, wf8, weights, biases, k):
    """aggr [n_pad, 128] f32 of the in-window edges, no autograd. CPU
    tensors take the plain version; CUDA tensors launch kernel 14."""
    _check(level, xwi, xj, wf8, weights, biases)
    _check_k(k)
    if xwi.device.type == "cpu":
        return fused_edge_phase_win_k_plain(level, xwi, xj, wf8, weights,
                                            biases, k)
    if xwi.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {xwi.device}")
    out = win_fwd_launch("fused_edge_phase_win_k", "fused_gmp_k", _FN, level,
                         xwi, xj, wf8, weights, biases)
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
    _check_k(k)
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
    out = win_bwd_launch("fused_edge_phase_win_k_bwd", "fused_gmp_k_bwd",
                         _BWD_FN, level, xwi, xj, wf8, weights, biases, g)
    fused_edge_phase_win_k_bwd.launches += 1
    return out


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
