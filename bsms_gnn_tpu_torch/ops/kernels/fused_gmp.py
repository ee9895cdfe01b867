"""Kernels 4 and 5: the windowed fused GMP edge phase and its backward.

Kernel 4 replaces the TPU kernel `bsms_gnn_tpu/ops/pallas/fused_gmp.py::
fused_edge_phase_win` (v3 forward, `_get_fwd3` → `_make_fwd3_kernel`):

    aggr[n] = Σ_{in-window e: recv(e)=n}
              LN(tail(relu(fiber_t[:, e]ᵀ·wf8 + xwi[send_e] + xj[recv_e])))

with the sender row `win_base[chunk]·W/2 + send_win[e]`, read only when
`send_win[e] < W`. Out-of-window and pad slots (sentinel `send_win == W`)
still run the edge MLP but are masked from the scatter; the caller adds the
compact residual (`compact_resid.py`).

CUDA design (`csrc/fused_gmp.cu` over the forward tile walk of
`csrc/edge_fwd_tiles.cuh`, which kernels 13 and 14 share). What bounds it
on the card: operations. Each
live slot costs L·2·128·128 FLOP in the tail (≈ 4.1 GFLOP at the 5k
mesh's level 0), against a few MB of traffic; in f32 that runs on the CUDA
cores (FMA, no TF32). The walk has the backward walk's grid plan (kernel 5
below): G blocks (SMs × the blocks per SM the kernel reaches, `walk_fill`,
at most the level's tiles) walk the level's 64-slot tiles, block b the
tiles b, b + G, b + 2G, ... (an SM's blocks then hold ⌊T/SMs⌋ or ⌈T/SMs⌉
tiles), so a level of few chunks (the 5k airfoil's levels hold 82 down to
one 512-slot chunk) still fills the card. A tile with no live slot (an in-window sender whose receiver
lies in the chunk's 128-row block) skips the front and the GEMMs and
writes nothing. A live tile loads its selected sender and receiver rows
directly (no one-hot selection), runs the tail MLP in place with the
weights' 64-row slabs double-buffered by cp.async, then the LayerNorm,
and stores each live slot's message row into `msg [E_pad, 128]` (in
xwi's dtype: the LN output, rounded to bf16 in bf16 mode where the TPU
kernel rounds it before its f32 sum). A second launch, the row-ordered
gather of `csrc/row_gather.cuh` (`recv_gather_kernel`, kernel 5's dxj
gather), sums each receiver row's messages over `win_row_ptr`,
`win_row_slots`, `win_long`, which list exactly the live slots, in list
order: no shared-memory output block, no per-chunk part, no chunk sum, no
atomics; two calls agree bit for bit, and a row with no slot comes out
zero. `msg` is transient: 21.5 MB in f32 at the 5k airfoil's level 0
(10.7 in bf16). `wgmma` tiles for the GEMMs are later work.

Kernel 5 replaces the TPU kernel's backward (`_get_bwd3` →
`_make_bwd3_kernel`): given the aggregate's cotangent g [n_pad, C] f32 it
recomputes each chunk's forward (remat in the kernel) and returns

    dpre [E_pad, C]  the cotangent of each slot's first-layer
                     pre-activation (zero on masked slots, whose cotangent
                     is zero: their output never entered the aggregate)
    dxj  [n_pad, C]  Σ_{e: recv(e)=n} dpre_e
    dwf8 [8, C]      fiber_tᵀ-weighted sums of dpre
    dW [L, C, C], db [L, C]   the tail layers' weight and bias gradients

CUDA design (`csrc/fused_gmp_bwd.cu` over the tile walk of
`csrc/edge_bwd_tiles.cuh`, which the backwards of kernels 11-14 share).
What bounds it: operations, about three times kernel 4's (the recompute,
the cotangent GEMMs and the weight-gradient GEMMs), in true f32 on the
CUDA cores. A
persistent grid of G blocks (the SM count times the blocks per SM the
kernel reaches, `walk_fill`, at most the level's tiles) walks the level's
64-slot tiles, block b the contiguous range `tile_ranges(T, G)[b] ..
[b + 1]` in order, so a level of few chunks still fills the card (the
5k airfoil's levels hold 82 down to one 512-slot chunk). Each
tile finds its chunk's block and window from its first slot; a tile with
no live slot (an in-window sender whose receiver lies in the chunk's
block) writes zero dpre rows and skips the walk. A live tile keeps each
layer's input, the LayerNorm output and the running cotangent in shared
memory, the tail weights' 64-row slabs double-buffered by cp.async (the
next GEMM's first slab loading during the current one's last). The TPU
carries dW, db and dwf8 in scratch across its sequential grid; here each
block adds its tiles into its own partial and `grad_sum_kernel` (also
kernel 6's and 11-14's backwards') sums the G partials in block order:
every gradient is the same from run to run, with no atomics, and the
partials (G × 201 KB) stay in L2. dxj is not summed in the walk: a launch
between the two, the row-ordered gather of `csrc/row_gather.cuh`
(`recv_gather_kernel`), sums dpre over each receiver row's live slots
(`win_row_ptr`, `win_row_slots`, `win_long`, kernel 1's lists), which are
exactly the slots the walk gives a cotangent. In bf16 mode the wrapper
passes the tail weights already rounded to bf16 (`build.stacked(...,
to_bf16=True)`), so the slab copies round nothing.

bf16 mode (xwi, xj in bf16) follows the TPU kernels: every dot's operands
are rounded to bf16 (fiber_t, wf8, the hidden activations, the weights,
and in the backward the edge cotangent g[recv], the running cotangent and
dpre) and accumulated in f32; the LN output is rounded to bf16 before the
f32 scatter sum, and dpre is stored in bf16.

The batch axis (a shared mesh: xwi, xj [B, n_pad, 128]): one launch of
kernel 4 walks the B·T tiles of the batch in the same stride order (tile
t is tile t mod T of sample ⌊t / T⌋, the grid still the card's fill), with
`msg [B, E_pad, 128]` (1.0 GB in f32 at B = 48 on the 5k airfoil's level
0) and one gather whose grid's y index is the sample; one launch of kernel
5 walks the B·T tiles in its ranges, still G partials (each block sums
every sample's tiles of its range into its own), dpre [B, E_pad, 128], dxj
by the batched gather. Every per-row output of sample b is the bits of a
call on sample b alone; the weight gradients sum over the batch. Kernels
13 and 14, which share the walks, take B = 1.

`fused_edge_phase_win` is the differentiable entry: an autograd Function
whose forward launches kernel 4 and whose backward launches kernel 5 and
then kernel 7 (`windowed.py::windowed_send_sum`) on dpre for the sender
side, as `fused_gmp.py:942-967` does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import torch

from bsms_gnn_tpu_torch.graph.hierarchy import GATHER_PIECE
from bsms_gnn_tpu_torch.ops.kernels import build
from bsms_gnn_tpu_torch.ops.kernels.windowed import windowed_send_sum

BN = 128
LN_EPS = 1e-5
# Kernel 5 keeps one activation tile per tail layer in shared memory.
MAX_BWD_LAYERS = 3
_FN = {torch.float32: "fused_edge_phase_win_f32",
       torch.bfloat16: "fused_edge_phase_win_bf16"}
_BWD_FN = {torch.float32: "fused_edge_phase_win_bwd_f32",
           torch.bfloat16: "fused_edge_phase_win_bwd_bf16"}
# Slots per tile of the tile walk (`csrc/edge_bwd_tiles.cuh`'s TR, held to
# this value by a static_assert there).
TILE_ROWS = 64


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


def _check(level, xwi, xj, wf8, weights, biases, batched=False):
    """Raise on what the windowed edge kernels do not take; `batched`:
    the function takes a batch axis (kernels 4 and 5; 13 and 14 do not)."""
    if level.window <= 0:
        raise NotImplementedError("fused edge phase needs a windowed level")
    build.check_batch(xwi, batched)
    n_pad, c = level.n_pad_nodes, xwi.shape[-1]
    if c != BN:
        raise NotImplementedError(f"latent width {c} (only 128)")
    if xwi.shape[-2:] != (n_pad, c) or xj.shape != xwi.shape:
        raise ValueError(f"xwi/xj {tuple(xwi.shape)}/{tuple(xj.shape)} "
                         f"!= (..., {n_pad}, {c})")
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
    xj[recv] (f32, on xwi's leading dims), the in-window mask and the
    receivers."""
    rows, covered = sender_rows(level)
    sel = torch.where(covered[:, None], xwi.float().index_select(-2, rows),
                      0.0)
    recv = level.receivers.long()
    zj = xj.float().index_select(-2, recv)
    fib = dot(level.fiber_t.t(), wf8.float(), bf16)
    return fib + sel + zj, covered, recv


def fused_edge_phase_win_plain(level, xwi, xj, wf8, weights, biases):
    """Kernel 4's function in plain PyTorch (index_select / matmul /
    index_add_), on any leading dims."""
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
    out = torch.zeros(*xwi.shape[:-2], level.n_pad_nodes, xwi.shape[-1],
                      dtype=torch.float32, device=xwi.device)
    return out.index_add_(-2, recv, e)


def fused_edge_phase_win_fwd(level, xwi, xj, wf8, weights, biases):
    """aggr [..., n_pad, 128] f32 of the in-window edges (xwi, xj [n_pad,
    128] or a batch [B, n_pad, 128], one launch), no autograd. CPU tensors
    take the plain version; CUDA tensors launch kernel 4."""
    _check(level, xwi, xj, wf8, weights, biases, batched=True)
    if xwi.device.type == "cpu":
        return fused_edge_phase_win_plain(level, xwi, xj, wf8, weights,
                                          biases)
    if xwi.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {xwi.device}")
    out = win_fwd_launch("fused_edge_phase_win", "fused_gmp", _FN, level,
                         xwi, xj, wf8, weights, biases)
    fused_edge_phase_win_fwd.launches += 1
    return out


def walk_sigs(fns: Dict[torch.dtype, str], n_in: int, n_int: int,
              n_out: int) -> Dict[str, list]:
    """The C signatures of a tile walk's library: each function of `fns`
    takes n_in pointers, n_int ints and n_out pointers (the stream last);
    its `_blocks_per_sm` (n_layers, int*)."""
    return {**{f: [build.P] * n_in + [build.I] * n_int + [build.P] * n_out
               for f in fns.values()},
            **{f + "_blocks_per_sm": [build.I, build.P]
               for f in fns.values()}}


def win_fwd_launch(what, lib_name, fns, level, xwi, xj, wf8, weights,
                   biases):
    """aggr [..., n_pad, 128] f32 by the windowed forward tile walk of
    `csrc/<lib_name>.cu` (kernel 4's, or kernel 14's under its own names;
    `fns`: dtype → C function) on CUDA tensors, for the batch xwi's
    leading dim gives (kernel 14's entries take one sample only)."""
    build.require(what, xwi.device, level.send_win, level.win_base,
                  level.receivers, level.chunk_block, level.win_row_ptr,
                  level.win_row_slots, level.win_long)
    lib = build.library(lib_name, walk_sigs(fns, 13, 10, 3))
    fn, dev = fns[xwi.dtype], xwi.device
    n_batch = xwi.shape[0] if xwi.dim() == 3 else 1
    n_tiles, grid = walk_grid(lib, fn, len(weights), level, n_batch)
    bf16 = xwi.dtype == torch.bfloat16
    w_stack = build.stacked(weights, to_bf16=bf16)
    b_stack = build.stacked(biases)
    xwi, xj = xwi.contiguous(), xj.contiguous()
    wf8 = wf8.detach().float().contiguous()
    lead = xwi.shape[:-2]
    msg = torch.empty(*lead, level.n_pad_edges, BN, dtype=xwi.dtype,
                      device=dev)
    out = torch.empty(*lead, level.n_pad_nodes, BN, dtype=torch.float32,
                      device=dev)
    err = getattr(lib, fn)(
        level.fiber_t.data_ptr(), xwi.data_ptr(), xj.data_ptr(),
        wf8.data_ptr(), w_stack.data_ptr(), b_stack.data_ptr(),
        level.send_win.data_ptr(), level.win_base.data_ptr(),
        level.receivers.data_ptr(), level.chunk_block.data_ptr(),
        level.win_row_ptr.data_ptr(), level.win_row_slots.data_ptr(),
        level.win_long.data_ptr(), len(weights), grid, n_tiles,
        level.n_pad_edges, level.edge_block, level.window, level.n_pad_nodes,
        level.win_long.numel(), GATHER_PIECE, n_batch, msg.data_ptr(),
        out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, what)
    return out


fused_edge_phase_win_fwd.launches = 0


@functools.lru_cache(maxsize=4096)
def tile_ranges(n_tiles: int, grid: int) -> Tuple[int, ...]:
    """The bounds of the tile walk's ranges (`csrc/edge_bwd_tiles.cuh`):
    G = min(grid, n_tiles) blocks (at least one), block b walking tiles
    bounds[b] .. bounds[b + 1] = ⌊b·T/G⌋ .. ⌊(b+1)·T/G⌋, as the kernel
    computes them. The wrapper's grid is len(bounds) − 1."""
    g = max(1, min(grid, n_tiles))
    return tuple(b * n_tiles // g for b in range(g + 1))


_walks: Dict[tuple, int] = {}


def walk_fill(lib, fn: str, n_layers: int, device) -> int:
    """The blocks that fill the card (blocks per SM × SMs) with the tile
    walk of `fn` in `lib` at n_layers tail layers, asked of the card once
    per device. Depends only on the card and the kernel."""
    key = (fn, n_layers, device)
    hit = _walks.get(key)
    if hit is None:
        per_sm = ctypes.c_int()
        with torch.cuda.device(device):
            build.check(getattr(lib, fn + "_blocks_per_sm")(
                n_layers, ctypes.addressof(per_sm)), fn)
        if per_sm.value < 1:
            raise RuntimeError(f"{fn}: the tile walk fits no block on an SM")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        hit = _walks[key] = per_sm.value * sms
    return hit


def walk_grid(lib, fn: str, n_layers: int, level,
              n_batch: int = 1) -> Tuple[int, int]:
    """(tiles of one sample, blocks) of one launch of the tile walk over
    `level` for a batch of n_batch samples (B·T tiles in all)."""
    fill = walk_fill(lib, fn, n_layers, level.receivers.device)
    if level.edge_block % TILE_ROWS:
        raise NotImplementedError(
            f"edge_block {level.edge_block} is not a multiple of the walk's "
            f"{TILE_ROWS}-slot tiles")
    n_tiles = level.n_pad_edges // TILE_ROWS
    return n_tiles, len(tile_ranges(n_tiles * n_batch, fill)) - 1


def fused_edge_phase_win_bwd_plain(level, xwi, xj, wf8, weights, biases, g):
    """Kernel 5's function in plain PyTorch, on any leading dims (the
    weight gradients summed over them)."""
    fused_edge_phase_win_bwd_plain.calls += 1
    return win_bwd_plain(level, xwi, xj, wf8, weights, biases, g)


fused_edge_phase_win_bwd_plain.calls = 0


def win_bwd_plain(level, xwi, xj, wf8, weights, biases, g):
    """The windowed edge phase's backward (kernels 5 and 14), uncounted."""
    bf16 = xwi.dtype == torch.bfloat16
    pre, covered, recv = _edge_pre(level, xwi, xj, wf8, bf16)
    ws, bs = [w.float() for w in weights], [b.float() for b in biases]
    normed, inv, hs = mlp_tail_fwd_save(pre, ws, bs, bf16)
    ge = torch.where(covered[:, None], g.float().index_select(-2, recv), 0.0)
    if bf16:
        ge = round_bf16(ge)
    c = xwi.shape[-1]

    def rows(t):  # the leading dims' slots as one row axis
        return t.reshape(-1, t.shape[-1])

    dpre, dw, db = mlp_tail_bwd(rows(pre), [rows(h) for h in hs],
                                rows(normed), rows(inv), rows(ge), ws, bf16)
    dpre = dpre.reshape(pre.shape)
    dpre_op = round_bf16(dpre) if bf16 else dpre
    dxj = torch.zeros(*xwi.shape[:-2], level.n_pad_nodes, c,
                      dtype=torch.float32,
                      device=xwi.device).index_add_(-2, recv, dpre_op)
    dwf8 = dot(level.fiber_t, dpre, bf16)
    if dwf8.dim() == 3:
        dwf8 = dwf8.sum(0)
    return dpre.to(xwi.dtype), dxj, dwf8, dw, db


def fused_edge_phase_win_bwd(level, xwi, xj, wf8, weights, biases, g):
    """(dpre [..., E_pad, 128] in xwi's dtype, dxj [..., n_pad, 128] f32,
    dwf8 [8, 128], dW [L, 128, 128], db [L, 128]) for the aggregate's
    cotangent g [..., n_pad, 128] (a batch [B, ...] in one launch, the
    weight gradients summed over it), no autograd. CPU tensors take the
    plain version; CUDA tensors launch kernel 5."""
    _check(level, xwi, xj, wf8, weights, biases, batched=True)
    if g.shape != xwi.shape:
        raise ValueError(f"g {tuple(g.shape)} != {tuple(xwi.shape)}")
    if xwi.device.type == "cpu":
        return fused_edge_phase_win_bwd_plain(level, xwi, xj, wf8, weights,
                                              biases, g)
    if xwi.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {xwi.device}")
    if len(weights) > MAX_BWD_LAYERS:
        raise NotImplementedError(
            f"{len(weights)} tail layers (kernel 5 takes {MAX_BWD_LAYERS})")
    out = win_bwd_launch("fused_edge_phase_win_bwd", "fused_gmp_bwd",
                         _BWD_FN, level, xwi, xj, wf8, weights, biases, g)
    fused_edge_phase_win_bwd.launches += 1
    return out


def win_bwd_launch(what, lib_name, fns, level, xwi, xj, wf8, weights,
                   biases, g):
    """(dpre, dxj, dwf8, dW, db) by the windowed backward tile walk of
    `csrc/<lib_name>.cu` (kernel 5's, or kernel 14's under its own names;
    `fns`: dtype → C function) on CUDA tensors, for the batch xwi's
    leading dim gives (kernel 14's entries take one sample only)."""
    build.require(what, xwi.device, level.send_win, level.win_base,
                  level.receivers, level.chunk_block, level.win_row_ptr,
                  level.win_row_slots, level.win_long)
    lib = build.library(lib_name, walk_sigs(fns, 15, 10, 5))
    fn = fns[xwi.dtype]
    dev, n_layers = xwi.device, len(weights)
    n_batch = xwi.shape[0] if xwi.dim() == 3 else 1
    n_tiles, grid = walk_grid(lib, fn, n_layers, level, n_batch)
    bf16 = xwi.dtype == torch.bfloat16
    w_stack = build.stacked(weights, to_bf16=bf16)
    wt_stack = build.stacked(weights, transpose=True, to_bf16=bf16)
    b_stack = build.stacked(biases)
    xwi, xj = xwi.contiguous(), xj.contiguous()
    wf8 = wf8.detach().float().contiguous()
    g = g.detach().float().contiguous()
    grad_size = n_layers * BN * BN + n_layers * BN + 8 * BN
    f32 = dict(dtype=torch.float32, device=dev)
    gpart = torch.empty(grid, grad_size, **f32)
    lead = xwi.shape[:-2]
    dpre = torch.empty(*lead, level.n_pad_edges, BN, dtype=xwi.dtype,
                       device=dev)
    dxj = torch.empty(*lead, level.n_pad_nodes, BN, **f32)
    grads = torch.empty(grad_size, **f32)
    err = getattr(lib, fn)(
        level.fiber_t.data_ptr(), xwi.data_ptr(), xj.data_ptr(),
        wf8.data_ptr(), w_stack.data_ptr(), b_stack.data_ptr(),
        wt_stack.data_ptr(), g.data_ptr(), level.send_win.data_ptr(),
        level.win_base.data_ptr(), level.receivers.data_ptr(),
        level.chunk_block.data_ptr(), level.win_row_ptr.data_ptr(),
        level.win_row_slots.data_ptr(), level.win_long.data_ptr(), n_layers,
        grid, n_tiles, level.n_pad_edges, level.edge_block, level.window,
        level.n_pad_nodes, level.win_long.numel(), GATHER_PIECE,
        n_batch, gpart.data_ptr(), dpre.data_ptr(), dxj.data_ptr(),
        grads.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, what)
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
    """aggr [..., n_pad, 128] f32 of the in-window edges (xwi, xj [n_pad,
    128] or a batch [B, n_pad, 128]), differentiable in xwi, xj, wf8 and
    every tail weight and bias. `wf8` rows [0, pd1) are the static-fiber
    rows of the first edge layer, row pd1 its bias; `weights`/`biases` are
    the tail layers ([C, C] stored [in, out])."""
    _check(level, xwi, xj, wf8, weights, biases, batched=True)
    return EdgePhase.apply(level, _V3, len(weights), xwi, xj, wf8, *weights,
                           *biases)
