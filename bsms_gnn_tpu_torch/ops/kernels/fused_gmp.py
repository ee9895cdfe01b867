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

Width and depth: kernels 4 and 5 take a latent width C of 128 or 256 and
any number of tail layers L whose tiles fit a block; every walk (kernels
4, 5 and 11-14) runs on a tile plan (`walk_plan`, the mirror of
`csrc/edge_bwd_tiles.cuh`'s `with_bwd_plan` / `with_fwd_plan`): at C = 128
the backward keeps L + 1 64-slot tiles of layer inputs while they fit a
block's 227 KB (L ≤ 3, the streamed front L ≤ 4), then 32-slot tiles (L ≤
8); at C = 256, 32-slot tiles with 16-row slabs (L ≤ 4), each row two
128-column halves; the forwards keep one tile (64 slots at 128, 32 at 256)
at any L. What no plan holds raises NotImplementedError naming C and L
before any launch, on the card only: the plain versions take any C and L.
A width that is not a multiple of 128 raises everywhere, as JAX leaves it
to XLA (`bsms_gnn_tpu/ops/message.py:502-514`): the `ell` or `segment`
method runs it.

The batch axis (a shared mesh: xwi, xj [B, n_pad, 128]): one launch of
kernel 4 walks the B·T tiles of the batch in the same stride order (tile
t is tile t mod T of sample ⌊t / T⌋, the grid still the card's fill), with
`msg [B, E_pad, 128]` (1.0 GB in f32 at B = 48 on the 5k airfoil's level
0) and one gather whose grid's y index is the sample; one launch of kernel
5 walks the B·T tiles in its ranges, still G partials (each block sums
every sample's tiles of its range into its own), dpre [B, E_pad, 128], dxj
by the batched gather. Every per-row output of sample b is the bits of a
call on sample b alone; the weight gradients sum over the batch. Kernels
11-14, which share the walks, take the batch the same way (11 and 12 with
their streamed rows moving by E_pad·128 elements a sample).

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
_FN = {torch.float32: "fused_edge_phase_win_f32",
       torch.bfloat16: "fused_edge_phase_win_bf16"}
_BWD_FN = {torch.float32: "fused_edge_phase_win_bwd_f32",
           torch.bfloat16: "fused_edge_phase_win_bwd_bf16"}
# Slots per tile of the tile walks at C = 128 and up to 3 tail layers
# (`csrc/edge_bwd_tiles.cuh`'s plan `Base`, held to this value by a
# static_assert there).
TILE_ROWS = 64
# The tile plans of `csrc/edge_bwd_tiles.cuh` as (C, TR, KS), each width's
# in the order the walks try them: the backward's first plan whose shared
# memory fits a block, the forward's first.
BWD_PLANS = {128: ((128, 64, 64), (128, 32, 64)), 256: ((256, 32, 16),)}
FWD_PLANS = {128: ((128, 64, 64),), 256: ((256, 32, 32),)}
# The shared memory one block may hold on an H100 (227 KB) and the widest
# dynamic stream kernel 13 takes (`csrc/edge_tile.cuh`'s MAX_WD).
SMEM_MAX = 232448
_MAX_WD = 4
FRONTS = ("win", "dyn", "stream")


def walk_smem(c, tr, ks, n_layers, front, backward=True) -> int:
    """Bytes of shared memory of a tile walk (`csrc/edge_bwd_tiles.cuh`'s
    `smem_bytes`, `csrc/edge_fwd_tiles.cuh`'s `fwd_smem_bytes`) at plan
    (C, TR, KS) with front `front`: the backward keeps n_layers + 1 tiles,
    the forward one."""
    tiles = n_layers + 1 if backward else 1
    floats = tiles * tr * c + 2 * ks * c
    if front != "stream":
        floats += 8 * c + 8 * tr
    if front == "dyn":
        floats += _MAX_WD * c + c + _MAX_WD * tr + tr
    return 4 * floats + 4 * 3 * tr


def check_width(c: int) -> None:
    """Raise on a latent width the kernel methods take nowhere: one that
    is not a multiple of 128, which JAX runs on XLA."""
    if c < BN or c % BN:
        raise NotImplementedError(
            f"latent width {c}: the kernels take multiples of {BN}; the "
            f"`ell` or `segment` aggregation method runs any width")


def walk_plan(c: int, n_layers: int, front: str, dtype,
              backward: bool = True) -> Tuple[int, int, int]:
    """(C, TR, KS): the tile plan a walk (kernels 4, 5 and 11-14) runs at
    latent width c with n_layers tail layers, front `front` ("win": kernels
    4, 5, 14; "dyn": 13; "stream": 11, 12) and activations of `dtype`, as
    the kernels choose it. Raises NotImplementedError naming C and L where
    no plan's shared memory fits a block, or the width is not one the walks
    take. A pure function of its arguments."""
    check_width(c)
    if front not in FRONTS:
        raise ValueError(f"front {front!r} not in {FRONTS}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"activations of dtype {dtype}")
    if n_layers < 1:
        raise ValueError(f"{n_layers} tail layers")
    plans = (BWD_PLANS if backward else FWD_PLANS).get(c, ())
    for plan in plans:
        if walk_smem(*plan, n_layers, front, backward) <= SMEM_MAX:
            return plan
    raise NotImplementedError(
        f"latent width {c} with {n_layers} tail layers: no tile plan of the "
        f"{'backward' if backward else 'forward'} edge walk ({front} front) "
        f"fits a block's {SMEM_MAX} bytes (widths 128 and 256 run; see "
        f"fused_gmp.walk_plan)")


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
    """Raise on what the windowed edge kernels (4, 5, 13 and 14) do not
    take: each takes one sample [n_pad, C] or a batch [B, n_pad, C], C a
    multiple of 128 (which C and how many tail layers the card's kernels
    take, `walk_plan` says at launch)."""
    if level.window <= 0:
        raise NotImplementedError("fused edge phase needs a windowed level")
    build.check_batch(xwi, True)
    n_pad, c = level.n_pad_nodes, xwi.shape[-1]
    check_width(c)
    if xwi.shape[-2:] != (n_pad, c) or xj.shape != xwi.shape:
        raise ValueError(f"xwi/xj {tuple(xwi.shape)}/{tuple(xj.shape)} "
                         f"!= (..., {n_pad}, {c})")
    if xj.dtype != xwi.dtype or xwi.dtype not in _FN:
        raise ValueError(f"xwi/xj dtypes {xwi.dtype}/{xj.dtype}")
    if wf8.shape != (8, c) or any(w.shape != (c, c) for w in weights):
        raise ValueError("wf8 must be [8, C] and the tail weights [C, C]")
    if len(weights) != len(biases) or not weights:
        raise ValueError("tail weights and biases differ in count")


def check_narrow(what, level, xwi, xj, wf8, weights, biases):
    """`_check`, for a windowed kernel that takes a latent width of 128
    only (kernel 14), on every device."""
    _check(level, xwi, xj, wf8, weights, biases)
    if xwi.shape[-1] != BN:
        raise NotImplementedError(
            f"latent width {xwi.shape[-1]}: {what} takes {BN}")


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
    """aggr [..., n_pad, C] f32 of the in-window edges (xwi, xj [n_pad,
    C] or a batch [B, n_pad, C], one launch), no autograd. CPU tensors
    take the plain version; CUDA tensors launch kernel 4 (C 128 or 256)."""
    _check(level, xwi, xj, wf8, weights, biases)
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
    takes n_in pointers, n_int ints (the latent width and the tail layers
    first) and n_out pointers (the stream last); its `_blocks_per_sm`
    (width, n_layers, int*)."""
    return {**{f: [build.P] * n_in + [build.I] * n_int + [build.P] * n_out
               for f in fns.values()},
            **{f + "_blocks_per_sm": [build.I, build.I, build.P]
               for f in fns.values()}}


def win_fwd_launch(what, lib_name, fns, level, xwi, xj, wf8, weights,
                   biases):
    """aggr [..., n_pad, C] f32 by the windowed forward tile walk of
    `csrc/<lib_name>.cu` (kernel 4's, or kernel 14's under its own names;
    `fns`: dtype → C function) on CUDA tensors, for the batch xwi's
    leading dim gives."""
    build.require(what, xwi.device, level.send_win, level.win_base,
                  level.receivers, level.chunk_block, level.win_row_ptr,
                  level.win_row_slots, level.win_long)
    c = xwi.shape[-1]
    tr = walk_plan(c, len(weights), "win", xwi.dtype, backward=False)[1]
    lib = build.library(lib_name, walk_sigs(fns, 13, 11, 3))
    fn, dev = fns[xwi.dtype], xwi.device
    n_batch = xwi.shape[0] if xwi.dim() == 3 else 1
    n_tiles, grid = walk_grid(lib, fn, c, len(weights), level, n_batch, tr)
    bf16 = xwi.dtype == torch.bfloat16
    w_stack = build.stacked(weights, to_bf16=bf16)
    b_stack = build.stacked(biases)
    xwi, xj = xwi.contiguous(), xj.contiguous()
    wf8 = wf8.detach().float().contiguous()
    lead = xwi.shape[:-2]
    msg = torch.empty(*lead, level.n_pad_edges, c, dtype=xwi.dtype,
                      device=dev)
    out = torch.empty(*lead, level.n_pad_nodes, c, dtype=torch.float32,
                      device=dev)
    err = getattr(lib, fn)(
        level.fiber_t.data_ptr(), xwi.data_ptr(), xj.data_ptr(),
        wf8.data_ptr(), w_stack.data_ptr(), b_stack.data_ptr(),
        level.send_win.data_ptr(), level.win_base.data_ptr(),
        level.receivers.data_ptr(), level.chunk_block.data_ptr(),
        level.win_row_ptr.data_ptr(), level.win_row_slots.data_ptr(),
        level.win_long.data_ptr(), c, len(weights), grid, n_tiles,
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


def walk_fill(lib, fn: str, width: int, n_layers: int, device) -> int:
    """The blocks that fill the card (blocks per SM × SMs) with the tile
    walk of `fn` in `lib` at latent width `width` and n_layers tail layers,
    asked of the card once per device. Depends only on the card and the
    kernel."""
    key = (fn, width, n_layers, device)
    hit = _walks.get(key)
    if hit is None:
        per_sm = ctypes.c_int()
        with torch.cuda.device(device):
            build.check(getattr(lib, fn + "_blocks_per_sm")(
                width, n_layers, ctypes.addressof(per_sm)), fn)
        if per_sm.value < 1:
            raise RuntimeError(f"{fn}: the tile walk fits no block on an SM")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        hit = _walks[key] = per_sm.value * sms
    return hit


def walk_grid(lib, fn: str, width: int, n_layers: int, level,
              n_batch: int = 1,
              tile_rows: int = TILE_ROWS) -> Tuple[int, int]:
    """(tiles of one sample, blocks) of one launch of the tile walk over
    `level` at latent width `width` for a batch of n_batch samples (B·T
    tiles in all), on tiles of `tile_rows` slots (the plan's TR,
    `walk_plan`)."""
    fill = walk_fill(lib, fn, width, n_layers, level.receivers.device)
    if level.edge_block % tile_rows:
        raise NotImplementedError(
            f"edge_block {level.edge_block} is not a multiple of the walk's "
            f"{tile_rows}-slot tiles")
    n_tiles = level.n_pad_edges // tile_rows
    return n_tiles, len(tile_ranges(n_tiles * n_batch, fill)) - 1


def fused_edge_phase_win_bwd_plain(level, xwi, xj, wf8, weights, biases, g):
    """Kernel 5's function in plain PyTorch, on any leading dims (the
    weight gradients summed over them)."""
    fused_edge_phase_win_bwd_plain.calls += 1
    return win_bwd_plain(level, xwi, xj, wf8, weights, biases, g)


fused_edge_phase_win_bwd_plain.calls = 0


def flat_rows(t: torch.Tensor) -> torch.Tensor:
    """t's leading dims' rows as one row axis: [..., R, C] → [-1, C]."""
    return t.reshape(-1, t.shape[-1])


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
    dpre, dw, db = mlp_tail_bwd(flat_rows(pre), [flat_rows(h) for h in hs],
                                flat_rows(normed), flat_rows(inv),
                                flat_rows(ge), ws, bf16)
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
    """(dpre [..., E_pad, C] in xwi's dtype, dxj [..., n_pad, C] f32,
    dwf8 [8, C], dW [L, C, C], db [L, C]) for the aggregate's cotangent g
    [..., n_pad, C] (a batch [B, ...] in one launch, the weight gradients
    summed over it), no autograd. CPU tensors take the plain version; CUDA
    tensors launch kernel 5 (C 128 or 256, L as `walk_plan` allows)."""
    _check(level, xwi, xj, wf8, weights, biases)
    if g.shape != xwi.shape:
        raise ValueError(f"g {tuple(g.shape)} != {tuple(xwi.shape)}")
    if xwi.device.type == "cpu":
        return fused_edge_phase_win_bwd_plain(level, xwi, xj, wf8, weights,
                                              biases, g)
    if xwi.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {xwi.device}")
    out = win_bwd_launch("fused_edge_phase_win_bwd", "fused_gmp_bwd",
                         _BWD_FN, level, xwi, xj, wf8, weights, biases, g)
    fused_edge_phase_win_bwd.launches += 1
    return out


def win_bwd_launch(what, lib_name, fns, level, xwi, xj, wf8, weights,
                   biases, g):
    """(dpre, dxj, dwf8, dW, db) by the windowed backward tile walk of
    `csrc/<lib_name>.cu` (kernel 5's, or kernel 14's under its own names;
    `fns`: dtype → C function) on CUDA tensors, for the batch xwi's
    leading dim gives."""
    build.require(what, xwi.device, level.send_win, level.win_base,
                  level.receivers, level.chunk_block, level.win_row_ptr,
                  level.win_row_slots, level.win_long)
    dev, n_layers, c = xwi.device, len(weights), xwi.shape[-1]
    tr = walk_plan(c, n_layers, "win", xwi.dtype)[1]
    lib = build.library(lib_name, walk_sigs(fns, 15, 11, 5))
    fn = fns[xwi.dtype]
    n_batch = xwi.shape[0] if xwi.dim() == 3 else 1
    n_tiles, grid = walk_grid(lib, fn, c, n_layers, level, n_batch, tr)
    bf16 = xwi.dtype == torch.bfloat16
    w_stack = build.stacked(weights, to_bf16=bf16)
    wt_stack = build.stacked(weights, transpose=True, to_bf16=bf16)
    b_stack = build.stacked(biases)
    xwi, xj = xwi.contiguous(), xj.contiguous()
    wf8 = wf8.detach().float().contiguous()
    g = g.detach().float().contiguous()
    grad_size = n_layers * c * c + n_layers * c + 8 * c
    f32 = dict(dtype=torch.float32, device=dev)
    gpart = torch.empty(grid, grad_size, **f32)
    lead = xwi.shape[:-2]
    dpre = torch.empty(*lead, level.n_pad_edges, c, dtype=xwi.dtype,
                       device=dev)
    dxj = torch.empty(*lead, level.n_pad_nodes, c, **f32)
    grads = torch.empty(grad_size, **f32)
    err = getattr(lib, fn)(
        level.fiber_t.data_ptr(), xwi.data_ptr(), xj.data_ptr(),
        wf8.data_ptr(), w_stack.data_ptr(), b_stack.data_ptr(),
        wt_stack.data_ptr(), g.data_ptr(), level.send_win.data_ptr(),
        level.win_base.data_ptr(), level.receivers.data_ptr(),
        level.chunk_block.data_ptr(), level.win_row_ptr.data_ptr(),
        level.win_row_slots.data_ptr(), level.win_long.data_ptr(),
        c, n_layers, grid, n_tiles, level.n_pad_edges, level.edge_block,
        level.window, level.n_pad_nodes, level.win_long.numel(), GATHER_PIECE,
        n_batch, gpart.data_ptr(), dpre.data_ptr(), dxj.data_ptr(),
        grads.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, what)
    dw, rest = grads.split([n_layers * c * c, grad_size - n_layers * c * c])
    db, dwf8 = rest.split([n_layers * c, 8 * c])
    return (dpre, dxj, dwf8.view(8, c), dw.view(n_layers, c, c),
            db.view(n_layers, c))


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
    """aggr [..., n_pad, C] f32 of the in-window edges (xwi, xj [n_pad, C]
    or a batch [B, n_pad, C]), differentiable in xwi, xj, wf8 and every
    tail weight and bias. `wf8` rows [0, pd1) are the static-fiber
    rows of the first edge layer, row pd1 its bias; `weights`/`biases` are
    the tail layers ([C, C] stored [in, out])."""
    _check(level, xwi, xj, wf8, weights, biases)
    return EdgePhase.apply(level, _V3, len(weights), xwi, xj, wf8, *weights,
                           *biases)
