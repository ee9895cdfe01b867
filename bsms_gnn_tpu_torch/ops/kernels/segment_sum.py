"""Kernel 8: the receiver-sorted segment sum.

Replaces the TPU kernel `bsms_gnn_tpu/ops/pallas/segment_sum.py::
segment_sum_raw` / `segment_sum_pallas` / `segment_sum_send_pallas`
(`_get_call` → `_make_kernel`): the [E_pad, C] edge rows of a block-aligned
layout summed into f32 [N_pad, C] receiver rows,

    out[r] = Σ_{s ∈ slots of r} feat[s]

where the slots of r are those the TPU kernel's one-hot gives r: the slots
of the chunks of r's 128-row block whose receiver is r
(`graph/hierarchy.py::row_tables`). Pad slots carry receiver N_pad − 1: they
are dropped in every block but the last, whose pad slots add onto row
N_pad − 1, as on the TPU; nothing reads that row. The sender form sums, for
each row, the reverse edges of its receiver slots (the TPU kernel run on
`feat[reverse_perm]`; level edge sets are symmetric).

CUDA design (`csrc/segment_sum.cu`): the one-hot MXU product becomes direct
row reads over the layout's slot lists (`row_ptr` with `row_slots`, or
`row_send` for the sender form: the same lists of the reverse edges, so
the same lengths and the same long rows, `row_long`), in one launch of the
row-ordered gather (`csrc/row_gather.cuh`), in f32 with no atomics, so the
result repeats from run to run. A warp walks four consecutive short lists
as one range, its lanes resolving 32 positions at once; a list of more
than GATHER_PIECE = 32 slots gets a block of its own. The order of the
sums: a list of up to 32 slots in list order; a longer one in pieces of
32, warp w of the block summing pieces w, w + 8, ... (each from zero, in
list order, and added in turn), and the warps' sums added in warp order.
Kernel 10 (`agg_node.py`) sums its aggregate on chip in this order, so its
backward, which sums the aggregate again with this kernel, sees the
forward's. The TPU's sequential grid over chunks, revisiting a 128-row
output block, is not carried over: rows are independent. What bounds it
on the card: bytes (each slot's row read once, the output written once;
C adds per slot). The walk costs where lists are long but few warps run:
on the 16k surface's levels 3-4 (2,048 and 1,024 rows of 26 and 44 slots
on average) a warp walks four lists of ~26 slots one after the other,
and a block of 8 warps sums a list of ~44 on two of them, so those levels
read slower than one warp per row walking its list alone
(`level_times.py`, PERF.md §6).

Widths that are not a multiple of 128 take the plain version on purpose,
as JAX's `_supported` (`segment_sum.py:118-131`) sends them to XLA: the
3-wide world-position stream of the world-edge models. Those calls count
in `segment_sum_raw.narrow_calls`, apart from the kernel's launches. The
kernel takes rows of a latent width of `windowed.WIDTHS` (128 or 256), as
JAX's getter is keyed on C (`segment_sum.py:84`): the gather sums them 128
columns at a time, one column block a grid z index, each over the same
lists in the same order, so at 256 each 128-column half is the bits of a
128-wide call on that half. Other multiples of 128 raise on the card.
Skip-empty layouts (the residual sub-levels) are refused, as `_supported`
refuses them: a block that owns no chunk would get no row. Their sums go
through kernel 9 (`segment_sum_accum.py`).

The batch axis (a shared mesh: feat [B, E_pad, C] → [B, N_pad, C]), as
JAX vmaps its kernel (`segment_sum.py:360,371,399`): one launch, the
sample the gather's grid y index, each sample's feat and output moving by
E_pad·C and N_pad·C elements (`csrc/row_gather.cuh`), so each sample's
rows are the bits of a call on that sample alone. The plain version works
on the leading dims (`index_select` / `index_add_` on dim -2), the 3-wide
route included.
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.graph.hierarchy import GATHER_PIECE
from bsms_gnn_tpu_torch.ops.kernels import build
from bsms_gnn_tpu_torch.ops.kernels.windowed import check_gather_width

_SIG = [build.P] * 4 + [build.I] * 6 + [build.P] * 2
_FN = {torch.float32: "segment_sum_f32", torch.bfloat16: "segment_sum_bf16"}


def _slots(level, send: bool):
    return level.row_send if send else level.row_slots


def _check(level, feat, send: bool):
    if level.skip_empty:
        raise ValueError("kernel 8 refuses a skip-empty layout (blocks "
                         "without a chunk): sum it with kernel 9, "
                         "segment_sum_accum")
    build.check_batch(feat, True)
    if feat.shape[-2] != level.n_pad_edges:
        raise ValueError(f"feat rows {feat.shape[-2]} != E_pad "
                         f"{level.n_pad_edges}")
    if level.row_ptr is None or (send and level.row_send is None):
        raise ValueError("the layout has no row tables (graph.hierarchy."
                         "to_device builds them; the sender form needs a "
                         "level)")


def segment_sum_plain(level, feat, send: bool = False):
    """Kernel 8's function in plain PyTorch: zeros plus `index_add_` of the
    slots the row table keeps, each to its receiver, on feat's leading
    dims."""
    segment_sum_plain.calls += 1
    slots = _slots(level, send)
    rows = level.receivers.index_select(0, level.row_slots).long()
    out = torch.zeros(*feat.shape[:-2], level.n_pad_nodes, feat.shape[-1],
                      dtype=torch.float32, device=feat.device)
    return out.index_add_(-2, rows, feat.index_select(-2, slots).float())


segment_sum_plain.calls = 0


def segment_sum_raw(level, feat, send: bool = False):
    """f32 [..., N_pad, C] receiver sums (`send`: sender sums) of feat
    [E_pad, C] or a batch [B, E_pad, C] (one launch), no autograd. CPU
    tensors, and widths that are not a multiple of 128, take the plain
    version; other CUDA tensors launch kernel 8 (C 128 or 256)."""
    _check(level, feat, send)
    if feat.device.type == "cpu":
        return segment_sum_plain(level, feat, send)
    if feat.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {feat.device}")
    c = feat.shape[-1]
    if c % 128:
        segment_sum_raw.narrow_calls += 1
        return segment_sum_plain(level, feat, send)
    check_gather_width("kernel 8", c)
    if feat.dtype not in _FN:
        raise ValueError(f"feat dtype {feat.dtype}")
    slots = _slots(level, send)
    build.require("segment_sum", feat.device, level.row_ptr, slots,
                  level.row_long)
    lib = build.library("segment_sum", {f: _SIG for f in _FN.values()})
    feat = feat.contiguous()
    out = torch.empty(*feat.shape[:-2], level.n_pad_nodes, c,
                      dtype=torch.float32, device=feat.device)
    err = getattr(lib, _FN[feat.dtype])(
        feat.data_ptr(), level.row_ptr.data_ptr(), slots.data_ptr(),
        level.row_long.data_ptr(), level.n_pad_nodes, level.row_long.numel(),
        GATHER_PIECE, feat.shape[0] if feat.dim() == 3 else 1,
        level.n_pad_edges, c, out.data_ptr(),
        torch.cuda.current_stream(feat.device).cuda_stream,
    )
    build.check(err, "segment_sum")
    segment_sum_raw.launches += 1
    return out


segment_sum_raw.launches = 0
segment_sum_raw.narrow_calls = 0


class _SegmentSum(torch.autograd.Function):
    """Forward kernel 8; backward the row gather by receivers (`send`: by
    senders), cast to the input's dtype (`segment_sum.py:356-357,395-396`)."""

    @staticmethod
    def forward(ctx, level, send, feat):
        ctx.level, ctx.send, ctx.dtype = level, send, feat.dtype
        return segment_sum_raw(level, feat, send)

    @staticmethod
    def backward(ctx, g):
        lvl = ctx.level
        idx = lvl.senders if ctx.send else lvl.receivers
        return None, None, g.index_select(-2, idx).to(ctx.dtype)


def segment_sum(level, feat):
    """Differentiable receiver sums of feat [..., E_pad, C]: f32 [...,
    N_pad, C]."""
    _check(level, feat, False)
    return _SegmentSum.apply(level, False, feat)


def segment_sum_send(level, feat):
    """Differentiable sender sums of feat [..., E_pad, C] (symmetric level
    edge sets): f32 [..., N_pad, C]."""
    _check(level, feat, True)
    return _SegmentSum.apply(level, True, feat)
