"""Kernel 9: the accumulating segment sum.

Replaces the TPU kernel `bsms_gnn_tpu/ops/pallas/segment_sum.py::
segment_sum_accum_raw` / `segment_sum_accum` / `segment_sum_accum_send_raw`
(`_get_accum_call` → `_make_accum_kernel`): the [E_pad, C] edge rows of a
block-aligned layout summed onto an existing f32 [N_pad, C] array,

    out[r] = acc[r] + Σ_{s ∈ slots of r} feat[s]

with kernel 8's slots of a row (`graph/hierarchy.py::row_tables`; a pad
slot adds onto row N_pad − 1 only in the last block, as on the TPU), and
rows that no slot reaches keeping acc. It is the one aggregation that
skip-empty layouts (the residual sub-levels, whose empty node blocks own
no chunk) take, as the TPU kernel, whose output aliases acc, is there
(`segment_sum.py:121`, `:253-256`). The sender form sums, for each row,
the reverse edges of its receiver slots (the TPU kernel run on
`feat[reverse_perm]`). With no acc (`acc=None`, the store form) the sums
alone: what the skip-empty gathers' backward takes (`ops/scatter.py`),
where JAX sums onto zeros (`bsms_gnn_tpu/ops/scatter.py:149-171`), the
same function without a zero fill and its read.

CUDA design (`csrc/segment_sum_accum.cu`): one launch of the row-ordered
gather (`csrc/row_gather.cuh`), as kernel 8 (`segment_sum.py`), over
`row_ptr` with `row_slots` or `row_send` (the same lists, so the same long
rows, `row_long`), but a warp to each short list (the residual lists hold
a few slots each, and four a warp left most of the card idle at level 1);
a list of more than GATHER_PIECE = 32 slots (on every skip-empty layout
the pad row N_pad − 1 of the last block's pad slots: up to 256 on the
cylinder's level 0) gets a block of its own, cut into pieces over its 8
warps. Each row's sum runs from zero in kernel 8's order and is then added
onto acc's row, read once beside the walk's first loads: the TPU kernel's
aliasing becomes an out-of-place write, so autograd keeps acc. The store
form writes the sum alone, bit for bit the call on zeros (a sum that
starts at +0 never ends at −0, and x + 0 = x). In f32 with no atomics, so
the result repeats from run to run. What bounds it on the card: bytes
(each listed slot's row read once, acc read once, the output written
once; C adds per slot). It takes rows of 128 (the latent width of every
path); other widths raise.
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.graph.hierarchy import GATHER_PIECE
from bsms_gnn_tpu_torch.ops.kernels import build

_SIG = [build.P] * 5 + [build.I] * 3 + [build.P] * 2
_FN = {torch.float32: "segment_sum_accum_f32",
       torch.bfloat16: "segment_sum_accum_bf16"}


def _check(level, feat, acc, send: bool):
    if feat.dim() != 2:
        raise NotImplementedError("batch axis")
    if feat.shape[0] != level.n_pad_edges:
        raise ValueError(f"feat rows {feat.shape[0]} != E_pad "
                         f"{level.n_pad_edges}")
    if acc is not None and acc.shape != (level.n_pad_nodes, feat.shape[-1]):
        raise ValueError(f"acc {tuple(acc.shape)} != ({level.n_pad_nodes}, "
                         f"{feat.shape[-1]})")
    if level.row_ptr is None or (send and level.row_send is None):
        raise ValueError("the layout has no row tables (graph.hierarchy."
                         "to_device builds them; the sender form needs a "
                         "level)")


def segment_sum_accum_plain(level, feat, acc, send: bool = False):
    """Kernel 9's function in plain PyTorch: acc (zeros where acc is None)
    plus `index_add_` of the slots the row table keeps, each to its
    receiver."""
    segment_sum_accum_plain.calls += 1
    slots = level.row_send if send else level.row_slots
    rows = level.receivers.index_select(0, level.row_slots).long()
    out = (torch.zeros(level.n_pad_nodes, feat.shape[-1],
                       dtype=torch.float32, device=feat.device)
           if acc is None else acc.float().clone())
    return out.index_add_(0, rows, feat.index_select(0, slots).float())


segment_sum_accum_plain.calls = 0


def segment_sum_accum_send_plain(level, feat, acc):
    """The sender form's plain version."""
    return segment_sum_accum_plain(level, feat, acc, send=True)


def segment_sum_accum_raw(level, feat, acc, send: bool = False):
    """f32 [N_pad, C]: acc + the receiver sums (`send`: sender sums) of
    feat [E_pad, C], no autograd; with acc None the sums alone (the store
    form). CPU tensors take the plain version; CUDA tensors launch kernel
    9."""
    _check(level, feat, acc, send)
    if feat.device.type == "cpu":
        return segment_sum_accum_plain(level, feat, acc, send)
    if feat.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {feat.device}")
    c = feat.shape[-1]
    if c != 128:
        raise NotImplementedError(f"kernel 9 takes rows of 128, not {c}")
    if feat.dtype not in _FN:
        raise ValueError(f"feat dtype {feat.dtype}")
    idx = level.row_send if send else level.row_slots
    build.require("segment_sum_accum", feat.device, level.row_ptr, idx,
                  level.row_long)
    lib = build.library("segment_sum_accum", {f: _SIG for f in _FN.values()})
    feat = feat.contiguous()
    if acc is not None:
        acc = acc.float().contiguous()
    out = torch.empty(level.n_pad_nodes, c, dtype=torch.float32,
                      device=feat.device)
    err = getattr(lib, _FN[feat.dtype])(
        feat.data_ptr(), level.row_ptr.data_ptr(), idx.data_ptr(),
        level.row_long.data_ptr(), None if acc is None else acc.data_ptr(),
        level.n_pad_nodes, level.row_long.numel(), GATHER_PIECE,
        out.data_ptr(), torch.cuda.current_stream(feat.device).cuda_stream,
    )
    build.check(err, "segment_sum_accum")
    segment_sum_accum_raw.launches += 1
    return out


segment_sum_accum_raw.launches = 0


def segment_sum_accum_send_raw(level, feat, acc):
    """acc + the sender sums of feat (symmetric level edge sets; with acc
    None the sums alone), no autograd: the sender form of
    `segment_sum_accum_raw`."""
    return segment_sum_accum_raw(level, feat, acc, send=True)


class _SegmentSumAccum(torch.autograd.Function):
    """Forward kernel 9; backward d_acc = g and d_feat = g[receivers], each
    in its input's dtype (`segment_sum.py:280-282`)."""

    @staticmethod
    def forward(ctx, level, feat, acc):
        ctx.level, ctx.dtypes = level, (feat.dtype, acc.dtype)
        return segment_sum_accum_raw(level, feat, acc)

    @staticmethod
    def backward(ctx, g):
        feat_dt, acc_dt = ctx.dtypes
        return (None, g.index_select(0, ctx.level.receivers).to(feat_dt),
                g.to(acc_dt))


def segment_sum_accum(level, feat, acc):
    """Differentiable acc + the receiver sums of feat: f32 [N_pad, C]."""
    _check(level, feat, acc, False)
    return _SegmentSumAccum.apply(level, feat, acc)
