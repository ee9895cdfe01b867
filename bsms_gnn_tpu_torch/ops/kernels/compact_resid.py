"""Kernel 2: the compact residual accumulate, and the compact gather.

Replaces the TPU kernel `bsms_gnn_tpu/ops/pallas/compact_resid.py::
compact_accum` / `compact_accum_raw` (`_get_call` → `_make_kernel`): adds
the receiver sums of the compact residual rows onto an accumulator,

    acc[vb·128 + rl] += vals[cb·128 + j]   for every visit (vb, cb) and
                                            row j with rl = visit_recv[v, j] ≥ 0

Output node blocks that no visit touches keep `acc`. As in the JAX
package, `compact_accum_raw` has no autograd (the transitions pair their
own adjoints) and `compact_accum` is differentiable: d_vals = g[receivers],
d_acc = g (`compact_resid.py:148-170`).

In place: the port adds onto `acc` and returns it. Every caller passes an
accumulator it no longer needs otherwise (the aggregate from
`fused_gmp.py`, the operator output from `windowed.py`), as the TPU kernel
aliased its accumulator onto its output. Under autograd `compact_accum`
marks `acc` dirty (`ctx.mark_dirty`), so the accumulator's history runs
through the accumulate's backward; nothing saves the accumulator before
the update for its own backward.

`compact_gather` is x[senders] or x[receivers] with the TPU's scatter-free
backward (`compact_resid.py:173-208`): for `'recv'` the cotangent rows
accumulate onto zeros through kernel 2; for `'send'` they first take
`ct[twin]` (the residual edge set of a level is symmetric, so sender sums
are receiver sums of the twin rows). So the gather's backward launches
kernel 2, as on the TPU, not the `index_add_` scatter that autograd of
`index_select` would run.

CUDA design (`csrc/compact_resid.cu` on `csrc/row_gather.cuh`): kernel
1's gather over the distinct receivers of the real compact rows
(`cr_rows`, ascending) and their ranges of compact rows (`cr_row_ptr`: the
rows are sorted by receiver, `graph/hierarchy.py::compact_row_tables`).
A warp owns 4 consecutive receivers; each lane loads 16 bytes (8 in bf16)
of every row of their ranges, the value row of a position being the
compact row itself (no slot table, no weight), sums in registers in row
order and adds the sum onto the receiver's accumulator row, whose value
it loaded beside its first rows. A receiver of more than 32 rows
(`cr_long`) gets a block of its own. The pad rows (`n_real` ..) are listed
nowhere, and accumulator rows no real row reaches are neither read nor
written. One launch, no atomics. What bounds it on the card: bytes (each
real value row read once, each reached accumulator row read and written
once); at the 5k mesh a launch moves about a MB, so its latency
dominates.

Why not a shared-memory copy of each visited 128-row block of `acc`: every
such block then moves whole (5.4 MB where 0.9 MB is needed at the 5k
airfoil's level 0), added to by serial read-modify-writes, and it ran 2.4x
slower than `index_add_` there.

bf16 vals are summed into the f32 accumulator exactly as read.

The batch axis (a shared mesh): vals [B, R_pad, 128] onto acc [B, n_pad,
128] is one launch whose grid's y index is the sample, each sample added
over the same ranges in the same order as a call on it alone; the
gathers take dim -2.
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.graph.hierarchy import GATHER_PIECE
from bsms_gnn_tpu_torch.ops.kernels import build

BN = 128
_SIG = [build.P] * 4 + [build.I] * 6 + [build.P] * 2
_FN = {torch.float32: "compact_accum_f32",
       torch.bfloat16: "compact_accum_bf16"}


def _check(cr, vals, acc):
    build.check_batch(vals, True)
    build.check_batch(acc, True)
    lead = vals.shape[:-2]
    if vals.shape[-2:] != (cr.n_rows, BN):
        raise ValueError(f"vals {tuple(vals.shape)} != (..., {cr.n_rows}, "
                         f"{BN})")
    if (acc.shape != (*lead, cr.n_pad_nodes, BN)
            or acc.dtype != torch.float32):
        raise ValueError(f"acc must be f32 {(*lead, cr.n_pad_nodes, BN)}")
    if not acc.is_contiguous():
        raise ValueError("acc is updated in place and must be contiguous")
    if vals.dtype not in _FN:
        raise ValueError(f"vals dtype {vals.dtype}")


def compact_accum_plain(cr, vals, acc):
    """The same function in plain PyTorch, on any leading dims: index_add_
    of the real rows, in place on acc."""
    compact_accum_plain.calls += 1
    n = cr.n_real
    return acc.index_add_(-2, cr.receivers[:n].long(),
                          vals[..., :n, :].float())


compact_accum_plain.calls = 0


def compact_accum_raw(cr, vals, acc):
    """acc (f32 [..., n_pad, 128], updated in place and returned) plus the
    receiver sums of vals [..., R_pad, 128] (a batch [B, ...] in one
    launch), no autograd. CPU tensors take the plain version; CUDA tensors
    launch kernel 2."""
    _check(cr, vals, acc)
    if vals.device.type == "cpu":
        return compact_accum_plain(cr, vals, acc)
    if vals.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {vals.device}")
    build.require("compact_accum", vals.device, cr.cr_rows, cr.cr_row_ptr,
                  cr.cr_long)
    if acc.device != vals.device:
        raise ValueError("acc and vals on different devices")
    lib = build.library("compact_resid", {f: _SIG for f in _FN.values()})
    vals = vals.contiguous()
    err = getattr(lib, _FN[vals.dtype])(
        vals.data_ptr(), cr.cr_rows.data_ptr(), cr.cr_row_ptr.data_ptr(),
        cr.cr_long.data_ptr(), cr.cr_rows.numel(), cr.cr_long.numel(),
        GATHER_PIECE, vals.shape[0] if vals.dim() == 3 else 1, cr.n_rows,
        cr.n_pad_nodes, acc.data_ptr(),
        torch.cuda.current_stream(vals.device).cuda_stream,
    )
    build.check(err, "compact_accum")
    compact_accum_raw.launches += 1
    return acc


compact_accum_raw.launches = 0


class _Accum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cr, vals, acc):
        ctx.cr, ctx.vals_dtype = cr, vals.dtype
        ctx.mark_dirty(acc)
        return compact_accum_raw(cr, vals, acc)

    @staticmethod
    def backward(ctx, g):
        d_vals = g.index_select(-2, ctx.cr.receivers).to(ctx.vals_dtype)
        return None, d_vals, g


def compact_accum(cr, vals, acc):
    """`compact_accum_raw`, differentiable in vals and acc."""
    _check(cr, vals, acc)
    return _Accum.apply(cr, vals, acc)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cr, by, x):
        ctx.cr, ctx.by, ctx.dtype = cr, by, x.dtype
        return x.index_select(-2, cr.senders if by == "send"
                              else cr.receivers)

    @staticmethod
    def backward(ctx, ct):
        cr = ctx.cr
        v = ct if ctx.by == "recv" else ct.index_select(-2, cr.twin)
        zeros = torch.zeros(*ct.shape[:-2], cr.n_pad_nodes, ct.shape[-1],
                            dtype=torch.float32, device=ct.device)
        return None, None, compact_accum_raw(cr, v, zeros).to(ctx.dtype)


def compact_gather(cr, x, by: str):
    """x[..., cr.senders, :] (`by='send'`) or x[..., cr.receivers, :]
    (`'recv'`) → [..., R_pad, C] (x [N_pad, C] or a batch [B, N_pad, C]),
    with the scatter-free backward above. `'send'` needs a symmetric
    compact residual (a level's, not a transition's)."""
    if by not in ("send", "recv"):
        raise ValueError(f"by={by!r}")
    if by == "send" and not cr.symmetric:
        raise ValueError("the sender gather's backward needs a symmetric "
                         "compact residual")
    build.check_batch(x, True)
    return _Gather.apply(cr, by, x)
