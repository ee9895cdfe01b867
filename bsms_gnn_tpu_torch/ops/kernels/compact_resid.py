"""Kernel 2: the compact residual accumulate, and the compact gather.

Replaces the TPU kernel `bsms_gnn_tpu/ops/pallas/compact_resid.py::
compact_accum` / `compact_accum_raw` (`_get_call` → `_make_kernel`): adds
the receiver sums of the compact residual rows onto an accumulator,

    acc[vb·128 + rl] += vals[cb·128 + j]   for every visit (vb, cb) and
                                            row j with rl = visit_recv[v, j] ≥ 0

Output node blocks that no visit touches keep `acc`. The port has no
autograd yet (serving only), so one wrapper serves both JAX entry points.

In place: the port adds onto `acc` and returns it. Every caller passes an
accumulator it no longer needs otherwise (the aggregate from
`fused_gmp.py`, the operator output from `windowed.py`), as the TPU kernel
aliased its accumulator onto its output.

CUDA design (`csrc/compact_resid.cu`): one thread block per 128-row output
block loads the block's accumulator rows into shared memory, walks the
block's visits (visits are sorted by output block, so they are one
contiguous range, `visit_ptr`) staging each visit's 128 value rows in
shared memory, and adds them one thread per output column and half-block
in row order (deterministic, no atomics); blocks without a visit return at
once. What bounds it on the card: bytes and latency (one read of each
value row and of each visited accumulator block, one write back); at the
5k mesh a launch moves well under a MB, so launch latency dominates.

bf16 vals are summed into the f32 accumulator exactly as read.
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.ops.kernels import build

BN = 128
_SIG = [build.P] * 5 + [build.I] + [build.P]
_FN = {torch.float32: "compact_accum_f32",
       torch.bfloat16: "compact_accum_bf16"}


def compact_gather(cr, x, by: str):
    """x[cr.senders] (`by='send'`) or x[cr.receivers] (`'recv'`): a plain
    index_select, as on the TPU (the JAX gather only adds a custom VJP)."""
    idx = {"send": cr.senders, "recv": cr.receivers}[by]
    return x.index_select(-2, idx)


def _check(cr, vals, acc):
    if vals.dim() != 2 or acc.dim() != 2:
        raise NotImplementedError("batch axis")
    if vals.shape != (cr.n_rows, BN):
        raise ValueError(f"vals {tuple(vals.shape)} != ({cr.n_rows}, {BN})")
    if acc.shape != (cr.n_pad_nodes, BN) or acc.dtype != torch.float32:
        raise ValueError(f"acc must be f32 ({cr.n_pad_nodes}, {BN})")
    if not acc.is_contiguous():
        raise ValueError("acc is updated in place and must be contiguous")
    if vals.dtype not in _FN:
        raise ValueError(f"vals dtype {vals.dtype}")


def compact_accum_plain(cr, vals, acc):
    """The same function in plain PyTorch: index_add_ of the real rows,
    in place on acc."""
    n = cr.n_real
    return acc.index_add_(0, cr.receivers[:n].long(), vals[:n].float())


def compact_accum(cr, vals, acc):
    """acc (f32 [n_pad, 128], updated in place and returned) plus the
    receiver sums of vals [R_pad, 128]. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    _check(cr, vals, acc)
    build.forward_only("compact_accum", vals, acc)
    if vals.device.type == "cpu":
        return compact_accum_plain(cr, vals, acc)
    if vals.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {vals.device}")
    build.require("compact_accum", vals.device, cr.visit_cblk,
                  cr.visit_recv, cr.visit_ptr)
    if acc.device != vals.device:
        raise ValueError("acc and vals on different devices")
    lib = build.library("compact_resid", {f: _SIG for f in _FN.values()})
    vals = vals.contiguous()
    err = getattr(lib, _FN[vals.dtype])(
        vals.data_ptr(), cr.visit_cblk.data_ptr(), cr.visit_recv.data_ptr(),
        cr.visit_ptr.data_ptr(), acc.data_ptr(), cr.n_pad_nodes // BN,
        torch.cuda.current_stream(vals.device).cuda_stream,
    )
    build.check(err, "compact_accum")
    compact_accum.launches += 1
    return acc


compact_accum.launches = 0
