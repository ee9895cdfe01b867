"""Kernel 1: the windowed rectangular operator application (fused level
transitions).

Replaces the TPU kernel `bsms_gnn_tpu/ops/pallas/windowed.py::
windowed_rect_conv_raw` (`_get_call` → `_make_kernel`):

    out[k] = Σ_{in-window e: recv(e)=k} ew_e · x[win_base[chunk]·W/2 + send_win[e]]

x lives in the operator's INPUT space ([n_in_pad, C]), out in its OUTPUT
space ([n_pad_nodes, C], f32). Sentinel slots (`send_win == W`) contribute
nothing; the caller adds the compact residual (`compact_resid.py`).

CUDA design (`csrc/windowed.cu`): one thread block per edge chunk; each
half of its threads takes half of the chunk's slots, loads the selected
rows directly (no one-hot selection; the loads of eight slots are issued
before their adds) and adds them, scaled by their weights, into its own
shared-memory copy of the chunk's 128-row output block, one thread per
column, in slot order. The two copies are summed into a per-chunk part,
and a second kernel adds the parts of each output block in chunk order
(deterministic, no atomics; a block with no chunk comes out zero), so the
deep transitions, whose few output blocks hold many chunks, still spread
over many SMs. What bounds it on the card: bytes and latency. Each slot
reads one 512-byte row (256 in bf16) and does 256 FLOP, far under the
card's operations-per-byte line; at the 5k mesh each launch moves a few
MB, so the per-launch latency dominates.

bf16 mode follows the TPU kernel, which rounds the ew-weighted one-hot to
bf16 before the f32-accumulated scatter dot: the weight is rounded to bf16
and the product with the bf16 row is exact in f32.
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.ops.kernels import build

BN = 128
_SIG = [build.P] * 7 + [build.I] * 4 + [build.P] * 3
_FN = {torch.float32: "windowed_rect_conv_f32",
       torch.bfloat16: "windowed_rect_conv_bf16"}


def _check(op, x):
    if op.window <= 0:
        raise NotImplementedError("windowed conv needs a windowed operator")
    if x.dim() != 2:
        raise NotImplementedError("batch axis")
    if x.shape != (op.n_in_pad, BN):
        raise ValueError(f"x {tuple(x.shape)} != ({op.n_in_pad}, {BN})")
    if x.dtype not in _FN:
        raise ValueError(f"x dtype {x.dtype}")


def windowed_rect_conv_plain(op, x):
    """The same function in plain PyTorch (index_select / index_add_)."""
    w = op.window
    sw = op.send_win.long()
    covered = sw < w
    base = op.win_base.long().repeat_interleave(op.edge_block)
    rows = torch.where(covered, base * (w // 2) + sw, 0)
    ew = op.ew.float()
    if x.dtype == torch.bfloat16:
        ew = ew.to(torch.bfloat16).float()
    msg = x.float().index_select(0, rows) * torch.where(covered, ew, 0.0)[:, None]
    out = torch.zeros(op.n_pad_nodes, x.shape[-1], dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, op.receivers.long(), msg)


def windowed_rect_conv(op, x):
    """Out-space f32 [n_pad_nodes, 128] of the in-window entries of a
    windowed TransOp applied to x [n_in_pad, 128]. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    _check(op, x)
    build.forward_only("windowed_rect_conv", x)
    if x.device.type == "cpu":
        return windowed_rect_conv_plain(op, x)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    build.require("windowed_rect_conv", x.device, op.send_win, op.win_base,
                  op.receivers, op.chunk_block, op.chunk_ptr)
    lib = build.library("windowed", {f: _SIG for f in _FN.values()})
    x = x.contiguous()
    n_chunks = op.n_pad_edges // op.edge_block
    part = torch.empty(n_chunks, BN, BN, dtype=torch.float32, device=x.device)
    out = torch.empty(op.n_pad_nodes, BN, dtype=torch.float32,
                      device=x.device)
    err = getattr(lib, _FN[x.dtype])(
        x.data_ptr(), op.ew.data_ptr(), op.send_win.data_ptr(),
        op.win_base.data_ptr(), op.receivers.data_ptr(),
        op.chunk_block.data_ptr(), op.chunk_ptr.data_ptr(), n_chunks,
        op.n_pad_nodes // BN, op.edge_block, op.window, part.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "windowed_rect_conv")
    windowed_rect_conv.launches += 1
    return out


windowed_rect_conv.launches = 0
