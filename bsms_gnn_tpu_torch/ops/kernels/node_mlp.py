"""Kernel 3: the fused GMP node phase.

Replaces the TPU kernel `bsms_gnn_tpu/ops/pallas/node_mlp.py::
fused_node_phase` (forward, `_get_fwd` → `_make_fwd_kernel`):

    out = LN(tail(relu(x·Wa + aggr·Wb + b0))) + x

per row, with Wa/Wb the x and aggr halves of the node MLP's [2C, C] first
layer. Output in bf16 in bf16 mode, else in x's dtype; x may be f32 in
bf16 mode (the level-0 GMP when the encoder runs in f32).

CUDA design (`csrc/node_mlp.cu`): one thread block per 64-row tile keeps
x, the aggregate and every hidden activation in shared memory through the
whole phase; the only device-memory traffic is x and aggr in, out out, and
the weights (L2-resident). What bounds it on the card: operations,
(2 + L)·2·128·128 FLOP per row against 768 bytes per row in f32; the tile
GEMM is the one `fused_gmp.py` describes (f32 FMA on CUDA cores, no TF32).

bf16 mode rounds every dot operand to bf16 (x, aggr, the hidden
activations, the weights) and accumulates in f32; LN and the residual add
run in f32 and the sum is stored in bf16.
"""

from __future__ import annotations

import torch

from bsms_gnn_tpu_torch.ops.kernels import build
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import BN, dot, mlp_tail_plain

_SIG = [build.P] * 7 + [build.I] * 2 + [build.P]
# (x dtype, bf16 compute) → C entry.
_FN = {(torch.float32, False): "fused_node_phase_f32",
       (torch.bfloat16, True): "fused_node_phase_bf16",
       (torch.float32, True): "fused_node_phase_f32_bf16"}
ROWS = 64


def _check(x, aggr, mlp, compute_dtype):
    if x.dim() != 2:
        raise NotImplementedError("batch axis")
    n_pad, c = x.shape
    if c != BN:
        raise NotImplementedError(f"latent width {c} (only 128)")
    if aggr.shape != x.shape or aggr.dtype != torch.float32:
        raise ValueError(f"aggr must be f32 {tuple(x.shape)}")
    if n_pad % ROWS:
        raise ValueError(f"rows {n_pad} not a multiple of {ROWS}")
    if not mlp.layer_normalized or len(mlp.weights) < 2:
        raise NotImplementedError("node MLP needs LayerNorm and a tail")
    ws = list(mlp.weights)
    if ws[0].shape != (2 * c, c) or any(w.shape != (c, c) for w in ws[1:]):
        raise NotImplementedError("node MLP widths")
    if (x.dtype, compute_dtype == torch.bfloat16) not in _FN:
        raise NotImplementedError(
            f"x dtype {x.dtype} with compute dtype {compute_dtype}")


def fused_node_phase_plain(x, aggr, mlp, compute_dtype=None):
    """The same function in plain PyTorch."""
    bf16 = compute_dtype == torch.bfloat16
    c = x.shape[-1]
    w0 = mlp.weights[0].float()
    x32 = x.float()
    pre = dot(x32, w0[:c], bf16) + dot(aggr, w0[c:], bf16) + mlp.biases[0]
    e = mlp_tail_plain(pre, [w.float() for w in list(mlp.weights)[1:]],
                       [b.float() for b in list(mlp.biases)[1:]], bf16)
    return (e + x32).to(torch.bfloat16 if bf16 else x.dtype)


def fused_node_phase(x, aggr, mlp, compute_dtype=None):
    """LN(MLP_node([x, aggr])) + x. `mlp` is the GMP's node MLP (weights
    stored [in, out]). CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    _check(x, aggr, mlp, compute_dtype)
    build.forward_only("fused_node_phase", x, aggr, *mlp.parameters())
    if x.device.type == "cpu":
        return fused_node_phase_plain(x, aggr, mlp, compute_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    lib = build.library("node_mlp", {f: _SIG for f in _FN.values()})
    ws, bs = list(mlp.weights), list(mlp.biases)
    w0, b0 = ws[0].float().contiguous(), bs[0].float().contiguous()
    w_stack, b_stack = build.stacked(ws[1:]), build.stacked(bs[1:])
    x, aggr = x.contiguous(), aggr.contiguous()
    bf16 = compute_dtype == torch.bfloat16
    out = torch.empty_like(x, dtype=torch.bfloat16 if bf16 else x.dtype)
    err = getattr(lib, _FN[(x.dtype, bf16)])(
        x.data_ptr(), aggr.data_ptr(), w0.data_ptr(), b0.data_ptr(),
        w_stack.data_ptr(), b_stack.data_ptr(), out.data_ptr(),
        len(mlp.weights) - 1, x.shape[0] // ROWS,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "fused_node_phase")
    fused_node_phase.launches += 1
    return out


fused_node_phase.launches = 0
