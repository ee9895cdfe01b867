"""Dense layers (counterpart of `bsms_gnn_tpu/ops/dense.py`).

`MLP`: hidden_layers × (Linear→ReLU) → Linear → optional non-affine
LayerNorm. Weights are stored [in, out], as the JAX package's `MLPParams`
stores them, and initialized like torch.nn.Linear (U(±1/√fan_in) for both
weight and bias) from an explicit `torch.Generator`.

`compute_dtype` follows the JAX rule: with bfloat16, operands are rounded
to bf16, products accumulate in f32, the bias is added in f32 and the
output is stored in bf16. With None, real f32 (the card runs with TF32
off; `chip_smoke.py` sets and states it). Inputs are [..., rows, in]: any
leading dims (a batch) ride the matmuls.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def dense(x, w, b, compute_dtype=None):
    """x @ w + b under the compute-dtype rule above."""
    if compute_dtype == torch.bfloat16:
        out = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
        return (out + b).to(torch.bfloat16)
    return x @ w + b


def layer_norm(x, eps: float = 1e-5):
    """Non-affine LayerNorm over the last axis; bf16 inputs normalize in
    f32 and return bf16."""
    x32 = x.float() if x.dtype == torch.bfloat16 else x
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class MLP(nn.Module):
    def __init__(self, input_dim: int, latent_dim: int, output_dim: int,
                 hidden_layers: int, layer_normalized: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [input_dim] + [latent_dim] * hidden_layers + [output_dim]
        self.layer_normalized = layer_normalized
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for fi, fo in zip(dims[:-1], dims[1:]):
            bound = 1.0 / fi ** 0.5
            w = torch.empty(fi, fo).uniform_(-bound, bound, generator=generator)
            b = torch.empty(fo).uniform_(-bound, bound, generator=generator)
            self.weights.append(nn.Parameter(w))
            self.biases.append(nn.Parameter(b))

    def forward(self, x, compute_dtype=None):
        return mlp_apply(self, x, compute_dtype)


def mlp_apply(mlp: MLP, x, compute_dtype=None):
    n = len(mlp.weights)
    for i in range(n - 1):
        x = torch.relu(dense(x, mlp.weights[i], mlp.biases[i], compute_dtype))
    x = dense(x, mlp.weights[-1], mlp.biases[-1], compute_dtype)
    return layer_norm(x) if mlp.layer_normalized else x


def mlp_apply_tail(mlp: MLP, pre_act, compute_dtype=None):
    """Finish an MLP whose first layer's pre-activation the caller computed
    (the split-first-layer trick: concat(xs) @ W == Σ xs_k @ W_k)."""
    x = torch.relu(pre_act)
    n = len(mlp.weights)
    for i in range(1, n - 1):
        x = torch.relu(dense(x, mlp.weights[i], mlp.biases[i], compute_dtype))
    x = dense(x, mlp.weights[-1], mlp.biases[-1], compute_dtype)
    return layer_norm(x) if mlp.layer_normalized else x
