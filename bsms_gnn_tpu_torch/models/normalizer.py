"""Online feature normalizer as explicit state (counterpart of
`bsms_gnn_tpu/models/normalizer.py`).

Weighted online accumulation of E[x] / E[x²] (row count scaled by `unit`),
capped at `max_accumulations`; std = max(√(E[x²]−E[x]²), 1e-8) with NaN→0.
The statistics keep the state's dtype, so a state made with
`dtype=torch.float64` accumulates in f64; normalize and denormalize return
f32. Accumulation takes an optional per-row mask so padded rows stay out of
the statistics.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from bsms_gnn_tpu_torch.device import resolve_device


@dataclass
class NormalizerState:
    acc_weight: torch.Tensor  # [] accumulated row weight (rows / unit)
    num_accumulations: torch.Tensor  # [] number of accumulate() calls
    e_x: torch.Tensor  # [size] running E[x]
    e_x2: torch.Tensor  # [size] running E[x²]
    max_accumulations: float = 5e5
    unit: float = 1e6
    std_epsilon: float = 1e-8


def init_normalizer(size: int, max_accumulations: float = 5e5,
                    unit: float = 1e6, std_epsilon: float = 1e-8,
                    dtype=torch.float32, device=None) -> NormalizerState:
    device = resolve_device(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return NormalizerState(zeros(), zeros(), zeros(size), zeros(size),
                           max_accumulations, unit, std_epsilon)


def normalizer_accumulate(state: NormalizerState, batched_data, mask=None
                          ) -> NormalizerState:
    """One accumulation step over data reshaped to [-1, size]; rows with
    mask 0 contribute neither to the count nor the means."""
    return normalizer_apply_sums(
        state, *normalizer_row_sums(state, batched_data, mask))


def normalizer_row_sums(state: NormalizerState, batched_data, mask=None):
    """(rows, Σx [size], Σx² [size]) over data reshaped to [-1, size], the
    rows with mask 0 left out: the reduction half of an accumulation step,
    which a sharded caller sums over its ranks before
    `normalizer_apply_sums` (JAX's `normalizer_row_sums`)."""
    dtype = state.e_x.dtype
    size = state.e_x.shape[0]
    data = batched_data.reshape(-1, size).to(dtype)
    if mask is None:
        m = torch.ones(data.shape[0], 1, dtype=dtype, device=data.device)
    else:
        m = mask.reshape(-1, 1).to(dtype).expand(data.shape[0], 1)
    return m.sum(), (data * m).sum(dim=0), (data.square() * m).sum(dim=0)


def normalizer_apply_sums(state: NormalizerState, n_rows, sum_x, sum_x2
                          ) -> NormalizerState:
    """One accumulation step from the (maybe group-summed) row sums."""
    n_rows = torch.clamp(n_rows, min=1.0)
    mean = sum_x / n_rows
    mean_sq = sum_x2 / n_rows

    delta_w = n_rows / state.unit
    new_w = state.acc_weight + delta_w
    new_ex = (state.e_x * state.acc_weight + mean * delta_w) / new_w
    new_ex2 = (state.e_x2 * state.acc_weight + mean_sq * delta_w) / new_w
    go = state.num_accumulations < state.max_accumulations
    return dataclasses.replace(
        state,
        acc_weight=torch.where(go, new_w, state.acc_weight),
        num_accumulations=state.num_accumulations + go.to(state.e_x.dtype),
        e_x=torch.where(go, new_ex, state.e_x),
        e_x2=torch.where(go, new_ex2, state.e_x2),
    )


def normalizer_std(state: NormalizerState):
    var = state.e_x2 - state.e_x.square()
    std = torch.nan_to_num(torch.sqrt(var))
    return torch.clamp(std, min=state.std_epsilon)


def normalize(state: NormalizerState, x):
    return ((x - state.e_x) / normalizer_std(state)).float()


def denormalize(state: NormalizerState, x):
    return (x * normalizer_std(state) + state.e_x).float()
