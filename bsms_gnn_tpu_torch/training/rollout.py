"""Closed-loop rollout + streaming RMSE metrics (counterpart of
`bsms_gnn_tpu/training/rollout.py`).

Starting from the initial condition, each prediction is fed back with the
static (mesh_pos, node_type) tail re-attached and Dirichlet (mask == 0)
nodes clamped to the initial condition. The JAX `lax.scan` is a Python
loop over steps here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


@torch.no_grad()
def rollout_trajectory(sim, hierarchy, ic, node_mask, n_steps: int,
                       compute_dtype=None):
    """ic: [N_pad, C+pos_dim+1] initial condition (frame 0 input);
    node_mask: [N_pad, 1]. Returns [n_steps, N_pad, C] predictions."""
    c_out = ic.shape[-1] - sim.cfg.pos_dim - 1
    pos_type = ic[..., c_out:]
    current = ic
    preds = []
    for _ in range(n_steps):
        pred = sim(hierarchy, current, node_mask, compute_dtype)
        nxt = torch.cat([pred, pos_type], dim=-1)
        current = torch.where(node_mask == 0, ic, nxt)
        preds.append(pred)
    return torch.stack(preds)


class StreamingStats:
    """Weighted streaming mean/std over accumulated batches (the same
    recurrence as the normalizer)."""

    def __init__(self, size: int):
        self.size = size
        self.w = 0.0
        self.e_x = np.zeros(size, np.float64)
        self.e_x2 = np.zeros(size, np.float64)

    def add(self, data: np.ndarray) -> None:
        data = np.asarray(data, np.float64).reshape(-1, self.size)
        dw = data.shape[0]
        neww = self.w + dw
        self.e_x = (self.e_x * self.w + data.mean(0) * dw) / neww
        self.e_x2 = (self.e_x2 * self.w + (data**2).mean(0) * dw) / neww
        self.w = neww

    def mean(self) -> np.ndarray:
        return self.e_x

    def std(self) -> np.ndarray:
        var = self.e_x2 - self.e_x**2
        return np.maximum(np.nan_to_num(np.sqrt(var)), 1e-8)


def rollout_metrics(
    preds: np.ndarray, targets: np.ndarray, node_mask: np.ndarray
) -> Dict[str, np.ndarray]:
    """Per-trajectory RMSE summaries. preds/targets: [T, N, C]; node_mask:
    [N, 1] or [T, N, 1]. Returns overall scalar RMSE, per-channel [T, C]
    RMSE, per-time [C, T]."""
    preds = np.asarray(preds, np.float64)
    targets = np.asarray(targets, np.float64)
    mask = np.asarray(node_mask, np.float64)
    if mask.ndim == 2:
        mask = np.broadcast_to(mask[None], preds.shape[:-1] + (1,))
    se = (preds - targets) ** 2
    overall = np.sqrt((se * mask).sum() / mask.sum() / se.shape[-1])
    per_channel = np.sqrt((se * mask).sum(axis=1) / mask.sum(axis=1))
    return {"overall": overall, "per_channel": per_channel,
            "per_time": per_channel.T}
