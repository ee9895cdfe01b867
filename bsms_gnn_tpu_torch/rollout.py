"""Rollout entry point: closed-loop evaluation with RMSE summaries
(counterpart of `bsms_gnn_tpu/rollout.py`).

Usage:
    python -m bsms_gnn_tpu_torch.rollout datasets=airfoil restore_dir=... restore_step=...

Restores a checkpoint (`restore_step` -1: the newest), rolls every test
trajectory out from its first frame, and prints the RMSE averaged over
time and channel, per channel, and at steps 0, 5, 10, 50 and the last,
each as mean and std over the trajectories.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from bsms_gnn_tpu_torch.config import Config, load_config
from bsms_gnn_tpu_torch.data.pipeline import rollout_iterator
from bsms_gnn_tpu_torch.data.trajectory import TrajectoryReader
from bsms_gnn_tpu_torch.train import restore, setup_run
from bsms_gnn_tpu_torch.training.rollout import (
    StreamingStats,
    rollout_metrics,
    rollout_trajectory,
)
from bsms_gnn_tpu_torch.training.trainer import Trainer


def run_rollout(cfg: Config,
                readers: Optional[Sequence[TrajectoryReader]] = None,
                on_trajectory: Optional[Callable] = None) -> dict:
    """Roll out the test trajectories (`readers`, or the dataset's test
    split on disk) with the restored model; `on_trajectory(reader, preds)`
    sees each rollout's predictions [T-1, N_pad, C] on the device. Returns
    the overall mean and std, the per-channel mean and the per-time mean."""
    device = setup_run(cfg)
    trainer = Trainer(cfg, device=device)
    if restore(cfg, trainer) < 0:
        print("WARNING: rolling out an untrained model (no restore_dir)",
              flush=True)

    trajectories = (rollout_iterator(cfg.datasets, cfg.base_seed, device)
                    if readers is None else
                    ((r, *r.full()) for r in readers))
    acc_overall = acc_channel = acc_time = None
    n_traj = 0
    for reader, inp, tar, mask in trajectories:
        preds = rollout_trajectory(
            trainer.sim, reader.hd, torch.from_numpy(inp[0]).to(device),
            torch.from_numpy(mask[0]).to(device), inp.shape[0],
            trainer.compute_dtype)
        if on_trajectory is not None:
            on_trajectory(reader, preds)
        m = rollout_metrics(preds.cpu().numpy(), tar, mask[0])
        if acc_overall is None:
            acc_overall = StreamingStats(1)
            acc_channel = StreamingStats(m["per_channel"].shape[-1])
            acc_time = StreamingStats(m["per_time"].shape[-1])
        acc_overall.add(np.asarray([[m["overall"]]]))
        acc_channel.add(m["per_channel"])
        acc_time.add(m["per_time"])
        n_traj += 1
        print(f"traj {n_traj}: rollout RMSE {m['overall']:.6f}", flush=True)

    if n_traj == 0:
        raise ValueError("no test trajectories to roll out")

    print("\n---- error averaged over time and channel ----")
    print(f"mean {acc_overall.mean()[0]:.6f}  std {acc_overall.std()[0]:.6f}")
    print("\n---- error per channel ----")
    print(f"mean {acc_channel.mean().tolist()}")
    print(f"std  {acc_channel.std().tolist()}")
    print("\n---- error at steps 0, 5, 10, 50, last ----")
    t_mean, t_std = acc_time.mean(), acc_time.std()
    t_len = t_mean.shape[0]
    steps = [s for s in (0, 5, 10, 50) if s < t_len] + [t_len - 1]
    print(f"mean {t_mean[steps].tolist()}")
    print(f"std  {t_std[steps].tolist()}", flush=True)

    return {
        "overall_mean": float(acc_overall.mean()[0]),
        "overall_std": float(acc_overall.std()[0]),
        "per_channel_mean": acc_channel.mean().tolist(),
        "per_time_mean": t_mean.tolist(),
    }


def main() -> None:
    run_rollout(load_config(sys.argv[1:]))


if __name__ == "__main__":
    main()
