"""Training entry point (counterpart of `bsms_gnn_tpu/train.py`).

Usage (overrides as the JAX CLI's: group swaps and dotted values):
    python -m bsms_gnn_tpu_torch.train datasets=airfoil batch=48 epochs=20
    python -m bsms_gnn_tpu_torch.train datasets=cylinder_flow device=cpu

Seeded setup, the loss and per-channel error of a train and a test batch
at the logging cadence (every `loss_freq` steps, every tenth of it near the
start and the end), checkpoints every `save_freq` steps and at the end
(`training/checkpoint.py`, optimizer state included), ETA lines. With
`restore_dir` the run resumes from `restore_step` (-1: the newest
checkpoint there) and, unlike the JAX CLI, which runs `total_steps + 1`
more iterations from the restored step, runs until the trainer's step
reaches `total_steps + 1`, so a resumed run ends where an uninterrupted
one does. f32 is true f32: TF32 is off for matmuls and cuDNN.
"""

from __future__ import annotations

import contextlib
import os
import sys
from datetime import datetime
from typing import Callable, ContextManager, Optional

import numpy as np
import torch

from bsms_gnn_tpu_torch.config import Config, load_config, to_yaml
from bsms_gnn_tpu_torch.data.pipeline import (
    TrajectorySampler,
    batch_to_device,
    device_prefetch,
)
from bsms_gnn_tpu_torch.device import resolve_device
from bsms_gnn_tpu_torch.training.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from bsms_gnn_tpu_torch.training.trainer import Trainer
from bsms_gnn_tpu_torch.utils import (
    MetricLogger,
    TicToc,
    board_loss,
    print_error_table,
)


def _log_cadence(step: int, freq: int, total: int) -> bool:
    """Every `freq` steps, plus every `freq // 10` near the start and end."""
    dense = max(freq // 10, 1)
    return (
        step % freq == 0
        or (step <= freq and step % dense == 0)
        or (step >= total - freq and step % dense == 0)
    )


def setup_run(cfg: Config):
    """What both CLIs start with: TF32 off, the config printed, and the
    device (`cfg.device`: "" the card, which raises without one)."""
    if cfg.parallel.data_axis > 1 or cfg.parallel.graph_axis > 1:
        raise NotImplementedError(
            "parallel.data_axis / graph_axis > 1: the CLIs run one process "
            "on one device; the multi-rank paths are library calls in "
            "bsms_gnn_tpu_torch.parallel (data_parallel_step, "
            "halo_train_step, edge_shard_train_step), one process per rank")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(to_yaml(cfg), flush=True)
    return resolve_device(cfg.device or None)


def restore(cfg: Config, trainer: Trainer) -> int:
    """Restore `cfg.restore_step` (-1: the newest) from `cfg.restore_dir`
    into `trainer`; the step restored, or -1."""
    if not cfg.restore_dir:
        return -1
    step = cfg.restore_step if cfg.restore_step >= 0 else latest_step(
        cfg.restore_dir)
    if step >= 0:
        restore_checkpoint(cfg.restore_dir, step, trainer)
        print(f"restored step {step} from {cfg.restore_dir}", flush=True)
    return step


def _plot_test_batch(cfg, trainer, batch, step, stamp) -> None:
    from scipy.spatial import Delaunay

    from bsms_gnn_tpu_torch.utils.plotting import plot_fields

    pred = trainer.get_pred(batch.hierarchy, batch.node_in,
                            batch.node_mask)[0].cpu().numpy()
    node_in = batch.node_in[0].cpu().numpy()
    n_pad = node_in.shape[0]
    real = int(batch.hierarchy.levels[0].node_mask[:n_pad].sum())
    pos = node_in[:real, -1 - cfg.model.pos_dim:-1]
    # Scatter panels need positions only: a Delaunay of the real nodes.
    cells = Delaunay(pos).simplices
    out = os.path.join(cfg.dump_dir, "plots", f"{cfg.datasets.name}_{stamp}",
                       f"step_{step}.png")
    plot_fields(pos, cells, pred[:real], batch.node_tar[0].cpu().numpy(),
                save_path=out, title=f"step {step}")
    print(f"plotted test batch → {out}", flush=True)


def run_train(cfg: Config, train_sampler: Optional[TrajectorySampler] = None,
              test_sampler: Optional[TrajectorySampler] = None,
              step_context: Optional[Callable[[int, Trainer],
                                              ContextManager]] = None
              ) -> dict:
    """Train as `cfg` says. The samplers default to the dataset on disk
    (`cfg.datasets`; `TrajectorySampler.from_readers` feeds trajectories
    held in memory); run_train closes them. `step_context(step, trainer)`,
    when given, wraps each loop iteration (its batch, logging, checkpoint
    and train step): the hook for measuring a run. Returns {"trainer", "losses" (each step's loss),
    "ckpt_dir"}."""
    logger = None
    try:
        device = setup_run(cfg)
        np.random.seed(cfg.base_seed)
        logger = MetricLogger(cfg.board, cfg.project)
        trainer = Trainer(cfg, device=device)
        restore(cfg, trainer)
        if train_sampler is None:
            train_sampler = TrajectorySampler(
                cfg.datasets, cfg.batch, cfg.dataset_workers, cfg.base_seed,
                "train", device=device)
        if test_sampler is None:
            test_sampler = TrajectorySampler(
                cfg.datasets, cfg.batch, max(1, cfg.dataset_workers // 4),
                cfg.base_seed, "test", device=device)

        stamp = datetime.now().strftime("%Y%m%d-%H%M%S")
        ckpt_dir = os.path.join(cfg.dump_dir, "ckpts", cfg.project,
                                cfg.datasets.name, stamp)
        print(f"stamp: {stamp}; checkpoints → {ckpt_dir}", flush=True)

        timer = TicToc()
        total_steps = cfg.epochs * cfg.steps_per_epoch
        train_iter = device_prefetch(train_sampler)
        losses, pending = [], []
        while trainer.step <= total_steps:
            with (step_context(trainer.step, trainer) if step_context
                  else contextlib.nullcontext()):
                batch = next(train_iter)
                step = trainer.step
                args = (batch.hierarchy, batch.node_in, batch.node_tar,
                        batch.node_mask)

                if _log_cadence(step, cfg.loss_freq, total_steps):
                    loss, mean, std = trainer.get_loss_and_error(*args)
                    board_loss(logger, "train", step, loss)
                    print_error_table("train", step, mean, std)
                    tb = batch_to_device(next(test_sampler))
                    loss, mean, std = trainer.get_loss_and_error(
                        tb.hierarchy, tb.node_in, tb.node_tar, tb.node_mask)
                    board_loss(logger, "test", step, loss)
                    print_error_table("test", step, mean, std)

                if cfg.plot and step > 0 and step % cfg.plot_freq == 0:
                    _plot_test_batch(cfg, trainer,
                                     batch_to_device(next(test_sampler)),
                                     step, stamp)

                if step % cfg.save_freq == 0 and step > 0:
                    save_checkpoint(ckpt_dir, step, trainer)
                    print(f"saved step {step} → {ckpt_dir}", flush=True)

                pending.append(trainer.iter(*args))
                if len(pending) >= 1024:  # one host sync per 1024 steps
                    losses += torch.stack(pending).tolist()
                    pending.clear()

                if trainer.step == cfg.time_warm:
                    timer.tic("train")
                if (trainer.step > cfg.time_warm
                        and trainer.step % cfg.time_freq == 0):
                    timer.estimate_time(
                        "train", (trainer.step - cfg.time_warm) / total_steps)
        if pending:
            losses += torch.stack(pending).tolist()
        save_checkpoint(ckpt_dir, trainer.step, trainer)
        print(f"saved step {trainer.step} → {ckpt_dir}", flush=True)
    finally:
        for sampler in (train_sampler, test_sampler):
            if sampler is not None:
                sampler.close()
        if logger is not None:
            logger.finish()
    return {"trainer": trainer, "losses": losses, "ckpt_dir": ckpt_dir}


def main() -> None:
    run_train(load_config(sys.argv[1:]))


if __name__ == "__main__":
    main()
