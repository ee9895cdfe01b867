"""Console metrics and optional wandb (counterpart of
`bsms_gnn_tpu/utils/logging.py`): loss lines and per-channel relative-error
tables; wandb only behind `board`, and only where it is installed."""

from __future__ import annotations

from typing import Optional, Sequence


def _try_wandb():
    try:
        import wandb  # type: ignore
    except ImportError:
        return None
    return wandb


class MetricLogger:
    def __init__(self, board: bool = False, project: str = "train",
                 config: Optional[dict] = None):
        self.wandb = None
        if board:
            wandb = _try_wandb()
            if wandb is not None:
                wandb.init(project=project, config=config or {})
                self.wandb = wandb
            else:
                print("[logging] wandb unavailable; console only", flush=True)

    def log(self, step: int, **scalars) -> None:
        if self.wandb is not None:
            self.wandb.log(dict(scalars), step=step)

    def log_figure(self, step: int, name: str, fig) -> None:
        """Log a matplotlib figure."""
        if self.wandb is not None and fig is not None:
            self.wandb.log({name: self.wandb.Image(fig)}, step=step)

    def finish(self) -> None:
        if self.wandb is not None:
            self.wandb.finish()


def board_loss(logger: MetricLogger, mode: str, step: int,
               loss: float) -> None:
    print(f"[{mode}] step {step}: loss {loss:.6f}", flush=True)
    logger.log(step, **{f"{mode}_loss": loss})


def print_error_table(mode: str, step: int, mean: Sequence[float],
                      std: Sequence[float]) -> None:
    """Per-channel relative error table."""
    header = f"{'channel':>8} | {'rel_err_mean':>12} | {'rel_err_std':>12}"
    rows = [f"{i:>8} | {m:>12.6f} | {s:>12.6f}"
            for i, (m, s) in enumerate(zip(mean, std))]
    print(f"-- {mode} error @ step {step} --", flush=True)
    print("\n".join([header, "-" * len(header), *rows]), flush=True)
