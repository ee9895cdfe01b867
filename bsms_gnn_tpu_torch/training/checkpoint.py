"""Checkpoints of the whole train state (counterpart of
`bsms_gnn_tpu/training/checkpoint.py`): `Trainer.state_dict()`, which
holds the parameters, the normalizers, the AdamW state, the counts and the
noise generator's state, so a restored run resumes exactly.

Layout as the JAX package's: one directory per step, `{ckpt_dir}/step_{n}/`,
here holding one `torch.save` file, `state.pt`, written under a temporary
name and renamed, so a reader never sees half a checkpoint.
"""

from __future__ import annotations

import os

import torch

STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir: str, step: int, trainer) -> str:
    """Save `trainer`'s state as step `step`; returns the step directory."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, STATE_FILE)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(trainer.state_dict(), tmp)
    os.replace(tmp, target)
    return path


def restore_checkpoint(ckpt_dir: str, step: int, trainer):
    """Load step `step` into `trainer` (onto its device); returns it."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}", STATE_FILE)
    state = torch.load(path, map_location=trainer.device, weights_only=True)
    trainer.load_state_dict(state)
    return trainer


def latest_step(ckpt_dir: str) -> int:
    """Largest step with a saved checkpoint, or -1."""
    if not os.path.isdir(ckpt_dir):
        return -1
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and d.split("_", 1)[1].isdigit()
             and os.path.isfile(os.path.join(ckpt_dir, d, STATE_FILE))]
    return max(steps, default=-1)
