"""LR schedule: linear warmup then cosine decay to zero (counterpart of
`bsms_gnn_tpu/training/schedule.py`).

factor = count / warmup during warmup, else 0.5·(1 + cos(π·progress)),
with progress clamped at 1 so the LR stays 0 past `decay_steps` (the JAX
package's fix of the reference's cosine that swings back up). `end_lr` is
unused, as in the reference.
"""

from __future__ import annotations

import math


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           decay_steps: int):
    """A plain function of the update count k = 0, 1, ... → learning rate."""

    def schedule(count: int) -> float:
        if count <= warmup_steps:
            return peak_lr * count / max(warmup_steps, 1)
        progress = min(max((count - warmup_steps)
                           / max(decay_steps - warmup_steps, 1), 0.0), 1.0)
        return peak_lr * 0.5 * (1.0 + math.cos(math.pi * progress))

    return schedule
