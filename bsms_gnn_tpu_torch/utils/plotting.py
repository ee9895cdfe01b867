"""Field plots on triangulated meshes (counterpart of
`bsms_gnn_tpu/utils/plotting.py`'s `plot_fields`): tripcolor panels of
prediction / target / |error| per channel, saved as PNG. Returns None
where matplotlib is not installed."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def plot_fields(
    mesh_pos: np.ndarray,
    cells: np.ndarray,
    pred: np.ndarray,
    target: Optional[np.ndarray] = None,
    channel_names: Optional[Sequence[str]] = None,
    save_path: Optional[str] = None,
    title: str = "",
):
    """pred/target: [N, C] nodal fields on a tri mesh. Returns the figure,
    or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import matplotlib.tri as mtri
    except ImportError:
        return None

    pred = np.asarray(pred)
    n, c = pred.shape
    tri = mtri.Triangulation(mesh_pos[:n, 0], mesh_pos[:n, 1], cells)
    rows = 1 if target is None else 3
    fig, axes = plt.subplots(rows, c, figsize=(4 * c, 3 * rows),
                             squeeze=False)
    names = channel_names or [f"ch{i}" for i in range(c)]
    for ci in range(c):
        panels = [("pred", pred[:, ci])]
        if target is not None:
            panels += [("target", target[:n, ci]),
                       ("|error|", np.abs(pred[:, ci] - target[:n, ci]))]
        for ri, (label, vals) in enumerate(panels):
            ax = axes[ri][ci]
            tpc = ax.tripcolor(tri, vals, shading="gouraud")
            fig.colorbar(tpc, ax=ax, fraction=0.046)
            ax.set_title(f"{names[ci]} {label}")
            ax.set_aspect("equal")
            ax.axis("off")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=110)
        plt.close(fig)
    return fig
