"""Synthetic airfoil-like mesh (counterpart of
`bsms_gnn_tpu/data/synthetic.py::make_graded_airfoil_mesh`), so the port
builds the benchmark mesh without the dataset readers."""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay

# Node-type codes of the MeshGraphNets datasets.
NT_NORMAL = 0
NT_AIRFOIL = 2
NT_INFLOW = 4


def make_graded_airfoil_mesh(n_nodes: int, rng: np.random.Generator):
    """Radially graded point density around an elliptical body (dense
    boundary layer, coarse far field) with the body interior carved out,
    matching the real airfoil mesh's node count and skewed edge-length and
    degree distribution. Returns (pos [N,2], cells [M,3], node_type [N,1])."""
    a, b = 0.5, 0.06  # body semi-axes (thin airfoil-ish ellipse)
    n_body = max(n_nodes // 20, 64)
    t = np.linspace(0, 2 * np.pi, n_body, endpoint=False)
    body = np.stack([a * np.cos(t), b * np.sin(t)], -1)

    # Graded cloud: radius ~ exponential in u so ~half the nodes sit within
    # 2 body-lengths; far field extends to ~20 body lengths.
    n_cloud = n_nodes - n_body
    u = rng.uniform(0, 1, n_cloud)
    r = 1.02 + (np.exp(4.0 * u) - 1) / (np.exp(4.0) - 1) * 40.0
    th = rng.uniform(0, 2 * np.pi, n_cloud)
    cloud = np.stack([a * r * np.cos(th), a * r * np.sin(th)], -1)
    # Push points out of the body (scaled ellipse test).
    inside = (cloud[:, 0] / (1.02 * a)) ** 2 + (cloud[:, 1] / (1.02 * b)) ** 2 < 1
    cloud[inside] *= 1.2 / np.sqrt(
        (cloud[inside, 0] / a) ** 2 + (cloud[inside, 1] / b) ** 2
    )[:, None]

    pos = np.concatenate([body, cloud])
    tri = Delaunay(pos)
    cells = tri.simplices.astype(np.int64)
    # Drop triangles whose centroid falls inside the body (the hole).
    cen = pos[cells].mean(axis=1)
    keep = (cen[:, 0] / a) ** 2 + (cen[:, 1] / b) ** 2 > 1.0
    cells = cells[keep]

    node_type = np.full((pos.shape[0], 1), NT_NORMAL, np.int32)
    node_type[:n_body] = NT_AIRFOIL
    rad = np.linalg.norm(pos, axis=-1)
    node_type[rad > 0.98 * rad.max()] = NT_INFLOW  # far-field boundary
    return pos.astype(np.float32), cells, node_type
