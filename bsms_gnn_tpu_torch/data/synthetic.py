"""Synthetic meshes (counterparts of `bsms_gnn_tpu/data/synthetic.py`'s
`make_graded_airfoil_mesh`, `make_grid_strip_mesh`, `make_sphere_mesh` and
`generate_inflating_trajectory`), so the port builds the benchmark meshes
without the dataset readers."""

from __future__ import annotations

import numpy as np
from scipy.spatial import ConvexHull, Delaunay

# Node-type codes of the MeshGraphNets datasets.
NT_NORMAL = 0
NT_AIRFOIL = 2
NT_HANDLE = 3
NT_INFLOW = 4
NT_OUTFLOW = 5
NT_WALL = 6


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


def make_grid_strip_mesh(n_nodes: int, ny: int = 8):
    """Regular triangulated strip of ~n_nodes (nx = n_nodes // ny columns,
    jittered interior positions): (pos [N,2], cells [M,3], node_type [N,1]).
    Bi-stride selection stays clean on it to depth 7 and more (alternating
    columns, bounded degree). The left column is inflow, the right outflow,
    the rest of the rim wall."""
    nx = max(n_nodes // ny, 4)
    xs, ys = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    pos = np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.float64)
    # Jitter interior nodes so edge fibers are non-degenerate.
    rng = np.random.default_rng(12345)
    interior = (
        (pos[:, 0] > 0) & (pos[:, 0] < nx - 1)
        & (pos[:, 1] > 0) & (pos[:, 1] < ny - 1)
    )
    pos[interior] += rng.uniform(-0.25, 0.25, size=(int(interior.sum()), 2))
    pos = pos / ny  # unit-height strip, aspect nx/ny
    cells = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a = i * ny + j
            b = (i + 1) * ny + j
            c = (i + 1) * ny + j + 1
            d = i * ny + j + 1
            cells.append([a, b, c])
            cells.append([a, c, d])
    cells = np.asarray(cells, dtype=np.int64)
    node_type = np.full((pos.shape[0], 1), NT_NORMAL, np.int32)
    x = pos[:, 0] * ny
    node_type[np.isclose(x, 0.0)] = NT_INFLOW
    node_type[np.isclose(x, nx - 1)] = NT_OUTFLOW
    y = pos[:, 1] * ny
    wall = (np.isclose(y, 0.0) | np.isclose(y, ny - 1)) & ~np.isclose(
        x, 0.0) & ~np.isclose(x, nx - 1)
    node_type[wall] = NT_WALL
    return pos.astype(np.float32), cells, node_type


def make_sphere_mesh(n_nodes: int, rng: np.random.Generator):
    """Closed triangulated surface in 3D (inflating-font-style cases):
    Fibonacci-sphere points + convex hull. Returns (pos [N,3], cells [M,3],
    node_type [N,1] with the bottom cap as handles)."""
    n = max(n_nodes, 32)
    i = np.arange(n, dtype=np.float64)
    golden = (1 + 5**0.5) / 2
    z = 1 - 2 * (i + 0.5) / n
    r = np.sqrt(np.maximum(1 - z**2, 0.0))
    theta = 2 * np.pi * i / golden
    pos = np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=-1)
    pos += rng.normal(0, 1e-3, pos.shape)  # break hull degeneracies
    pos /= np.linalg.norm(pos, axis=-1, keepdims=True)
    hull = ConvexHull(pos)
    cells = hull.simplices.astype(np.int64)
    node_type = np.full((n, 1), NT_NORMAL, np.int32)
    node_type[pos[:, 2] < np.quantile(pos[:, 2], 0.05)] = NT_HANDLE
    return pos.astype(np.float32), cells, node_type


def generate_inflating_trajectory(n_nodes: int, n_frames: int,
                                  rng: np.random.Generator):
    """world_pos dynamics: the surface inflates radially with a smooth
    angular bulge; handle nodes stay at rest (Dirichlet). Returns a dict of
    per-frame arrays: mesh_pos [T, N, 3], node_type [T, N, 1], cells [T, M,
    3], world_pos [T, N, 3]."""
    pos, cells, node_type = make_sphere_mesh(n_nodes, rng)
    n = pos.shape[0]
    phase = float(rng.uniform(0, 2 * np.pi))
    handles = (node_type[:, 0] == NT_HANDLE)
    world = np.zeros((n_frames, n, 3), np.float32)
    for ti in range(n_frames):
        inflate = 1.0 + 0.25 * (1 - np.cos(0.35 * ti + 0.0)) / 2
        bulge = 1.0 + 0.08 * np.sin(3 * np.arctan2(pos[:, 1], pos[:, 0]) + phase) \
            * np.sin(0.35 * ti)
        scale = inflate * bulge  # [N]
        w = pos * scale[:, None]
        w[handles] = pos[handles]
        world[ti] = w
    return {
        "mesh_pos": np.broadcast_to(pos, (n_frames, n, 3)).copy(),
        "node_type": np.broadcast_to(node_type, (n_frames, n, 1)).copy(),
        "cells": np.broadcast_to(cells, (n_frames,) + cells.shape).copy(),
        "world_pos": world,
    }
