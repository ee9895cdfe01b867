"""Synthetic meshes and datasets (counterparts of
`bsms_gnn_tpu/data/synthetic.py`'s `make_delaunay_mesh`,
`make_graded_airfoil_mesh`, `make_grid_strip_mesh`, `make_sphere_mesh`,
`make_tetra_mesh`, `generate_trajectory`, `generate_inflating_trajectory`,
`generate_tetra_trajectory` and the dataset writers
`generate_synthetic_dataset`, `generate_synthetic_inflating_dataset` and
`generate_synthetic_tetra_dataset`), so the port builds the benchmark
meshes and writes schema-identical HDF5 trajectories (one file per
trajectory under `{root}/{name}/{split}/`, every field with a leading time
axis) from the same seeds as the JAX package. The writers need h5py,
imported when they run; the meshes and trajectories need only numpy and
scipy."""

from __future__ import annotations

import os

import numpy as np
from scipy.spatial import ConvexHull, Delaunay

from bsms_gnn_tpu_torch.data.datasets import (  # noqa: F401 (re-exported)
    NT_AIRFOIL,
    NT_HANDLE,
    NT_INFLOW,
    NT_NORMAL,
    NT_OUTFLOW,
    NT_WALL,
    get_mask,
)


def cylinder_mask(node_type: np.ndarray) -> np.ndarray:
    """cylinder_flow's loss mask: valid ⇔ type ∈ {0 interior, 5 outflow}
    (f32, the shape of `node_type`)."""
    return get_mask("cylinder_flow", node_type)


def _write_h5(path: str, fields: dict) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        for k, v in fields.items():
            f.create_dataset(k, data=v)


def make_delaunay_mesh(n_nodes: int, rng: np.random.Generator):
    """Irregular triangulated mesh on the unit square: a boundary ring
    and uniform interior points, Delaunay-triangulated. Returns (pos [N,2],
    cells [M,3], node_type [N,1]): left edge inflow, right edge outflow,
    top and bottom wall."""
    n_side = max(4, int(np.sqrt(n_nodes) // 4))
    t = np.linspace(0, 1, n_side, endpoint=False)
    boundary = np.concatenate([
        np.stack([t, np.zeros_like(t)], -1),
        np.stack([np.ones_like(t), t], -1),
        np.stack([1 - t, np.ones_like(t)], -1),
        np.stack([np.zeros_like(t), 1 - t], -1),
    ])
    n_interior = max(n_nodes - boundary.shape[0], 8)
    interior = rng.uniform(0.02, 0.98, size=(n_interior, 2))
    pos = np.concatenate([boundary, interior])
    cells = Delaunay(pos).simplices.astype(np.int64)

    node_type = np.full((pos.shape[0], 1), NT_NORMAL, np.int32)
    nb = boundary.shape[0]
    node_type[:nb][np.isclose(pos[:nb, 0], 0.0)] = NT_INFLOW
    node_type[:nb][np.isclose(pos[:nb, 0], 1.0)] = NT_OUTFLOW
    on_wall = np.isclose(pos[:nb, 1], 0.0) | np.isclose(pos[:nb, 1], 1.0)
    node_type[:nb][on_wall & ~np.isclose(pos[:nb, 0], 0.0)
                   & ~np.isclose(pos[:nb, 0], 1.0)] = NT_WALL
    return pos.astype(np.float32), cells, node_type


def _analytic_fields(pos: np.ndarray, t: float, phase: float):
    """The traveling vortex's velocity (vx, vy) and advected density at
    time t."""
    x, y = pos[:, 0], pos[:, 1]
    vx = np.sin(2 * np.pi * (x - 0.3 * t) + phase) * np.cos(2 * np.pi * y)
    vy = -np.cos(2 * np.pi * (x - 0.3 * t) + phase) * np.sin(2 * np.pi * y)
    rho = 1.0 + 0.2 * np.sin(2 * np.pi * (x + y - 0.5 * t) + phase)
    return vx.astype(np.float32), vy.astype(np.float32), rho.astype(np.float32)


def generate_trajectory(mesh: tuple, n_frames: int,
                        rng: np.random.Generator, with_density: bool = False):
    """One trajectory of the analytic flow on `mesh` = (pos, cells,
    node_type), the fields per frame in the converted-dataset schema:
    mesh_pos [T, N, 2], node_type [T, N, 1], cells [T, M, 3], velocity
    [T, N, 2] and, `with_density`, density [T, N, 1]. Equals
    `bsms_gnn_tpu/data/synthetic.py::generate_trajectory(n, n_frames, rng,
    with_density, mesh)`'s fields."""
    pos, cells, node_type = mesh
    n = pos.shape[0]
    phase = float(rng.uniform(0, 2 * np.pi))
    vel = np.zeros((n_frames, n, 2), np.float32)
    rho = np.zeros((n_frames, n, 1), np.float32)
    for ti in range(n_frames):
        vx, vy, r = _analytic_fields(pos, ti * 0.05, phase)
        vel[ti, :, 0], vel[ti, :, 1] = vx, vy
        rho[ti, :, 0] = r
    fields = {
        "mesh_pos": np.broadcast_to(pos, (n_frames, n, 2)).copy(),
        "node_type": np.broadcast_to(node_type, (n_frames, n, 1)).copy(),
        "cells": np.broadcast_to(cells, (n_frames,) + cells.shape).copy(),
        "velocity": vel,
    }
    if with_density:
        fields["density"] = rho
    return fields


def generate_synthetic_dataset(
    root: str,
    name: str = "synthetic_airfoil",
    n_train: int = 4,
    n_test: int = 2,
    n_nodes: int = 500,
    n_frames: int = 20,
    consistent_mesh: bool = True,
    with_density: bool = True,
    seed: int = 0,
) -> str:
    """Write a dataset of Delaunay meshes on the unit square (one shared
    mesh, or each trajectory its own of n_nodes / 2 to n_nodes nodes) and
    the analytic flow; returns its directory."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, name)
    shared = make_delaunay_mesh(n_nodes, rng) if consistent_mesh else None
    for split, count in (("train", n_train), ("test", n_test)):
        split_dir = os.path.join(base, split)
        os.makedirs(split_dir, exist_ok=True)
        for i in range(count):
            mesh = shared or make_delaunay_mesh(
                int(rng.integers(n_nodes // 2, n_nodes)), rng)
            fields = generate_trajectory(mesh, n_frames, rng, with_density)
            _write_h5(os.path.join(split_dir, f"{i}.h5"), fields)
    return base


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


def generate_synthetic_inflating_dataset(
    root: str,
    name: str = "synthetic_inflating_font",
    n_train: int = 2,
    n_test: int = 1,
    n_nodes: int = 400,
    n_frames: int = 10,
    seed: int = 0,
) -> str:
    """Closed-surface dataset in the inflating-font schema; returns its
    directory."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, name)
    for split, count in (("train", n_train), ("test", n_test)):
        split_dir = os.path.join(base, split)
        os.makedirs(split_dir, exist_ok=True)
        for i in range(count):
            fields = generate_inflating_trajectory(
                int(rng.integers(max(n_nodes // 2, 32), n_nodes)), n_frames,
                rng)
            _write_h5(os.path.join(split_dir, f"{i}.h5"), fields)
    return base


def make_tetra_mesh(n_nodes: int, rng: np.random.Generator):
    """A Delaunay-tetrahedralized block in the unit cube (deforming_plate-
    style cases): uniform points, the first n_nodes // 8 moved onto the
    face z = 0, which holds the handles. Returns (pos [N,3], cells [M,4],
    node_type [N,1])."""
    pos = rng.uniform(0.0, 1.0, size=(max(n_nodes, 16), 3))
    pos[: n_nodes // 8, 2] = 0.0  # the anchor face
    cells = Delaunay(pos).simplices.astype(np.int64)
    node_type = np.full((pos.shape[0], 1), NT_NORMAL, np.int32)
    node_type[np.isclose(pos[:, 2], 0.0)] = NT_HANDLE
    return pos.astype(np.float32), cells, node_type


def generate_tetra_trajectory(n_nodes: int, n_frames: int,
                              rng: np.random.Generator):
    """world_pos dynamics on `make_tetra_mesh(n_nodes, rng)`: a smooth
    squeeze of the block over time, stronger away from the anchor face.
    Returns a dict of per-frame arrays: mesh_pos [T, N, 3], node_type [T, N,
    1], cells [T, M, 4], world_pos [T, N, 3]."""
    pos, cells, node_type = make_tetra_mesh(n_nodes, rng)
    n = pos.shape[0]
    phase = float(rng.uniform(0, 2 * np.pi))
    world = np.zeros((n_frames, n, 3), np.float32)
    for ti in range(n_frames):
        s = 1.0 - 0.2 * np.sin(0.3 * ti + phase) * pos[:, 2]
        world[ti] = pos * s[:, None]
    return {
        "mesh_pos": np.broadcast_to(pos, (n_frames, n, 3)).copy(),
        "node_type": np.broadcast_to(node_type, (n_frames, n, 1)).copy(),
        "cells": np.broadcast_to(cells, (n_frames,) + cells.shape).copy(),
        "world_pos": world,
    }


def generate_synthetic_tetra_dataset(
    root: str,
    name: str = "synthetic_deforming_plate",
    n_train: int = 2,
    n_test: int = 1,
    n_nodes: int = 300,
    n_frames: int = 10,
    seed: int = 0,
) -> str:
    """Tetra-mesh dataset in the deforming_plate schema (each trajectory
    its own block of n_nodes / 2 to n_nodes nodes); returns its
    directory."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, name)
    for split, count in (("train", n_train), ("test", n_test)):
        split_dir = os.path.join(base, split)
        os.makedirs(split_dir, exist_ok=True)
        for i in range(count):
            fields = generate_tetra_trajectory(
                int(rng.integers(n_nodes // 2, n_nodes)), n_frames, rng)
            _write_h5(os.path.join(split_dir, f"{i}.h5"), fields)
    return base
