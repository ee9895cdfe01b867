"""One trajectory: its fields, its cached padded hierarchy and the padded
per-frame model inputs (counterpart of `bsms_gnn_tpu/data/trajectory.py`).

The reader takes the configured fields of one trajectory, Morton-reorders
the mesh when the dataset is windowed (`node_perm` maps a new node id to
the original one; `window` < 0 is the JAX CLI's `window="auto"`, each
level's width tuned), builds or loads the cached hierarchy (one cache shared
by the trajectories of a consistent-mesh dataset, else one each; with the
bucket plan's sizes on variable-mesh datasets), moves it to the device
once and keeps it there, and assembles the inputs [output fields,
mesh_pos, node_type] per frame, zero-padded to the hierarchy's N_pad rows.

`TrajectoryReader(cfg, file_path, ...)` reads an HDF5 file (with h5py,
imported there); `TrajectoryReader.from_fields(cfg, fields, cache_dir,
cache_name, ...)` takes the fields held in memory.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from bsms_gnn_tpu_torch.config import DatasetConfig
from bsms_gnn_tpu_torch.data.datasets import get_mask
from bsms_gnn_tpu_torch.graph.hierarchy import (
    Hierarchy,
    load_or_build_hierarchy,
    to_device,
)
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.graph.order import morton_perm


def _pad_rows(x: np.ndarray, n_pad: int) -> np.ndarray:
    """Zero-pad axis -2 (nodes) to n_pad."""
    pad = [(0, 0)] * x.ndim
    pad[-2] = (0, n_pad - x.shape[-2])
    return np.pad(x, pad)


def read_fields(cfg: DatasetConfig, file_path: str) -> Dict[str, np.ndarray]:
    """The configured fields of one HDF5 trajectory."""
    import h5py

    with h5py.File(file_path, "r") as f:
        return {name: np.asarray(f[name]) for name in cfg.field_names}


def cache_name_for(cfg: DatasetConfig, file_path: str) -> str:
    """The hierarchy cache's name for a trajectory file: "shared" on a
    consistent-mesh dataset, else the file's; "_mrt" added on windowed
    datasets, whose Morton-ordered levels must not meet the original
    order's cache."""
    name = ("shared" if cfg.consist_mesh
            else os.path.splitext(os.path.basename(file_path))[0])
    return name + "_mrt" if cfg.window else name


class TrajectoryReader:
    """`device` is where the hierarchy goes (None: the CUDA card, which
    raises without one). `shared` is a reader of the same consistent-mesh
    dataset whose hierarchy, host and device, this one takes instead of
    loading its own. The buckets are the bucket plan's for this file
    (`data.pipeline.BucketPlan.for_file`)."""

    def __init__(self, cfg: DatasetConfig, file_path: str,
                 node_buckets: Optional[List[int]] = None,
                 edge_buckets: Optional[List[int]] = None,
                 ell_buckets: Optional[List[int]] = None,
                 resid_buckets: Optional[List] = None, device=None,
                 shared: Optional["TrajectoryReader"] = None):
        self.file_path = file_path
        self._setup(cfg, read_fields(cfg, file_path),
                    os.path.dirname(file_path),
                    cache_name_for(cfg, file_path),
                    dict(node_buckets=node_buckets, edge_buckets=edge_buckets,
                         ell_buckets=ell_buckets,
                         resid_buckets=resid_buckets), device, shared)

    @classmethod
    def from_fields(cls, cfg: DatasetConfig, fields: Dict[str, np.ndarray],
                    cache_dir: str, cache_name: str, device=None,
                    shared: Optional["TrajectoryReader"] = None,
                    **buckets) -> "TrajectoryReader":
        """A reader of a trajectory held in memory (`fields`: each
        configured field with a leading time axis, as the files hold
        them); its hierarchy is cached under `cache_dir` as `cache_name`
        (with "_mrt" added on windowed datasets, as the file path does)."""
        self = cls.__new__(cls)
        self.file_path = None
        self._setup(cfg, dict(fields), cache_dir,
                    cache_name + ("_mrt" if cfg.window else ""), buckets,
                    device, shared)
        return self

    def _setup(self, cfg, fields, cache_dir, cache_name, buckets, device,
               shared):
        self.cfg = cfg
        self.cells = fields["cells"][0]
        self.mesh_pos0 = np.asarray(fields["mesh_pos"][0], np.float64)
        self.n_nodes = self.mesh_pos0.shape[0]
        # An input cannot be the last frame: it has no target.
        self.length = fields["mesh_pos"].shape[0] - 1

        self.node_perm: Optional[np.ndarray] = None
        if cfg.window:
            perm = morton_perm(self.mesh_pos0)
            inv = np.empty(len(perm), np.int64)
            inv[perm] = np.arange(len(perm))
            self.node_perm = perm
            self.cells = inv[self.cells.astype(np.int64)].astype(
                self.cells.dtype)
            for name, arr in fields.items():
                if (name != "cells" and arr.ndim >= 2
                        and arr.shape[1] == self.n_nodes):
                    fields[name] = arr[:, perm]
            self.mesh_pos0 = np.asarray(fields["mesh_pos"][0], np.float64)

        if shared is not None:
            if shared.n_nodes != self.n_nodes:
                raise ValueError(f"a mesh of {self.n_nodes} nodes cannot "
                                 f"share a hierarchy of {shared.n_nodes}")
            self.hierarchy, self.hd = shared.hierarchy, shared.hd
        else:
            self.hierarchy: Hierarchy = load_or_build_hierarchy(
                cache_dir, cache_name, to_flat_edge(self.cells, cfg.mesh_type),
                cfg.unet_depth, self.n_nodes, self.mesh_pos0,
                pad_multiple=cfg.pad_multiple, edge_block=cfg.edge_block,
                # A negative window: each level's width tuned (per mesh,
                # so off the bucketed path).
                window="auto" if cfg.window < 0 else cfg.window, **buckets)
            self.hd = to_device(self.hierarchy, device)
        self.n_pad = self.hierarchy.levels[0].n_pad_nodes

        # Inputs [T, N_pad, C + pos + 1], outputs [T, N_pad, C], masks
        # [T, N_pad, 1]: the output fields, then mesh_pos, then node_type.
        out_keys = list(cfg.output_field_names)
        inputs = np.concatenate(
            [fields[k].astype(np.float32) for k in out_keys]
            + [fields["mesh_pos"].astype(np.float32),
               fields["node_type"].astype(np.float32)], axis=-1)
        outputs = np.concatenate(
            [fields[k].astype(np.float32) for k in out_keys], axis=-1)
        mask = get_mask(cfg.name, fields["node_type"])

        self.node_in = _pad_rows(inputs, self.n_pad)
        self.node_out = _pad_rows(outputs, self.n_pad)
        self.node_mask = _pad_rows(mask.astype(np.float32), self.n_pad)

    def __len__(self) -> int:
        return self.length

    def sample(self, t: int):
        """(node_in[t], target = outputs[t+1], mask[t]): the one-step
        supervised pair."""
        return self.node_in[t], self.node_out[t + 1], self.node_mask[t]

    def full(self):
        """The whole trajectory for rollout: inputs [T-1, ...], targets
        [T-1, ...] (frame t's target is outputs[t+1]), masks [T-1, ...]."""
        return self.node_in[:-1], self.node_out[1:], self.node_mask[:-1]

    def level_sizes(self):
        """(per-level real node counts, per-level real edge counts)."""
        return ([g.n_nodes for g in self.hierarchy.levels],
                [g.n_edges for g in self.hierarchy.levels])
