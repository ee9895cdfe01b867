"""Batches of variable-mesh datasets (counterpart of the collation in
`bsms_gnn_tpu/data/pipeline.py`: `stack_hierarchies`; the HDF5 sampler
that feeds it, and its `Batch`, are not ported).

Each trajectory of a variable-mesh dataset has its own mesh, padded to its
size group's buckets (`graph/buckets.py`), and its own hierarchy, moved to
the device once and kept, as JAX's readers keep theirs. A batch of B such
samples runs on the union of their hierarchies (`graph.hierarchy.union`):
one hierarchy of B·N_pad rows per level, block-diagonal, on which the
batch [B, N_pad, C] runs every route and kernel as one sample does, each
kernel once a call. JAX stacks the hierarchies leaf-wise and vmaps the
forward over them (`simulator_forward_auto`), which computes the same
function sample by sample. The real node and edge counts are metadata
only, so the samples' may differ; JAX's `stack_hierarchies`, which keeps
them as pytree aux data, refuses two different meshes.
"""

from __future__ import annotations

from typing import Sequence

import torch

from bsms_gnn_tpu_torch.graph.hierarchy import Hierarchy, union


def stack_hierarchies(hs: Sequence[Hierarchy]) -> Hierarchy:
    """The union of B device hierarchies (each through `to_device`) of one
    size group, on their device: every index offset by its sample's base,
    the derived tables of `to_device` included. Hierarchies of different
    padded shapes, devices or kinds (unbucketed ones, which carry fused
    transition operators) raise ValueError."""
    hs = list(hs)
    if not hs:
        raise ValueError("no hierarchy to stack")
    devices = {lv.senders.device if isinstance(lv.senders, torch.Tensor)
               else None for h in hs for lv in h.levels}
    if len(devices) != 1 or None in devices:
        raise ValueError("stack_hierarchies takes hierarchies on one device "
                         "(graph.hierarchy.to_device)")
    return union(hs)
