"""Size buckets of a variable-mesh dataset (counterpart of the sizing part
of `bsms_gnn_tpu/data/pipeline.py::plan_buckets`, over meshes held in
memory: the HDF5 reading and the JSON plan cache are not ported).

The meshes split into `size_buckets` groups by their level-0 node count
(`np.array_split` of the sorted order). Each group pins every level's
shapes to the group maxima, so every member pads to the same hierarchy
shapes: node buckets (real nodes + 1, rounded up to max(pad_multiple,
128, window / 2)), edge buckets (the members' block-aligned layouts at
those node buckets) and, on windowed datasets, the residual sub-layouts
(E_pad, ELL width) the window tables leave, (0, 0) where no member has
one. The ELL widths (the largest in- or out-degree) are the JAX plan's;
the port builds no ELL table and reads none of them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from bsms_gnn_tpu_torch.config import DatasetConfig
from bsms_gnn_tpu_torch.graph.bistride import BistrideLevels
from bsms_gnn_tpu_torch.graph.hierarchy import (
    NODE_BLOCK,
    _pad_level,
    layout_edge_count,
)


@dataclass
class BucketPlan:
    groups: List[dict]  # {"node_buckets", "edge_buckets", "ell_buckets",
    #                      "resid_buckets" ([e_pad, k] per level, or None)}
    mesh_group: List[int]  # the group of each mesh, in the input order

    def for_mesh(self, i: int) -> dict:
        """`pad_levels` / `build_hierarchy` keyword arguments of mesh i."""
        g = self.groups[self.mesh_group[i]]
        return {"node_buckets": g["node_buckets"],
                "edge_buckets": g["edge_buckets"],
                "resid_buckets": (None if g["resid_buckets"] is None
                                  else [tuple(r) for r in g["resid_buckets"]])}


def _ell_width(*index_arrays) -> int:
    """The widest row of the ELL tables over these index arrays (≥ 1)."""
    return max([1] + [int(np.bincount(a).max()) for a in index_arrays
                      if len(a)])


def plan_buckets(levels: Sequence[BistrideLevels],
                 cfg: DatasetConfig) -> BucketPlan:
    """The bucket plan of a dataset whose meshes' bi-stride levels are
    `levels` (each built from the mesh as its hierarchy will be: Morton-
    ordered when `cfg.window`), by `cfg.size_buckets`, `pad_multiple`,
    `edge_block` and `window`."""
    if cfg.consist_mesh:
        raise ValueError("a consistent-mesh dataset pads its one mesh; it "
                         "has no bucket plan")
    if cfg.window < 0:
        raise ValueError("window=-1 (per-level auto widths) cannot be "
                         "pinned by a bucket plan")
    sizes = [[g.num_nodes for g in lv.graphs] for lv in levels]
    order = sorted(range(len(levels)), key=lambda i: sizes[i][0])
    k = max(1, int(cfg.size_buckets))
    members = [list(g) for g in np.array_split(np.asarray(order), k)
               if len(g)]
    m = max(cfg.pad_multiple, NODE_BLOCK)
    if cfg.window:
        m = max(m, cfg.window // 2)

    groups, mesh_group = [], [0] * len(levels)
    for gi, idx in enumerate(members):
        n_levels = len(sizes[idx[0]])
        n_max = np.max([sizes[i] for i in idx], axis=0)
        node_buckets = [int(-(-(n + 1) // m) * m) for n in n_max]
        edge_buckets = [0] * n_levels
        ell_buckets = [0] * n_levels
        resid_buckets = [[0, 0] for _ in range(n_levels)]
        for i in idx:
            mesh_group[i] = gi
            for l, g in enumerate(levels[i].graphs):
                if cfg.window:
                    lg = _pad_level(
                        g, node_buckets[l], np.zeros(g.flat_edges.shape[1]),
                        edge_block=cfg.edge_block, window=cfg.window,
                        compact=False)
                    real = lg.edge_mask > 0
                    edge_buckets[l] = max(edge_buckets[l], lg.n_pad_edges)
                    ell_buckets[l] = max(ell_buckets[l], _ell_width(
                        lg.receivers[real], lg.senders[real]))
                    r = lg.resid
                    if r is not None:
                        rr = r.edge_mask > 0
                        resid_buckets[l][0] = max(resid_buckets[l][0],
                                                  r.n_pad_edges)
                        resid_buckets[l][1] = max(
                            resid_buckets[l][1],
                            _ell_width(r.receivers[rr], r.senders[rr]))
                else:
                    counts = np.bincount(g.flat_edges[1],
                                         minlength=node_buckets[l])
                    edge_buckets[l] = max(
                        edge_buckets[l],
                        layout_edge_count(counts, node_buckets[l],
                                          cfg.edge_block))
                    ell_buckets[l] = max(ell_buckets[l], int(counts.max()))
        groups.append({"node_buckets": node_buckets,
                       "edge_buckets": edge_buckets,
                       "ell_buckets": ell_buckets,
                       "resid_buckets": resid_buckets if cfg.window else None})
    return BucketPlan(groups, mesh_group)
