"""Dataset registry and per-dataset loss masks (counterpart of
`bsms_gnn_tpu/data/datasets.py`): a mask marks the loss-valid nodes (1)
against the Dirichlet and outgoing-boundary nodes (0), by node type."""

from __future__ import annotations

import numpy as np

# MeshGraphNets node-type codes (DeepMind meta.json convention).
NT_NORMAL = 0
NT_OBSTACLE = 1
NT_AIRFOIL = 2
NT_HANDLE = 3
NT_INFLOW = 4
NT_OUTFLOW = 5
NT_WALL = 6


def _mask_normal_only(node_type: np.ndarray) -> np.ndarray:
    """Valid ⇔ type == 0 (airfoil; the contact and cloth cases)."""
    return (node_type == NT_NORMAL).astype(np.float32)


def _mask_cylinder(node_type: np.ndarray) -> np.ndarray:
    """Valid ⇔ type ∈ {0 interior, 5 outflow}."""
    return ((node_type == NT_NORMAL) | (node_type == NT_OUTFLOW)).astype(
        np.float32)


_MASKS = {
    "airfoil": _mask_normal_only,
    "synthetic_airfoil": _mask_normal_only,
    "cylinder_flow": _mask_cylinder,
    "synthetic_cylinder_flow": _mask_cylinder,
    "deforming_plate": _mask_normal_only,
    "synthetic_deforming_plate": _mask_normal_only,
    "flag_simple": _mask_normal_only,
    "inflating_font": _mask_normal_only,
    "synthetic_inflating_font": _mask_normal_only,
}

DATASET_HANDLER = sorted(_MASKS)


def get_mask(dataset_name: str, node_type: np.ndarray) -> np.ndarray:
    """node_type [..., N, 1] → mask [..., N, 1] float32."""
    if dataset_name not in _MASKS:
        raise KeyError(
            f"Unknown dataset {dataset_name!r}; known: {DATASET_HANDLER}")
    return _MASKS[dataset_name](np.asarray(node_type))
