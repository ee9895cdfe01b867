"""Carry weights and normalizer statistics across from the JAX package.

The JAX side hands over plain data: `SimulatorParams` flattened to nested
dicts (one per dataclass, keyed by field name) and tuples of numpy arrays,
with weights stored [in, out] as `MLPParams` stores them, and
`NormalizerState` as a dict of its fields. The port stores weights [in, out]
too, so a tree path maps one to one onto a `state_dict` key:
`process.down_gmps[0].mlp_edge.weights[1]` ↔
`"process.down_gmps.0.mlp_edge.weights.1"`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from bsms_gnn_tpu_torch.device import resolve_device
from bsms_gnn_tpu_torch.models.normalizer import NormalizerState

_NORM_ARRAYS = ("acc_weight", "num_accumulations", "e_x", "e_x2")
_NORM_SCALARS = ("max_accumulations", "unit", "std_epsilon")


def params_from_numpy(tree: Any) -> Dict[str, torch.Tensor]:
    """Nested dicts/tuples of arrays → a `state_dict` for `Simulator`
    (`sim.load_state_dict(params_from_numpy(tree))`)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (tuple, list)):
            items = ((str(i), v) for i, v in enumerate(node))
        else:
            out[prefix] = torch.from_numpy(np.array(node, np.float32))
            return
        for k, v in items:
            walk(v, f"{prefix}.{k}" if prefix else k)

    walk(tree, "")
    return out


def params_to_numpy(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse: numeric key parts become tuple positions."""
    root: Dict[str, Any] = {}
    for key, value in state_dict.items():
        node = root
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value.detach().cpu().numpy()

    def fold(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return tuple(fold(node[str(i)]) for i in range(len(node)))
        return {k: fold(v) for k, v in node.items()}

    return fold(root)


def normalizer_from_numpy(d: Dict[str, Any], device=None,
                          dtype=torch.float32) -> NormalizerState:
    device = resolve_device(device)
    arrays = {k: torch.as_tensor(np.array(d[k]), dtype=dtype, device=device)
              for k in _NORM_ARRAYS}
    return NormalizerState(**arrays, **{k: float(d[k]) for k in _NORM_SCALARS})


def normalizer_to_numpy(state: NormalizerState) -> Dict[str, Any]:
    out: Dict[str, Any] = {k: getattr(state, k).cpu().numpy()
                           for k in _NORM_ARRAYS}
    out.update({k: getattr(state, k) for k in _NORM_SCALARS})
    return out
