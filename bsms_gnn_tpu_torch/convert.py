"""Carry weights, normalizer statistics and the train state across from
the JAX package.

The JAX side hands over plain data: `SimulatorParams` flattened to nested
dicts (one per dataclass, keyed by field name) and tuples of numpy arrays,
with weights stored [in, out] as `MLPParams` stores them, and
`NormalizerState` as a dict of its fields. The port stores weights [in, out]
too, so a tree path maps one to one onto a `state_dict` key:
`process.down_gmps[0].mlp_edge.weights[1]` ↔
`"process.down_gmps.0.mlp_edge.weights.1"`.

The train state (`train_state_from_jax` / `train_state_to_jax`): JAX's
`TrainState` with numpy leaves (`jax.tree_util.tree_map(np.asarray,
state)`) holds the step (every train step, the warmup gate's included),
the simulator and optax's state: `chain(clip_by_global_norm,
adamw(schedule))` keeps `ScaleByAdamState(count, mu, nu)` and the
schedule's `count`, both the number of applied updates, and
`MultiSteps` wraps it with its `mini_step`, `gradient_step` (applied
updates) and `acc_grads` (the running mean). The port's `Trainer`
keeps the same as per-parameter AdamW `step` / `exp_avg` / `exp_avg_sq`
and its `_step`, `updates`, `mini_step` and `acc_grads`
(`Trainer.state_dict()`). The two AdamWs compute the same update from the
same moments (optax's weight decay joins the scaled update; PyTorch's
shrinks the weights first, the same step in exact arithmetic).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

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


def _jax_nested(obj):
    """A flax.struct tree with numpy leaves → nested dicts (pytree fields
    only) and tuples of arrays, as `params_from_numpy` takes them."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _jax_nested(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.metadata.get("pytree_node", True)}
    if isinstance(obj, (tuple, list)):
        return tuple(_jax_nested(v) for v in obj)
    return np.asarray(obj)


def _find(tree, fields):
    """The first namedtuple in `tree` (tuples and namedtuples walked in
    order) whose fields are `fields`."""
    if getattr(tree, "_fields", None) == fields:
        return tree
    if isinstance(tree, tuple):
        for item in tree:
            found = _find(item, fields)
            if found is not None:
                return found
    return None


def _normalizer_state(state) -> Dict[str, Any]:
    """A JAX `NormalizerState` → the dict `Trainer.state_dict()` keeps."""
    out: Dict[str, Any] = {k: torch.as_tensor(np.array(getattr(state, k),
                                                       np.float32))
                           for k in _NORM_ARRAYS}
    out.update({k: float(getattr(state, k)) for k in _NORM_SCALARS})
    return out


def train_state_from_jax(state) -> Dict[str, Any]:
    """JAX's `TrainState` with numpy leaves → a `Trainer.load_state_dict`
    input (without a noise generator state: JAX draws its noise from the
    step's key). Raises ValueError where optax's counts disagree."""
    opt = state.opt_state
    multi = getattr(opt, "inner_opt_state", None) is not None
    inner = opt.inner_opt_state if multi else opt
    adam = _find(inner, ("count", "mu", "nu"))
    sched = _find(inner, ("count",))
    if adam is None or sched is None:
        raise ValueError("no ScaleByAdamState / ScaleByScheduleState in the "
                         "optimizer state")
    updates = int(adam.count)
    if int(sched.count) != updates or (
            multi and int(opt.gradient_step) != updates):
        raise ValueError(f"optax's update counts disagree: adam "
                         f"{int(adam.count)}, schedule {int(sched.count)}"
                         + (f", MultiSteps {int(opt.gradient_step)}"
                            if multi else ""))
    mu = params_from_numpy(_jax_nested(adam.mu))
    nu = params_from_numpy(_jax_nested(adam.nu))
    return {
        "params": params_from_numpy(_jax_nested(state.sim.params)),
        "norm_in": _normalizer_state(state.sim.norm_in),
        "norm_out": _normalizer_state(state.sim.norm_out),
        # PyTorch's AdamW has no state before its first update.
        "adam": ({} if updates == 0 else {
            k: {"step": torch.tensor(float(updates)), "exp_avg": mu[k],
                "exp_avg_sq": nu[k]} for k in mu}),
        "step": int(state.step),
        "updates": updates,
        "mini_step": int(opt.mini_step) if multi else 0,
        "acc_grads": (params_from_numpy(_jax_nested(opt.acc_grads))
                      if multi else None),
    }


def _numpy_fields(d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in d.items()}


def train_state_to_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """A `Trainer.state_dict()` → plain data for JAX's `TrainState`:
    "step", "params" (nested as `params_to_numpy` gives them), "norm_in" /
    "norm_out" (`NormalizerState` fields), "count" (ScaleByAdamState's and
    the schedule's), "mu", "nu" (nested like "params"; zeros before the
    first update), "mini_step", "gradient_step" and "acc_grads" (nested;
    zeros where the trainer holds no running mean). The last three are
    MultiSteps' (`gradient_accumulation_steps` > 1) and unused without
    it."""
    params = state["params"]
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}

    def moment(name):
        return params_to_numpy({k: state["adam"][k][name]
                                if k in state["adam"] else zeros[k]
                                for k in params})

    acc: Optional[Dict[str, torch.Tensor]] = state["acc_grads"]
    return {
        "step": int(state["step"]),
        "params": params_to_numpy(params),
        "norm_in": _numpy_fields(state["norm_in"]),
        "norm_out": _numpy_fields(state["norm_out"]),
        "count": int(state["updates"]),
        "mu": moment("exp_avg"),
        "nu": moment("exp_avg_sq"),
        "mini_step": int(state["mini_step"]),
        "gradient_step": int(state["updates"]),
        "acc_grads": params_to_numpy(zeros if acc is None else acc),
    }
