"""Weights and normalizer statistics carried between the JAX package and
the PyTorch port (`bsms_gnn_tpu_torch/convert.py`), and the JAX-side
flattening the other port tests share."""

import dataclasses

import jax
import numpy as np
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from bsms_gnn_tpu.config import ModelConfig as JaxModelConfig
from bsms_gnn_tpu.models.normalizer import normalizer_accumulate
from bsms_gnn_tpu.models.simulator import SimulatorState, init_simulator
from bsms_gnn_tpu_torch.config import ModelConfig
from bsms_gnn_tpu_torch.convert import (
    normalizer_from_numpy,
    normalizer_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from bsms_gnn_tpu_torch.models.simulator import Simulator


def jax_to_nested(obj):
    """A flax.struct tree → nested dicts (pytree fields only) and tuples of
    numpy arrays."""
    if dataclasses.is_dataclass(obj):
        return {
            f.name: jax_to_nested(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if f.metadata.get("pytree_node", True)
        }
    if isinstance(obj, (tuple, list)):
        return tuple(jax_to_nested(v) for v in obj)
    return np.asarray(obj)


def nested_to_jax(template, tree):
    """Rebuild a flax.struct tree shaped like `template` from nested data."""
    if dataclasses.is_dataclass(template):
        return template.replace(**{
            k: nested_to_jax(getattr(template, k), v) for k, v in tree.items()
        })
    if isinstance(template, tuple):
        return tuple(nested_to_jax(t, v) for t, v in zip(template, tree))
    return jax.numpy.asarray(tree)


def normalizer_to_dict(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def small_configs(depth=3, hidden=2):
    jcfg = JaxModelConfig(latent_dim=128, hidden_layer=hidden,
                          unet_depth=depth, aggregation="fused")
    tcfg = ModelConfig(latent_dim=128, hidden_layer=hidden, unet_depth=depth,
                       aggregation="fused")
    return jcfg, tcfg


def jax_state_with_stats(jcfg, n_rows=200, seed=0) -> SimulatorState:
    """init_simulator plus three normalizer accumulations over seeded
    frames, so std is not the 1e-8 floor."""
    state = init_simulator(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    n_in, n_out = state.norm_in, state.norm_out
    for _ in range(3):
        n_in = normalizer_accumulate(
            n_in, rng.normal(0.5, 2.0, (n_rows, jcfg.out_dim + 1)))
        n_out = normalizer_accumulate(
            n_out, rng.normal(-0.1, 0.3, (n_rows, jcfg.out_dim)))
    return state.replace(norm_in=n_in, norm_out=n_out)


def port_simulator(tcfg, state: SimulatorState) -> Simulator:
    sim = Simulator(tcfg, torch.Generator().manual_seed(1), device="cpu")
    sim.load_state_dict(params_from_numpy(jax_to_nested(state.params)))
    sim.norm_in = normalizer_from_numpy(normalizer_to_dict(state.norm_in),
                                        device="cpu")
    sim.norm_out = normalizer_from_numpy(normalizer_to_dict(state.norm_out),
                                         device="cpu")
    return sim


def test_params_round_trip_jax_port_jax():
    jcfg, tcfg = small_configs()
    state = jax_state_with_stats(jcfg)
    sim = port_simulator(tcfg, state)
    back = nested_to_jax(state.params, params_to_numpy(sim.state_dict()))
    a, b = jax.tree_util.tree_leaves(state.params), jax.tree_util.tree_leaves(back)
    assert len(a) == len(b) == len(sim.state_dict())
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        state.params)


def test_state_dict_keys_follow_the_jax_tree():
    jcfg, tcfg = small_configs(depth=2, hidden=1)
    state = jax_state_with_stats(jcfg)
    sd = params_from_numpy(jax_to_nested(state.params))
    sim = Simulator(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(sd) == set(sim.state_dict())
    w = sd["process.down_gmps.1.mlp_edge.weights.0"]
    want = state.params.process.down_gmps[1].mlp_edge.weights[0]
    assert tuple(w.shape) == (2 * 128 + 3, 128)  # stored [in, out]
    np.testing.assert_array_equal(w.numpy(), np.asarray(want))


def test_normalizer_round_trip():
    jcfg, _ = small_configs()
    state = jax_state_with_stats(jcfg)
    d = normalizer_to_dict(state.norm_in)
    back = normalizer_to_numpy(normalizer_from_numpy(d, device="cpu"))
    assert set(back) == set(d)
    for k in d:
        np.testing.assert_array_equal(np.asarray(back[k]), d[k])


def test_normalizer_accumulate_matches_jax():
    """The port's accumulate (f32 state, masked and unmasked) and
    normalize / denormalize against the JAX package's."""
    from bsms_gnn_tpu.models import normalizer as jn
    from bsms_gnn_tpu_torch.models import normalizer as tn

    rng = np.random.default_rng(4)
    js, ts = jn.init_normalizer(4), tn.init_normalizer(4, device="cpu")
    for i in range(4):
        data = rng.normal(1.0, 3.0, (64, 4)).astype(np.float32)
        mask = None if i % 2 else (rng.uniform(size=(64, 1)) < 0.7).astype(
            np.float32)
        js = jn.normalizer_accumulate(js, data, mask)
        ts = tn.normalizer_accumulate(
            ts, torch.tensor(data), None if mask is None else torch.tensor(mask))
    for k in ("acc_weight", "num_accumulations", "e_x", "e_x2"):
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=1e-6)
    x = rng.standard_normal((10, 4)).astype(np.float32)
    np.testing.assert_allclose(tn.normalize(ts, torch.tensor(x)).numpy(),
                               np.asarray(jn.normalize(js, x)), rtol=1e-5)
    np.testing.assert_allclose(tn.denormalize(ts, torch.tensor(x)).numpy(),
                               np.asarray(jn.denormalize(js, x)), rtol=1e-5)
