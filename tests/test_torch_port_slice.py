"""The port's serving slice against the JAX package on the CPU: the whole
forward (f32 with per-level taps, and bf16), and a closed-loop rollout.

Mesh: a 24×24 triangulated grid with scrambled ids, depth 3, window 128,
edge_block 512, latent 128, hidden 2. On the JAX side this runs all four
Pallas kernels in interpret mode, and its levels and transitions both carry
compact residuals and lack them in places."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from conftest import make_grid_mesh
from test_torch_port_weights import (
    jax_state_with_stats,
    port_simulator,
    small_configs,
)

from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.models.normalizer import normalize as jax_normalize
from bsms_gnn_tpu.models.simulator import simulator_forward, split_node_input
from bsms_gnn_tpu.ops.bsgmp import bsgmp_apply
from bsms_gnn_tpu.ops.dense import mlp_apply
from bsms_gnn_tpu.training import rollout as jax_rollout_mod
from bsms_gnn_tpu.training.rollout import rollout_trajectory as jax_rollout
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.training import rollout as port_rollout_mod
from bsms_gnn_tpu_torch.training.rollout import rollout_trajectory

DEPTH = 3
# f32: both sides compute in true f32 (HIGHEST on the JAX side) but sum in
# different orders through ~20 dense layers and LayerNorms.
F32_TOL = 5e-4
# bf16: every dot operand is rounded to 8 bits of mantissa (relative step
# 2^-8 ≈ 3.9e-3); a rounding that lands on the other side of a tie in one
# of ~20 layers moves an output by a few steps. The bound is relative to
# the scale of the predicted delta (measured: 0.8% of it).
BF16_REL = 2e-2


@pytest.fixture(scope="module")
def case():
    pos, cells = make_grid_mesh(24, 24)
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(pos))
    inv = np.empty(len(pos), np.int64)
    inv[perm] = np.arange(len(pos))
    pos, cells = pos[perm], inv[cells]
    n = len(pos)
    kw = dict(edge_block=512, window=128)
    hj = jax_build(jax_flat_edge(cells, "tri"), DEPTH, n, pos, **kw)
    ht = to_device(build_hierarchy(to_flat_edge(cells, "tri"), DEPTH, n, pos,
                                   **kw), "cpu")
    jcfg, tcfg = small_configs(depth=DEPTH, hidden=2)
    state = jax_state_with_stats(jcfg)
    sim = port_simulator(tcfg, state)

    n_pad = hj.levels[0].n_pad_nodes
    node_in = np.zeros((n_pad, 3 + 2 + 1), np.float32)
    node_in[:n, :3] = rng.standard_normal((n, 3))
    node_in[:n, 3:5] = pos / 24.0
    node_type = np.where(rng.uniform(size=n) < 0.1, 4, 0)
    node_in[:n, 5] = node_type
    mask = np.zeros((n_pad, 1), np.float32)
    mask[:n, 0] = node_type == 0
    return dict(hj=hj, ht=ht, jcfg=jcfg, state=state, sim=sim,
                node_in=node_in, mask=mask)


def test_slice_runs_every_kind_of_level(case):
    ht = case["ht"]
    with_cr = [lvl.cresid is not None for lvl in ht.levels[:DEPTH + 1]]
    ops = [op for t in ht.transitions for op in (t.down_op, t.up_op)]
    assert any(with_cr) and not all(with_cr)
    assert all(op.window > 0 for op in ops)
    assert any(op.cresid is not None for op in ops)
    assert any(op.cresid is None for op in ops)


def test_forward_f32_matches_jax_with_taps(case):
    hj, ht, jcfg, state, sim = (case[k] for k in
                                ("hj", "ht", "jcfg", "state", "sim"))
    node_in, mask = case["node_in"], case["mask"]
    want = np.asarray(jax.jit(
        lambda ni, m: simulator_forward(state.params, state.norm_in,
                                        state.norm_out, hj, ni, m, jcfg)
    )(jnp.asarray(node_in), jnp.asarray(mask)))
    with torch.no_grad():
        got = sim(ht, torch.from_numpy(node_in), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)

    # Per-level GMP outputs from the same encoded input.
    latent, _, _ = split_node_input(jnp.asarray(node_in), jcfg.pos_dim)
    x0 = mlp_apply(state.params.encode, jax_normalize(state.norm_in, latent))

    def jax_taps(x):
        taps = {}
        bsgmp_apply(state.params.process, hj, x, method="fused",
                    tap=taps.__setitem__)
        return taps

    taps_j = jax.jit(jax_taps)(x0)
    taps_t = {}
    with torch.no_grad():
        sim.process(ht, torch.tensor(np.asarray(x0)),
                    tap=lambda k, v: taps_t.__setitem__(k, v.numpy()))
    assert sorted(taps_j) == sorted(taps_t) and len(taps_t) == 2 * DEPTH + 1
    for k in taps_j:
        np.testing.assert_allclose(taps_t[k], np.asarray(taps_j[k]),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=k)


@pytest.mark.parametrize("io_dtype", ["", "float32"])
def test_forward_bf16_matches_jax(case, io_dtype):
    hj, ht, jcfg, state, sim = (case[k] for k in
                                ("hj", "ht", "jcfg", "state", "sim"))
    node_in, mask = case["node_in"], case["mask"]
    jcfg = dataclasses.replace(jcfg, io_dtype=io_dtype)
    want = np.asarray(jax.jit(
        lambda ni, m: simulator_forward(state.params, state.norm_in,
                                        state.norm_out, hj, ni, m, jcfg,
                                        jnp.bfloat16)
    )(jnp.asarray(node_in), jnp.asarray(mask)))
    cfg = sim.cfg
    sim.cfg = dataclasses.replace(cfg, io_dtype=io_dtype)
    try:
        with torch.no_grad():
            got = sim(ht, torch.from_numpy(node_in), torch.from_numpy(mask),
                      torch.bfloat16).numpy()
    finally:
        sim.cfg = cfg
    assert got.dtype == want.dtype == np.float32
    delta_scale = np.abs(want - node_in[:, :3]).max()
    assert np.abs(got - want).max() <= BF16_REL * delta_scale


def test_rollout_matches_jax(case):
    hj, ht, jcfg, state, sim = (case[k] for k in
                                ("hj", "ht", "jcfg", "state", "sim"))
    node_in, mask = case["node_in"], case["mask"]
    want = np.asarray(jax.jit(
        lambda ic, m: jax_rollout(state, hj, ic, m, 3, jcfg)
    )(jnp.asarray(node_in), jnp.asarray(mask)))
    got = rollout_trajectory(sim, ht, torch.from_numpy(node_in),
                             torch.from_numpy(mask), 3).numpy()
    assert got.shape == want.shape == (3, node_in.shape[0], 3)
    np.testing.assert_allclose(got, want, rtol=2 * F32_TOL, atol=2 * F32_TOL)


def test_rollout_metrics_and_streaming_stats_match_jax():
    rng = np.random.default_rng(9)
    preds = rng.standard_normal((4, 50, 3))
    targets = preds + 0.1 * rng.standard_normal((4, 50, 3))
    mask = (rng.uniform(size=(50, 1)) < 0.8).astype(np.float32)
    want = jax_rollout_mod.rollout_metrics(preds, targets, mask)
    got = port_rollout_mod.rollout_metrics(preds, targets, mask)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    sj, st = jax_rollout_mod.StreamingStats(3), port_rollout_mod.StreamingStats(3)
    for batch in (preds[0], preds[1:3]):
        sj.add(batch)
        st.add(batch)
    np.testing.assert_array_equal(st.mean(), sj.mean())
    np.testing.assert_array_equal(st.std(), sj.std())
