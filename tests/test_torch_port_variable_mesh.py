"""The port's variable-mesh path (cylinder_flow on bucketed hierarchies,
the `fused` method) against the JAX package on the CPU: the GMP whose
out-of-window edges ride the residual sub-level (v3's mini-layout branch:
kernel 9), the explicit transition convs `edge_conv_down` / `edge_conv_up`
(kernel 1's level form and kernel 9, or kernel 8 unwindowed) with their
VJPs, the simulator forward on the windowed and the unwindowed group
(f32 with taps, and bf16), and a closed-loop rollout. The JAX kernels run
in interpret mode. The gradients of the loss and `Trainer` are
`test_torch_port_variable_mesh_train.py`'s.

The group is `test_torch_port_buckets.py`'s: two Delaunay meshes of 450
and 600 nodes (Morton-ordered when windowed), depth 2, window 256,
edge_block 512, one size group. The model is cylinder_flow's cut to
depth 2 and hidden 1 (latent 128); the frame is frame 0 of the analytic
flow on the mesh, the mask the cylinder mask.

Tolerances on the rows of real nodes (row n_pad − 1 takes the pad slots
and is not compared), relative to the largest |value| of the reference:
the GMP, the convs and the forward's taps 1e-4 (f32 sums in other
orders); the prediction 5e-4 and the rollout 1e-3; bf16 2e-2 of the
predicted delta's scale (a rounding flip early in the forward spreads).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_buckets import WINDOW, group
from test_torch_port_train import assert_close, leaf
from test_torch_port_weights import (
    jax_state_with_stats,
    jax_to_nested,
    port_simulator,
)

from bsms_gnn_tpu.config import ModelConfig as JaxModelConfig
from bsms_gnn_tpu.models.normalizer import normalize as jax_normalize
from bsms_gnn_tpu.models.simulator import simulator_forward, split_node_input
from bsms_gnn_tpu.ops.bsgmp import bsgmp_apply
from bsms_gnn_tpu.ops.dense import mlp_apply
from bsms_gnn_tpu.ops.message import edge_conv_down as jax_conv_down
from bsms_gnn_tpu.ops.message import edge_conv_up as jax_conv_up
from bsms_gnn_tpu.ops.message import gmp_apply
from bsms_gnn_tpu.training.rollout import rollout_trajectory as jax_rollout
from bsms_gnn_tpu_torch.config import cylinder_flow_config
from bsms_gnn_tpu_torch.data.synthetic import (
    cylinder_mask,
    generate_trajectory,
)
from bsms_gnn_tpu_torch.graph.hierarchy import to_device
from bsms_gnn_tpu_torch.ops.kernels import segment_sum_accum as ssa
from bsms_gnn_tpu_torch.ops.kernels import windowed
from bsms_gnn_tpu_torch.ops.message import edge_conv_down, edge_conv_up
from bsms_gnn_tpu_torch.training.rollout import rollout_trajectory

DEPTH, HIDDEN, C = 2, 1, 128
TOL, F32_TOL, BF16_REL = 1e-4, 5e-4, 2e-2


@functools.lru_cache(maxsize=None)
def model():
    jcfg = JaxModelConfig(latent_dim=C, hidden_layer=HIDDEN, unet_depth=DEPTH,
                          out_dim=2, pos_dim=2, aggregation="fused")
    state = jax_state_with_stats(jcfg)
    tcfg = cylinder_flow_config(unet_depth=DEPTH, hidden_layer=HIDDEN)
    return jcfg, tcfg, state, port_simulator(tcfg.model, state)


@functools.lru_cache(maxsize=None)
def frames(window):
    """Per mesh of the group: (JAX hierarchy, port hierarchy on the CPU,
    node_in frame 0, target frame 1, mask), numpy arrays."""
    meshes, _, pairs = group(window)
    out = []
    for i, ((pos, cells, node_type), (hj, ht)) in enumerate(zip(meshes,
                                                                 pairs)):
        fields = generate_trajectory((pos, cells, node_type), 2,
                                     np.random.default_rng(i))
        n, n_pad = len(pos), ht.levels[0].n_pad_nodes
        node_in = np.zeros((n_pad, 5), np.float32)
        node_in[:n, :2] = fields["velocity"][0]
        node_in[:n, 2:4] = pos
        node_in[:n, 4] = node_type[:, 0]
        target = np.zeros((n_pad, 2), np.float32)
        target[:n] = fields["velocity"][1]
        mask = np.zeros((n_pad, 1), np.float32)
        mask[:n] = cylinder_mask(node_type)
        assert 0 < mask.sum() < n
        out.append((hj, to_device(ht, "cpu"), node_in, target, mask))
    return out


@pytest.fixture
def sim():
    s = model()[3]
    yield s
    s.zero_grad(set_to_none=True)


def _real(a, n):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))[:n]


def _tap_level(name):
    """The level of a tap: down{i} at level i, up{i} at depth − 1 − i."""
    if name == "bottom":
        return DEPTH
    i = int(name[-1])
    return i if name.startswith("down") else DEPTH - 1 - i


# -- the data ---------------------------------------------------------------------


@pytest.mark.parametrize("n,seed", [(450, 5), (1885, 0)])
def test_mesh_and_trajectory_match_jax(n, seed):
    """`make_delaunay_mesh` and `generate_trajectory` (three frames, the
    same seeded phase) equal the JAX package's exactly."""
    from bsms_gnn_tpu.data.synthetic import generate_trajectory as jax_traj
    from bsms_gnn_tpu.data.synthetic import make_delaunay_mesh as jax_mesh
    from bsms_gnn_tpu_torch.data.synthetic import make_delaunay_mesh

    mesh = make_delaunay_mesh(n, np.random.default_rng(seed))
    for a, b in zip(mesh, jax_mesh(n, np.random.default_rng(seed))):
        np.testing.assert_array_equal(a, b)
    got = generate_trajectory(mesh, 3, np.random.default_rng(7))
    want, _ = jax_traj(n, 3, np.random.default_rng(7), False, mesh)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# -- the GMP and the convs ------------------------------------------------------


def test_gmp_with_residual_matches_jax(sim):
    """Level 0's down GMP on the 600-node mesh, whose level 0 has a
    residual sub-level: output, x gradient and every parameter gradient
    against jax.grad of `gmp_apply(method="fused")`; kernel 9 runs in the
    forward (the accumulate) and the backward (the two residual gathers)."""
    hj, ht = frames(WINDOW)[1][:2]
    lj, lt = hj.levels[0], ht.levels[0]
    assert lt.resid is not None and lt.cresid is None
    n = lt.n_nodes
    gj = model()[2].params.process.down_gmps[0]
    gt = sim.process.down_gmps[0]
    rng = np.random.default_rng(30)
    x = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    cot = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    cot[n:] = 0.0

    def out(xx, p):
        return gmp_apply(p, lj, xx, None, "fused", None)

    def out_and_grads(xx, p):
        return out(xx, p), jax.grad(
            lambda a, q: jnp.vdot(out(a, q), jnp.asarray(cot)),
            argnums=(0, 1))(xx, p)

    y, (gx, gp) = jax.jit(out_and_grads)(jnp.asarray(x), gj)
    gp = jax_to_nested(gp)

    ssa.segment_sum_accum_plain.calls = 0
    xt = leaf(x, "f32")
    got = gt(lt, xt, None, None, "fused")
    assert ssa.segment_sum_accum_plain.calls == 1
    assert_close(got[:n], _real(y, n), TOL, "output")
    (got * torch.tensor(cot)).sum().backward()
    assert ssa.segment_sum_accum_plain.calls == 3
    assert_close(xt.grad[:n], _real(gx, n), TOL, "dx")
    for mlp in ("mlp_edge", "mlp_node"):
        mod = getattr(gt, mlp)
        for kind in ("weights", "biases"):
            for i, w in enumerate(gp[mlp][kind]):
                assert_close(getattr(mod, kind)[i].grad, w, TOL,
                             f"{mlp}.{kind}.{i}")


@pytest.mark.parametrize("window", [WINDOW, 0])
@pytest.mark.parametrize("lvl", [0, 1])
def test_edge_conv_pair_matches_jax(window, lvl):
    """`edge_conv_down` / `edge_conv_up` with the level's own weights on
    the 450-node mesh (windowed: kernel 1's level form, plus kernel 9 for
    level 0's residual; unwindowed: kernel 8), and each one's VJP, which is
    the other direction, against the JAX pair (`method="fused"`)."""
    hj, ht = frames(window)[0][:2]
    lj, lt = hj.levels[lvl], ht.levels[lvl]
    n = lt.n_nodes
    rng = np.random.default_rng(31 + lvl)
    x = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    g = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    g[n:] = 0.0
    windowed.windowed_conv_plain.calls = 0
    for fj, ft in ((jax_conv_down, edge_conv_down), (jax_conv_up, edge_conv_up)):
        want, vjp = jax.vjp(lambda a: fj(lj, a, None, "fused"), jnp.asarray(x))
        (dwant,) = vjp(jnp.asarray(g))
        xt = leaf(x, "f32")
        out = ft(lt, xt)
        out.backward(torch.tensor(g))
        assert_close(out[:n], _real(want, n), TOL, "conv")
        assert_close(xt.grad[:n], _real(dwant, n), TOL, "conv vjp")
    assert windowed.windowed_conv_plain.calls == (4 if window else 0)


def test_edge_conv_bf16_matches_jax():
    """bf16 rows: the level form rounds ew to bf16, the residual's
    messages round to bf16, as the JAX conv does."""
    hj, ht = frames(WINDOW)[0][:2]
    lj, lt = hj.levels[0], ht.levels[0]
    x = np.random.default_rng(33).standard_normal(
        (lt.n_pad_nodes, C)).astype(np.float32)
    n = lt.n_nodes
    for fj, ft in ((jax_conv_down, edge_conv_down), (jax_conv_up, edge_conv_up)):
        want = fj(lj, jnp.asarray(x).astype(jnp.bfloat16), None, "fused")
        with torch.no_grad():
            got = ft(lt, torch.tensor(x).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
        assert_close(got[:n], _real(want, n), 1e-2, "bf16 conv")


# -- the simulator ------------------------------------------------------------


@pytest.mark.parametrize("window", [WINDOW, 0])
def test_forward_f32_matches_jax_with_taps(sim, window):
    """The prediction and each GMP's output on the 600-node mesh (one JAX
    compile for both)."""
    jcfg, _, state, _ = model()
    hj, ht, node_in, _, mask = frames(window)[1]
    n = ht.levels[0].n_nodes

    def jax_forward_and_taps(ni, m):
        pred = simulator_forward(state.params, state.norm_in, state.norm_out,
                                 hj, ni, m, jcfg, None)
        latent, _, _ = split_node_input(ni, jcfg.pos_dim)
        x0 = mlp_apply(state.params.encode,
                       jax_normalize(state.norm_in, latent))
        taps = {}
        bsgmp_apply(state.params.process, hj, x0, None, method="fused",
                    tap=taps.__setitem__)
        return pred, x0, taps

    want, x0, taps_j = jax.jit(jax_forward_and_taps)(
        jnp.asarray(node_in), jnp.asarray(mask))
    with torch.no_grad():
        got = sim(ht, torch.from_numpy(node_in), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy()[:n], np.asarray(want)[:n],
                               rtol=F32_TOL, atol=F32_TOL)
    taps_t = {}
    with torch.no_grad():
        sim.process(ht, torch.tensor(np.asarray(x0)),
                    tap=lambda k, v: taps_t.__setitem__(k, v.numpy()))
    assert sorted(taps_j) == sorted(taps_t) and len(taps_t) == 2 * DEPTH + 1
    for k, v in taps_j.items():
        n_k = ht.levels[_tap_level(k)].n_nodes
        assert_close(torch.tensor(taps_t[k][:n_k]), _real(v, n_k), TOL, k)


def test_forward_bf16_matches_jax(sim):
    jcfg, _, state, _ = model()
    hj, ht, node_in, _, mask = frames(WINDOW)[1]
    n = ht.levels[0].n_nodes
    want = np.asarray(jax.jit(
        lambda ni, m: simulator_forward(state.params, state.norm_in,
                                        state.norm_out, hj, ni, m, jcfg,
                                        jnp.bfloat16)
    )(jnp.asarray(node_in), jnp.asarray(mask)))[:n]
    with torch.no_grad():
        got = sim(ht, torch.from_numpy(node_in), torch.from_numpy(mask),
                  torch.bfloat16).numpy()[:n]
    scale = np.abs(want - node_in[:n, :2]).max()
    assert scale > 0
    assert np.abs(got - want).max() <= BF16_REL * scale


def test_rollout_matches_jax(sim):
    """Three closed-loop steps on the 600-node mesh (Dirichlet nodes
    clamped to the initial condition)."""
    jcfg, _, state, _ = model()
    hj, ht, node_in, _, mask = frames(WINDOW)[1]
    n = ht.levels[0].n_nodes
    want = np.asarray(jax.jit(
        lambda ic, m: jax_rollout(state, hj, ic, m, 3, jcfg)
    )(jnp.asarray(node_in), jnp.asarray(mask)))
    got = rollout_trajectory(sim, ht, torch.from_numpy(node_in),
                             torch.from_numpy(mask), 3).numpy()
    assert got.shape == want.shape == (3, node_in.shape[0], 2)
    np.testing.assert_allclose(got[:, :n], want[:, :n], rtol=2 * F32_TOL,
                               atol=2 * F32_TOL)
