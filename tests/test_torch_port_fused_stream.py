"""The port's `fused` method on unwindowed hierarchies against the JAX
package on the CPU: kernel 12's (v2) and kernel 11's (v1) plain forwards
(f32, bf16, row n_pad − 1 included) against the JAX kernels
(`fused_edge_phase`, `fused_edge_mlp_aggregate`, interpret mode), their
plain backwards through the autograd Functions against `jax.vjp` under a
random cotangent, the GMP on both routes, and v1 on a windowed level with
two world-space streams (output and every gradient against `gmp_apply`),
and the weights' carry-across. The whole model on these cases is
`test_torch_port_fused_stream_model.py`'s.

Two cases, each the default unwindowed hierarchy of depth 2 (edge_block
128) with T0's dense forms dropped, so that T0 runs kernel 8's route as the
headline meshes' sparse transitions do:
- `plain` (v2, kernel 12): a 300-node graded airfoil, not reordered, the
  airfoil model cut to latent 128, hidden 1;
- `world` (v1, kernel 11): a 600-node sphere, the inflating-font model on
  the `fused` method cut to latent 128, hidden 1 (world edges).
The windowed GMP runs on the scrambled 24×24 grid's windowed hierarchy
(window 128, edge_block 512). The JAX weights reach the port through
`convert.params_from_numpy` unchanged: the GMP's parameter layout does not
depend on the method.

Tolerances, relative to the largest |value| of the reference unless said
otherwise:
- kernels 11 and 12 and the GMP (`KERNEL_TOL`): f32 sums in another order
  through the MLPs (1e-4); in bf16 both sides round the same operands, and
  an f32 sum in another order can put an intermediate on the other side of
  a bf16 rounding step (2^-8 relative), so 2e-2;
- the forward and rollout, f32: 5e-4; bf16: 2e-2 of the predicted delta's
  scale;
- gradients: each within 1e-3 of its RMS (f32);
- the trainer: losses 1e-6 through the gate (no model runs), 1e-4 after
  the updates; each tensor's update within 1e-2 of its RMS.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_hierarchy import scrambled_grid
from test_torch_port_pallas import sparse_t0
from test_torch_port_train import assert_close, leaf
from test_torch_port_weights import (
    jax_state_with_stats,
    jax_to_nested,
    port_simulator,
)

from bsms_gnn_tpu.config import ModelConfig as JaxModelConfig
from bsms_gnn_tpu.data.synthetic import make_graded_airfoil_mesh as jax_airfoil
from bsms_gnn_tpu.data.synthetic import make_sphere_mesh as jax_sphere
from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.models.simulator import init_simulator
from bsms_gnn_tpu.ops.message import gmp_apply, init_gmp
from bsms_gnn_tpu.ops.pallas.fused_gmp import (
    fused_edge_mlp_aggregate as jax_v1,
)
from bsms_gnn_tpu.ops.pallas.fused_gmp import fused_edge_phase as jax_v2
from bsms_gnn_tpu_torch.config import Config, ModelConfig, inflating_font_config
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.data.synthetic import (
    NT_NORMAL,
    generate_inflating_trajectory,
    make_graded_airfoil_mesh,
    make_sphere_mesh,
)
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.models.simulator import Simulator
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp_stream as fgs
from bsms_gnn_tpu_torch.ops.message import GMP

AIRFOIL_NODES, SPHERE_NODES, DEPTH, HIDDEN, C = 300, 600, 2, 1, 128
KERNEL_TOL = {"f32": 1e-4, "bf16": 2e-2}
F32_TOL = 5e-4
BF16_REL = 2e-2
GRAD_F32_TOL = 1e-3
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
CASES = ("plain", "world")


def _hierarchies(cells, n, pos64):
    hj = sparse_t0(jax_build(jax_flat_edge(cells, "tri"), DEPTH, n, pos64),
                   lambda o, **kw: o.replace(**kw))
    ht = build_hierarchy(to_flat_edge(cells, "tri"), DEPTH, n, pos64)
    ht = to_device(sparse_t0(ht, dataclasses.replace), "cpu")
    assert all(lvl.window == 0 and lvl.edge_block == 128 for lvl in ht.levels)
    assert ht.transitions[0].down_op.dense is None
    return hj, ht


@functools.lru_cache(maxsize=None)
def _case(name):
    if name == "plain":
        pos, cells, node_type = make_graded_airfoil_mesh(
            AIRFOIL_NODES, np.random.default_rng(0))
        ref = jax_airfoil(AIRFOIL_NODES, np.random.default_rng(0))
        jcfg = JaxModelConfig(latent_dim=C, hidden_layer=HIDDEN,
                              unet_depth=DEPTH, aggregation="fused")
        tcfg = Config(model=ModelConfig(latent_dim=C, hidden_layer=HIDDEN,
                                        unet_depth=DEPTH))
    else:
        pos, cells, node_type = make_sphere_mesh(SPHERE_NODES,
                                                 np.random.default_rng(0))
        ref = jax_sphere(SPHERE_NODES, np.random.default_rng(0))
        jcfg = JaxModelConfig(latent_dim=C, hidden_layer=HIDDEN,
                              unet_depth=DEPTH, out_dim=3, pos_dim=3,
                              world_edges=True, aggregation="fused")
        tcfg = inflating_font_config(unet_depth=DEPTH, hidden_layer=HIDDEN,
                                     aggregation="fused")
    for a, b in zip(ref, (pos, cells, node_type)):
        np.testing.assert_array_equal(a, b)
    n, pd = len(pos), pos.shape[1]
    hj, ht = _hierarchies(cells, n, pos.astype(np.float64))
    state = jax_state_with_stats(jcfg)
    sim = port_simulator(tcfg.model, state)
    n_pad = ht.levels[0].n_pad_nodes
    rng = np.random.default_rng(1)
    node_in = np.zeros((n_pad, 3 + pd + 1), np.float32)
    node_in[:n, 3:3 + pd] = pos
    node_in[:n, -1] = node_type[:, 0]
    mask = np.zeros((n_pad, 1), np.float32)
    mask[:n, 0] = node_type[:, 0] == NT_NORMAL
    if name == "plain":
        node_in[:n, :3] = rng.standard_normal((n, 3))
        target = node_in[:, :3] + 0.1 * rng.standard_normal(
            (n_pad, 3)).astype(np.float32) * mask
        train_in = node_in
    else:
        node_in[:n, :3] = 1.05 * pos + 0.02 * rng.standard_normal((n, 3))
        # The train frames: frames 0 and 1 of the inflating trajectory.
        traj = generate_inflating_trajectory(SPHERE_NODES, 2,
                                             np.random.default_rng(0))
        np.testing.assert_array_equal(traj["mesh_pos"][0], pos)
        train_in = node_in.copy()
        train_in[:n, :3] = traj["world_pos"][0]
        target = np.zeros((n_pad, 3), np.float32)
        target[:n] = traj["world_pos"][1]
    assert 0 < mask.sum() < n
    return dict(hj=hj, ht=ht, jcfg=jcfg, tcfg=tcfg, state=state, sim=sim,
                node_in=node_in, mask=mask, train=(train_in, target),
                dyn_dims=(3,) if name == "world" else ())


@pytest.fixture(params=CASES)
def case(request):
    c = _case(request.param)
    yield c
    c["sim"].zero_grad(set_to_none=True)


def _tail(mlp):
    return tuple(mlp.weights[1:]), tuple(mlp.biases[1:])


# -- kernels 12 and 11 --------------------------------------------------------


def _kernel_inputs(case, seed):
    """Level 0, level 0's down-GMP tail weights and seeded inputs: for v2
    (the plain case) zi [E_pad, C] and xj [n_pad, C], for v1 pre [E_pad, C];
    and a cotangent g [n_pad, C]."""
    lj, lt = case["hj"].levels[0], case["ht"].levels[0]
    rng = np.random.default_rng(seed)
    rows = [rng.standard_normal((lt.n_pad_edges, C)).astype(np.float32)]
    if not case["dyn_dims"]:
        rows.append(rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32))
    g = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    mj = case["state"].params.process.down_gmps[0].mlp_edge
    mt = case["sim"].process.down_gmps[0].mlp_edge
    return lj, lt, rows, g, mj, mt


def _jax_kernel(case):
    return jax_v1 if case["dyn_dims"] else jax_v2


def _port_kernel(case):
    """(differentiable entry, its plain forward, its plain backward)."""
    if case["dyn_dims"]:
        return (fgs.fused_edge_mlp_aggregate, fgs.fused_edge_mlp_aggregate_plain,
                fgs.fused_edge_mlp_aggregate_bwd_plain)
    return (fgs.fused_edge_phase, fgs.fused_edge_phase_plain,
            fgs.fused_edge_phase_bwd_plain)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_kernel_forward_matches_jax(case, dt):
    """Every row, n_pad − 1 (where the last block's pad slots land)
    included."""
    lj, lt, rows, _, mj, mt = _kernel_inputs(case, 3)
    jd, td = DTYPES[dt]
    want = _jax_kernel(case)(lj, *(jnp.asarray(r).astype(jd) for r in rows),
                                 *_tail(mj))
    entry, plain, _ = _port_kernel(case)
    plain.calls = 0
    with torch.no_grad():
        got = entry(lt, *(torch.tensor(r).to(td) for r in rows),
                    *(list(t) for t in _tail(mt)))
    assert plain.calls == 1
    assert got.dtype == torch.float32 and got.shape == (lt.n_pad_nodes, C)
    assert_close(got, want, KERNEL_TOL[dt], dt)
    last = lt.n_pad_nodes - 1
    recv, inb = fgs.in_block(lt)
    assert bool((inb & (recv == last)).any())  # pad slots land on the row
    assert bool((~inb).any())  # and other pad slots are masked
    assert_close(got[last], np.asarray(want)[last], KERNEL_TOL[dt], "last")


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_kernel_backward_matches_jax_vjp(case, dt):
    """The plain backward through the autograd Function: dzi and dxj (v2)
    or dpre (v1), dW and db against jax.vjp of the JAX kernel under a
    random cotangent; the masked slots' cotangent is zero."""
    lj, lt, rows, g, mj, mt = _kernel_inputs(case, 4)
    jd, td = DTYPES[dt]
    ws_j, bs_j = _tail(mj)
    fn = _jax_kernel(case)
    _, vjp = jax.vjp(lambda *a: fn(lj, *a), *(jnp.asarray(r).astype(jd)
                                              for r in rows), ws_j, bs_j)
    *d_rows, dws, dbs = vjp(jnp.asarray(g))

    entry, _, bwd_plain = _port_kernel(case)
    leaves = [leaf(r, dt) for r in rows]
    ws = [w.detach().clone().requires_grad_() for w in _tail(mt)[0]]
    bs = [b.detach().clone().requires_grad_() for b in _tail(mt)[1]]
    bwd_plain.calls = 0
    entry(lt, *leaves, ws, bs).backward(torch.tensor(g))
    assert bwd_plain.calls == 1
    tol = KERNEL_TOL[dt]
    for x, want, what in zip(leaves, d_rows, ("d_edge_rows", "dxj")):
        assert x.grad.dtype == td
        assert_close(x.grad, want, tol, what)
    for i, (w, b) in enumerate(zip(ws, bs)):
        assert_close(w.grad, dws[i], tol, f"dW{i}")
        assert_close(b.grad, dbs[i], tol, f"db{i}")
    _, inb = fgs.in_block(lt)
    assert (leaves[0].grad[~inb] == 0).all()


# -- the GMP -------------------------------------------------------------------


def _gmp_grads(gj, level, x, wpos, cot, dyn_dims):
    """JAX's f32 output, x gradient and parameter gradients of
    vdot(gmp_apply(method="fused"), cot)."""

    def out(xx, p):
        return gmp_apply(p, level, xx, None if wpos is None
                         else jnp.asarray(wpos), "fused", None,
                         dyn_dims or None)

    _, (gx, gp) = jax.value_and_grad(
        lambda xx, p: jnp.vdot(out(xx, p), jnp.asarray(cot)),
        argnums=(0, 1))(jnp.asarray(x), gj)
    return np.asarray(out(jnp.asarray(x), gj)), gx, jax_to_nested(gp)


def _check_gmp(gt, lt, x, wpos, cot, want):
    y, gx, gp = want
    xt = leaf(x, "f32")
    # The model's world positions carry no gradient (they come from the
    # input frame), so none is asked for here.
    pos = None if wpos is None else torch.tensor(wpos)
    out = gt(lt, xt, None, pos, "fused")
    assert_close(out, y, KERNEL_TOL["f32"], "output")
    (out * torch.tensor(cot)).sum().backward()
    assert_close(xt.grad, gx, KERNEL_TOL["f32"], "dx")
    for mlp in ("mlp_edge", "mlp_node"):
        mod = getattr(gt, mlp)
        for kind in ("weights", "biases"):
            for i, w in enumerate(gp[mlp][kind]):
                assert_close(getattr(mod, kind)[i].grad, w, KERNEL_TOL["f32"],
                             f"{mlp}.{kind}.{i}")


def _gmp_inputs(lt, n_world, seed):
    """x, a cotangent and world positions. The cotangent is zero on the pad
    rows, as the model gives it (the loss is masked, the transitions weigh
    pad rows 0 and the node phase is row-local): the sender sums of the
    gathers' backwards (kernel 8 here, JAX's ELL sum on its `fused` method)
    differ in row n_pad − 1, which only the last block's pad slots reach,
    and those carry gradient only from a cotangent on pad rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    cot = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    cot[lt.n_nodes:] = 0.0
    wpos = None
    if n_world:
        wpos = np.zeros((lt.n_pad_nodes, n_world), np.float32)
        wpos[:lt.n_nodes] = rng.standard_normal((lt.n_nodes, n_world))
    return x, cot, wpos


def test_gmp_matches_jax(case):
    """Output, x gradient and every parameter gradient of level 0's down
    GMP against jax.grad of `gmp_apply(method="fused")`, f32, through kernel
    12's route (plain) or kernel 11's (world). The other levels' GMPs run in
    the whole-model tests."""
    lj, lt = case["hj"].levels[0], case["ht"].levels[0]
    gj = case["state"].params.process.down_gmps[0]
    gt = case["sim"].process.down_gmps[0]
    x, cot, wpos = _gmp_inputs(lt, sum(case["dyn_dims"]), 10)
    want = _gmp_grads(gj, lj, x, wpos, cot, case["dyn_dims"])
    _, plain, bwd_plain = _port_kernel(case)
    plain.calls = bwd_plain.calls = 0
    _check_gmp(gt, lt, x, wpos, cot, want)
    assert plain.calls == bwd_plain.calls == 1


def test_gmp_bf16_matches_jax(case):
    lj, lt = case["hj"].levels[1], case["ht"].levels[1]
    gj = case["state"].params.process.up_gmps[0]
    gt = case["sim"].process.up_gmps[0]
    x, _, wpos = _gmp_inputs(lt, sum(case["dyn_dims"]), 12)
    want = gmp_apply(gj, lj, jnp.asarray(x).astype(jnp.bfloat16),
                     None if wpos is None else jnp.asarray(wpos), "fused",
                     jnp.bfloat16, case["dyn_dims"] or None)
    with torch.no_grad():
        got = gt(lt, torch.tensor(x).to(torch.bfloat16), torch.bfloat16,
                 None if wpos is None else torch.tensor(wpos), "fused")
    assert str(want.dtype) == str(got.dtype).removeprefix("torch.")
    assert_close(got, want, KERNEL_TOL["bf16"], "bf16")


def test_two_stream_gmp_on_a_windowed_level_runs_v1():
    """Two world-space streams on a windowed level (edge_block 512): both
    sides take v1 over every slot (no window, no residual), kernel 11 in the
    port; output and every gradient, f32."""
    pos, cells = scrambled_grid()
    layout = dict(edge_block=512, window=128)
    lj = jax_build(jax_flat_edge(cells, "tri"), 1, len(pos), pos,
                   **layout).levels[0]
    lt = to_device(build_hierarchy(to_flat_edge(cells, "tri"), 1, len(pos),
                                   pos, **layout), "cpu").levels[0]
    assert lt.window > 0 and lt.edge_block == 512
    dyn = (3, 2)
    gj = init_gmp(jax.random.PRNGKey(5), C, HIDDEN, 2, fiber_dims=dyn + (2,))
    gt = GMP(C, HIDDEN, 2, fiber_dims=dyn + (2,))
    gt.load_state_dict(params_from_numpy(jax_to_nested(gj)))
    x, cot, wpos = _gmp_inputs(lt, sum(dyn), 13)
    want = _gmp_grads(gj, lj, x, wpos, cot, dyn)
    fgs.fused_edge_mlp_aggregate_plain.calls = 0
    _check_gmp(gt, lt, x, wpos, cot, want)
    assert fgs.fused_edge_mlp_aggregate_plain.calls == 1


def test_weights_carry_across_methods():
    """The same JAX parameter tree loads into the port's model on either
    method: the GMP's parameter layout does not depend on it."""
    for world in (False, True):
        cfg = dict(latent_dim=C, hidden_layer=HIDDEN, unet_depth=DEPTH,
                   world_edges=world, pos_dim=3 if world else 2)
        trees = [jax_to_nested(init_simulator(jax.random.PRNGKey(0),
                                              JaxModelConfig(aggregation=m,
                                                             **cfg)).params)
                 for m in ("fused", "pallas")]
        dicts = [params_from_numpy(t) for t in trees]
        assert {k: v.shape for k, v in dicts[0].items()} == {
            k: v.shape for k, v in dicts[1].items()}
        for m in ("fused", "pallas"):
            sim = Simulator(ModelConfig(aggregation=m, **cfg), device="cpu")
            sim.load_state_dict(dicts[0])
