"""The port's `"fusedK"` method against the JAX package on the CPU, at the
GMP and kernel level: kernel 14's plain forward and backward against JAX's
v5 (`fused_edge_phase_win_k`, interpret mode) at K = 2, 3 and 4; the
routing of a `"fusedK"` GMP, read from the plain versions' call counts
(the density gate to kernel 4 or 14, a skip-empty gated level to v2,
world edges to kernel 13); the bounds on K. The whole model on this path
is `test_torch_port_interleave_model.py`'s.

The case: `make_graded_airfoil_mesh(2000)` Morton-ordered, depth 4,
window 256, edge_block 512, whose levels 3 and 4 have 6.0 and 9.0 chunks
per 128-node block (the gate's 6 passes), the others fewer.

Tolerances are JAX's own for v5 against v3 (`tests/test_windowed.py:
960-1020`): the forward within 2e-5 (rtol and atol), every gradient within
rtol 2e-3 / atol 5e-4 (dW sums O(100) chunk products in another order).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from bsms_gnn_tpu.data.synthetic import make_graded_airfoil_mesh as jax_airfoil
from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.graph.order import reorder_mesh as jax_reorder
from bsms_gnn_tpu.ops.pallas.fused_gmp import fused_edge_phase_win_k as jax_v5
from bsms_gnn_tpu_torch.config import MAX_INTERLEAVE, ModelConfig, split_interleave
from bsms_gnn_tpu_torch.data.synthetic import make_graded_airfoil_mesh
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.graph.order import reorder_mesh
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp, fused_gmp_dyn, fused_gmp_k
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp_stream
from bsms_gnn_tpu_torch.ops.message import GMP

NODES, DEPTH, C = 2000, 4, 128
LAYOUT = dict(edge_block=512, window=256)
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=5e-4)


@functools.lru_cache(maxsize=None)
def airfoil():
    """(JAX hierarchy, the port's on the CPU, positions, node types) of
    the Morton-ordered 2,000-node airfoil."""
    pos, cells, nt = make_graded_airfoil_mesh(NODES, np.random.default_rng(0))
    pos, cells, (nt,), _ = reorder_mesh(pos, cells, (nt,))
    pos = pos.astype(np.float64)
    jp, jc, _ = jax_airfoil(NODES, np.random.default_rng(0))
    jp, jc, _, _ = jax_reorder(jp, jc)
    np.testing.assert_array_equal(jc, cells)
    hj = jax_build(jax_flat_edge(jc, "tri"), DEPTH, len(pos), pos, **LAYOUT)
    ht = to_device(build_hierarchy(to_flat_edge(cells, "tri"), DEPTH,
                                   len(pos), pos, **LAYOUT), "cpu")
    return hj, ht, pos, nt


def density(level):
    return (level.n_pad_edges // level.edge_block) / (level.n_pad_nodes // 128)


def test_the_gate_passes_levels_3_and_4():
    _, ht, _, _ = airfoil()
    assert [fused_gmp_k.passes_gate(g) for g in ht.levels] == (
        [False] * 3 + [True] * 2)
    assert [density(g) for g in ht.levels[3:]] == [6.0, 9.0]


def _inputs(level, seed=7):
    """JAX's own v5 test's recipe: unit-normal rows (zero on pad rows),
    fiber weights and cotangent, tail weights and biases at 0.05."""
    rng = np.random.default_rng(seed)
    mask = np.asarray(level.node_mask, np.float32)

    def rows():
        return (rng.standard_normal((level.n_pad_nodes, C)) * mask).astype(
            np.float32)

    xwi, xj, cot = rows(), rows(), rows()
    wf8 = rng.standard_normal((8, C)).astype(np.float32)
    ws = [(0.05 * rng.standard_normal((C, C))).astype(np.float32)
          for _ in range(3)]
    bs = [(0.05 * rng.standard_normal(C)).astype(np.float32)
          for _ in range(3)]
    return xwi, xj, wf8, ws, bs, cot


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("lvl", [0, 3])
def test_plain_v5_matches_jax_v5(k, lvl):
    """Kernel 14's plain forward and, through its autograd Function, its
    plain backward and kernel 7's against JAX's v5 with the gate off
    (`min_density=0`): the aggregate and the gradients of xwi, xj, wf8 and
    every tail weight and bias under one cotangent."""
    hj, ht, _, _ = airfoil()
    lj, lt = hj.levels[lvl], ht.levels[lvl]
    xwi, xj, wf8, ws, bs, cot = _inputs(lt)

    def jloss(a, b, w, wss, bss):
        out = jax_v5(lj, a, b, w, wss, bss, k, min_density=0)
        return jnp.vdot(out, cot), out

    (_, want), grads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        *(jnp.asarray(v) for v in (xwi, xj, wf8)),
        tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))

    args = [torch.tensor(v, requires_grad=True) for v in (xwi, xj, wf8)]
    tw = [torch.tensor(w, requires_grad=True) for w in ws]
    tb = [torch.tensor(b, requires_grad=True) for b in bs]
    fused_gmp_k.fused_edge_phase_win_k_plain.calls = 0
    fused_gmp_k.fused_edge_phase_win_k_bwd_plain.calls = 0
    got = fused_gmp_k.fused_edge_phase_win_k(lt, *args, tw, tb, k,
                                             min_density=0)
    (got * torch.tensor(cot)).sum().backward()
    assert fused_gmp_k.fused_edge_phase_win_k_plain.calls == 1
    assert fused_gmp_k.fused_edge_phase_win_k_bwd_plain.calls == 1
    n = lt.n_nodes
    np.testing.assert_allclose(got.detach().numpy()[:n],
                               np.asarray(want)[:n], **FWD_TOL)
    gx, gj, gw8, gws, gbs = grads
    for name, t, w in [("xwi", args[0], gx), ("xj", args[1], gj),
                       ("wf8", args[2], gw8),
                       *((f"W{i}", t, w) for i, (t, w) in
                         enumerate(zip(tw, gws))),
                       *((f"b{i}", t, w) for i, (t, w) in
                         enumerate(zip(tb, gbs)))]:
        g, w = t.grad.numpy(), np.asarray(w)
        if g.shape[0] == lt.n_pad_nodes:
            g, w = g[:n], w[:n]
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)


# -- routing -------------------------------------------------------------------


@pytest.fixture
def counts():
    plains = {
        "v3": fused_gmp.fused_edge_phase_win_plain,
        "v5": fused_gmp_k.fused_edge_phase_win_k_plain,
        "v2": fused_gmp_stream.fused_edge_phase_plain,
        "v4": fused_gmp_dyn.fused_edge_phase_win_dyn_plain,
        "v3_bwd": fused_gmp.fused_edge_phase_win_bwd_plain,
        "v5_bwd": fused_gmp_k.fused_edge_phase_win_k_bwd_plain,
    }

    def read():
        return {k: f.calls for k, f in plains.items()}

    for f in plains.values():
        f.calls = 0
    yield read
    for f in plains.values():
        f.calls = 0


def _gmp(world=False):
    return GMP(C, 1, 2, torch.Generator().manual_seed(0),
               fiber_dims=(3, 2) if world else None)


def _x(level, seed=1):
    return torch.randn(level.n_pad_nodes, C,
                       generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("lvl,route", [(0, "v3"), (2, "v3"), (3, "v5"),
                                       (4, "v5")])
def test_the_density_gate_routes_each_level(counts, lvl, route):
    """A `"fused4"` GMP runs kernel 14 (forward, then its backward) on the
    levels that pass the gate and kernel 4 (then kernel 5) on the others;
    nothing else."""
    level = airfoil()[1].levels[lvl]
    x = _x(level).requires_grad_()
    _gmp()(level, x, method="fused4").square().sum().backward()
    want = dict.fromkeys(("v3", "v5", "v2", "v4", "v3_bwd", "v5_bwd"), 0)
    want.update({route: 1, f"{route}_bwd": 1})
    assert counts() == want


def test_a_skip_empty_gated_level_takes_v2(counts):
    """JAX's v5 refuses a skip-empty layout and `gmp_apply` falls back to
    v2 on the whole level (in- and out-of-window slots, no residual
    phase): the port takes kernel 12 there, with the same result as the
    `"fused"` GMP's v2 route on the same level."""
    level = dataclasses.replace(airfoil()[1].levels[3], skip_empty=True)
    x = _x(level)
    gmp = _gmp()
    with torch.no_grad():
        got = gmp(level, x, method="fused4")
        assert counts() == dict(v3=0, v5=0, v2=1, v4=0, v3_bwd=0, v5_bwd=0)
        want = gmp._streamed(level, x, None)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_world_edge_gmps_ignore_k(counts):
    """A world-edge GMP on `"fused4"` takes kernel 13 (v4) on a gated
    level, as JAX's `gmp_apply` does."""
    level = airfoil()[1].levels[3]
    with torch.no_grad():
        _gmp(world=True)(level, _x(level), pos=torch.zeros(
            level.n_pad_nodes, 3), method="fused4")
    assert counts() == dict(v3=0, v5=0, v2=0, v4=1, v3_bwd=0, v5_bwd=0)


def test_fused1_is_fused_and_fusedk_computes_fused(counts):
    """`"fused1"` is `"fused"` (the same route, the same output to the
    bit); `"fused2"` … `"fused8"` give kernel 4's result on a gated level
    (kernel 14's plain version is kernel 4's)."""
    level = airfoil()[1].levels[4]
    x, gmp = _x(level), _gmp()
    with torch.no_grad():
        want = gmp(level, x, method="fused")
        assert counts()["v3"] == 1
        torch.testing.assert_close(gmp(level, x, method="fused1"), want,
                                   rtol=0, atol=0)
        assert counts()["v3"] == 2 and counts()["v5"] == 0
        for k in range(2, MAX_INTERLEAVE + 1):
            torch.testing.assert_close(gmp(level, x, method=f"fused{k}"),
                                       want, rtol=0, atol=0)
    assert counts()["v5"] == MAX_INTERLEAVE - 1


@pytest.mark.parametrize("method", ["fused0", "fused9", "fused64"])
def test_k_outside_its_range_raises(method):
    """K must lie in [1, 8], when the config is read and at the GMP."""
    with pytest.raises(ValueError, match=r"\[1, 8\]"):
        ModelConfig(aggregation=method)
    with pytest.raises(ValueError, match=r"\[1, 8\]"):
        split_interleave(method)
    level = airfoil()[1].levels[3]
    with torch.no_grad(), pytest.raises(ValueError, match=r"\[1, 8\]"):
        _gmp()(level, _x(level), method=method)


def test_split_interleave():
    assert split_interleave("fused") == ("fused", 1)
    assert split_interleave("fused1") == ("fused", 1)
    assert split_interleave("fused4") == ("fused", 4)
    assert split_interleave("fused8") == ("fused", 8)
    assert split_interleave("pallas") == ("pallas", 1)
    assert ModelConfig(aggregation="fused4").aggregation == "fused4"


@pytest.mark.parametrize("name", ["fused_edge_phase_win_k_fwd",
                                  "fused_edge_phase_win_k_bwd"])
def test_kernel14_wrappers_raise_on_another_device(name):
    """Kernel 14's wrappers take the plain version on the CPU, launch on
    CUDA and raise on any other device (here `meta`)."""
    level = airfoil()[1].levels[3]
    gmp = _gmp()
    ws, bs = list(gmp.mlp_edge.weights)[1:], list(gmp.mlp_edge.biases)[1:]
    rows = torch.empty(level.n_pad_nodes, C, device="meta")
    extra = [rows] if name.endswith("bwd") else []
    with torch.no_grad(), pytest.raises(RuntimeError,
                                        match="no kernel for device meta"):
        getattr(fused_gmp_k, name)(level, rows, rows,
                                   torch.empty(8, C, device="meta"), ws, bs,
                                   *extra, 4)
