"""Kernel 15 (the sub-window conv) of the port against the v6 prototype
(`benchmarks/v6_prototype.py`) on the CPU: `build_sub_tables` element for
element against the prototype's own loop, and kernel 15's plain version
against the prototype's Pallas kernel (`_get_v6_conv`, interpret mode), f32
and bf16. The levels: level 0 of `test_torch_port_interleave.py`'s
Morton-ordered 2,000-node airfoil at window 256 (two candidate blocks per
window, so the two blocks are the whole window) and at window 512 (four
candidates, where the choice and its ties matter), edge_block 512; the
tables also at window 128 (one candidate, fewer than K).

Tolerances: `test_torch_port_kernels.py`'s `SELECT_TOL` (f32 1e-4 of the
output scale: sums in another order; bf16 1e-5: both sides add products of
bf16 values, exact in f32).
"""

import functools
import importlib
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_interleave import NODES, airfoil
from test_torch_port_kernels import SELECT_TOL, assert_close, both

from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.ops.pallas.fused_gmp import _chunk_tables
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.ops.kernels import subwin_conv as sw

C = 128


@functools.lru_cache(maxsize=None)
def prototype():
    """benchmarks/v6_prototype.py, imported as its own script imports its
    neighbours."""
    bench = str(pathlib.Path(__file__).resolve().parents[1] / "benchmarks")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    return importlib.import_module("v6_prototype")


@functools.lru_cache(maxsize=None)
def level0(window):
    """(JAX level 0, the port's on the CPU) at `window`, edge_block 512."""
    if window == 256:
        hj, ht, _, _ = airfoil()
        return hj.levels[0], ht.levels[0]
    _, _, pos, _ = airfoil()
    cells = airfoil_cells()
    kw = dict(edge_block=512, window=window)
    hj = jax_build(jax_flat_edge(cells, "tri"), 1, NODES, pos, **kw)
    ht = to_device(build_hierarchy(to_flat_edge(cells, "tri"), 1, NODES,
                                   pos, **kw), "cpu")
    return hj.levels[0], ht.levels[0]


def airfoil_cells():
    from bsms_gnn_tpu_torch.data.synthetic import make_graded_airfoil_mesh
    from bsms_gnn_tpu_torch.graph.order import reorder_mesh

    pos, cells, _ = make_graded_airfoil_mesh(NODES, np.random.default_rng(0))
    return reorder_mesh(pos, cells)[1]


@pytest.mark.parametrize("window", [128, 256, 512])
def test_sub_tables_equal_the_prototype(window):
    lj, lt = level0(window)
    want = prototype().build_sub_tables(lj)
    got = sw.build_sub_tables(lt)
    for name, g, w in zip(("sub_base", "send_sub", "covered"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    covered, in_win = got[2], ((np.asarray(lt.send_win) < window)
                               & (np.asarray(lt.edge_mask) > 0))
    # The K blocks cover most of the window's real edges, and at windows
    # of at most K blocks all of them.
    assert covered.sum() > 0.8 * in_win.sum()
    assert not (covered & ~in_win).any()
    if window <= sw.K * sw.SUB:
        assert covered.sum() == in_win.sum()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("window", [256, 512])
def test_plain_matches_the_prototype_kernel(dt, window):
    """Kernel 15's plain version against `_get_v6_conv` in interpret mode,
    fed as the prototype's `main` feeds it (ew zero off the covered set:
    the port's kernel skips those slots itself)."""
    proto = prototype()
    lj, lt = level0(window)
    sub_base, send_sub, covered = sw.build_sub_tables(lt)
    be, e_pad, n_pad = lt.edge_block, lt.n_pad_edges, lt.n_pad_nodes
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n_pad, C)).astype(np.float32)
    ew = rng.standard_normal(e_pad).astype(np.float32)
    xj, xt = both(x, dt)

    n_chunks, n_subs = e_pad // be, e_pad // sw.SUB
    rows8 = -(-n_subs // 8) * 8
    sw_p = np.pad(send_sub.reshape(n_subs, sw.SUB),
                  ((0, rows8 - n_subs), (0, 0)), constant_values=sw.K * sw.SUB)
    ew_p = proto._pack_rows(np.where(covered, ew, 0.0), be, n_chunks, 0)
    chunk_block, first, recv = _chunk_tables(jax.device_put(lj))
    ops = (be // sw.SUB) * sw.K
    call = proto._get_v6_conv(e_pad, n_pad, C, be, dt == "f32", True, ops)
    want = call(chunk_block, first, jnp.asarray(sub_base), *([xj] * ops),
                jnp.asarray(sw_p), recv, jnp.asarray(ew_p))

    sw.subwin_conv_plain.calls = 0
    got = sw.subwin_conv(lt, xt, torch.tensor(ew), torch.tensor(sub_base),
                         torch.tensor(send_sub))
    assert sw.subwin_conv_plain.calls == 1
    assert got.dtype == torch.float32 and got.shape == (n_pad, C)
    assert_close(got, want, SELECT_TOL[dt])


def test_wrapper_raises_on_another_device():
    _, lt = level0(256)
    sub_base, send_sub, _ = (torch.tensor(a) for a in
                             sw.build_sub_tables(lt))
    x = torch.empty(lt.n_pad_nodes, C, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        sw.subwin_conv(lt, x, torch.empty(lt.n_pad_edges, device="meta"),
                       sub_base, send_sub)
