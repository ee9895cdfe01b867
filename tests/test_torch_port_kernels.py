"""Each kernel module of the port against the JAX package's Pallas kernel
(interpret mode on the CPU), at the same seeded inputs. On the CPU every
port wrapper runs its plain PyTorch version; the CUDA kernels are held
against those plain versions on the card by chip_smoke.py.

f32 tolerance 1e-4 abs/rel: both sides compute in true f32 and differ in
summation order only. bf16: both sides round the same operands to bf16 and
accumulate in f32, so a different f32 sum can put an intermediate on the
other side of a bf16 rounding step (2^-8 relative): 2e-2 of the output
scale for the MLP kernels, 1e-5 for the selection kernels (their products
of bf16 values are exact in f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_slice import DEPTH
from test_torch_port_weights import jax_state_with_stats, port_simulator, small_configs
from test_torch_port_hierarchy import scrambled_grid

from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.ops.pallas import compact_resid as jax_cr
from bsms_gnn_tpu.ops.pallas.fused_gmp import fused_edge_phase_win as jax_fused_edge
from bsms_gnn_tpu.ops.pallas.node_mlp import fused_node_phase as jax_node_phase
from bsms_gnn_tpu.ops.pallas.windowed import windowed_rect_conv_raw
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.ops.kernels.compact_resid import compact_accum, compact_gather
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import fused_edge_phase_win
from bsms_gnn_tpu_torch.ops.kernels.node_mlp import fused_node_phase
from bsms_gnn_tpu_torch.ops.kernels.windowed import windowed_rect_conv

C = 128
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
MLP_TOL = {"f32": 1e-4, "bf16": 2e-2}
SELECT_TOL = {"f32": 1e-4, "bf16": 1e-5}


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():  # the kernel wrappers are forward only
        yield


@pytest.fixture(scope="module")
def hier():
    pos, cells = scrambled_grid()
    kw = dict(edge_block=512, window=128)
    hj = jax_build(jax_flat_edge(cells, "tri"), DEPTH, len(pos), pos, **kw)
    ht = to_device(build_hierarchy(to_flat_edge(cells, "tri"), DEPTH, len(pos),
                                   pos, **kw), "cpu")
    jcfg, tcfg = small_configs(depth=DEPTH, hidden=2)
    state = jax_state_with_stats(jcfg)
    return hj, ht, state, port_simulator(tcfg, state)


def both(a, dt):
    """The same numpy array as a JAX and a torch array of dtype `dt`."""
    jd, td = DTYPES[dt]
    return jnp.asarray(a).astype(jd), torch.tensor(a).to(td)


def assert_close(got, want, tol):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= tol * scale


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("which", ["down", "up"])
def test_windowed_rect_conv(hier, dt, which):
    hj, ht, _, _ = hier
    opj, opt = (getattr(hj.transitions[0], f"{which}_op"),
                getattr(ht.transitions[0], f"{which}_op"))
    x = np.random.default_rng(1).standard_normal((opt.n_in_pad, C))
    xj, xt = both(x.astype(np.float32), dt)
    got = windowed_rect_conv(opt, xt)
    assert got.dtype == torch.float32 and got.shape == (opt.n_pad_nodes, C)
    assert_close(got, windowed_rect_conv_raw(opj, xj), SELECT_TOL[dt])


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("where", ["level0", "trans0_down"])
@pytest.mark.parametrize("raw", [False, True])
def test_compact_accum(hier, dt, where, raw):
    hj, ht, _, _ = hier
    crj, crt = ((hj.levels[0].cresid, ht.levels[0].cresid) if where == "level0"
                else (hj.transitions[0].down_op.cresid,
                      ht.transitions[0].down_op.cresid))
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((crt.n_rows, C)).astype(np.float32)
    acc = rng.standard_normal((crt.n_pad_nodes, C)).astype(np.float32)
    vj, vt = both(vals, dt)
    jfn = jax_cr.compact_accum_raw if raw else jax_cr.compact_accum
    want = jfn(crj, vj, jnp.asarray(acc))
    acc_t = torch.tensor(acc)
    got = compact_accum(crt, vt, acc_t)
    assert got is acc_t  # updated in place
    assert_close(got, want, SELECT_TOL[dt])


@pytest.mark.parametrize("by", ["send", "recv"])
def test_compact_gather(hier, by):
    hj, ht, _, _ = hier
    x = np.random.default_rng(3).standard_normal(
        (ht.levels[0].n_pad_nodes, C)).astype(np.float32)
    want = jax_cr.compact_gather(hj.levels[0].cresid, jnp.asarray(x), by)
    got = compact_gather(ht.levels[0].cresid, torch.tensor(x), by)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("x_dt,dt", [("f32", "f32"), ("bf16", "bf16"),
                                     ("f32", "bf16")])
def test_fused_node_phase(hier, x_dt, dt):
    """dt is the compute dtype; f32 x in bf16 compute is the level-0 GMP
    under io_dtype=float32."""
    _, ht, state, sim = hier
    n = ht.levels[0].n_pad_nodes
    rng = np.random.default_rng(4)
    x = rng.standard_normal((n, C)).astype(np.float32)
    aggr = (3 * rng.standard_normal((n, C))).astype(np.float32)
    xj, xt = both(x, x_dt)
    cd_j, cd_t = (None, None) if dt == "f32" else DTYPES[dt]
    want = jax_node_phase(xj, jnp.asarray(aggr),
                          state.params.process.down_gmps[0].mlp_node, cd_j)
    got = fused_node_phase(xt, torch.tensor(aggr),
                           sim.process.down_gmps[0].mlp_node, cd_t)
    assert got.dtype == DTYPES[dt][1]
    assert str(want.dtype) == str(got.dtype).removeprefix("torch.")
    assert_close(got, want, MLP_TOL[dt])


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("lvl", [0, 1])
def test_fused_edge_phase_win(hier, dt, lvl):
    hj, ht, state, sim = hier
    n = ht.levels[lvl].n_pad_nodes
    rng = np.random.default_rng(5 + lvl)
    xwi = rng.standard_normal((n, C)).astype(np.float32)
    xj = rng.standard_normal((n, C)).astype(np.float32)
    wf8 = (0.3 * rng.standard_normal((8, C))).astype(np.float32)
    mj = state.params.process.down_gmps[lvl].mlp_edge
    mt = sim.process.down_gmps[lvl].mlp_edge
    (aj, at), (bj, bt) = both(xwi, dt), both(xj, dt)
    want = jax_fused_edge(hj.levels[lvl], aj, bj, jnp.asarray(wf8),
                          mj.weights[1:], mj.biases[1:])
    got = fused_edge_phase_win(ht.levels[lvl], at, bt, torch.tensor(wf8),
                               list(mt.weights)[1:], list(mt.biases)[1:])
    assert got.dtype == torch.float32
    assert_close(got, want, MLP_TOL[dt])
