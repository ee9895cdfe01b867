"""The port's edge-sharded step (`parallel/edge_shard.py`, the
`"eshard:<group>:<local>"` methods) against the JAX package's GSPMD edge
sharding (`bsms_gnn_tpu/parallel/edge_shard.py`).

(a) One process, no collectives: on `test_parallel.py`'s 9×9 grid (`ell`,
    `segment`) and `test_windowed.py`'s 24×24 Morton grid at window 256
    (windowed `fused`, the kernels' plain versions), at S = 2 and 3, the
    ranks' slot ranges cover every level's and operator's slots once, are
    balanced by live slots, split each operator's compact residual with its
    slots and each level's by twin pairs; the ranks' partial aggregates
    (`GMP.edge_aggregate`), conv sums and transition sums add to the
    one-device ones.
(b) Gloo ranks on `ell` and `segment`, `test_parallel.py`'s setup (depth
    2, latent 16, hidden 1, B = 8, three steps: the warmup gate and two
    updates, with noise) at meshes (data, graph) = (1, 2) and (2, 2):
    every step's loss against JAX's `make_spmd_train_step` on the same
    mesh shape (fed the same draw) and each parameter's update against
    its; each update's summed, clipped gradients against the port's
    one-process `Trainer` on the whole batch at (1, 2), and at (2, 2)
    against the port's data-parallel step on the same two halves
    (`data_parallel_step`): the targets' constant shift leaves the output
    normalizer a tiny spread, so the order of the gate's sums over the
    halves moves the node-side gradients by ~2e-5 of their RMS, the
    data-parallel step's as much as the edge shard's; against it the edge
    shard's own sums are held.
(c) The windowed `fused` path at (1, 2): the forward against JAX's
    forward on a GSPMD-sharded hierarchy (`test_windowed.py:575`'s case),
    the train step (gate and two updates, one frame) against the port's
    one-process `Trainer`; the plain versions of kernels 4, 5, 3, 6, 1,
    2 and 7 ran on the ranks. With world edges (v4, the world positions
    through the transitions' narrow route) the forward against the port's
    one-device forward.
(d) After the steps every rank holds the same parameters, bit for bit.

Tolerances: the losses rtol 1e-4 (`test_parallel.py`'s); the gradients
within GRAD_RMS_TOL of each tensor's RMS in RMS and the updates within
UPDATE_RMS_TOL (`test_torch_port_data_parallel.py`'s measures); the
forward rtol 1e-4, atol 1e-5 (`test_windowed.py`'s); the sums of (a)
1e-5 of the one-device sum's scale (f32 sums in another order)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from conftest import make_grid_mesh
from test_torch_port_weights import (
    jax_state_with_stats,
    jax_to_nested,
    normalizer_to_dict,
)
from torch_parallel_group import (
    Group,
    grad_errors,
    step_grads,
    update_errors,
)

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import DatasetConfig as JaxDatasetConfig
from bsms_gnn_tpu.config import ModelConfig as JaxModelConfig
from bsms_gnn_tpu.config import OptConfig as JaxOptConfig
from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.models.simulator import simulator_forward
from bsms_gnn_tpu.parallel import (
    make_mesh,
    make_spmd_train_step,
    replicate_state,
    shard_batch,
    shard_hierarchy,
)
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import (
    Config,
    DatasetConfig,
    ModelConfig,
    OptConfig,
)
from bsms_gnn_tpu_torch.convert import (
    normalizer_from_numpy,
    params_from_numpy,
)
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.graph.order import reorder_mesh
from bsms_gnn_tpu_torch.models.simulator import Simulator
from bsms_gnn_tpu_torch.ops.message import GMP, edge_conv_down, edge_conv_up
from bsms_gnn_tpu_torch.ops.transition import trans_down, trans_up
from bsms_gnn_tpu_torch.parallel.edge_shard import (
    PIECE,
    edge_partition,
    edge_shard,
    live_slots,
)
from bsms_gnn_tpu_torch.training.trainer import Trainer

OUT, DEPTH, N_PAD, B, STEPS = 3, 2, 128, 8, 3
LOSS_RTOL = 1e-4
GRAD_RMS_TOL = 1e-5
UPDATE_RMS_TOL = 1e-2
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
SUM_TOL = 1e-5
MODEL = dict(unet_depth=DEPTH, latent_dim=16, hidden_layer=1, out_dim=OUT,
             accumulation_steps=1)
WIDE = dict(unet_depth=DEPTH, aggregation="fused", accumulation_steps=1)
WORLD_EDGES = dict(WIDE, world_edges=True, world_dim=2)
OPT = dict(warmup_steps=2, decay_steps=20)
NOISE = dict(noise_level=[0.05] * OUT, noise_gamma=0.1)
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
METHODS = ("ell", "segment")
LAYOUT = dict(pad_multiple=N_PAD)
WINDOWED = dict(window=256)
# A GMP's sum and its cotangent's, per GMP and explicit conv or fused
# transition, then the loss's, the edge gradients' and all gradients'.
STEP_REDUCTIONS = 2 * (4 * DEPTH + 1) + 3


def grid_inputs(pos, n_pad, b, rng):
    n = len(pos)
    node_in = np.zeros((b, n_pad, OUT + 3), np.float32)
    node_in[:, :n, :OUT] = rng.standard_normal((b, n, OUT))
    node_in[:, :n, OUT:OUT + 2] = pos
    node_tar = np.zeros((b, n_pad, OUT), np.float32)
    node_tar[:, :n] = node_in[:, :n, :OUT] + 0.05
    mask = np.zeros((b, n_pad, 1), np.float32)
    mask[:, :n] = 1.0
    return node_in, node_tar, mask


def port_state(jcfg, seed):
    """A JAX simulator state with normalizer statistics, as the worker's
    `simulator` reads it."""
    st = jax_state_with_stats(jcfg, seed=seed)
    return dict(params=params_from_numpy(jax_to_nested(st.params)),
                norm_in=normalizer_to_dict(st.norm_in),
                norm_out=normalizer_to_dict(st.norm_out))


def port_trainer(model, init, hd, ins, noise):
    """The port's one-process `Trainer` over STEPS steps: (losses, each
    step's gradients, the parameters after)."""
    tr = Trainer(Config(datasets=DatasetConfig(**NOISE),
                        model=ModelConfig(**model), opt=OptConfig(**OPT)),
                 device="cpu")
    tr.sim.load_state_dict(init)
    t_in = [torch.from_numpy(a) for a in ins]
    losses, grads = [], []
    for i in range(STEPS):
        losses.append(float(tr.iter(hd, *t_in, torch.from_numpy(noise[i]))))
        grads.append(step_grads(tr))
    return dict(losses=losses, grads=grads, params={
        k: v.numpy().copy() for k, v in tr.sim.state_dict().items()})


@pytest.fixture(scope="module")
def case():
    pos, cells = make_grid_mesh(9, 9)
    n = len(pos)
    rng = np.random.default_rng(11)
    node_in, node_tar, mask = grid_inputs(pos, N_PAD, B, rng)
    keys = [jax.random.fold_in(jax.random.PRNGKey(5), i) for i in range(STEPS)]
    # JAX's noise draw of each step (`Trainer._inject_noise`).
    noise = np.stack([np.asarray(jax.random.normal(k, node_tar.shape,
                                                   jnp.float32))
                      for k in keys])

    # (c)'s windowed case: test_windowed.py:575's Morton-ordered grid.
    wpos, wcells, _, _ = reorder_mesh(*make_grid_mesh(24, 24))
    wn = len(wpos)
    hw = build_hierarchy(to_flat_edge(wcells, "tri"), DEPTH, wn, wpos,
                         **WINDOWED)
    wn_pad = hw.levels[0].n_pad_nodes
    w_in, w_tar, w_mask = grid_inputs(wpos, wn_pad, 1, rng)
    w_in, w_tar, w_mask = w_in[0], w_tar[0], w_mask[0]
    w_noise = rng.standard_normal((STEPS,) + w_tar.shape).astype(np.float32)
    jwide = JaxModelConfig(**WIDE)
    wstate = jax_state_with_stats(jwide, seed=0)
    wide_init = params_from_numpy(jax_to_nested(wstate.params))
    world_in = w_in.copy()
    world_in[:wn, :2] = wpos * 1.03 + 0.01
    world = port_state(JaxModelConfig(**WORLD_EDGES), seed=2)

    jcfgs = {agg: JaxConfig(datasets=JaxDatasetConfig(**NOISE),
                            model=JaxModelConfig(**MODEL, aggregation=agg),
                            opt=JaxOptConfig(**OPT)) for agg in METHODS}
    init = params_from_numpy(jax_to_nested(
        JaxTrainer(jcfgs["ell"], init_key=jax.random.PRNGKey(0))
        .state.sim.params))
    batch = dict(pos=pos, cells=cells, depth=DEPTH, node_in=node_in,
                 node_tar=node_tar, mask=mask, kind="eshard_train",
                 opt=OPT, datasets=NOISE, params=init, steps=STEPS,
                 noise=noise, layout=LAYOUT)
    wide = dict(pos=wpos, cells=wcells, depth=DEPTH, layout=WINDOWED,
                mesh=(1, 2), model=WIDE)
    groups = {
        (1, 2): {**{f"{agg}_1x2": dict(batch, mesh=(1, 2),
                                       model=dict(MODEL, aggregation=agg))
                    for agg in METHODS},
                 **{f"{agg}_dp": dict(batch, kind="dp_train", data=True,
                                      model=dict(MODEL, aggregation=agg))
                    for agg in METHODS},
                 "fused_forward": dict(
                     wide, kind="eshard_forward", node_in=w_in, mask=w_mask,
                     params=wide_init, norm_in=normalizer_to_dict(
                         wstate.norm_in),
                     norm_out=normalizer_to_dict(wstate.norm_out)),
                 "world_forward": dict(
                     wide, model=WORLD_EDGES, kind="eshard_forward",
                     node_in=world_in, mask=w_mask, **world),
                 "fused_train": dict(
                     wide, kind="eshard_train", node_in=w_in[None],
                     node_tar=w_tar[None], mask=w_mask[None],
                     noise=w_noise[:, None], opt=OPT, datasets=NOISE,
                     params=wide_init, steps=STEPS)},
        (2, 2): {f"{agg}_2x2": dict(batch, mesh=(2, 2),
                                    model=dict(MODEL, aggregation=agg))
                 for agg in METHODS}}
    running = {m: Group(cases, m[0] * m[1]) for m, cases in groups.items()}

    # JAX's GSPMD steps and sharded forward, while the ranks run.
    h = jax_build(jax_flat_edge(cells, "tri"), DEPTH, n, pos, **LAYOUT)

    def jax_steps(agg, shape):
        jtr = JaxTrainer(jcfgs[agg], init_key=jax.random.PRNGKey(0))
        m = make_mesh(*shape)
        step = make_spmd_train_step(jtr, m, h)
        state = replicate_state(m, jtr.state)
        h_dev = shard_hierarchy(h, m)
        ins = shard_batch(m, *(jnp.asarray(a)
                               for a in (node_in, node_tar, mask)))
        losses = []
        for k in keys:
            state, loss = step(state, h_dev, *ins, k)
            losses.append(float(loss))
        return dict(losses=losses, params={
            k: v.numpy() for k, v in params_from_numpy(
                jax_to_nested(state.sim.params)).items()})

    def jax_fused_forward():
        hwj = jax_build(jax_flat_edge(wcells, "tri"), DEPTH, wn, wpos,
                        **WINDOWED)
        hw_dev = shard_hierarchy(hwj, make_mesh(1, 2))
        return np.asarray(jax.jit(
            lambda a, m: simulator_forward(wstate.params, wstate.norm_in,
                                           wstate.norm_out, hw_dev, a, m,
                                           jwide))(
            jnp.asarray(w_in), jnp.asarray(w_mask)))

    # The compiles overlap (XLA compiles outside the GIL).
    with ThreadPoolExecutor(len(METHODS) * len(MESHES) + 1) as ex:
        futs = {f"{agg}_{name}": ex.submit(jax_steps, agg, shape)
                for agg in METHODS for name, shape in MESHES.items()}
        futs["fused_forward"] = ex.submit(jax_fused_forward)
        jax_ref = {k: f.result() for k, f in futs.items()}

    # The port's one-process trainers on the whole batch.
    hd = to_device(build_hierarchy(to_flat_edge(cells, "tri"), DEPTH, n, pos,
                                   **LAYOUT), "cpu")
    port_ref = {agg: port_trainer(dict(MODEL, aggregation=agg), init, hd,
                                  (node_in, node_tar, mask), noise)
                for agg in METHODS}
    port_ref["fused"] = port_trainer(
        WIDE, wide_init, to_device(hw, "cpu"),
        (w_in[None], w_tar[None], w_mask[None]), w_noise[:, None])
    sim = Simulator(ModelConfig(**WORLD_EDGES), device="cpu")
    sim.load_state_dict(world["params"])
    sim.norm_in, sim.norm_out = (normalizer_from_numpy(world[k], device="cpu")
                                 for k in ("norm_in", "norm_out"))
    with torch.no_grad():
        port_ref["world_forward"] = sim(
            to_device(hw, "cpu"), torch.from_numpy(world_in),
            torch.from_numpy(w_mask)).numpy()
    results = {m: g.results() for m, g in running.items()}
    return dict(init=init, wide_init=wide_init, jax=jax_ref, port=port_ref,
                results=results, n=n, wn=wn, grid=(pos, cells),
                windowed=(wpos, wcells, hw))


# -- (a) one process ----------------------------------------------------------


def _layouts(h):
    """(name, host layout) of every level and operator."""
    out = [(f"L{l}", lv) for l, lv in enumerate(h.levels)]
    for l, t in enumerate(h.transitions):
        out += [(f"T{l} down", t.down_op), (f"T{l} up", t.up_op)]
    return [(k, v) for k, v in out if v is not None]


def _close(got, want, what):
    scale = max(float(want.detach().abs().max()), 1.0)
    err = float((got - want).detach().abs().max())
    assert err <= SUM_TOL * scale, (what, err, scale)


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("grid", ["unwindowed", "windowed"])
def test_ranks_cover_every_slot_once(case, grid, s):
    """The ranges tile each layout's slots in PIECE steps; each rank's live
    slots lie within one piece of an even share; an operator's compact
    residual is split with its slots and a level's by twin pairs, every
    rank's part symmetric."""
    h = (case["windowed"][2] if grid == "windowed" else build_hierarchy(
        to_flat_edge(case["grid"][1], "tri"), DEPTH, case["n"],
        case["grid"][0], **LAYOUT))
    plan = edge_partition(h, s)
    parts = [edge_shard(h, plan, r) for r in range(s)]
    for l, lv in enumerate(h.levels):
        rngs = plan.levels[l]
        assert rngs[0][0] == 0 and rngs[-1][1] == lv.n_pad_edges
        assert all(a[1] == b[0] for a, b in zip(rngs, rngs[1:]))
        assert all(a % PIECE == 0 for r in rngs for a in r)
        live = live_slots(lv)
        shares = [int(live[a:b].sum()) for a, b in rngs]
        n_pieces = lv.n_pad_edges // PIECE
        if n_pieces >= s:
            assert all(b > a for a, b in rngs)
            assert max(abs(x - live.sum() / s) for x in shares) <= PIECE
        assert sum(p.levels[l].n_edges for p in parts) == lv.n_edges
        rows = [p.levels[l].cresid for p in parts]
        if lv.cresid is None:
            assert rows == [None] * s
            continue
        def pairs(c):
            return list(zip(c.senders[:c.n_real].tolist(),
                            c.receivers[:c.n_real].tolist()))

        key = set(pairs(lv.cresid))
        got = [e for c in rows if c is not None for e in pairs(c)]
        assert len(got) == len(key) and set(got) == key
        for c in rows:
            if c is not None:
                mine = set(pairs(c))
                assert {(b, a) for a, b in mine} == mine
    for l, t in enumerate(h.transitions):
        for name in ("down_op", "up_op"):
            op = getattr(t, name)
            if op is None or op.cresid is None:
                continue
            rows = [getattr(p.transitions[l], name).cresid for p in parts]
            assert sum(0 if c is None else c.n_real for c in rows) == \
                op.cresid.n_real


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("local", ["ell", "segment", "fused"])
def test_rank_parts_add_to_one_device(case, local, s):
    """Every level's partial aggregates and conv sums, and every
    operator's partial sums, add to the one-device ones."""
    if local == "fused":
        h = case["windowed"][2]
    else:
        h = build_hierarchy(to_flat_edge(case["grid"][1], "tri"), DEPTH,
                            case["n"], case["grid"][0], **LAYOUT)
    plan = edge_partition(h, s)
    hd = to_device(h, "cpu")
    ranks = [to_device(edge_shard(h, plan, r), "cpu") for r in range(s)]
    g = torch.Generator().manual_seed(s)
    gmp = GMP(128, 1, 2, g)
    # World edges: v4 on `fused`, the generic route's dynamic fiber else.
    gmp_w = GMP(128, 1, 2, g, fiber_dims=(2, 2))
    for l, lv in enumerate(hd.levels):
        x = torch.randn(lv.n_pad_nodes, 128, generator=g)
        pos = torch.randn(lv.n_pad_nodes, 2, generator=g)
        real = slice(0, lv.n_nodes)
        for m, p in ((gmp, None), (gmp_w, pos)):
            want = m.edge_aggregate(lv, x, p, None, local)
            got = sum(m.edge_aggregate(rk.levels[l], x, p, None, local)
                      for rk in ranks)
            _close(got[real], want[real], f"L{l} aggregate")
        conv_method = "fused" if local == "fused" else local
        for conv in (edge_conv_down, edge_conv_up):
            want = conv(lv, x, None, conv_method)
            got = sum(conv(rk.levels[l], x, None, conv_method)
                      for rk in ranks)
            _close(got, want, f"L{l} {conv.__name__}")
    if local != "fused":
        return
    for l, t in enumerate(hd.transitions):
        x = torch.randn(hd.levels[l].n_pad_nodes, 128, generator=g)
        y = torch.randn(hd.levels[l + 1].n_pad_nodes, 128, generator=g)
        _close(sum(trans_down(rk.transitions[l], x) for rk in ranks),
               trans_down(t, x), f"T{l} down")
        _close(sum(trans_up(rk.transitions[l], y) for rk in ranks),
               trans_up(t, y), f"T{l} up")
        # The world positions' narrow route.
        _close(sum(trans_down(rk.transitions[l], x[:, :2]) for rk in ranks),
               trans_down(t, x[:, :2]), f"T{l} down, narrow")


def test_refused_routes(case):
    """`pallas` (kernel 10 fuses the aggregate with the node phase) and the
    unwindowed `fused` routes (v2, v1: their sender sums read reverse
    slots) raise on an edge shard, as does a runtime conv weight."""
    from bsms_gnn_tpu_torch.ops.scatter import eshard_parts

    with pytest.raises(NotImplementedError, match="pallas"):
        eshard_parts("eshard:graph:pallas")
    h = build_hierarchy(to_flat_edge(case["grid"][1], "tri"), DEPTH,
                        case["n"], case["grid"][0], **LAYOUT)
    rk = to_device(edge_shard(h, edge_partition(h, 2), 0), "cpu")
    lv = rk.levels[0]
    gmp = GMP(128, 1, 2, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="v2 or v1"):
        gmp.edge_aggregate(lv, torch.zeros(lv.n_pad_nodes, 128), None, None,
                           "fused")
    with pytest.raises(NotImplementedError, match="ew must be None"):
        edge_conv_down(lv, torch.zeros(lv.n_pad_nodes, 8),
                       torch.zeros(lv.n_pad_edges), "eshard:graph:ell")


# -- (b) ell and segment against JAX's GSPMD step -----------------------------


def check_replicas(results, name):
    """(d): every rank that ran `name` holds the same parameters."""
    ran = [r for r in results if name in r]
    assert len(ran) > 1
    for r in ran[1:]:
        for k, v in ran[0][name]["params"].items():
            assert np.array_equal(v, r[name]["params"][k]), k


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("agg", METHODS)
def test_step_matches_jax_spmd(case, agg, mesh_name):
    shape = MESHES[mesh_name]
    name = f"{agg}_{mesh_name}"
    results = case["results"][shape]
    got, want = results[0][name], case["jax"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert got["updates"] == STEPS - 1
    assert got["reductions"] == [2] + [STEP_REDUCTIONS] * (STEPS - 1)
    errs = update_errors(got["params"], want["params"], case["init"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= UPDATE_RMS_TOL, (worst, errs[worst])
    one = (case["port"][agg] if shape[0] == 1
           else case["results"][(1, 2)][0][f"{agg}_dp"])
    assert got["grads"][0] is None and one["grads"][0] is None
    for i in range(1, STEPS):
        errs = grad_errors(got["grads"][i], one["grads"][i])
        worst = max(errs, key=errs.get)
        assert errs[worst] <= GRAD_RMS_TOL, (i, worst, errs[worst])
    check_replicas(results, name)


# -- (c) the windowed fused path ----------------------------------------------


def test_fused_forward_matches_jax_gspmd(case):
    results = case["results"][(1, 2)]
    wn = case["wn"]
    want = case["jax"]["fused_forward"][:wn]
    for r in results:
        got = r["fused_forward"]
        np.testing.assert_allclose(got["pred"][:wn], want, **FWD_TOL)
        assert got["reductions"] == 4 * DEPTH + 1
        calls = got["plain_calls"]
        for k in ("fused_edge_phase_win", "fused_node_phase",
                  "compact_accum"):
            assert calls[k] > 0, (r["fused_forward"]["shard"], k)
    # Each rank walks its part of the slots: together the whole of them.
    h = case["windowed"][2]
    assert [sum(x) for x in zip(results[0]["fused_forward"]["slots"],
                                results[1]["fused_forward"]["slots"])] == \
        [lv.n_pad_edges for lv in h.levels]


def test_world_edge_forward_matches_one_device(case):
    results = case["results"][(1, 2)]
    wn = case["wn"]
    for r in results:
        got = r["world_forward"]
        np.testing.assert_allclose(got["pred"][:wn],
                                   case["port"]["world_forward"][:wn],
                                   **FWD_TOL)
        assert got["plain_calls"]["fused_edge_phase_win_dyn"] > 0
        assert got["plain_calls"]["fused_edge_phase_win"] == 0
        # One sum for each GMP, each transition of h and each down
        # transition of the world positions (the up GMPs read the
        # positions their level had on the way down).
        assert got["reductions"] == 5 * DEPTH + 1


def test_fused_train_matches_one_process(case):
    results = case["results"][(1, 2)]
    got, want = results[0]["fused_train"], case["port"]["fused"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert got["reductions"] == [2] + [STEP_REDUCTIONS] * (STEPS - 1)
    for i in range(1, STEPS):
        errs = grad_errors(got["grads"][i], want["grads"][i])
        worst = max(errs, key=errs.get)
        assert errs[worst] <= GRAD_RMS_TOL, (i, worst, errs[worst])
    errs = update_errors(got["params"], want["params"], case["wide_init"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= UPDATE_RMS_TOL, (worst, errs[worst])
    for r in results:
        calls = r["fused_train"]["plain_calls"]
        for k in ("fused_edge_phase_win", "fused_edge_phase_win_bwd",
                  "fused_node_phase", "fused_node_phase_bwd",
                  "compact_accum", "windowed_send_sum"):
            assert calls[k] > 0, (r["fused_train"]["shard"], k)
    check_replicas(results, "fused_train")
