"""World-space edges on bucketed hierarchies: the port's `fused` GMP on a
windowed level whose out-of-window edges ride a residual sub-level (no
compact tables: v4's mini-layout branch, `bsms_gnn_tpu/ops/message.py:
357-387`: kernel 13's plain version in the window, the gathered positions'
[Δworld, ‖Δworld‖] term, the edge MLP and kernel 9's plain version on the
residual slots) against JAX's `gmp_apply(method="fused")` with its Pallas
kernels in interpret mode; the same through a union of three samples; and
the deforming-plate model (forward, rollout, one `Trainer` step) against
the JAX package.

The group: three Morton-ordered tetra blocks (`make_tetra_mesh` of 300,
350 and 400 nodes, seeds 1, 0, 2), depth 3, window 256, edge_block 512,
planned into one size group, so level 0 of each carries a residual
sub-level (44 to 190 edges) and no compact tables. The GMP is
deforming_plate's first down GMP cut to hidden 1 (latent 128, world 3,
pos 3: the static fiber is 4 wide). Its inputs: x ~ N(0, 1), the world
positions the mesh positions squeezed by frame 1 of
`generate_tetra_trajectory`'s recipe plus 0.01·N(0, 1), zero on the pad
rows; the cotangent zero on the pad rows.

Tolerances, relative to the largest |value| of the reference, on the real
rows (row n_pad − 1 sums the pad slots' messages in both packages, in
other orders): `test_torch_port_contact.py`'s, F32_TOL 5e-4 for the
output, GRAD_F32_TOL 1e-3 for the gradients, BF16_REL 2e-2 in bf16; the
union against each sample's own call 1e-6 (the same sums, in matmuls of
other row counts). The model at depth 3 (hidden 1) against JAX's `fused`
method: the forward 5e-4, the rollout 1e-3; the `Trainer` against JAX's
on its plain `segment` aggregation (the same function): the gate's
losses 1e-6, the update's 1e-4, each tensor's update within 1e-2 of its
RMS.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_train import assert_close, both, leaf
from test_torch_port_weights import (
    jax_state_with_stats,
    jax_to_nested,
    port_simulator,
)

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import DatasetConfig as JaxDatasetConfig
from bsms_gnn_tpu.config import ModelConfig as JaxModelConfig
from bsms_gnn_tpu.config import OptConfig as JaxOptConfig
from bsms_gnn_tpu.graph.bistride import build_bistride_levels as jax_levels
from bsms_gnn_tpu.graph.hierarchy import pad_levels as jax_pad_levels
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.models.simulator import simulator_forward
from bsms_gnn_tpu.ops.message import gmp_apply
from bsms_gnn_tpu.training.rollout import rollout_trajectory as jax_rollout
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import (
    DatasetConfig,
    OptConfig,
    deforming_plate_config,
)
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.data.datasets import get_mask
from bsms_gnn_tpu_torch.data.synthetic import make_tetra_mesh
from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels
from bsms_gnn_tpu_torch.graph.buckets import plan_buckets
from bsms_gnn_tpu_torch.graph.hierarchy import pad_levels, to_device, union
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.graph.order import reorder_mesh
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp_dyn
from bsms_gnn_tpu_torch.ops.kernels import segment_sum_accum as ssa
from bsms_gnn_tpu_torch.training.rollout import rollout_trajectory
from bsms_gnn_tpu_torch.training.trainer import Trainer

MESHES, DEPTH, HIDDEN, C, WD = ((300, 1), (350, 0), (400, 2)), 3, 1, 128, 3
LAYOUT = dict(edge_block=512, window=256)
SERVED = 1
F32_TOL, GRAD_F32_TOL, BF16_REL, UNION_TOL = 5e-4, 1e-3, 2e-2, 1e-6
ROLLOUT_TOL, ROLLOUT_STEPS = 1e-3, 3


def squeeze(pos, t, phase):
    """`generate_tetra_trajectory`'s world positions at frame t."""
    s = 1.0 - 0.2 * np.sin(0.3 * t + phase) * pos[:, 2]
    return (pos * s[:, None]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def group():
    """Per mesh: (pos, node_type, JAX hierarchy, port hierarchy on the
    CPU)."""
    meshes, levels = [], []
    for n, seed in MESHES:
        pos, cells, node_type = make_tetra_mesh(n, np.random.default_rng(seed))
        pos, cells, (node_type,), _ = reorder_mesh(pos, cells, (node_type,))
        meshes.append((pos.astype(np.float64), cells, node_type))
        levels.append(build_bistride_levels(to_flat_edge(cells, "tetra"),
                                            DEPTH, len(pos),
                                            pos.astype(np.float64)))
    plan = plan_buckets(levels, DatasetConfig(
        consist_mesh=False, pad_multiple=128, size_buckets=1, **LAYOUT))
    assert len(plan.groups) == 1
    out = []
    for i, ((pos, cells, node_type), lv) in enumerate(zip(meshes, levels)):
        kw = dict(pos=pos, **LAYOUT, **plan.for_mesh(i))
        jl = jax_levels(jax_flat_edge(cells, "tetra"), DEPTH, len(pos), pos)
        hj, ht = jax_pad_levels(jl, 128, **kw), pad_levels(lv, 128, **kw)
        out.append((pos, node_type, hj, to_device(ht, "cpu")))
    return out


@functools.lru_cache(maxsize=None)
def model():
    jcfg = JaxModelConfig(latent_dim=C, hidden_layer=HIDDEN, unet_depth=DEPTH,
                          out_dim=3, pos_dim=3, world_edges=True,
                          aggregation="fused")
    state = jax_state_with_stats(jcfg)
    tcfg = deforming_plate_config(unet_depth=DEPTH, hidden_layer=HIDDEN)
    sim = port_simulator(tcfg.model, state)
    # [Δworld 3, ‖Δworld‖, Δmesh 3, ‖Δmesh‖, x_i, x_j]
    assert sim.process.down_gmps[0].mlp_edge.weights[0].shape == (2 * C + 8, C)
    return jcfg, tcfg, state, sim


@pytest.fixture
def sim():
    s = model()[3]
    yield s
    s.zero_grad(set_to_none=True)


def gmp_inputs(i, seed):
    """Mesh i's level 0 GMP inputs: x, the world positions, the
    cotangent (zero on the pad rows)."""
    pos, _, _, ht = group()[i]
    lvl = ht.levels[0]
    n, n_pad = lvl.n_nodes, lvl.n_pad_nodes
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_pad, C)).astype(np.float32)
    wpos = np.zeros((n_pad, WD), np.float32)
    wpos[:n] = squeeze(pos, 1, 0.4) + 0.01 * rng.standard_normal((n, WD))
    cot = np.zeros((n_pad, C), np.float32)
    cot[:n] = rng.standard_normal((n, C))
    return x, wpos, cot


@pytest.fixture(scope="module")
def gmp_case():
    """JAX's f32 output, x gradient and parameter gradients of
    vdot(out, cot) for the served mesh's level 0 down GMP."""
    _, _, hj, ht = group()[SERVED]
    lvl = ht.levels[0]
    assert lvl.window > 0 and lvl.cresid is None
    assert lvl.resid is not None and lvl.resid.n_edges > 0
    assert lvl.fiber.shape[-1] == 4
    x, wpos, cot = gmp_inputs(SERVED, 31)
    pj = model()[2].params.process.down_gmps[0]

    def out(xx, p):
        return gmp_apply(p, hj.levels[0], xx, jnp.asarray(wpos), "fused",
                         None, (WD,))

    gx, gp = jax.grad(lambda xx, p: jnp.vdot(out(xx, p), jnp.asarray(cot)),
                      argnums=(0, 1))(jnp.asarray(x), pj)
    return dict(x=x, wpos=wpos, cot=cot, y=np.asarray(out(jnp.asarray(x), pj)),
                gx=gx, gp=jax_to_nested(gp), n=lvl.n_nodes)


def test_resid_world_gmp_matches_jax(sim, gmp_case):
    """Output, x gradient and every parameter gradient of the GMP against
    jax.grad of JAX's v4 branch with the mini residual layout, f32: kernel
    13's and kernel 9's plain versions run once each way; the positions
    get no gradient."""
    lt = group()[SERVED][3].levels[0]
    gt, n = sim.process.down_gmps[0], gmp_case["n"]
    for f in (fused_edge_phase_win_dyn_plain(), ssa.segment_sum_accum_plain):
        f.calls = 0
    xt = leaf(gmp_case["x"], "f32")
    pos = torch.tensor(gmp_case["wpos"]).requires_grad_()
    out = gt(lt, xt, None, pos, "fused")
    assert fused_edge_phase_win_dyn_plain().calls == 1
    assert ssa.segment_sum_accum_plain.calls == 1
    assert_close(out[:n], gmp_case["y"][:n], F32_TOL, "output")
    (out * torch.tensor(gmp_case["cot"])).sum().backward()
    assert pos.grad is None
    # The backward: kernel 13's, and kernel 9's store form in the two
    # residual gathers' backwards.
    assert ssa.segment_sum_accum_plain.calls == 3
    assert_close(xt.grad, gmp_case["gx"], GRAD_F32_TOL, "dx")
    for mlp in ("mlp_edge", "mlp_node"):
        mod = getattr(gt, mlp)
        for kind in ("weights", "biases"):
            for i, w in enumerate(gmp_case["gp"][mlp][kind]):
                assert_close(getattr(mod, kind)[i].grad, w, GRAD_F32_TOL,
                             f"{mlp}.{kind}.{i}")


def fused_edge_phase_win_dyn_plain():
    return fused_gmp_dyn.fused_edge_phase_win_dyn_plain


def test_resid_world_gmp_bf16_matches_jax(sim, gmp_case):
    hj, ht = group()[SERVED][2:]
    gj = model()[2].params.process.down_gmps[0]
    xj, xt = both(gmp_case["x"], "bf16")
    n = gmp_case["n"]
    want = gmp_apply(gj, hj.levels[0], xj, jnp.asarray(gmp_case["wpos"]),
                     "fused", jnp.bfloat16, (WD,))
    with torch.no_grad():
        got = sim.process.down_gmps[0](
            ht.levels[0], xt, torch.bfloat16, torch.tensor(gmp_case["wpos"]),
            "fused")
    assert str(want.dtype) == str(got.dtype).removeprefix("torch.")
    assert_close(got[:n], want[:n], BF16_REL, "bf16")


def test_resid_world_gmp_on_a_union_equals_each_sample(sim):
    """The GMP on level 0 of the union of the three meshes' hierarchies
    (one frame of 3·N_pad rows, as a variable-mesh batch runs): each
    sample's rows of the output and of the x gradient equal that sample's
    own call on its own level."""
    hts = [g[3] for g in group()]
    lu = union(hts).levels[0]
    gt = sim.process.down_gmps[0]
    ins = [gmp_inputs(i, 40 + i) for i in range(len(hts))]

    def call(level, x, wpos, cot):
        xt = torch.tensor(x).requires_grad_()
        out = gt(level, xt, None, torch.tensor(wpos), "fused")
        (out * torch.tensor(cot)).sum().backward()
        gt.zero_grad(set_to_none=True)
        return out.detach(), xt.grad

    out, gx = call(lu, *(np.concatenate(a) for a in zip(*ins)))
    n_pad = hts[0].levels[0].n_pad_nodes
    for s, (h, a) in enumerate(zip(hts, ins)):
        want, want_gx = call(h.levels[0], *a)
        rows = slice(s * n_pad, (s + 1) * n_pad)
        n = h.levels[0].n_nodes
        assert_close(out[rows][:n], want[:n].numpy(), UNION_TOL, f"out {s}")
        assert_close(gx[rows][:n], want_gx[:n].numpy(), UNION_TOL, f"dx {s}")


# -- the model --------------------------------------------------------------


def plate_frames(i):
    """Mesh i's frame pair of the squeeze (frames 2 and 3, phase 0.7):
    node_in [world 3, mesh 3, node type], the target, the deforming-plate
    mask."""
    pos, node_type, _, ht = group()[i]
    n, n_pad = len(pos), ht.levels[0].n_pad_nodes
    node_in = np.zeros((n_pad, 7), np.float32)
    node_in[:n, :3] = squeeze(pos, 2, 0.7)
    node_in[:n, 3:6] = pos
    node_in[:n, 6] = node_type[:, 0]
    target = np.zeros((n_pad, 3), np.float32)
    target[:n] = squeeze(pos, 3, 0.7)
    mask = np.zeros((n_pad, 1), np.float32)
    mask[:n] = get_mask("synthetic_deforming_plate", node_type)
    assert 0 < mask.sum() < n
    return node_in, target, mask


def test_plate_forward_and_rollout_match_jax(sim):
    """The served mesh's forward (f32) and a closed-loop rollout against
    JAX's on its `fused` method (Pallas in interpret mode), on the real
    rows."""
    jcfg, _, state, _ = model()
    _, _, hj, ht = group()[SERVED]
    node_in, _, mask = plate_frames(SERVED)
    n = ht.levels[0].n_nodes
    want = jax.jit(lambda ni, m: simulator_forward(
        state.params, state.norm_in, state.norm_out, hj, ni, m, jcfg))(
        jnp.asarray(node_in), jnp.asarray(mask))
    with torch.no_grad():
        got = sim(ht, torch.tensor(node_in), torch.tensor(mask))
    assert_close(got[:n], np.asarray(want)[:n], F32_TOL, "forward")
    preds_j = jax.jit(lambda ic, m: jax_rollout(
        state, hj, ic, m, ROLLOUT_STEPS, jcfg))(jnp.asarray(node_in),
                                                jnp.asarray(mask))
    with torch.no_grad():
        preds = rollout_trajectory(sim, ht, torch.tensor(node_in),
                                   torch.tensor(mask), ROLLOUT_STEPS)
    assert preds.shape == (ROLLOUT_STEPS, *got.shape)
    assert_close(preds[:, :n], np.asarray(preds_j)[:, :n], ROLLOUT_TOL,
                 "rollout")


def test_plate_trainer_step_matches_jax():
    """accumulation_steps=2 (the warmup gate), then two updates (the
    first at the schedule's rate 0), both fed
    the same noise draw each step, with deforming_plate's noise (σ 0.003
    on the world positions, γ 1.0): per-step losses and each tensor's
    update. JAX's trainer runs its plain `segment` aggregation; the GMP's
    kernel route is held against JAX's interpret-mode kernels above."""
    jcfg = model()[0]
    _, _, hj, ht = group()[SERVED]
    node_in, target, mask = plate_frames(SERVED)
    opt_kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=6)
    tcfg = deforming_plate_config(unet_depth=DEPTH, hidden_layer=HIDDEN,
                                  accumulation_steps=2)
    assert tcfg.datasets.noise_gamma == 1.0
    jtr = JaxTrainer(JaxConfig(
        model=dataclasses.replace(jcfg, accumulation_steps=2,
                                  aggregation="segment"),
        datasets=JaxDatasetConfig(
            noise_level=list(tcfg.datasets.noise_level),
            noise_gamma=tcfg.datasets.noise_gamma),
        opt=JaxOptConfig(**opt_kw)), init_key=jax.random.PRNGKey(3))
    ttr = Trainer(tcfg, OptConfig(**opt_kw), device="cpu")
    init = params_from_numpy(jax_to_nested(jtr.state.sim.params))
    ttr.sim.load_state_dict(init)

    ni, nt, m = (jnp.asarray(a) for a in (node_in, target, mask))
    ti, tt, tm = (torch.from_numpy(a) for a in (node_in, target, mask))
    key = jax.random.PRNGKey(7)
    losses_j, losses_t = [], []
    for i in range(4):
        k = jax.random.fold_in(key, i)
        z = torch.tensor(np.asarray(jax.random.normal(k, nt.shape, nt.dtype)))
        losses_j.append(float(jtr.iter(hj, ni, nt, m, k)))
        losses_t.append(float(ttr.iter(ht, ti, tt, tm, z)))
    assert ttr.step == jtr.step == 4 and ttr.updates == 2
    np.testing.assert_allclose(losses_t[:2], losses_j[:2], rtol=1e-6)
    np.testing.assert_allclose(losses_t[2:], losses_j[2:], rtol=1e-4)
    want = params_from_numpy(jax_to_nested(jtr.state.sim.params))
    for k, p in ttr.sim.state_dict().items():
        upd = p.numpy() - init[k].numpy()
        upd_j = want[k].numpy() - init[k].numpy()
        rms = np.sqrt(np.mean(upd_j.astype(np.float64) ** 2))
        assert rms > 0, k
        err = np.sqrt(np.mean((upd - upd_j).astype(np.float64) ** 2))
        assert err <= 1e-2 * rms, f"{k}: update rms err {err:.3e} of {rms:.3e}"
