"""The port's sharded rollout and noisy train step (`parallel/halo.py`:
`halo_rollout`, `HaloTrainer`) on a gloo group of four CPU ranks.

On `test_halo.py`'s 9×9 grid at depth 2:
- a 3-step `halo_rollout` (latent 16, `ell`, ghost layout, S = 2) against
  JAX's `make_halo_rollout` on the same plan;
- a warmup gate and two updates with a nonzero noise, every rank fed its
  part of one global draw, against the port's one-device `Trainer` fed the
  whole draw: the generic path (latent 16, `ell`, ghost and plain levels
  mixed, S = 4) and the ghost `fused` path with a replicated bottom level
  (latent 128, window 128, S = 2: kernels 4-7 and 2 through their plain
  versions, the replication boundary's group sum both ways);
- that path under remat (every GMP checkpointed: its forward, exchanges
  included, replayed in the backward) against no remat;
- every rank ends each run with the same parameters, bit for bit.

Tolerances: the rollout against JAX on the same plan within F32_TOL
(`test_torch_port_slice.py`'s); the steps' losses against the one-device
model `test_halo.py`'s rtol 2e-3, atol 2e-4; each update's summed,
clipped gradients within GRAD_RMS_TOL of each tensor's RMS in RMS (f32
sums in another order); each parameter's update (after − before) within
UPDATE_RMS_TOL of the reference update's RMS in RMS
(`test_torch_port_halo_train.py`'s); remat against no remat exactly."""

import jax.numpy as jnp
import numpy as np
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
    gather_shards,
    grad_errors,
    step_grads,
    update_errors,
)

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import ModelConfig as JaxModelConfig
from bsms_gnn_tpu.graph.bistride import build_bistride_levels as jax_levels
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.parallel import (
    build_partition as jax_partition,
    make_halo_rollout,
    make_mesh,
    partition_nodes,
)
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import (
    Config,
    DatasetConfig,
    ModelConfig,
    OptConfig,
)
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.parallel.partition import (
    build_partition,
    unpartition_nodes,
)
from bsms_gnn_tpu_torch.training.trainer import Trainer

OUT, DEPTH, N_PAD, WORLD, STEPS, ROLLOUT = 3, 2, 128, 4, 3, 3
F32_TOL = 5e-4
ONE_DEVICE_TOL = dict(rtol=2e-3, atol=2e-4)
GRAD_RMS_TOL = 1e-5
UPDATE_RMS_TOL = 1e-2
SMALL = dict(unet_depth=DEPTH, latent_dim=16, hidden_layer=1, out_dim=OUT,
             accumulation_steps=1, aggregation="ell")
WIDE = dict(SMALL, latent_dim=128, aggregation="fused")
OPT = dict(warmup_steps=2, decay_steps=20)
NOISE = dict(noise_level=[0.05] * OUT, noise_gamma=0.1)
GHOST = dict(block=32, local_layouts=True)
MIXED = dict(block=32, local_layouts=True, ghost_floor=45)
FUSED_REPL = dict(block=64, local_layouts=True, window=128,
                  replicate_floor=25)


@pytest.fixture(scope="module")
def case():
    pos, cells = make_grid_mesh(9, 9)
    n = len(pos)
    rng = np.random.default_rng(3)
    node_in = np.zeros((N_PAD, OUT + 3), np.float32)
    node_in[:n, :OUT] = rng.standard_normal((n, OUT))
    node_in[:n, OUT:OUT + 2] = pos
    node_tar = np.zeros((N_PAD, OUT), np.float32)
    node_tar[:n] = node_in[:n, :OUT] + 0.05 * rng.standard_normal((n, OUT))
    mask = np.zeros((N_PAD, 1), np.float32)
    mask[:n] = 1.0
    noise = rng.standard_normal((STEPS, N_PAD, OUT)).astype(np.float32)
    frame = dict(pos=pos, cells=cells, depth=DEPTH, n_pad=N_PAD,
                 node_in=node_in, node_tar=node_tar, mask=mask)

    jcfg = JaxModelConfig(**SMALL)
    state = jax_state_with_stats(jcfg)
    inits = {k: {n_: v.clone() for n_, v in Trainer(
        Config(model=ModelConfig(**m)),
        generator=torch.Generator().manual_seed(i), device="cpu").sim.state_dict().items()}
        for i, (k, m) in enumerate((("small", SMALL), ("wide", WIDE)))}
    train = dict(frame, kind="train", opt=OPT, steps=STEPS, datasets=NOISE,
                 noise=noise)
    cases = {
        "rollout": dict(frame, kind="forward", S=2, plan=GHOST, model=SMALL,
                        params=params_from_numpy(jax_to_nested(state.params)),
                        norm_in=normalizer_to_dict(state.norm_in),
                        norm_out=normalizer_to_dict(state.norm_out),
                        rollout=ROLLOUT),
        "noise_ell_s4": dict(train, S=4, plan=MIXED, model=SMALL,
                             params=inits["small"]),
        "noise_fused_s2": dict(train, S=2, plan=FUSED_REPL, model=WIDE,
                               params=inits["wide"]),
    }
    cases["noise_fused_s2_remat"] = dict(cases["noise_fused_s2"],
                                         model=dict(WIDE, remat=True))
    group = Group(cases, WORLD)

    # JAX's rollout, while the ranks run.
    jl = jax_levels(jax_flat_edge(cells, "tri"), DEPTH, n, pos)
    plan = jax_partition(jl, 2, N_PAD, pos, **GHOST)
    ro = make_halo_rollout(JaxTrainer(JaxConfig(model=jcfg)), make_mesh(1, 2),
                           plan, ROLLOUT)
    rollout = np.asarray(ro(state, jnp.asarray(partition_nodes(plan, node_in)),
                            jnp.asarray(partition_nodes(plan, mask))))

    # The port's one-device trainers on the whole frame and draw.
    one = {}
    for k, model, params, win in (
            ("noise_ell_s4", SMALL, inits["small"], {}),
            ("noise_fused_s2", WIDE, inits["wide"],
             dict(edge_block=128, window=128))):
        tr = Trainer(Config(datasets=DatasetConfig(**NOISE),
                            model=ModelConfig(**model),
                            opt=OptConfig(**OPT)), device="cpu")
        tr.sim.load_state_dict(params)
        h = to_device(build_hierarchy(to_flat_edge(cells, "tri"), DEPTH, n,
                                      pos, pad_multiple=N_PAD, **win), "cpu")
        ins = [torch.from_numpy(a) for a in (node_in, node_tar, mask)]
        losses, grads = [], []
        for i in range(STEPS):
            losses.append(float(tr.iter(h, *ins, torch.from_numpy(noise[i]))))
            grads.append(step_grads(tr))
        one[k] = dict(losses=losses, grads=grads, params={
            k2: v.numpy().copy() for k2, v in tr.sim.state_dict().items()})
    tl = build_bistride_levels(to_flat_edge(cells, "tri"), DEPTH, n, pos)
    return dict(n=n, cases=cases, one=one, rollout=rollout, inits=inits,
                plan=build_partition(tl, 2, N_PAD, pos, **GHOST),
                results=group.results())


def check_replicas(case, name):
    """Every rank of the group holds the same parameters, bit for bit."""
    s = case["cases"][name]["S"]
    res = case["results"]
    for r in range(1, s):
        for k, v in res[0][name]["params"].items():
            assert np.array_equal(v, res[r][name]["params"][k]), (r, k)


def test_halo_rollout_matches_jax(case):
    n, plan = case["n"], case["plan"]
    got = unpartition_nodes(plan, gather_shards(case["results"], "rollout",
                                                "rollout", 2))
    want = unpartition_nodes(plan, case["rollout"])
    assert got.shape == want.shape == (ROLLOUT, N_PAD, OUT)
    np.testing.assert_allclose(got[:, :n], want[:, :n], rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("name", ["noise_ell_s4", "noise_fused_s2"])
def test_noisy_step_matches_one_device_trainer(case, name):
    """The gate and two updates against the one-device `Trainer`: the
    losses, the summed and clipped gradients of each update (all taken at
    the initial weights: the first update's rate is schedule(0) = 0) and
    each parameter's update (after − before)."""
    got, want = case["results"][0][name], case["one"][name]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               **ONE_DEVICE_TOL)
    assert got["grads"][0] is None and want["grads"][0] is None
    for i in range(1, STEPS):
        errs = grad_errors(got["grads"][i], want["grads"][i])
        worst = max(errs, key=errs.get)
        assert errs[worst] <= GRAD_RMS_TOL, (i, worst, errs[worst])
    model = "small" if name == "noise_ell_s4" else "wide"
    errs = update_errors(got["params"], want["params"], case["inits"][model])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= UPDATE_RMS_TOL, (worst, errs[worst])
    check_replicas(case, name)
    if name == "noise_fused_s2":
        calls = got["plain_calls"]
        for k in ("fused_edge_phase_win", "fused_edge_phase_win_bwd",
                  "fused_node_phase", "fused_node_phase_bwd",
                  "windowed_conv", "windowed_send_sum"):
            assert calls[k] > 0, k


def test_remat_matches_no_remat(case):
    a = case["results"][0]["noise_fused_s2"]
    b = case["results"][0]["noise_fused_s2_remat"]
    np.testing.assert_array_equal(a["losses"], b["losses"])
    for k, v in a["params"].items():
        np.testing.assert_array_equal(v, b["params"][k], err_msg=k)
    check_replicas(case, "noise_fused_s2_remat")
    # The replayed forwards call the forward kernels again.
    assert (b["plain_calls"]["fused_edge_phase_win"]
            > a["plain_calls"]["fused_edge_phase_win"])
