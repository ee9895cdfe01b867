"""The batch axis of the port's trainer (a shared windowed mesh, the
`fused` method) against the JAX package on the CPU: `Trainer.iter` at B =
2 over a warmup-gate step and two updates against JAX's `Trainer`, fed
JAX's own noise. JAX's trainer runs its plain aggregation (`segment`,
no Pallas kernel): the port's `fused` kernels' plain versions are held
against JAX's interpret-mode kernels in `test_torch_port_batch.py` and
`test_torch_port_batch_grads.py`, and the plain model compiles in ~5 s
against ~25 s, which keeps this file well inside its budget alone.

The mesh and frame are `test_torch_port_slice.py`'s (a 24×24 grid with
scrambled ids, depth 3, window 128, edge_block 512, latent 128, hidden
2), the batch `test_torch_port_batch_grads.py`'s frames. The trainers
draw their own weights, so the slice's model is not built."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from conftest import make_grid_mesh
from test_torch_port_batch_grads import make_frames
from test_torch_port_slice import DEPTH
from test_torch_port_train import jax_param_grads
from test_torch_port_weights import (
    jax_to_nested,
    normalizer_to_dict,
    small_configs,
)

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import OptConfig as JaxOptConfig
from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import Config, ModelConfig, OptConfig
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.training.schedule import warmup_cosine_schedule
from bsms_gnn_tpu_torch.training.trainer import Trainer


@pytest.fixture(scope="module")
def mesh():
    """(JAX's hierarchy, the port's, the model config, the B frames):
    the slice case's mesh and frame, built as
    `test_torch_port_slice.py::case` builds them."""
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
    n_pad = hj.levels[0].n_pad_nodes
    node_in = np.zeros((n_pad, 3 + 2 + 1), np.float32)
    node_in[:n, :3] = rng.standard_normal((n, 3))
    node_in[:n, 3:5] = pos / 24.0
    node_type = np.where(rng.uniform(size=n) < 0.1, 4, 0)
    node_in[:n, 5] = node_type
    mask = np.zeros((n_pad, 1), np.float32)
    mask[:n, 0] = node_type == 0
    frames = make_frames(node_in, mask, hj.levels[0].node_mask[:, 0] > 0)
    return hj, ht, small_configs(depth=DEPTH, hidden=2)[0], frames


def test_batched_trainer_matches_jax_trainer(mesh):
    """`Trainer.iter` on [B, N_pad, ...]: accumulation_steps=1 (the warmup
    gate over both frames), then 2 updates at a warmup-cosine rate, both
    trainers fed the same noise draw (JAX's, in the batch's shape) each
    step: the losses, the normalizer states after the gate and the
    parameters after the last update, as `test_torch_port_train.py`'s
    trainer test holds them."""
    hj, ht, jcfg, (node_in, target, mask) = mesh
    opt_kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=6)
    jtr = JaxTrainer(JaxConfig(model=dataclasses.replace(
        jcfg, accumulation_steps=1, aggregation="segment"),
        opt=JaxOptConfig(**opt_kw)),
        init_key=jax.random.PRNGKey(3))
    tcfg = ModelConfig(latent_dim=128, hidden_layer=jcfg.hidden_layer,
                       unet_depth=DEPTH, accumulation_steps=1,
                       aggregation="fused")
    ttr = Trainer(Config(model=tcfg), OptConfig(**opt_kw), device="cpu")
    init = params_from_numpy(jax_to_nested(jtr.state.sim.params))
    ttr.sim.load_state_dict(init)

    ni, nt, m = (jnp.asarray(a) for a in (node_in, target, mask))
    ti, tt, tm = (torch.from_numpy(a) for a in (node_in, target, mask))
    key = jax.random.PRNGKey(7)
    losses_j, losses_t = [], []
    for i in range(3):
        k = jax.random.fold_in(key, i)
        z = jax.random.normal(k, nt.shape, nt.dtype)
        losses_j.append(float(jtr.iter(hj, ni, nt, m, k)))
        losses_t.append(float(ttr.iter(ht, ti, tt, tm,
                                       torch.tensor(np.asarray(z)))))
    assert ttr.step == jtr.step == 3 and ttr.updates == 2
    np.testing.assert_allclose(losses_t[:1], losses_j[:1], rtol=1e-6)
    np.testing.assert_allclose(losses_t[1:], losses_j[1:], rtol=1e-4)
    assert len(set(losses_t)) == 3

    for name in ("norm_in", "norm_out"):
        want = normalizer_to_dict(getattr(jtr.state.sim, name))
        got = getattr(ttr.sim, name)
        for f in ("acc_weight", "num_accumulations", "e_x", "e_x2"):
            np.testing.assert_allclose(getattr(got, f).numpy(), want[f],
                                       rtol=1e-5, err_msg=f"{name}.{f}")
    want = jax_param_grads(jtr.state.sim.params)
    # As `test_torch_port_train.py::test_trainer_matches_jax_trainer`: each
    # tensor's update to 1e-2 of its RMS in RMS, every weight but one in a
    # thousand to a quarter of the summed rates, every weight to twice
    # them. The first update runs at rate 0, so one update moves weights.
    sched = warmup_cosine_schedule(**opt_kw)
    rates = sum(sched(k) for k in range(2))
    for k, p in ttr.sim.state_dict().items():
        w, p0 = want[k].numpy(), init[k].numpy()
        diff = np.abs(p.numpy() - w)
        assert diff.max() <= 2 * rates, k
        assert (diff > 0.25 * rates).mean() <= 1e-3, k
        upd, upd_j = p.numpy() - p0, w - p0
        rms = np.sqrt(np.mean(upd_j.astype(np.float64) ** 2))
        assert rms > 0, k  # every tensor moved
        err = np.sqrt(np.mean((upd - upd_j).astype(np.float64) ** 2))
        assert err <= 1e-2 * rms, f"{k}: update rms err {err:.3e} of {rms:.3e}"
