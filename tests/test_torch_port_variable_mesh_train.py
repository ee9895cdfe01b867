"""The port's variable-mesh path against the JAX package on the CPU,
training: `Trainer` stepping across
the two meshes of one size group at batch 1 (a normalizer-warmup gate
step on one mesh, then two updates on the other: the first update's rate
is 0, as in the JAX schedule), against the JAX `Trainer` fed the same
noise. The group, model and frames are
`test_torch_port_variable_mesh.py`'s (the JAX kernels run in interpret
mode; each mesh compiles its own JAX train step, the gate step too, which
is why this test has a file of its own).

Tolerances: the losses 1e-6 through the gate (no model runs) and 1e-4
after the updates, the normalizer states 1e-5, each tensor's update within
1e-2 of its RMS.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_port_buckets import WINDOW
from test_torch_port_train import jax_param_grads
from test_torch_port_variable_mesh import frames, model
from test_torch_port_weights import jax_to_nested, normalizer_to_dict

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.config import DatasetConfig as JaxDatasetConfig
from bsms_gnn_tpu.config import OptConfig as JaxOptConfig
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.config import OptConfig
from bsms_gnn_tpu_torch.convert import params_from_numpy
from bsms_gnn_tpu_torch.training.trainer import Trainer


def test_trainer_across_meshes_matches_jax_trainer():
    """accumulation_steps=1: the gate step on the 450-node mesh (its
    normalizer statistics), then two updates on the 600-node mesh (one JAX
    compile; the first at rate 0 fills Adam's moments), each side fed the
    same noise draw (cylinder_flow's σ = 0.02 on the velocity): the losses,
    the normalizer states after the gate and each tensor's update."""
    jcfg, tcfg, _, _ = model()
    steps = frames(WINDOW)
    opt_kw = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=4)
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, accumulation_steps=1))
    jtr = JaxTrainer(JaxConfig(
        model=dataclasses.replace(jcfg, accumulation_steps=1),
        datasets=JaxDatasetConfig(
            noise_level=list(tcfg.datasets.noise_level),
            noise_gamma=tcfg.datasets.noise_gamma),
        opt=JaxOptConfig(**opt_kw)), init_key=jax.random.PRNGKey(3))
    ttr = Trainer(tcfg, OptConfig(**opt_kw), device="cpu")
    init = params_from_numpy(jax_to_nested(jtr.state.sim.params))
    ttr.sim.load_state_dict(init)

    key = jax.random.PRNGKey(7)
    losses_j, losses_t = [], []
    for i, m in enumerate((0, 1, 1)):
        hj, ht, node_in, target, mask = steps[m]
        k = jax.random.fold_in(key, i)
        z = jax.random.normal(k, target.shape, jnp.float32)
        losses_j.append(float(jtr.iter(hj, *(jnp.asarray(a) for a in
                                             (node_in, target, mask)), k)))
        losses_t.append(float(ttr.iter(
            ht, *(torch.from_numpy(a) for a in (node_in, target, mask)),
            torch.tensor(np.asarray(z)))))
        if i == 0:
            for name in ("norm_in", "norm_out"):
                want = normalizer_to_dict(getattr(jtr.state.sim, name))
                got = getattr(ttr.sim, name)
                for f in ("acc_weight", "num_accumulations", "e_x", "e_x2"):
                    np.testing.assert_allclose(
                        getattr(got, f).numpy(), want[f], rtol=1e-5,
                        atol=1e-7, err_msg=f"{name}.{f}")
    assert ttr.step == jtr.step == 3 and ttr.updates == 2
    np.testing.assert_allclose(losses_t[:1], losses_j[:1], rtol=1e-6)
    np.testing.assert_allclose(losses_t[1:], losses_j[1:], rtol=1e-4)
    want = jax_param_grads(jtr.state.sim.params)
    for k, p in ttr.sim.state_dict().items():
        upd = p.numpy() - init[k].numpy()
        upd_j = want[k].numpy() - init[k].numpy()
        rms = np.sqrt(np.mean(upd_j.astype(np.float64) ** 2))
        assert rms > 0, k
        err = np.sqrt(np.mean((upd - upd_j).astype(np.float64) ** 2))
        assert err <= 1e-2 * rms, f"{k}: update rms err {err:.3e} of {rms:.3e}"
