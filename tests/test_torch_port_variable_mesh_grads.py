"""The port's variable-mesh path against the JAX package on the CPU: the
masked RMSE of a frame pair on a bucketed windowed hierarchy and every
parameter's gradient against `jax.value_and_grad` of the JAX trainer's
loss (kernels 5, 6, 7, 1's level form and 9 in their plain versions on
the port's side, the JAX kernels in interpret mode). The group, model and
frames are `test_torch_port_variable_mesh.py`'s.

Tolerance: each gradient within 1e-3 of its RMS (f32 sums in other
orders); the loss 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_port_buckets import WINDOW
from test_torch_port_train import jax_param_grads
from test_torch_port_variable_mesh import (  # noqa: F401 (fixture)
    frames,
    model,
    sim,
)

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.ops.kernels import segment_sum_accum as ssa
from bsms_gnn_tpu_torch.training.trainer import masked_rmse

GRAD_TOL = 1e-3


def test_loss_and_gradients_match_jax(sim):
    """The masked RMSE of the 600-node mesh's frame pair and every
    parameter's gradient against `jax.value_and_grad` of the JAX
    trainer's loss."""
    jcfg, _, state, _ = model()
    hj, ht, node_in, target, mask = frames(WINDOW)[1]
    jtr = JaxTrainer(JaxConfig(model=jcfg), init_key=jax.random.PRNGKey(0))
    args = tuple(jnp.asarray(a) for a in (node_in, target, mask))
    loss_j, grads_j = jax.jit(lambda p, *a: jax.value_and_grad(
        jtr._loss_fn)(p, state, hj, *a))(state.params, *args)
    want = jax_param_grads(grads_j)
    ni, nt, m = (torch.from_numpy(a) for a in (node_in, target, mask))
    ssa.segment_sum_accum_plain.calls = 0
    loss = masked_rmse(sim(ht, ni, m), nt, m)
    loss.backward()
    assert ssa.segment_sum_accum_plain.calls > 0
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    got = {k: p.grad for k, p in sim.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w, gk = w.numpy(), got[k].numpy()
        rms = np.sqrt(np.mean(w.astype(np.float64) ** 2))
        assert rms > 0, k
        err = np.abs(gk - w).max()
        assert err <= GRAD_TOL * rms, f"{k}: {err:.3e} vs rms {rms:.3e}"
