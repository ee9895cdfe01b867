"""The port's `"fused4"` train step against the JAX package on the CPU:
the loss and every parameter's gradient against JAX's `"fused4"` and
JAX's `"fused"`, on `test_torch_port_interleave_model.py`'s case (3 of
its 9 GMPs run kernel 14's plain forward and backward). Tolerances are
`test_torch_port_train.py`'s: the loss within 1e-5, each gradient's
largest error within `GRAD_F32_TOL` (1e-3) of its RMS.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_interleave_model import METHODS, case, jcfg  # noqa: F401
from test_torch_port_train import GRAD_F32_TOL, jax_param_grads

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp_k
from bsms_gnn_tpu_torch.training.trainer import masked_rmse


def test_loss_and_gradients_match_jax_fused4_and_fused(case):
    """The train step's loss and every parameter's gradient against
    `jax.value_and_grad` of JAX's trainer loss on both methods; the
    backward runs kernel 14's plain backward in 3 GMPs."""
    state, hj, sim = case["state"], case["hj"], case["sim"]
    args = tuple(jnp.asarray(case[k]) for k in ("node_in", "tar", "mask"))

    def loss_and_grads(method):
        jtr = JaxTrainer(JaxConfig(model=jcfg(method)),
                         init_key=jax.random.PRNGKey(0))
        return jax.value_and_grad(jtr._loss_fn)(state.params, state, hj,
                                                *args)

    want = jax.jit(lambda: [loss_and_grads(m) for m in METHODS])()
    sim.zero_grad(set_to_none=True)
    fused_gmp_k.fused_edge_phase_win_k_bwd_plain.calls = 0
    ni, nt, m = (torch.from_numpy(case[k]) for k in ("node_in", "tar",
                                                      "mask"))
    loss = masked_rmse(sim(case["ht"], ni, m), nt, m)
    loss.backward()
    assert fused_gmp_k.fused_edge_phase_win_k_bwd_plain.calls == 3
    got = {k: p.grad.numpy() for k, p in sim.named_parameters()}
    sim.zero_grad(set_to_none=True)
    for method, (loss_j, grads_j) in zip(METHODS, want):
        np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5,
                                   err_msg=method)
        grads_j = jax_param_grads(grads_j)
        assert sorted(got) == sorted(grads_j)
        for k, w in grads_j.items():
            w = w.numpy()
            rms = np.sqrt(np.mean(w.astype(np.float64) ** 2))
            assert rms > 0, k
            err = np.abs(got[k] - w).max()
            assert err <= GRAD_F32_TOL * rms, (
                f"{method} {k}: {err:.3e} vs rms {rms:.3e}")
