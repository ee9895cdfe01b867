"""The port's `"fused4"` model against the JAX package on the CPU: the
simulator forward against JAX's `"fused4"` and JAX's `"fused"` with the
same weights and inputs, and a 3-step rollout against JAX's `"fused4"`
(the train step's loss and gradients are
`test_torch_port_interleave_grads.py`'s, apart so that test workers can
run the two side by side).

The case is `test_torch_port_interleave.py`'s Morton-ordered 2,000-node
airfoil (depth 4, window 256, edge_block 512) with the airfoil model at
latent 128, hidden 1: its levels 3 and 4 pass the density gate, so 3 of
the 9 GMPs run kernel 14's plain version (levels 3 down and up, 4) and 6
kernel 4's. JAX's `"fused4"` takes the explicit conv + pool transitions
(`bsgmp.py:71` tests the unstripped method) and its `"fused"` the fused
TransOps; the port takes the TransOps on both, so both JAX methods are a
reference for it.

Tolerance: `test_torch_port_slice.py`'s `F32_TOL` (5e-4, rtol and atol;
twice that for the rollout, as there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_interleave import DEPTH, airfoil
from test_torch_port_slice import F32_TOL
from test_torch_port_weights import jax_state_with_stats, port_simulator

from bsms_gnn_tpu.config import ModelConfig as JaxModelConfig
from bsms_gnn_tpu.models.simulator import simulator_forward
from bsms_gnn_tpu.training.rollout import rollout_trajectory as jax_rollout
from bsms_gnn_tpu_torch.config import ModelConfig
from bsms_gnn_tpu_torch.ops.kernels import fused_gmp, fused_gmp_k
from bsms_gnn_tpu_torch.training.rollout import rollout_trajectory

HIDDEN = 1
METHODS = ("fused4", "fused")


def jcfg(method):
    return JaxModelConfig(latent_dim=128, hidden_layer=HIDDEN,
                          unet_depth=DEPTH, aggregation=method)


@pytest.fixture(scope="module")
def case():
    hj, ht, pos, nt = airfoil()
    state = jax_state_with_stats(jcfg("fused4"))
    sim = port_simulator(ModelConfig(latent_dim=128, hidden_layer=HIDDEN,
                                     unet_depth=DEPTH, aggregation="fused4"),
                         state)
    n, n_pad = len(pos), ht.levels[0].n_pad_nodes
    rng = np.random.default_rng(3)
    node_in = np.zeros((n_pad, 6), np.float32)
    node_in[:n, :3] = rng.standard_normal((n, 3))
    node_in[:n, 3:5] = pos
    node_in[:n, 5] = nt[:, 0]
    mask = np.zeros((n_pad, 1), np.float32)
    mask[:n, 0] = nt[:, 0] == 0
    tar = node_in[:, :3] + 0.1 * rng.standard_normal((n_pad, 3)).astype(
        np.float32) * mask
    return dict(hj=hj, ht=ht, state=state, sim=sim, node_in=node_in,
                mask=mask, tar=tar)


def test_forward_matches_jax_fused4_and_fused(case):
    """The f32 prediction against both JAX methods (one jit for both);
    kernel 14's plain version runs in 3 GMPs, kernel 4's in 6."""
    state, hj = case["state"], case["hj"]
    node_in, mask, sim = case["node_in"], case["mask"], case["sim"]

    def both(ni, m):
        return [simulator_forward(state.params, state.norm_in,
                                  state.norm_out, hj, ni, m, jcfg(method))
                for method in METHODS]

    want = jax.jit(both)(jnp.asarray(node_in), jnp.asarray(mask))
    fused_gmp.fused_edge_phase_win_plain.calls = 0
    fused_gmp_k.fused_edge_phase_win_k_plain.calls = 0
    with torch.no_grad():
        got = sim(case["ht"], torch.from_numpy(node_in),
                  torch.from_numpy(mask)).numpy()
    assert fused_gmp_k.fused_edge_phase_win_k_plain.calls == 3
    assert fused_gmp.fused_edge_phase_win_plain.calls == 2 * DEPTH + 1 - 3
    for method, w in zip(METHODS, want):
        np.testing.assert_allclose(got, np.asarray(w), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=method)


def test_rollout_matches_jax_fused4(case):
    """Three closed-loop steps against JAX's `"fused4"` rollout."""
    state, hj = case["state"], case["hj"]
    node_in, mask, sim = case["node_in"], case["mask"], case["sim"]
    want = np.asarray(jax.jit(
        lambda ic, m: jax_rollout(state, hj, ic, m, 3, jcfg("fused4"))
    )(jnp.asarray(node_in), jnp.asarray(mask)))
    got = rollout_trajectory(sim, case["ht"], torch.from_numpy(node_in),
                             torch.from_numpy(mask), 3).numpy()
    assert got.shape == want.shape == (3, node_in.shape[0], 3)
    np.testing.assert_allclose(got, want, rtol=2 * F32_TOL, atol=2 * F32_TOL)
