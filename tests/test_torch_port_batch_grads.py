"""The batch axis of the port's simulator (a shared windowed mesh, the
`fused` method) against the JAX package on the CPU: `Simulator.forward` at
B = 2 against JAX's `simulator_forward` (and each sample against the
port's forward on that frame alone), then the masked RMSE over the batch
and every parameter's gradient against `jax.value_and_grad(
Trainer._loss_fn)`.

The case is `test_torch_port_slice.py`'s (a 24×24 grid with scrambled ids,
depth 3, window 128, edge_block 512, latent 128, hidden 2); JAX's Pallas
kernels run in interpret mode, vmapped over the batch. One JAX compile
gives both references: the loss's gradient with the prediction beside it.

The frames' seed is fixed because the gradients are piecewise smooth: a
ReLU input within f32 rounding of zero lands on the side its order of
sums picks, and the two sides' weight gradients lie ~1e-3 of their RMS
apart. No frame keeps the tile tests' margin of 3e-6 (the port's ReLU
inputs at B = 2 hold 1,715-1,790 within it at each seed tried), so some
seeds put a unit on its kink. `frame_seed_sweep.py` in this directory
runs seeds 0-45: 33 land at the rounding level or within GRAD_F32_TOL,
and each of the 13 that miss comes back within it after a nudge of the
frames by one f32 step (12 of them to the clean seeds' ~1e-5 of RMS).
Seed 41 is a clean one (6.8e-6 of RMS)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_slice import F32_TOL, case  # noqa: F401 (fixture)
from test_torch_port_train import GRAD_F32_TOL, jax_param_grads

from bsms_gnn_tpu.config import Config as JaxConfig
from bsms_gnn_tpu.models.simulator import simulator_forward_auto
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer
from bsms_gnn_tpu.training.trainer import masked_rmse as jax_masked_rmse
from bsms_gnn_tpu_torch.training.trainer import masked_rmse

B = 2
FRAME_SEED = 41


def make_frames(node_in, mask, real):
    """B training frames on a case's mesh from its frame `node_in` and
    `mask`: seeded output fields on the `real` rows (the frame's positions
    and node types), targets near them; masked nodes keep their fields."""
    rng = np.random.default_rng(FRAME_SEED)
    node_in = np.repeat(node_in[None], B, axis=0)
    mask = np.repeat(mask[None], B, axis=0)
    node_in[:, real, :3] = rng.standard_normal((B, int(real.sum()), 3))
    tar = node_in[..., :3] + 0.1 * rng.standard_normal(
        node_in[..., :3].shape).astype(np.float32)
    tar = tar * (mask > 0) + node_in[..., :3] * (mask == 0)
    return node_in, tar.astype(np.float32), mask


@pytest.fixture(scope="module")
def frames(case):
    return make_frames(case["node_in"], case["mask"],
                       case["hj"].levels[0].node_mask[:, 0] > 0)


@pytest.fixture(scope="module")
def jax_ref(case, frames):
    """(prediction, loss, gradients) of JAX's f32 model on the batch, from
    one compile: `jax.value_and_grad` of `Trainer._loss_fn`'s body
    (`training/trainer.py:117-123`: `simulator_forward_auto`, then
    `masked_rmse`), with the prediction kept as its aux output."""
    hj, jcfg, state = case["hj"], case["jcfg"], case["state"]
    jtr = JaxTrainer(JaxConfig(model=jcfg), init_key=jax.random.PRNGKey(0))

    def loss_fn(params, ni, nt, m):
        pred = simulator_forward_auto(params, state.norm_in, state.norm_out,
                                      hj, ni, m, jtr.cfg.model,
                                      jtr.compute_dtype)
        return jax_masked_rmse(pred, nt, m), pred

    args = tuple(jnp.asarray(a) for a in frames)
    (loss, pred), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(state.params, *args)
    return np.asarray(pred), float(loss), jax_param_grads(grads)


def test_forward_batched_matches_jax(case, frames, jax_ref):
    """`Simulator.forward` on [B, N_pad, ...] against JAX's forward on the
    same batch (F32_TOL), and each sample bit for bit the port's forward on
    that frame alone."""
    ht, sim = case["ht"], case["sim"]
    node_in, _, mask = frames
    want = jax_ref[0]
    with torch.no_grad():
        got = sim(ht, torch.from_numpy(node_in), torch.from_numpy(mask))
        assert got.shape == want.shape == (B, ht.levels[0].n_pad_nodes, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL)
        for s in range(B):
            one = sim(ht, torch.from_numpy(node_in[s]),
                      torch.from_numpy(mask[s]))
            assert torch.equal(got[s], one)


def test_batched_loss_and_gradients_match_jax(case, frames, jax_ref):
    """The masked RMSE over the batch and every parameter's gradient at B
    = 2 against JAX's, f32: the loss to 1e-5, each gradient to
    GRAD_F32_TOL of its RMS."""
    ht, sim = case["ht"], case["sim"]
    _, loss_j, want = jax_ref
    sim.zero_grad(set_to_none=True)
    ni, nt, m = (torch.from_numpy(a) for a in frames)
    loss = masked_rmse(sim(ht, ni, m), nt, m)
    loss.backward()
    got = {k: p.grad for k, p in sim.named_parameters()}
    sim.zero_grad(set_to_none=True)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    for k, w in want.items():
        w, g = w.numpy(), got[k].numpy()
        rms = np.sqrt(np.mean(w.astype(np.float64) ** 2))
        assert rms > 0, k
        err = np.abs(g - w).max()
        assert err <= GRAD_F32_TOL * rms, f"{k}: {err:.3e} vs rms {rms:.3e}"
