"""Why `test_torch_port_batch_grads.py` and `test_torch_port_batch_contact.py`
fix their frames' seeds: the port's loss gradient at B = 2 against JAX's
over a range of frame seeds, and for each seed where a gradient misses
GRAD_F32_TOL of its RMS, whether a nudge of the frames by one f32 step
puts the port back on JAX's.

    JAX_PLATFORMS=cpu python tests/frame_seed_sweep.py [FIRST LAST [NUDGES]]
    JAX_PLATFORMS=cpu python tests/frame_seed_sweep.py contact [FIRST ...]
    JAX_PLATFORMS=cpu python tests/frame_seed_sweep.py wide [FIRST ...]

The first form sweeps the slice case's frames (`test_torch_port_batch_
grads.py`), the second the flag case's (`test_torch_port_batch_contact.py`:
the contact recipe's world z drawn from the seed), `wide` and `wide128`
`test_torch_port_wide.py`'s train frame at latent 256 and 128 with four
tail layers.

The gradients are piecewise smooth: a ReLU input within f32 rounding of
zero lands on the side its order of sums picks, and the two sides' weight
gradients differ by ~1e-3 of their RMS. A miss that a one-step nudge of
the inputs (each field and position moved up, down or not, at random)
brings back to the rounding level of the clean seeds (~1e-5 of RMS) is
such a kink, not a fault of the port. One JAX compile serves every seed.
"""

import os
import sys

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import conftest  # noqa: E402,F401 (the CPU platform)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_port_batch_contact as contact_batch  # noqa: E402
import test_torch_port_batch_grads as grads_test  # noqa: E402
import test_torch_port_contact as contact_test  # noqa: E402
import test_torch_port_slice as slice_test  # noqa: E402
import test_torch_port_wide as wide_test  # noqa: E402
from test_torch_port_train import GRAD_F32_TOL, jax_param_grads  # noqa: E402

from bsms_gnn_tpu.config import Config as JaxConfig  # noqa: E402
from bsms_gnn_tpu.models.simulator import simulator_forward_auto  # noqa: E402
from bsms_gnn_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from bsms_gnn_tpu.training.trainer import (  # noqa: E402
    masked_rmse as jax_masked_rmse,
)
from bsms_gnn_tpu_torch.training.trainer import masked_rmse  # noqa: E402


def slice_frames(case, seed):
    grads_test.FRAME_SEED = seed
    return grads_test.make_frames(case["node_in"], case["mask"],
                                  case["hj"].levels[0].node_mask[:, 0] > 0)


def contact_frames(case, seed):
    node_in, target = contact_batch.make_frames(
        case["node_in"], case["target"], case["n"], seed)
    return node_in, target, np.repeat(case["mask"][None], contact_batch.B,
                                      axis=0)


def wide_case(c, layers):
    """`test_torch_port_wide.py`'s mesh and model at (c, layers)."""
    mesh = wide_test.mesh._get_wrapped_function()()
    jcfg, state, sim = wide_test.model(c, layers)
    return dict(mesh, jcfg=jcfg, state=state, sim=sim)


def wide_frames(case, seed):
    return (*wide_test.train_frame(case, seed), case["mask"])


# case name → (its module-scoped fixture or case builder, its frames for a
# seed)
CASES = {"slice": (slice_test.case, slice_frames),
         "contact": (contact_test.case, contact_frames),
         "wide": (lambda: wide_case(256, 4), wide_frames),
         "wide128": (lambda: wide_case(128, 4), wide_frames)}


def main(name="slice", first=0, last=45, nudges=200):
    fixture, make_frames = CASES[name]
    wrapped = getattr(fixture, "_get_wrapped_function", None)
    case = wrapped()() if wrapped else fixture()
    hj, ht, jcfg, state, sim = (case[k] for k in
                                ("hj", "ht", "jcfg", "state", "sim"))
    jtr = JaxTrainer(JaxConfig(model=jcfg), init_key=jax.random.PRNGKey(0))

    def loss_fn(params, ni, nt, m):
        pred = simulator_forward_auto(params, state.norm_in, state.norm_out,
                                      hj, ni, m, jtr.cfg.model,
                                      jtr.compute_dtype)
        return jax_masked_rmse(pred, nt, m)

    jax_grad = jax.jit(jax.grad(loss_fn))

    relu, near = torch.relu, [0]

    def counted_relu(x):  # counts the ReLU inputs within 3e-6 of zero
        near[0] += int((x.detach().abs() < 3e-6).sum())
        return relu(x)

    def port_grads(ni, nt, m, count=False):
        sim.zero_grad(set_to_none=True)
        ni, nt, m = (torch.from_numpy(a) for a in (ni, nt, m))
        near[0] = 0
        torch.relu = counted_relu if count else relu
        try:
            masked_rmse(sim(ht, ni, m), nt, m).backward()
        finally:
            torch.relu = relu
        return {k: p.grad.numpy().copy() for k, p in sim.named_parameters()}

    def worst(want, got):
        return max(np.abs(got[k] - w).max()
                   / np.sqrt(np.mean(w.astype(np.float64) ** 2))
                   for k, w in want.items())

    misses = []
    for seed in range(first, last + 1):
        frames = make_frames(case, seed)
        want = {k: v.numpy() for k, v in jax_param_grads(jax_grad(
            state.params, *(jnp.asarray(a) for a in frames))).items()}
        at = worst(want, port_grads(*frames, count=True))
        line = (f"seed {seed}: {near[0]} ReLU inputs within 3e-6 of zero; "
                f"worst gradient {at:.2e} of its RMS")
        if at > GRAD_F32_TOL:
            rng = np.random.default_rng(seed)
            best = np.inf
            for k in range(nudges):
                ni = frames[0].copy()
                f = ni[..., :5]
                step = rng.integers(-1, 2, size=f.shape)
                moved = np.where(step > 0, np.nextafter(f, np.float32(np.inf)),
                                 np.nextafter(f, np.float32(-np.inf)))
                ni[..., :5] = np.where((step != 0) & (f != 0), moved, f)
                best = min(best, worst(want, port_grads(ni, *frames[1:])))
                if best < 2e-5:
                    break
            line += (f": MISS; nearest after {k + 1} one-step nudges "
                     f"{best:.2e}")
            misses.append((seed, at, best))
        print(line, flush=True)
    print(f"{len(misses)} of {last - first + 1} seeds miss GRAD_F32_TOL "
          f"({GRAD_F32_TOL:g}); of those, "
          f"{sum(b <= GRAD_F32_TOL for _, _, b in misses)} are within it "
          f"and {sum(b < 2e-5 for _, _, b in misses)} at the clean seeds' "
          f"rounding level (< 2e-5) after a one-step nudge")


if __name__ == "__main__":
    args = sys.argv[1:]
    name = args.pop(0) if args and args[0] in CASES else "slice"
    main(name, *(int(a) for a in args))
