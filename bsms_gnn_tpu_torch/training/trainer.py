"""The trainer: AdamW + warmup-cosine + global-norm clip, with the
normalizer-warmup gate and on-device noise injection (counterpart of
`bsms_gnn_tpu/training/trainer.py`).

  * masked RMSE loss √(Σ mask·se / Σ mask / C), over the whole batch;
  * the first `accumulation_steps` steps only accumulate normalizer
    statistics (padding excluded, Dirichlet nodes included) and update no
    parameter; their loss is that of the zero prediction;
  * Gaussian noise with per-channel σ on the output-field channels, zero on
    masked nodes, drawn on the device; the target absorbs (1−γ)·noise;
  * the update is optax's `chain(clip_by_global_norm, adamw(schedule))`,
    wrapped in `optax.MultiSteps` when `gradient_accumulation_steps` k > 1:
    `torch.optim.AdamW(betas=(0.9, 0.999), eps=1e-8)` computes optax's
    adamw step when the n-th update (n = 0, 1, ...) runs at
    `schedule(n)`, counted by updates only (the warmup-gate steps do not
    count, so the first update's rate is schedule(0) = 0), and when the
    gradients were clipped as optax clips them: scaled by
    max_norm / norm only when norm ≥ max_norm. With k > 1 each train step
    folds its gradients into their running mean as MultiSteps does
    (acc + (g − acc) / (i + 1) at mini-step i) and every k-th applies
    clip + AdamW to the mean and resets it; the other steps leave the
    parameters as they are. The schedule still counts applied updates,
    and the warmup-gate steps are no mini-steps (JAX's gate never calls
    the optimizer).

A step takes one frame ([N_pad, ...]) or a batch ([B, N_pad, ...]) of
frames over one shared hierarchy or of samples on the union of theirs
(`data.pipeline.stack_hierarchies`): the noise is drawn in node_tar's
shape, the warmup gate accumulates every sample's real rows, and the loss
is taken over the batch, as JAX's `Trainer.iter` does. `remat`
(`ModelConfig`) checkpoints the GMPs (`ops/bsgmp.py`).

`state_dict()` / `load_state_dict()` carry everything a resumed run needs
(`training/checkpoint.py` saves them): the parameters, both normalizers,
the AdamW moments and counts by parameter name, the step, update and
mini-step counts, MultiSteps' running mean and the noise generator's
state. `convert.py` turns them into JAX's `TrainState` and back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from bsms_gnn_tpu_torch.config import Config, OptConfig
from bsms_gnn_tpu_torch.device import resolve_device
from bsms_gnn_tpu_torch.models.normalizer import NormalizerState
from bsms_gnn_tpu_torch.models.simulator import Simulator, simulator_warmup
from bsms_gnn_tpu_torch.training.schedule import warmup_cosine_schedule


def masked_rmse(pred, tar, mask):
    se = (pred - tar).square()
    return torch.sqrt((se * mask).sum() / mask.sum() / se.shape[-1])


def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place on `grads`: all of them scaled by
    max_norm / norm when their global L2 norm reaches max_norm, untouched
    below it. Returns the norm before clipping."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Trainer:
    """Owns the simulator, its optimizer and the step counts.

    `Trainer(cfg, opt=None, generator=None, device=None,
    compute_dtype=None)`: `opt` None is `cfg.opt`; weights are drawn from
    `generator` (default: seeded with `cfg.base_seed`), and the noise
    generator on `device` is seeded from it. `device=None` is the CUDA card
    and raises without one. `compute_dtype` None is
    `cfg.model.compute_dtype` ("float32": f32, "bfloat16": the bf16
    recipe); `torch.bfloat16` asks for bf16 whatever the config says.
    """

    def __init__(self, cfg: Config, opt: Optional[OptConfig] = None,
                 generator: Optional[torch.Generator] = None, device=None,
                 compute_dtype=None):
        opt = cfg.opt if opt is None else opt
        if opt.gradient_accumulation_steps < 1:
            raise ValueError("gradient_accumulation_steps must be >= 1")
        self.cfg, self.opt_cfg = cfg, opt
        self.device = resolve_device(device)
        if compute_dtype is None and cfg.model.compute_dtype == "bfloat16":
            compute_dtype = torch.bfloat16
        self.compute_dtype = compute_dtype
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.base_seed)
        self.sim = Simulator(cfg.model, generator, self.device)
        seed = int(torch.randint(0, 2**62, (1,), generator=generator))
        self.noise_generator = torch.Generator(self.device).manual_seed(seed)
        self.optimizer = torch.optim.AdamW(
            self.sim.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=opt.weight_decay)
        self.schedule = warmup_cosine_schedule(opt.peak_lr, opt.warmup_steps,
                                               opt.decay_steps)
        self.noise_level = torch.tensor(cfg.datasets.noise_level,
                                        dtype=torch.float32,
                                        device=self.device)
        self.noise_gamma = float(cfg.datasets.noise_gamma)
        self._step = 0  # train steps taken, warmup included
        self.updates = 0  # optimizer updates taken
        # MultiSteps' mini-step in [0, k) and running mean of the gradients
        # (k > 1 only).
        self.mini_step = 0
        self.acc_grads = None

    # -- noise ------------------------------------------------------------

    def inject_noise(self, node_in, node_tar, node_mask, noise=None):
        """Add σ·z to the output-field channels of node_in (zero on masked
        nodes) and (1−γ)·σ·z to the target. `z` is `noise` when given (a
        standard-normal draw shaped like node_tar), else a fresh draw from
        the trainer's generator."""
        if noise is None:
            noise = torch.randn(node_tar.shape, generator=self.noise_generator,
                                device=node_tar.device, dtype=node_tar.dtype)
        c = self.noise_level.shape[0]
        noise = noise * self.noise_level
        noise = torch.where(node_mask == 0, 0.0, noise)
        node_in = torch.cat([node_in[..., :c] + noise, node_in[..., c:]],
                            dim=-1)
        return node_in, node_tar + (1.0 - self.noise_gamma) * noise

    # -- steps ------------------------------------------------------------

    def loss(self, hierarchy, node_in, node_tar, node_mask):
        """The differentiable masked RMSE of the prediction."""
        pred = self.sim(hierarchy, node_in, node_mask, self.compute_dtype)
        return masked_rmse(pred, node_tar, node_mask)

    def iter(self, hierarchy, node_in, node_tar, node_mask, noise=None):
        """One training iteration on a frame or a batch of frames; returns
        the scalar loss (detached)."""
        node_in, node_tar = self.inject_noise(node_in, node_tar, node_mask,
                                              noise)
        if self._step < self.cfg.model.accumulation_steps:
            # Level 0's real rows: [N_pad, 1], or on a union [B·N_pad, 1],
            # read as the batch's [B, N_pad, 1].
            pad_mask = hierarchy.levels[0].node_mask
            if hierarchy.samples > 1 and node_mask.dim() == 3:
                pad_mask = pad_mask.reshape(hierarchy.samples, -1, 1)
            simulator_warmup(self.sim, node_in, node_tar,
                             pad_mask.expand_as(node_mask))
            loss = masked_rmse(torch.zeros_like(node_tar), node_tar,
                               node_mask)
        else:
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.loss(hierarchy, node_in, node_tar, node_mask)
            loss.backward()
            params = list(self.sim.parameters())
            for p in params:  # optax reads an unused parameter's as zero
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if self._accumulate(params):
                clip_by_global_norm([p.grad for p in params],
                                    self.opt_cfg.gnorm_clip)
                for group in self.optimizer.param_groups:
                    group["lr"] = self.schedule(self.updates)
                self.optimizer.step()
                self.updates += 1
        self._step += 1
        return loss.detach()

    def _accumulate(self, params) -> bool:
        """optax.MultiSteps' bookkeeping: whether this step applies an
        update. With k > 1 the step's gradients join the running mean
        (Welford's update, as optax computes it); on the k-th mini-step the
        mean becomes the parameters' gradients and the mean restarts."""
        k = self.opt_cfg.gradient_accumulation_steps
        if k == 1:
            return True
        grads = [p.grad for p in params]
        if self.acc_grads is None:
            self.acc_grads = [torch.zeros_like(g) for g in grads]
        i = self.mini_step
        for a, g in zip(self.acc_grads, grads):
            a.add_((g - a) / (i + 1))
        self.mini_step = (i + 1) % k
        if self.mini_step:
            return False
        for p, a in zip(params, self.acc_grads):
            p.grad = a.clone()
            a.zero_()
        return True

    # -- state ------------------------------------------------------------

    def state_dict(self) -> dict:
        """Everything a resumed run needs, as tensors, numbers and dicts
        (what `torch.load(..., weights_only=True)` reads back): "params"
        (the simulator's state_dict), "norm_in" / "norm_out" (the
        normalizers' fields), "adam" ({name: {"step", "exp_avg",
        "exp_avg_sq"}}, empty before the first update), "step", "updates",
        "mini_step", "acc_grads" ({name: running mean} under MultiSteps
        once a step has run, else None) and "noise_generator" (its device
        type and state)."""
        names = [k for k, _ in self.sim.named_parameters()]
        opt_state = self.optimizer.state_dict()["state"]
        return {
            "params": {k: v.detach().clone()
                       for k, v in self.sim.state_dict().items()},
            "norm_in": _normalizer_dict(self.sim.norm_in),
            "norm_out": _normalizer_dict(self.sim.norm_out),
            "adam": {names[i]: {k: v.detach().clone() for k, v in st.items()}
                     for i, st in opt_state.items()},
            "step": self._step,
            "updates": self.updates,
            "mini_step": self.mini_step,
            "acc_grads": (None if self.acc_grads is None else
                          {k: a.detach().clone()
                           for k, a in zip(names, self.acc_grads)}),
            "noise_generator": {"device": self.noise_generator.device.type,
                                "state": self.noise_generator.get_state()},
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore `state_dict()`'s output (or `convert.
        train_state_from_jax`'s, which has no generator state: the
        trainer's own generator is kept then) onto this trainer's
        device."""
        names = [k for k, _ in self.sim.named_parameters()]
        self.sim.load_state_dict(state["params"])
        self.sim.norm_in = _normalizer_from_dict(state["norm_in"],
                                                 self.device)
        self.sim.norm_out = _normalizer_from_dict(state["norm_out"],
                                                  self.device)
        adam = state["adam"]
        unknown = set(adam) - set(names)
        if unknown:
            raise KeyError(f"AdamW state for unknown parameters "
                           f"{sorted(unknown)}")
        opt_sd = self.optimizer.state_dict()
        opt_sd["state"] = {i: {f: v.clone() for f, v in adam[k].items()}
                           for i, k in enumerate(names) if k in adam}
        self.optimizer.load_state_dict(opt_sd)
        self._step = int(state["step"])
        self.updates = int(state["updates"])
        self.mini_step = int(state["mini_step"])
        acc = state["acc_grads"]
        self.acc_grads = None if acc is None else [
            acc[k].to(self.device, torch.float32).clone() for k in names]
        gen = state.get("noise_generator")
        if gen is not None:
            if gen["device"] != self.noise_generator.device.type:
                raise ValueError(
                    f"the noise generator's state is a {gen['device']} "
                    f"generator's; this trainer's is on "
                    f"{self.noise_generator.device.type}")
            self.noise_generator.set_state(gen["state"].cpu())

    # -- evaluation -------------------------------------------------------

    @torch.no_grad()
    def get_pred(self, hierarchy, node_in, node_mask):
        return self.sim(hierarchy, node_in, node_mask, self.compute_dtype)

    def get_loss(self, hierarchy, node_in, node_tar, node_mask):
        pred = self.get_pred(hierarchy, node_in, node_mask)
        return masked_rmse(pred, node_tar, node_mask)

    def get_loss_and_error(self, hierarchy, node_in, node_tar, node_mask,
                           relative: bool = True
                           ) -> Tuple[float, np.ndarray, np.ndarray]:
        """(loss, per-channel error mean, std) from one forward pass."""
        pred = self.get_pred(hierarchy, node_in, node_mask)
        loss = float(masked_rmse(pred, node_tar, node_mask))
        mean, std = self._error_stats(
            pred.cpu().numpy(), node_tar.cpu().numpy(),
            node_mask.cpu().numpy(), relative)
        return loss, mean, std

    def get_error(self, hierarchy, node_in, node_tar, node_mask,
                  relative: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Per-channel (relative) error mean/std over valid nodes only."""
        pred = self.get_pred(hierarchy, node_in, node_mask)
        return self._error_stats(pred.cpu().numpy(), node_tar.cpu().numpy(),
                                 node_mask.cpu().numpy(), relative)

    @staticmethod
    def _error_stats(pred: np.ndarray, tar: np.ndarray, mask: np.ndarray,
                     relative: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        err = np.sqrt(np.where(mask > 0, (pred - tar) ** 2, 0.0))
        if relative:
            tar_sqr = np.where(mask > 0, tar**2, 0.0)
            tar_scale = np.sqrt(
                tar_sqr.sum(axis=-2, keepdims=True)
                / (mask.sum(axis=-2, keepdims=True) + 1e-6)
            ) + 1e-6
            err = err / tar_scale
        flat = err.reshape(-1, err.shape[-1])
        fmask = (mask.reshape(-1, 1) > 0)[:, 0]
        sel = flat[fmask]
        return sel.mean(axis=0), sel.std(axis=0)

    @property
    def step(self) -> int:
        return self._step


def _normalizer_dict(state: NormalizerState) -> dict:
    return {f: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for f, v in vars(state).items()}


def _normalizer_from_dict(d: dict, device) -> NormalizerState:
    return NormalizerState(**{
        k: (v.to(device, torch.float32).clone()
            if isinstance(v, torch.Tensor) else float(v))
        for k, v in d.items()})
