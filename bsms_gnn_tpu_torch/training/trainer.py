"""The trainer: AdamW + warmup-cosine + global-norm clip, with the
normalizer-warmup gate and on-device noise injection (counterpart of
`bsms_gnn_tpu/training/trainer.py`).

  * masked RMSE loss √(Σ mask·se / Σ mask / C), over the whole batch;
  * the first `accumulation_steps` steps only accumulate normalizer
    statistics (padding excluded, Dirichlet nodes included) and update no
    parameter; their loss is that of the zero prediction;
  * Gaussian noise with per-channel σ on the output-field channels, zero on
    masked nodes, drawn on the device; the target absorbs (1−γ)·noise;
  * the update is optax's `chain(clip_by_global_norm, adamw(schedule))`:
    `torch.optim.AdamW(betas=(0.9, 0.999), eps=1e-8)` computes optax's
    adamw step when the k-th update (k = 0, 1, ...) runs at
    `schedule(k)`, counted by updates only (the warmup-gate steps do not
    count, so the first update's rate is schedule(0) = 0), and when the
    gradients were clipped as optax clips them: scaled by
    max_norm / norm only when norm ≥ max_norm.

A step takes one frame ([N_pad, ...]) or a batch of frames over one
shared hierarchy ([B, N_pad, ...]): the noise is drawn in node_tar's shape,
the warmup gate accumulates every sample's rows, and the loss is taken over
the batch, as JAX's `Trainer.iter` does.

Not ported (each raises NotImplementedError): `gradient_accumulation_steps
> 1` (optax.MultiSteps), `remat`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from bsms_gnn_tpu_torch.config import Config, OptConfig
from bsms_gnn_tpu_torch.device import resolve_device
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

    `Trainer(cfg, opt, generator=None, device=None, compute_dtype=None)`:
    weights are drawn from `generator` (default: seeded with
    `cfg.base_seed`), and the noise generator on `device` is seeded from it.
    `device=None` is the CUDA card and raises without one. `compute_dtype`
    None is f32, `torch.bfloat16` the bf16 recipe.
    """

    def __init__(self, cfg: Config, opt: OptConfig,
                 generator: Optional[torch.Generator] = None, device=None,
                 compute_dtype=None):
        if opt.gradient_accumulation_steps > 1:
            raise NotImplementedError(
                "gradient_accumulation_steps > 1 (optax.MultiSteps)")
        if cfg.model.remat:
            raise NotImplementedError("remat")
        self.cfg, self.opt_cfg = cfg, opt
        self.device = resolve_device(device)
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
            pad_mask = hierarchy.levels[0].node_mask.expand_as(node_mask)
            simulator_warmup(self.sim, node_in, node_tar, pad_mask)
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
            clip_by_global_norm([p.grad for p in params],
                                self.opt_cfg.gnorm_clip)
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.updates)
            self.optimizer.step()
            self.updates += 1
        self._step += 1
        return loss.detach()

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
