"""Configuration (counterpart of `bsms_gnn_tpu/config.py`, the dataclasses
only, with the airfoil defaults of `bsms_gnn_tpu/configs/`; no YAML
loading yet). The port runs the JAX package's `aggregation=fused` method on
windowed layouts only, so `ModelConfig` has no `aggregation` field.
`DatasetConfig` keeps only the fields the trainer reads (the noise)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class ModelConfig:
    latent_dim: int = 128
    hidden_layer: int = 3
    unet_depth: int = 7
    out_dim: int = 3
    pos_dim: int = 2
    # Normalizer warmup steps (NOT gradient accumulation): the first
    # `accumulation_steps` train steps only accumulate normalizer statistics.
    accumulation_steps: int = 300
    # Encode/decode MLP dtype: "" = the compute dtype; "float32" pins the
    # normalized I/O boundary to full precision while the processor runs in
    # the compute dtype.
    io_dtype: str = ""
    # Checkpoint each GMP block. Not ported: the trainer raises on True.
    remat: bool = False


@dataclass
class DatasetConfig:
    # Training noise: per-channel σ on the output fields, and the share
    # (1 − γ) of it the target absorbs.
    noise_level: List[float] = field(
        default_factory=lambda: [10.0, 10.0, 0.01])
    noise_gamma: float = 1.0


@dataclass
class OptConfig:
    peak_lr: float = 1e-4
    end_lr: float = 1e-7  # unused, as in the reference
    warmup_steps: int = 20000
    decay_steps: int = 200000
    gnorm_clip: float = 1.0
    weight_decay: float = 1e-4
    # optax.MultiSteps in the JAX package. Not ported: the trainer raises
    # on > 1.
    gradient_accumulation_steps: int = 1


@dataclass
class Config:
    """The groups the trainer reads besides the optimizer's."""

    model: ModelConfig = field(default_factory=ModelConfig)
    datasets: DatasetConfig = field(default_factory=DatasetConfig)
    base_seed: int = 42
