"""Configuration (counterpart of `bsms_gnn_tpu/config.py`, the dataclasses
only, with the airfoil defaults of `bsms_gnn_tpu/configs/`, the
inflating-font presets as `inflating_font_config`, the flag presets as
`flag_simple_config` and the cylinder-flow presets as
`cylinder_flow_config`; no YAML loading yet).

`ModelConfig.aggregation` picks one of the JAX package's two production
methods: `"fused"` (the fused edge-phase kernels: the windowed ones on
windowed layouts with at most one world-space stream, the streamed-input
ones on unwindowed layouts and for other world-space streams) or
`"pallas"` (any layout: gathers, the edge MLP as plain matmuls, then the
fused aggregation + node-phase kernel). The parity-oracle methods `"ell"` and `"segment"` are not ported.
`DatasetConfig` keeps the fields the trainer reads (the noise) and those
that shape a variable-mesh dataset's hierarchies (`graph/buckets.py`)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
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
    # World-space edge features (Δworld, ‖Δworld‖ beside Δmesh): the first
    # `world_dim` output channels are world positions (0 = pos_dim).
    world_edges: bool = False
    world_dim: int = 0
    # "fused" or "pallas" (see the module docstring).
    aggregation: str = "fused"
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
    # False: every trajectory has its own mesh (variable-mesh datasets),
    # padded to its size group's buckets.
    consist_mesh: bool = True
    # Node pads round up to this multiple (and to 128, and to window / 2).
    pad_multiple: int = 128
    # Edge slots per chunk of the block-aligned layouts.
    edge_block: int = 128
    # Variable-mesh datasets: the number of size groups, by level-0 nodes.
    size_buckets: int = 1
    # Source-window rows of the windowed layouts (Morton-ordered meshes);
    # 0 = unwindowed.
    window: int = 0


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


def inflating_font_config(**model_overrides) -> Config:
    """The inflating elastic surface: `configs/model/inflating_font.yaml`
    and `configs/datasets/inflating_font.yaml` of the JAX package (a closed
    3-D surface whose world positions are the output fields, world-space
    edges), on the `pallas` method, bench.py's method for it (the `fused`
    method runs world edges too: `aggregation="fused"`). `model_overrides`
    replace ModelConfig fields (bench.py's surface point sets
    unet_depth=7)."""
    model = ModelConfig(latent_dim=128, hidden_layer=3, unet_depth=4,
                        out_dim=3, pos_dim=3, accumulation_steps=300,
                        world_edges=True, aggregation="pallas")
    return Config(model=replace(model, **model_overrides),
                  datasets=DatasetConfig(noise_level=[0.003] * 3,
                                         noise_gamma=1.0))


def flag_simple_config(**model_overrides) -> Config:
    """The cloth flag: `configs/model/flag_simple.yaml` and
    `configs/datasets/flag_simple.yaml` of the JAX package (a 2-D mesh
    moving in 3-D world space, world positions as the output fields,
    world-space edges), on the `fused` method, the JAX package's recipe for
    world edges on a windowed, Morton-ordered layout. `model_overrides`
    replace ModelConfig fields."""
    model = ModelConfig(latent_dim=128, hidden_layer=3, unet_depth=5,
                        out_dim=3, pos_dim=2, accumulation_steps=300,
                        world_edges=True, world_dim=3, aggregation="fused")
    return Config(model=replace(model, **model_overrides),
                  datasets=DatasetConfig(noise_level=[0.003] * 3,
                                         noise_gamma=0.1))


def cylinder_flow_config(**model_overrides) -> Config:
    """Flow past a cylinder: `configs/model/cylinder_flow.yaml` and
    `configs/datasets/cylinder_flow.yaml` of the JAX package (velocity as
    the output fields, 2-D meshes, one mesh per trajectory), on the `fused`
    method. `model_overrides` replace ModelConfig fields."""
    model = ModelConfig(latent_dim=128, hidden_layer=3, unet_depth=5,
                        out_dim=2, pos_dim=2, accumulation_steps=300,
                        aggregation="fused")
    return Config(model=replace(model, **model_overrides),
                  datasets=DatasetConfig(noise_level=[0.02, 0.02],
                                         noise_gamma=1.0, consist_mesh=False))
