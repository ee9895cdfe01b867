"""PyTorch and CUDA port of `bsms_gnn_tpu` for NVIDIA Hopper (H100).

Serving and training run here: `graph.hierarchy.build_hierarchy` and
`to_device`, `models.simulator.Simulator`,
`training.rollout.rollout_trajectory` and `training.trainer.Trainer`, on
the `fused` method (windowed and unwindowed hierarchies, with or without
world-space edges, and the bucketed hierarchies of variable-mesh datasets
with `graph.buckets.plan_buckets`) and the `pallas` method (block-aligned
hierarchies, world-space edges included), through seventeen hand-written
CUDA kernels
(`ops/kernels/`). Entry points default to the CUDA card and
raise where there is none; pass `device="cpu"` for the plain PyTorch
versions. The two CLIs, `python -m bsms_gnn_tpu_torch.train` and
`python -m bsms_gnn_tpu_torch.rollout`, take the JAX CLIs' overrides
(`config.load_config`) plus `device=cpu`, read HDF5 datasets
(`data/`) and write checkpoints with the optimizer state
(`training/checkpoint.py`). The package imports nothing of JAX or of
`bsms_gnn_tpu`, needs no PyYAML, and imports h5py only where it writes
or reads HDF5.
"""
