"""PyTorch and CUDA port of `bsms_gnn_tpu` for NVIDIA Hopper (H100).

The serving path runs here: `graph.hierarchy.build_hierarchy` and
`to_device`, `models.simulator.Simulator` and
`training.rollout.rollout_trajectory`, through four hand-written CUDA
kernels (`ops/kernels/`). Entry points default to the CUDA card and raise
where there is none; pass `device="cpu"` for the plain PyTorch versions.
The package imports nothing of JAX or of `bsms_gnn_tpu`.
"""
