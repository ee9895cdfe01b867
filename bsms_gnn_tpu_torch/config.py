"""Model configuration (counterpart of `bsms_gnn_tpu/config.py::ModelConfig`,
the dataclass only, with the airfoil defaults of
`bsms_gnn_tpu/configs/model/airfoil.yaml`). The port runs the JAX
package's `aggregation=fused` method on windowed layouts only, so it has no
`aggregation` field."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ModelConfig:
    latent_dim: int = 128
    hidden_layer: int = 3
    unet_depth: int = 7
    out_dim: int = 3
    pos_dim: int = 2
    # Encode/decode MLP dtype: "" = the compute dtype; "float32" pins the
    # normalized I/O boundary to full precision while the processor runs in
    # the compute dtype.
    io_dtype: str = ""
