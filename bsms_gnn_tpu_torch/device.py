"""The card is the default device of every public entry point."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card, and raises where there is none: the CPU
    (and with it the plain PyTorch versions of the kernels) is taken only
    when the caller asks for it by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
