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


def same_device(a, b) -> bool:
    """Whether two devices are one: a CUDA device named without an index
    is the current card."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return a.index == b.index or None in (a.index, b.index)
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (
        cur if b.index is None else b.index)
