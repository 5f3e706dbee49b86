"""Device selection shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU: `None`
means CUDA, and without a CUDA device that raises instead of carrying on
silently on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """`None` -> the current CUDA device (raises without one); anything else
    is passed to `torch.device` as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
