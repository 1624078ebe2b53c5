"""Where the port's entry points run: on the card unless told otherwise."""
from __future__ import annotations

import torch

from .kernels._build import cuda_available


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device on a machine without one
    raises: nothing moves to the CPU unless the caller passes "cpu"."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not cuda_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on the card by default — "
            "pass device='cpu' to run its plain PyTorch path")
    return dev
