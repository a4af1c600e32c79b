"""SymED in PyTorch: the resident service ported from the JAX package.

Subpackages mirror ``repro``'s (``core``, ``kernels``, ``launch``, ``data``)
so every module has an obvious counterpart.  The port imports ``torch`` and
numpy only.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; they never fall back to the CPU on their own.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA was asked for (explicitly or by default) and is absent.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
