"""Plain PyTorch versions of the port's kernels (the correctness contract).

Port of ``repro.kernels.ref``, for the kernels ported so far.  Each function
computes what its CUDA kernel computes, in the same arithmetic, so the
kernel can be held against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.digitize import _lloyd_half_step

__all__ = ["kmeans_assign_ref"]


def kmeans_assign_ref(x, mask, centers, center_active):
    """Plain version of ``kernels.kmeans.kmeans_assign_cuda``.

    ``x (S, N, D)``, ``mask (S, N)`` (bool, or nonzero = valid),
    ``centers (S, K, D)``, ``center_active (S, K)`` (likewise).  Returns
    ``labels (S, N) i32`` with masked rows zeroed, ``sums (S, K, D) f32``,
    ``counts (S, K) f32``: ``digitize._lloyd_half_step`` with the kernel's
    zeroed labels.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    centers = torch.as_tensor(centers, dtype=torch.float32, device=x.device)
    mask = torch.as_tensor(mask, device=x.device) != 0
    active = torch.as_tensor(center_active, device=x.device) != 0
    labels, sums, counts = _lloyd_half_step(x, mask, centers, active)
    return torch.where(mask, labels, torch.zeros_like(labels)), sums, counts
