"""Public entry points for the port's kernels.

Dispatch: a CUDA tensor goes to the hand-written kernel, which either runs
or raises; a CPU tensor goes to the plain PyTorch version in
``repro_torch.kernels.ref``.  ``force_ref=True`` takes the plain version on
any device.  Nothing falls back from a failed kernel to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.kmeans import kmeans_assign_cuda

__all__ = ["kmeans_assign"]


def kmeans_assign(x, mask, centers, center_active, *, force_ref: bool = False):
    """One fused Lloyd assign + stats step for S independent problems.

    ``x (S, N, D) f32``, ``mask (S, N)``, ``centers (S, K, D) f32``,
    ``center_active (S, K)`` -> ``labels (S, N) i32`` (0 on masked rows),
    ``sums (S, K, D) f32``, ``counts (S, K) f32``.
    """
    if force_ref or not torch.as_tensor(x).is_cuda:
        return ref.kmeans_assign_ref(x, mask, centers, center_active)
    mask = mask if mask.dtype == torch.bool else mask != 0
    if center_active.dtype != torch.bool:
        center_active = center_active != 0
    return kmeans_assign_cuda(x.contiguous(), mask.contiguous(),
                              centers.contiguous(),
                              center_active.contiguous())
