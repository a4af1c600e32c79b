"""Public entry points for the port's kernels.

Dispatch: a CUDA tensor goes to the hand-written kernel, which either runs
or raises; a CPU tensor goes to the plain PyTorch version in
``repro_torch.kernels.ref``.  ``force_ref=True`` takes the plain version on
any device.  Nothing falls back from a failed kernel to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.dtw import dtw_cuda
from repro_torch.kernels.ewma import ewma_scan_cuda
from repro_torch.kernels.kmeans import kmeans_assign_cuda, kmeans_lloyd_cuda

__all__ = ["ewma_scan", "kmeans_assign", "kmeans_lloyd", "dtw"]


def ewma_scan(ts, alpha, *, force_ref: bool = False):
    """Batched EWMA/EWMV ``(B, T) -> (means, vars)``, both ``(B, T) f32``."""
    if force_ref or not torch.as_tensor(ts).is_cuda:
        return ref.ewma_scan_ref(ts, alpha)
    return ewma_scan_cuda(ts.float().contiguous(), alpha)


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


def kmeans_lloyd(coords, mask, c_init, k, iters: int, *,
                 force_ref: bool = False):
    """``iters`` Lloyd iterations (assign, then move each non-empty cluster's
    center to its mean) for S independent problems, in one kernel launch.

    ``coords (S, N, D) f32``, ``mask (S, N)``, ``c_init (S, K, D) f32``,
    ``k (S,)`` (centers ``[0, k_s)`` active) -> ``centers (S, K, D) f32``,
    ``labels (S, N) i32`` of the last iteration (0 on masked rows).
    """
    if force_ref or not torch.as_tensor(coords).is_cuda:
        return ref.kmeans_lloyd_ref(coords, mask, c_init, k, iters)
    mask = mask if mask.dtype == torch.bool else mask != 0
    return kmeans_lloyd_cuda(coords.contiguous(), mask.contiguous(),
                             c_init.contiguous(),
                             k.to(torch.int32).contiguous(), iters)


def dtw(x, y, band=None, *, force_ref: bool = False):
    """Batched banded DTW distances ``(B, N) x (B, N) -> (B,)``."""
    if force_ref or not torch.as_tensor(x).is_cuda:
        return ref.dtw_batch_ref(x, y, band)
    return dtw_cuda(x.float().contiguous(), y.float().contiguous(), band)
