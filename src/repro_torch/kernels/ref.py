"""Plain PyTorch versions of the port's kernels (the correctness contract).

Port of ``repro.kernels.ref``, for the kernels ported so far.  Each function
computes what its CUDA kernel computes, in the same arithmetic, so the
kernel can be held against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.digitize import _lloyd_half_step, _lloyd_loop
from repro_torch.core.metrics import dtw_ref
from repro_torch.core.normalize import ewm_scan

__all__ = ["ewma_scan_ref", "kmeans_assign_ref", "kmeans_lloyd_ref",
           "dtw_batch_ref"]


def ewma_scan_ref(ts, alpha):
    """Plain version of ``kernels.ewma.ewma_scan_cuda``: ``core.normalize.
    ewm_scan`` on f32 ``ts (B, T)`` -> ``means, vars (B, T) f32``."""
    return ewm_scan(torch.as_tensor(ts, dtype=torch.float32), alpha)


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


def kmeans_lloyd_ref(coords, mask, c_init, k, iters: int):
    """Plain version of ``kernels.kmeans.kmeans_lloyd_cuda``.

    ``coords (S, N, D)``, ``mask (S, N)``, ``c_init (S, K, D)``, ``k (S,)``
    (centers ``[0, k_s)`` active): ``iters`` rounds of ``kmeans_assign_ref``
    and the center update.  Returns ``centers (S, K, D) f32`` and the last
    round's ``labels (S, N) i32`` (0 on masked rows; all 0 when ``iters =
    0``).
    """
    coords = torch.as_tensor(coords, dtype=torch.float32)
    c_init = torch.as_tensor(c_init, dtype=torch.float32, device=coords.device)
    k = torch.as_tensor(k, device=coords.device)
    active = (torch.arange(c_init.shape[1], device=coords.device)[None, :]
              < k[:, None])
    return _lloyd_loop(
        lambda centers: kmeans_assign_ref(coords, mask, centers, active),
        c_init, coords.shape[1], int(iters))


def dtw_batch_ref(x, y, band=None):
    """Plain version of ``kernels.dtw.dtw_cuda``: ``core.metrics.dtw_ref``
    on batched pairs ``x, y (B, N)`` -> ``(B,) f32``."""
    return dtw_ref(x, y, band=band)
