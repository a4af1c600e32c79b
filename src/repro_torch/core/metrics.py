"""Evaluation metrics (paper Sec. 4.1): DTW reconstruction error, compression
rate, dimension-reduction rate.

Port of ``repro.core.metrics``.  ``dtw_ref`` is the plain PyTorch DTW (the
anti-diagonal wavefront, optionally Sakoe-Chiba banded); the CUDA kernel in
``repro_torch.kernels.dtw`` computes each cell in the same operations and
order, so the two agree bitwise on the card.  On the CPU ``dtw_ref``
agrees with the reference's within a few ulp: its compiled program fuses
the cell's multiply-add in most cells, as both port versions do in all.
``repro_torch.kernels.ops.dtw`` dispatches between them.  The rates divide
by a runtime point count: a true f32 division.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.normalize import fma32

__all__ = ["dtw_ref", "compression_rate_symed", "compression_rate_abba",
           "drr"]

_INF = 1e30


def dtw_ref(x: torch.Tensor, y: torch.Tensor,
            band: Optional[int] = None) -> torch.Tensor:
    """DTW distance between 1-D series (batched on leading axes).

    Local cost ``(x_i - y_j)^2``, accumulated along the optimal warping
    path; returns the sqrt of the accumulated cost.  Diagonal ``d`` holds
    cells ``(i, d - i)``:

        cur[i] = c[i, d-i] + min(min(prev[i-1], prev[i]), prev2[i-1])

    with the origin's predecessor 0 and every cell outside the grid or the
    band 1e30.  Each cell rounds ``x - y`` on its own and then ``diff *
    diff + best`` once, as a fused multiply-add (as the reference's compiled
    program does in most cells, and the CUDA kernel in all).

    Args:
      x: (..., N), y: (..., M).
      band: Sakoe-Chiba radius (``|i - j| <= band``); None = full DTW.  The
        radius is clamped to ``max(band, |N - M|)`` so that the terminal
        cell stays reachable.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    n, m = x.shape[-1], y.shape[-1]
    r = max(int(band), abs(n - m)) if band is not None else max(n, m)
    batch = torch.broadcast_shapes(x.shape[:-1], y.shape[:-1])
    x = x.expand(batch + (n,))
    y = y.expand(batch + (m,))

    ii = torch.arange(n, device=x.device)
    inf_col = torch.full(batch + (1,), _INF, dtype=torch.float32,
                         device=x.device)

    def shift(a):  # a[i - 1], 1e30 at i = 0
        return torch.cat([inf_col, a[..., :-1]], dim=-1)

    prev2 = torch.full(batch + (n,), _INF, dtype=torch.float32,
                       device=x.device)
    prev = prev2
    cur = prev2
    for d in range(n + m - 1):
        jj = d - ii
        valid = (jj >= 0) & (jj < m) & ((ii - jj).abs() <= r)
        diff = x - y[..., jj.clamp(0, m - 1)]
        best = torch.minimum(torch.minimum(shift(prev), prev), shift(prev2))
        if d == 0:  # the origin cell has no predecessor
            best = torch.where(ii == 0, 0.0, best)
        cur = torch.where(valid, fma32(diff, diff, best), _INF)
        prev2, prev = prev, cur
    return torch.sqrt(cur[..., n - 1])


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, device=like.device).to(torch.float32)


def compression_rate_symed(n_pieces: torch.Tensor, n_points) -> torch.Tensor:
    """CR_SymED = (bytes(P)/2) / bytes(T) = n / N  [paper Eq. 3]."""
    return n_pieces.float() / _f32(n_points, n_pieces)


def compression_rate_abba(n_pieces: torch.Tensor, k_clusters: torch.Tensor,
                          n_points: int) -> torch.Tensor:
    """CR_ABBA = (bytes(C) + bytes(S)) / bytes(T) = (8k + n) / 4N
    [paper Eq. 3]: 1-byte symbols, centers of two 4-byte floats."""
    num = 8.0 * k_clusters.float() + n_pieces.float()
    return num / (4.0 * _f32(n_points, n_pieces))


def drr(n_symbols: torch.Tensor, n_points) -> torch.Tensor:
    """Dimension-reduction rate len(S)/len(T)."""
    return n_symbols.float() / _f32(n_points, n_symbols)
