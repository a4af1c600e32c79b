"""Offline ABBA baseline (Elsworth & Guettel 2020) -- the paper's comparator.

Port of ``repro.core.abba``.  ABBA = (global z-normalization) -> (greedy
piecewise-linear compression) -> (k-means digitization with
tolerance-driven k search) -> symbols.

Segmentation reuses the SymED sender: with ``alpha=0`` on globally
pre-normalized data EWMV stays at exactly 1.0, which makes the online error
test *identical* to ABBA's offline criterion ``SSE <= (len_ts - 2) *
tol^2``.  Digitization is a deterministic offline k-search (quantile init +
farthest-point growth), warm-started Lloyd.

The global mean and std sum in the order the reference's CPU compilation
sums an f32 reduction (``digitize._row_sum``: windows of 32 points, the
padding split evenly before and after, until 32 or fewer remain); the
division by ``T`` is a multiply by ``f32(1/T)``.  That order is written
out on every device (``ordered=True``), here and in the k-search's
reductions outside the Lloyd loop, so the normalized stream, the pieces
and the coordinates are bitwise equal on the CPU and on the card.  The
Lloyd loops run in the Lloyd kernel on the card
(``kernels.ops.kmeans_lloyd``), whose sums are the only ones in another
order, and in the plain version on the CPU, bitwise to the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import digitize as dg
from repro_torch.core.compress import compress_stream
from repro_torch.core.normalize import fma32, sqrt32
from repro_torch.core.receiver import compact_events

__all__ = ["AbbaResult", "abba_encode"]

class AbbaResult(NamedTuple):
    labels: torch.Tensor    # (n_max,) int32
    centers: torch.Tensor   # (k_max, 2) in normalized piece space
    k: torch.Tensor         # () int32
    lengths: torch.Tensor   # (n_max,) int32 true piece lengths
    incs: torch.Tensor      # (n_max,) f32 true (normalized-space) increments
    n_pieces: torch.Tensor  # () int32
    mean: torch.Tensor      # () f32 global normalization params
    std: torch.Tensor       # () f32


def _kmeans_growth(coords, mask, n, *, k_min, k_max, tol, lloyd_iters,
                   use_kernel):
    """Deterministic offline k-search: quantile seed, farthest-point growth.

    ``coords (n_max, 2)``, ``mask (n_max,)``, ``n ()``.  The growth loop
    tests its predicate on the host (``digitize._any``, one sync a trip).
    """
    n_max, k_cap = coords.shape[0], k_max
    dev = coords.device
    bound = float(np.float32(tol) * np.float32(tol))

    # seed k_min centers at inc-quantiles of the active pieces
    order = torch.argsort(
        torch.where(mask, coords[:, 1], torch.full_like(coords[:, 1], 1e30)),
        stable=True)
    k0 = torch.clamp_max(n, k_min).to(torch.int32)
    pos = ((torch.arange(k_cap, device=dev, dtype=torch.float32) + 0.5)
           * (n.float() / torch.clamp_min(k0.float(), 1.0)))
    idx = order[torch.clamp(pos.to(torch.int32), 0, n_max - 1).long()]
    c_init = coords[idx]

    def run(c_init, k):
        c, lab = dg.masked_kmeans_table(coords[None], mask[None], c_init[None],
                                        k.reshape(1), lloyd_iters,
                                        use_kernel=use_kernel)
        err = dg.max_cluster_variance(coords[None], mask[None], c, lab,
                                      k.reshape(1), ordered=True)
        return c[0], lab[0], err[0]

    c, lab, err = run(c_init, k0)
    k_hi = torch.clamp_max(n, min(k_max, n_max)).to(torch.int32)
    k = k0
    while dg._any((k < k_hi) & (err > bound)):
        # farthest-point growth: new center = active piece farthest from its
        # center
        diff = coords - c[lab.long()]
        d = fma32(diff[:, 1], diff[:, 1], diff[:, 0] * diff[:, 0])
        far = torch.argmax(torch.where(mask, d, torch.full_like(d, -1.0)))
        c_new = dg._put_rows(c[None], k.reshape(1), coords[far][None])[0]
        k = k + 1
        c, lab, err = run(c_new, k)
    return c, lab, k


def abba_encode(ts, *, n_max: int = 512, tol: float = 0.5, scl: float = 1.0,
                len_max: int = 512, k_min: int = 3, k_max: int = 100,
                lloyd_iters: int = 20, device=None) -> AbbaResult:
    """Offline ABBA on a single stream ``(T,)``.

    ``device``: where it runs, ``cuda`` unless ``"cpu"`` is passed; on the
    card the k-search's Lloyd loops run in the Lloyd kernel.
    """
    dev = resolve_device(device)
    ts = torch.as_tensor(ts, dtype=torch.float32, device=dev)
    inv_t = float(np.float32(1.0) / np.float32(ts.shape[0]))
    mean = dg._row_sum(ts, 0, ordered=True) * inv_t
    centered = ts - mean
    std = torch.clamp_min(
        sqrt32(dg._row_sum(centered * centered, 0, ordered=True) * inv_t),
        1e-12)
    tn = (ts - mean) / std

    # alpha=0 freezes EWMV at 1.0 -> exact offline ABBA segmentation criterion
    events = compress_stream(tn, tol=tol, len_max=len_max, alpha=0.0)
    wire = compact_events(events, n_max=n_max, t0=tn[0])

    pieces = torch.stack([wire["lengths"].float(), wire["incs"]], dim=-1)
    mask = torch.arange(n_max, device=dev) < wire["n_pieces"]
    _, coords = dg.scale_coords(pieces[None], mask[None], scl, ordered=True)
    c, lab, k = _kmeans_growth(
        coords[0], mask, wire["n_pieces"], k_min=k_min, k_max=k_max, tol=tol,
        lloyd_iters=lloyd_iters, use_kernel=dev.type == "cuda")
    centers_raw, _ = dg._raw_centers(pieces[None], mask[None], lab[None],
                                     c.shape[0])
    return AbbaResult(
        labels=torch.where(mask, lab, torch.zeros_like(lab)),
        centers=centers_raw[0],
        k=k,
        lengths=wire["lengths"],
        incs=wire["incs"],
        n_pieces=wire["n_pieces"],
        mean=mean,
        std=std,
    )
