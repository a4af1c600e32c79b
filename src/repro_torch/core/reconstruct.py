"""Reconstruction: symbols/pieces -> time series (paper Sec. 3.2).

Port of ``repro.core.reconstruct``.  Three steps, batched over leading axes
so that the DTW monitor rebuilds many sessions at once:

  * inverse digitization -- replace each symbol by its center (len~, inc~),
  * quantization         -- cumulative-error rounding of lengths back to ints
                            (the carry keeps the total length, as in ABBA),
  * inverse compression  -- polygonal interpolation of the piece chain.

SymED's online reconstruction skips the first two steps and interpolates the
receiver's raw pieces directly.

The reference's prefix sums (``jnp.cumsum``) compile on the CPU to blocks of
16 summed in order, the block totals scanned the same way and each block's
prefix added to its elements.  ``_cumsum32`` writes that order out, on
every device, so the port's floats are bitwise equal to the reference's and
the integers of ``quantize_lengths`` exactly equal.  The interpolation's
multiply-add is fused as the reference's compiled program fuses it.
"""
from __future__ import annotations

import torch

from repro_torch.core.normalize import fma32

__all__ = [
    "inverse_digitization",
    "quantize_lengths",
    "inverse_compression",
    "reconstruct_from_pieces",
    "reconstruct_from_symbols",
]

_SCAN_BLOCK = 16


def _cumsum_seq(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis, added left to right."""
    acc = x[..., 0]
    out = [acc]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
        out.append(acc)
    return torch.stack(out, dim=-1)


def _cumsum32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sums along the last axis in the reference's
    compiled order (see the module doc)."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _cumsum_seq(x) if n else x
    nb = -(-n // _SCAN_BLOCK)
    pad = torch.zeros(x.shape[:-1] + (nb * _SCAN_BLOCK - n,), dtype=x.dtype,
                      device=x.device)
    blocks = torch.cat([x, pad], dim=-1).reshape(
        x.shape[:-1] + (nb, _SCAN_BLOCK))
    within = _cumsum_seq(blocks)
    totals = _cumsum32(within[..., -1])  # (..., nb) inclusive
    later = within[..., 1:, :] + totals[..., :-1, None]
    out = torch.cat([within[..., :1, :], later], dim=-2)
    return out.reshape(x.shape[:-1] + (nb * _SCAN_BLOCK,))[..., :n]


def _live(n_max: int, n_pieces, device) -> torch.Tensor:
    n_pieces = torch.as_tensor(n_pieces, device=device)
    return torch.arange(n_max, device=device) < n_pieces[..., None]


def inverse_digitization(labels: torch.Tensor,
                         centers: torch.Tensor) -> torch.Tensor:
    """symbols -> representative pieces: ``(..., n_max)`` int labels and
    ``(..., k, 2)`` centers -> ``(..., n_max, 2)`` f32."""
    labels = torch.as_tensor(labels, dtype=torch.long, device=centers.device)
    idx = labels[..., None].expand(labels.shape + (centers.shape[-1],))
    return torch.gather(centers, -2, idx)


def quantize_lengths(lengths: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Round fractional lengths to ints >= 1, carrying the rounding error.

    ``alloc_i = max(alloc_{i-1} + live_i, round(csum_i))`` in closed form:
    ``alloc_i = cnt_i + max(0, running_max(round(csum_j) - cnt_j))`` with
    ``cnt`` the live-piece count, so ``sum(q) == round(sum(lengths))``
    whenever each live piece can keep at least one point.  Batched on
    leading axes; returns int32.
    """
    lengths = torch.where(mask, torch.as_tensor(lengths, dtype=torch.float32),
                          0.0)
    r = torch.round(_cumsum32(lengths))
    cnt = _cumsum32(mask.to(torch.float32))
    runmax = torch.cummax(r - cnt, dim=-1).values
    alloc = cnt + torch.clamp_min(runmax, 0.0)
    prev = torch.cat([torch.zeros_like(alloc[..., :1]), alloc[..., :-1]],
                     dim=-1)
    q = (alloc - prev).to(torch.int32)
    return torch.where(mask, q, 0)


def inverse_compression(lengths: torch.Tensor, incs: torch.Tensor, n_pieces,
                        t0, total_len: int) -> torch.Tensor:
    """Interpolate the polygonal chain into ``total_len`` points.

    Args:
      lengths: (..., n_max) int piece lengths (padded with 0).
      incs: (..., n_max) f32 piece increments.
      n_pieces: (...,) valid counts.
      t0: (...,) f32 anchor values (first stream point).
      total_len: output length.

    Output index x lands in piece j with start_j <= x < start_{j+1}; its
    value is ``base_j + clip((x - start_j) / max(len_j, 1), 0, 1) * inc_j``.
    Indices beyond the chain hold the final endpoint.
    """
    incs = torch.as_tensor(incs, dtype=torch.float32)
    dev = incs.device
    n_max = lengths.shape[-1]
    live = _live(n_max, n_pieces, dev)
    lens = torch.where(live, torch.as_tensor(lengths, device=dev), 0).to(
        torch.float32)
    incs = torch.where(live, incs, 0.0)
    t0 = torch.as_tensor(t0, dtype=torch.float32, device=dev)
    batch = lens.shape[:-1]
    zero = torch.zeros(batch + (1,), dtype=torch.float32, device=dev)

    starts = torch.cat([zero, _cumsum32(lens)], dim=-1)
    bases = t0[..., None] + torch.cat([zero, _cumsum32(incs)], dim=-1)

    x = torch.arange(total_len, dtype=torch.float32, device=dev).expand(
        batch + (total_len,)).contiguous()
    # piece index of each output position (rightmost start <= x)
    j = torch.searchsorted(starts.contiguous(), x, right=True) - 1
    j = j.clamp(0, n_max - 1)
    start_j = torch.gather(starts, -1, j)
    len_j = torch.gather(lens, -1, j)
    frac = (x - start_j) / torch.clamp_min(len_j, 1.0)
    # the reference's compiled program fuses this multiply-add
    val = fma32(frac.clamp(0.0, 1.0), torch.gather(incs, -1, j),
                torch.gather(bases, -1, j))
    # past the end of the chain: hold the final endpoint (padded incs are 0,
    # so bases[-1] == t0 + the sum of live increments)
    return torch.where(x >= starts[..., -1:], bases[..., -1:], val)


def reconstruct_from_pieces(lengths, incs, n_pieces, t0,
                            total_len: int) -> torch.Tensor:
    """SymED online reconstruction: interpolate raw receiver pieces."""
    return inverse_compression(torch.as_tensor(lengths).to(torch.int32),
                               incs, n_pieces, t0, total_len)


def reconstruct_from_symbols(labels, centers, n_pieces, t0,
                             total_len: int) -> torch.Tensor:
    """Offline reconstruction from the symbol string and the center table
    (the ABBA path)."""
    centers = torch.as_tensor(centers, dtype=torch.float32)
    n_max = labels.shape[-1]
    live = _live(n_max, n_pieces, centers.device)
    rep = inverse_digitization(labels, centers)
    qlens = quantize_lengths(rep[..., 0], live)
    return inverse_compression(qlens, torch.where(live, rep[..., 1], 0.0),
                               n_pieces, t0, total_len)
