"""Evaluation metrics (paper Sec. 4.1): compression and dimension-reduction rate.

Port of ``repro.core.metrics`` (the DTW reference arrives with the DTW
kernel).  Both rates divide by a runtime point count: a true f32 division.
"""
from __future__ import annotations

import torch

__all__ = ["compression_rate_symed", "drr"]


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, device=like.device).to(torch.float32)


def compression_rate_symed(n_pieces: torch.Tensor, n_points) -> torch.Tensor:
    """CR_SymED = (bytes(P)/2) / bytes(T) = n / N  [paper Eq. 3]."""
    return n_pieces.float() / _f32(n_points, n_pieces)


def drr(n_symbols: torch.Tensor, n_points) -> torch.Tensor:
    """Dimension-reduction rate len(S)/len(T)."""
    return n_symbols.float() / _f32(n_points, n_symbols)
