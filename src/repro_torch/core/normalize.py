"""Online normalization (SymED Eq. 1-2): damped-window EWMA / EWMV.

Port of ``repro.core.normalize``.  The reference's jitted CPU code contracts
some multiply-add pairs into fused multiply-adds (one rounding instead of
two); ``fma32`` reproduces each such contraction where the reference's
compiled sender has it, so the sender state stays bitwise equal (but for
the rare double rounding its docstring names).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = ["EwmState", "ewm_init", "ewm_coeffs", "ewm_step", "ewm_scan",
           "standardize", "fma32", "sqrt32"]


def fma32(a, b, c) -> torch.Tensor:  # symlint-torch: f64-ok: rounds a fused multiply-add to odd in f64
    """f32 ``a * b + c`` with one rounding, as a fused multiply-add does.

    The product of two f32 values is exact in f64.  The f64 sum ``s`` is
    rounded to odd: where TwoSum's error term ``e`` is not zero and ``s``
    has an even last bit, ``s`` steps one f64 ulp towards ``e``.  A value
    rounded to odd with 53 bits rounds to 24 bits exactly as the exact sum
    would, so the final rounding to f32 is the only one that shows.
    """
    dev = next((x.device for x in (a, b, c) if torch.is_tensor(x)), None)
    a, b, c = (x.double() if torch.is_tensor(x)
               else torch.tensor(float(x), dtype=torch.float64, device=dev)
               for x in (a, b, c))
    p = a * b
    s = p + c
    bp = s - c
    e = (p - bp) + (c - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    inexact = (e != 0) & torch.isfinite(s)
    towards = torch.where(e > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where(inexact & even, torch.nextafter(s, towards), s)
    return s.float()


def sqrt32(x: torch.Tensor) -> torch.Tensor:  # symlint-torch: f64-ok: a correctly rounded f32 root, taken in f64
    """Correctly rounded f32 square root, as the reference's compiled
    ``sqrt`` gives it.  Taken in f64 and rounded once: 53 bits hold the
    root of a 24-bit value closely enough that the rounding to f32 is
    exact (torch's vectorized f32 ``sqrt`` on the CPU can miss by an
    ulp)."""
    return torch.sqrt(x.double()).float()


class EwmState(NamedTuple):
    """Damped-window normalization state (paper Eq. 1-2)."""

    mean: torch.Tensor  # EWMA_j
    var: torch.Tensor   # EWMV_j


def ewm_init(t0: torch.Tensor) -> EwmState:
    """Paper initialization: EWMA_0 = t_0, EWMV_0 = 1.0."""
    t0 = torch.as_tensor(t0, dtype=torch.float32)
    return EwmState(mean=t0, var=torch.ones_like(t0))


def ewm_coeffs(alpha) -> Tuple[float, float]:
    """``a`` and ``1 - a`` of the update, as f32 values: the roundings of
    ``alpha`` and of ``1.0 - alpha`` (a float or a 0-d tensor)."""
    a = float(torch.as_tensor(alpha, dtype=torch.float32))
    b = float(torch.as_tensor(1.0 - alpha, dtype=torch.float32))
    return a, b


def ewm_step(state: EwmState, t: torch.Tensor, alpha: float, *,
             single: bool = False) -> EwmState:
    """One damped-window update.

    EWMA_j = a*t_j + (1-a)*EWMA_{j-1}
    EWMV_j = a*(t_j - EWMA_j)^2 + (1-a)*EWMV_{j-1}

    ``a`` and ``1 - a`` are f32 roundings of Python doubles, as in the
    reference; the two sums are fused where the reference's are.  The
    reference's batched programs fuse the EWMV sum as ``fma(1-a, v, a d^2)``;
    its program for one rank-1 stream (``single=True``) as
    ``fma(a, d^2, (1-a) v)``.
    """
    a, b = ewm_coeffs(alpha)
    mean = fma32(a, t, b * state.mean)
    dev = t - mean
    if single:
        var = fma32(a, dev * dev, b * state.var)
    else:
        var = fma32(b, state.var, (dev * dev) * a)
    return EwmState(mean=mean, var=var)


def ewm_scan(ts: torch.Tensor, alpha: float, time_axis: int = -1
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """EWMA/EWMV over a (batched) stream; step 0 keeps the paper's init."""
    ts = torch.as_tensor(ts, dtype=torch.float32).movedim(time_axis, 0)
    state = ewm_init(ts[0])
    means, vars_ = [state.mean], [state.var]
    for t in ts[1:]:
        state = ewm_step(state, t, alpha)
        means.append(state.mean)
        vars_.append(state.var)
    return (torch.stack(means).movedim(0, time_axis),
            torch.stack(vars_).movedim(0, time_axis))


def standardize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                eps: float = 1e-12) -> torch.Tensor:
    """z-score ``x`` with the damped-window params: (x - EWMA)/sqrt(EWMV)."""
    return (x - mean) * torch.rsqrt(var + eps)
