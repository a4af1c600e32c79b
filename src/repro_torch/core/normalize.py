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

__all__ = ["EwmState", "ewm_init", "ewm_step", "ewm_scan", "standardize",
           "fma32"]


def fma32(a, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` as a fused multiply-add computes it, nearly.

    The product is exact in f64, but the sum is rounded to f64 and then to
    f32: two roundings, which can differ from a true fma's one by an ulp
    when the f64 sum lands on an f32 halfway point (ROADMAP Queue C).
    """
    a, b, c = (x.double() if torch.is_tensor(x) else float(x)
               for x in (a, b, c))
    return (a * b + c).float()


class EwmState(NamedTuple):
    """Damped-window normalization state (paper Eq. 1-2)."""

    mean: torch.Tensor  # EWMA_j
    var: torch.Tensor   # EWMV_j


def ewm_init(t0: torch.Tensor) -> EwmState:
    """Paper initialization: EWMA_0 = t_0, EWMV_0 = 1.0."""
    t0 = torch.as_tensor(t0, dtype=torch.float32)
    return EwmState(mean=t0, var=torch.ones_like(t0))


def ewm_step(state: EwmState, t: torch.Tensor, alpha: float) -> EwmState:
    """One damped-window update.

    EWMA_j = a*t_j + (1-a)*EWMA_{j-1}
    EWMV_j = a*(t_j - EWMA_j)^2 + (1-a)*EWMV_{j-1}

    ``a`` and ``1 - a`` are f32 roundings of Python doubles, as in the
    reference; the two sums are fused where the reference's are.
    """
    a = float(torch.tensor(alpha, dtype=torch.float32))
    b = float(torch.tensor(1.0 - alpha, dtype=torch.float32))
    mean = fma32(a, t, b * state.mean)
    dev = t - mean
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
