"""SymED sender: online adaptive piecewise-linear compression (paper Alg. 1).

Port of ``repro.core.compress``.  Sender state is O(1) per stream and every
function is batched over leading dimensions.  The Brownian-bridge error of
the open segment comes from centered sufficient statistics:

    err_raw = S2 - 2*(D/L)*S1 + (D/L)^2 * L(L+1)(2L+1)/6

and the error of the re-standardized segment is ``err_raw / EWMV_j``.

The f32 operation order is the reference's as its CPU compilation runs it:
the division by the constant 6 is a multiply by ``f32(1/6)``, ``D / L`` is
a true division, and the multiply-adds that compilation fuses are fused
here (``fma32``), so emit decisions and carries are bitwise equal.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.normalize import EwmState, ewm_init, ewm_step, fma32

__all__ = [
    "CompressorState",
    "PieceEvent",
    "compressor_init",
    "compressor_step",
    "compressor_finalize",
    "compress_stream",
    "bridge_error_direct",
    "pieces_on_wire",
]

_SIXTH = float(np.float32(1.0 / 6.0))


class CompressorState(NamedTuple):
    """O(1) per-stream sender state."""

    norm: EwmState
    seg_start: torch.Tensor  # raw value t_start of the open segment
    last: torch.Tensor       # raw value of the newest point in the segment
    npts: torch.Tensor       # points in the segment (int32)
    s0: torch.Tensor         # sum_h (t_h - seg_start)
    s1: torch.Tensor         # sum_h h*(t_h - seg_start)
    s2: torch.Tensor         # sum_h (t_h - seg_start)^2


class PieceEvent(NamedTuple):
    """Per-step sender output (``endpoint`` is the one float on the wire)."""

    emit: torch.Tensor      # bool
    endpoint: torch.Tensor  # t_{m-1} (0 where emit=False)
    length: torch.Tensor    # piece length in steps (int32)
    inc: torch.Tensor       # piece increment in raw space


def compressor_init(t0: torch.Tensor) -> CompressorState:
    """Open the first segment at the first stream point ``t0``."""
    t0 = torch.as_tensor(t0, dtype=torch.float32)
    z = torch.zeros_like(t0)
    return CompressorState(
        norm=ewm_init(t0), seg_start=t0, last=t0,
        npts=torch.ones(t0.shape, dtype=torch.int32, device=t0.device),
        s0=z, s1=z, s2=z,
    )


def _bridge_error_raw(s1, s2, delta, length_f):
    """Brownian-bridge SSE of the open segment in raw space, O(1)."""
    l = length_f
    sum_h2 = (l * (l + 1.0) * (2.0 * l + 1.0)) * _SIXTH
    r = delta / l
    err = fma32(r * r, sum_h2, fma32(-(2.0 * r), s1, s2))
    return torch.clamp_min(err, 0.0)


def bridge_error_direct(seg: torch.Tensor) -> torch.Tensor:
    """O(m) oracle: SSE between ``seg`` and the chord joining its ends."""
    seg = torch.as_tensor(seg, dtype=torch.float32)
    n = seg.shape[-1]
    if n < 3:
        return torch.zeros(seg.shape[:-1], dtype=torch.float32,
                           device=seg.device)
    h = torch.arange(n, dtype=torch.float32, device=seg.device)
    line = seg[..., :1] + (seg[..., -1:] - seg[..., :1]) * (h / (n - 1.0))
    return torch.sum((seg - line) ** 2, dim=-1)


def _where(flag, a, b):
    return torch.where(flag.reshape(flag.shape + (1,) * (a.dim() - flag.dim())),
                       a, b)


def compressor_step(
    state: CompressorState,
    t: torch.Tensor,
    *,
    tol: float,
    len_max: int,
    alpha: float,
) -> Tuple[CompressorState, PieceEvent]:
    """Ingest one raw point; possibly emit a finished piece (paper Alg. 1)."""
    t = torch.as_tensor(t, dtype=torch.float32)
    norm = ewm_step(state.norm, t, alpha)

    v = t - state.seg_start
    h = state.npts.float()
    s0 = state.s0 + v
    s1 = fma32(h, v, state.s1)
    s2 = fma32(v, v, state.s2)
    npts_new = state.npts + 1
    len_f = npts_new.float() - 1.0

    err_raw = _bridge_error_raw(s1, s2, v, torch.clamp_min(len_f, 1.0))
    err = err_raw / torch.clamp_min(norm.var, 1e-12)

    tol32 = float(np.float32(tol))
    bound = (npts_new.float() - 2.0) * tol32 * tol32
    violated = (err > bound) | (npts_new > int(len_max))

    piece_len = state.npts - 1
    piece_inc = state.last - state.seg_start
    v1 = t - state.last
    seeded = CompressorState(
        norm=norm, seg_start=state.last, last=t,
        npts=torch.full_like(state.npts, 2), s0=v1, s1=v1, s2=v1 * v1,
    )
    grown = CompressorState(
        norm=norm, seg_start=state.seg_start, last=t, npts=npts_new,
        s0=s0, s1=s1, s2=s2,
    )
    new_state = CompressorState(norm, *(
        _where(violated, a, b) for a, b in zip(seeded[1:], grown[1:])))
    zero_f = torch.zeros_like(t)
    event = PieceEvent(
        emit=violated,
        endpoint=torch.where(violated, state.last, zero_f),
        length=torch.where(violated, piece_len, torch.zeros_like(piece_len)),
        inc=torch.where(violated, piece_inc, zero_f),
    )
    return new_state, event


def compressor_finalize(state: CompressorState) -> PieceEvent:
    """Flush the trailing open segment as a final piece (>= 2 points)."""
    has_piece = state.npts >= 2
    zero_f = torch.zeros_like(state.last)
    return PieceEvent(
        emit=has_piece,
        endpoint=torch.where(has_piece, state.last, zero_f),
        length=torch.where(has_piece, state.npts - 1,
                           torch.zeros_like(state.npts)),
        inc=torch.where(has_piece, state.last - state.seg_start, zero_f),
    )


def pieces_on_wire(events: dict, step_offset: int):
    """Sender-side wire encode: ``(endpoints f32[n], steps i32[n])`` host
    arrays of the pieces one window's events put on the wire."""
    emit = np.asarray(torch.as_tensor(events["emit"]).cpu()).reshape(-1)
    endpoints = np.asarray(
        torch.as_tensor(events["endpoint"]).cpu()).reshape(-1)
    idx = np.nonzero(emit)[0]
    return (endpoints[idx].astype(np.float32),
            (idx + step_offset).astype(np.int32))


def compress_stream(
    ts: torch.Tensor,
    *,
    tol: float = 0.5,
    len_max: int = 512,
    alpha: float = 0.01,
) -> dict:
    """Run the online sender over a whole stream (batched on leading axes).

    Returns per-step ``emit``/``endpoint``/``length``/``inc`` shaped
    ``(..., T)``, the trailing-flush ``tail``, ``n_pieces`` and
    ``final_state`` -- the reference's dict.
    """
    ts = torch.as_tensor(ts, dtype=torch.float32)
    ts_t = ts.movedim(-1, 0)
    state = compressor_init(ts_t[0])
    zf = torch.zeros_like(ts_t[0])
    # a no-emit slot for t_0 so events align 1:1 with stream steps
    events = [PieceEvent(torch.zeros_like(zf, dtype=torch.bool), zf,
                         torch.zeros_like(zf, dtype=torch.int32), zf)]
    for t in ts_t[1:]:
        state, ev = compressor_step(state, t, tol=tol, len_max=len_max,
                                    alpha=alpha)
        events.append(ev)
    stacked = PieceEvent(*(torch.stack(xs, dim=-1) for xs in zip(*events)))
    tail = compressor_finalize(state)
    n_pieces = (stacked.emit.sum(-1, dtype=torch.int32)
                + tail.emit.to(torch.int32))
    return {
        "emit": stacked.emit, "endpoint": stacked.endpoint,
        "length": stacked.length, "inc": stacked.inc,
        "tail": tail, "n_pieces": n_pieces, "final_state": state,
    }
