"""SymED end-to-end pipeline: sender (Alg. 1) -> wire -> receiver (Alg. 2+3).

Port of ``repro.core.symed`` for the resident service's path:

  * ``symed_encode`` -- one stream in one shot (without reconstruction,
    which arrives with ``core/reconstruct``);
  * ``symed_receive_masked_chunk_table`` -- the session table ingests one
    padded, ragged window per slot: per-slot sender scan and wire
    compaction, then one table-level digitize pass whose Lloyd half-steps
    can run in the CUDA k-means kernel (``use_kernel=True``);
  * ``symed_receive_finish`` -- close a stream: flush the tail, digitize the
    rest, emit the closing symbol-delta frame.

A ``ReceiverState`` carries every leaf with a leading slot axis when it is
a table; ``symed_receive_masked_chunk`` / ``symed_receive_finish`` also take
one slot's state (no leading axis).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.compress import (
    CompressorState, compress_stream, compressor_finalize, compressor_init,
    compressor_step,
)
from repro_torch.core.digitize import (
    DigitizerState, _select_lanes, digitize_pieces, digitize_span_table,
    digitizer_delta, digitizer_init,
)
from repro_torch.core.metrics import compression_rate_symed, drr
from repro_torch.core.receiver import (
    append_tail, compact_chunk, compact_events, delta_frame_bytes,
    pieces_from_wire,
)

__all__ = [
    "ReceiverState",
    "SymEDConfig",
    "receiver_init",
    "symed_encode",
    "symed_receive_finish",
    "symed_receive_masked_chunk",
    "symed_receive_masked_chunk_table",
    "symbols_to_string",
]


@dataclasses.dataclass(frozen=True)
class SymEDConfig:
    """Hyperparameters (paper Sec. 4.1 defaults)."""

    tol: float = 0.5          # error-tolerance (compression + digitization)
    alpha: float = 0.01       # damped-window weight (paper: 0.01..0.02)
    scl: float = 1.0          # length-vs-increment weight (2D clustering)
    k_min: int = 3            # minimum alphabet size
    k_max: int = 100          # maximum alphabet size
    len_max: int = 512        # maximum points per piece
    n_max: int = 512          # per-stream piece buffer capacity
    lloyd_iters: int = 10     # Lloyd iterations per k-means warm start

    def digitize_kw(self) -> Dict[str, Any]:
        """The digitizer's keyword arguments under this config."""
        return dict(tol=self.tol, scl=self.scl, k_min=self.k_min,
                    k_max_active=self.k_max, lloyd_iters=self.lloyd_iters)


class ReceiverState(NamedTuple):
    """Full online SymED state for one stream (or a table of them).

    ``comp`` is the O(1) sender carry; ``endpoints``/``steps``/``n_pieces``
    the receiver's padded wire buffers; ``dig`` the resumable digitizer
    (``dig.n`` pieces digitized so far); ``symbols_online`` the symbol each
    piece got when first digitized; ``t0``/``t_seen``/``chunks`` the hello
    value, the stream clock and the cadence counter.
    """

    comp: CompressorState
    dig: DigitizerState
    endpoints: torch.Tensor       # (..., n_max) f32 transmitted endpoints
    steps: torch.Tensor           # (..., n_max) i32 arrival step per piece
    n_pieces: torch.Tensor        # (...,) i32 pieces compacted so far
    symbols_online: torch.Tensor  # (..., n_max) i32 symbol at first digitize
    t0: torch.Tensor              # (...,) f32 first raw point (the "hello")
    t_seen: torch.Tensor          # (...,) i32 stream points ingested so far
    chunks: torch.Tensor          # (...,) i32 windows ingested so far


def receiver_init(cfg: SymEDConfig, key: torch.Tensor) -> ReceiverState:
    """Blank (unseeded) receiver; ``key (..., 2)`` sets the batch shape.

    ``t_seen == 0`` marks a slot that no stream point has opened yet: the
    first valid point of its first window seeds the compressor.
    """
    key = torch.as_tensor(key, dtype=torch.int64)
    batch, dev = key.shape[:-1], key.device
    zf = torch.zeros(batch, dtype=torch.float32, device=dev)
    zi = torch.zeros(batch, dtype=torch.int32, device=dev)
    buf_f = torch.zeros(batch + (cfg.n_max,), dtype=torch.float32, device=dev)
    buf_i = torch.zeros(batch + (cfg.n_max,), dtype=torch.int32, device=dev)
    return ReceiverState(
        comp=compressor_init(zf), dig=digitizer_init(cfg.n_max, cfg.k_max, key),
        endpoints=buf_f, steps=buf_i, n_pieces=zi, symbols_online=buf_i.clone(),
        t0=zf.clone(), t_seen=zi.clone(), chunks=zi.clone(),
    )


def _masked_sender_wire(windows, n_valid, table: ReceiverState, *, tol, alpha,
                        len_max):
    """Per-slot sender scan + wire compaction of one masked window.

    ``windows (S, C)``, ``n_valid (S,)``.  Every slot position runs one of
    three branches, selected per lane: padding passes the carry through, a
    slot's very first valid point seeds the compressor, every other point
    runs ``compressor_step``.  Returns ``(comp, t0, t_seen, endpoints,
    steps, n_pieces, chunks)``.
    """
    comp, t0, t_seen = table.comp, table.t0, table.t_seen
    emits, ends, idxs = [], [], []
    zero_f = torch.zeros_like(t0)
    for c in range(windows.shape[1]):
        x = windows[:, c]
        valid = n_valid > c
        seed = valid & (t_seen == 0)
        ingest = valid & (t_seen != 0)
        stepped, ev = compressor_step(comp, x, tol=tol, len_max=len_max,
                                      alpha=alpha)
        comp = _select_lanes(ingest, stepped,
                             _select_lanes(seed, compressor_init(x), comp))
        emits.append(ingest & ev.emit)
        ends.append(torch.where(ingest, ev.endpoint, zero_f))
        # t_seen is the 0-based stream index of x: the arrival clock
        idxs.append(torch.where(ingest, t_seen, torch.zeros_like(t_seen)))
        t0 = torch.where(seed, x, t0)
        t_seen = torch.where(seed, torch.ones_like(t_seen),
                             torch.where(ingest, t_seen + 1, t_seen))
    endpoints, steps, n_pieces = compact_chunk(
        table.endpoints, table.steps, table.n_pieces, torch.stack(emits, -1),
        torch.stack(ends, -1), torch.stack(idxs, -1))
    chunks = table.chunks + (n_valid > 0).to(torch.int32)
    return comp, t0, t_seen, endpoints, steps, n_pieces, chunks


def _digitize_new_pieces_table(dig, symbols_online, endpoints, steps,
                               n_pieces, t0, emitted, *, cfg: SymEDConfig,
                               use_kernel: bool):
    """Digitize slots ``[dig.n, n_pieces)`` of every lane that ``emitted``
    (the others get an empty span); record first-time symbols."""
    lens, incs = pieces_from_wire(endpoints, steps, n_pieces, t0)
    hi = torch.where(emitted, n_pieces, dig.n)
    dig_new, span_syms = digitize_span_table(
        dig, lens, incs, dig.n, hi, use_kernel=use_kernel, **cfg.digitize_kw())
    idx = torch.arange(cfg.n_max, device=n_pieces.device)[None, :]
    in_span = (idx >= dig.n[:, None]) & (idx < hi[:, None])
    return dig_new, torch.where(in_span, span_syms, symbols_online)


def _symbol_delta_info(n_dig_prev, dig, symbols_online, endpoints, emitted):
    """The wire-out payload of one pass: what its digitize added."""
    labels_d, endpoints_d, n_new = digitizer_delta(
        n_dig_prev, dig, symbols_online, endpoints)
    emitted = torch.as_tensor(emitted, dtype=torch.bool,
                              device=n_new.device).expand(n_new.shape)
    frame = delta_frame_bytes(n_new)
    return {
        "labels": labels_d, "endpoints": endpoints_d, "n_new": n_new,
        "emitted": emitted,
        "frame_bytes": torch.where(emitted, frame, torch.zeros_like(frame)),
    }


def symed_receive_masked_chunk_table(
    windows: torch.Tensor,
    n_valid: torch.Tensor,
    cfg: SymEDConfig,
    table: ReceiverState,
    *,
    digitize_every_k: int = 1,
    use_kernel: bool = False,
    mark: Optional[Callable[[str], None]] = None,
) -> Tuple[ReceiverState, Dict[str, Any]]:
    """The session table ingests one padded window per slot.

    ``windows (S, C)``, ``n_valid (S,)`` valid points per slot (0 = idle
    slot, a no-op).  The sender scan and wire compaction run per slot; the
    digitize pass runs once for the table, its Lloyd half-steps in the CUDA
    kernel when ``use_kernel``.  ``mark(phase)``, when given, is called
    after the sender half (``"sender"``) and after the digitize pass
    (``"digitize"``).  Returns ``(table, info)``.
    """
    if digitize_every_k < 0:
        raise ValueError(f"digitize_every_k must be >= 0, got {digitize_every_k}")
    n_valid = torch.as_tensor(n_valid, dtype=torch.int32,
                              device=windows.device)
    comp, t0, t_seen, endpoints, steps, n_pieces, chunks = _masked_sender_wire(
        windows.to(torch.float32), n_valid, table, tol=cfg.tol,
        alpha=cfg.alpha, len_max=cfg.len_max)
    if mark is not None:
        mark("sender")

    n_dig_prev = table.dig.n
    if digitize_every_k:
        emitted = (n_valid > 0) & (chunks % int(digitize_every_k) == 0)
        dig, symbols_online = _digitize_new_pieces_table(
            table.dig, table.symbols_online, endpoints, steps, n_pieces, t0,
            emitted, cfg=cfg, use_kernel=use_kernel)
    else:
        emitted = torch.zeros_like(n_valid, dtype=torch.bool)
        dig, symbols_online = table.dig, table.symbols_online
    if mark is not None:
        mark("digitize")

    new_table = ReceiverState(
        comp=comp, dig=dig, endpoints=endpoints, steps=steps,
        n_pieces=n_pieces, symbols_online=symbols_online,
        t0=t0, t_seen=t_seen, chunks=chunks,
    )
    info = {
        "n_pieces": n_pieces,
        "n_digitized": dig.n,
        "t_seen": t_seen,
        "symbols_online": symbols_online,
        "symbol_delta": _symbol_delta_info(
            n_dig_prev, dig, symbols_online, endpoints, emitted),
    }
    return new_table, info


def _batch1(state):
    return type(state)(*(_batch1(x) if isinstance(x, tuple) else x[None]
                         for x in state))


def _unbatch1(tree):
    if isinstance(tree, dict):
        return {k: _unbatch1(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_unbatch1(x) for x in tree))
    return tree[0]


def symed_receive_masked_chunk(ts_chunk, n_valid, cfg: SymEDConfig,
                               state: ReceiverState, *,
                               digitize_every_k: int = 1):
    """One slot ingests the first ``n_valid`` points of ``ts_chunk (C,)``."""
    table, info = symed_receive_masked_chunk_table(
        torch.as_tensor(ts_chunk)[None], torch.as_tensor(n_valid).reshape(1),
        cfg, _batch1(state), digitize_every_k=digitize_every_k)
    return _unbatch1(table), _unbatch1(info)


def symed_receive_finish(state: ReceiverState, cfg: SymEDConfig, *,
                         with_delta: bool = False) -> Dict[str, Any]:
    """Close a stream: flush the tail, digitize the rest.

    Takes one slot's state (or a table).  The output dict matches
    ``symed_encode``'s; ``with_delta=True`` adds ``out["symbol_delta"]``,
    the closing wire-out frame.
    """
    single = state.t_seen.dim() == 0
    st = _batch1(state) if single else state
    tail = compressor_finalize(st.comp)
    endpoints, steps, n_pieces = append_tail(
        st.endpoints, st.steps, st.n_pieces, tail, st.t_seen)
    lens, incs = pieces_from_wire(endpoints, steps, n_pieces, st.t0)
    dig, span_syms = digitize_span_table(
        st.dig, lens, incs, st.dig.n, n_pieces, **cfg.digitize_kw())
    idx = torch.arange(cfg.n_max, device=n_pieces.device)[None, :]
    in_span = (idx >= st.dig.n[:, None]) & (idx < n_pieces[:, None])
    symbols_online = torch.where(in_span, span_syms, st.symbols_online)
    out = {
        "symbols": dig.labels,
        "symbols_online": symbols_online,
        "centers": dig.centers,
        "k": dig.k,
        "pieces_len": lens,
        "pieces_inc": incs,
        "n_pieces": n_pieces,
        "wire_bytes": 4.0 + 4.0 * n_pieces.float(),
        "cr": compression_rate_symed(n_pieces, st.t_seen),
        "drr": drr(n_pieces, st.t_seen),
    }
    if with_delta:
        out["symbol_delta"] = _symbol_delta_info(
            st.dig.n, dig, symbols_online, endpoints, True)
    return _unbatch1(out) if single else out


def symed_encode(ts, cfg: SymEDConfig, key) -> Dict[str, torch.Tensor]:
    """Encode one stream ``ts (T,)`` in one shot: sender, wire, receiver.

    ``key (2,)`` seeds the digitizer.  The output dict is the reference's
    ``symed_encode(..., reconstruct=False)``.
    """
    ts = torch.as_tensor(ts, dtype=torch.float32)
    events = compress_stream(ts, tol=cfg.tol, len_max=cfg.len_max,
                             alpha=cfg.alpha)
    wire = compact_events(events, n_max=cfg.n_max, t0=ts[0])
    dig = digitize_pieces(
        wire["lengths"], wire["incs"], wire["n_pieces"],
        torch.as_tensor(key, device=ts.device), k_cap=cfg.k_max,
        tol=cfg.tol, scl=cfg.scl, k_min=cfg.k_min, k_max_active=cfg.k_max,
        lloyd_iters=cfg.lloyd_iters)
    n_points = torch.tensor(ts.shape[-1], dtype=torch.int32, device=ts.device)
    return {
        "symbols": dig["labels"],
        "symbols_online": dig["symbols"],
        "centers": dig["centers"],
        "k": dig["k"],
        "pieces_len": wire["lengths"],
        "pieces_inc": wire["incs"],
        "n_pieces": wire["n_pieces"],
        "wire_bytes": 4.0 + 4.0 * wire["n_pieces"].float(),
        "cr": compression_rate_symed(wire["n_pieces"], n_points),
        "drr": drr(wire["n_pieces"], n_points),
    }


def symbols_to_string(labels, n_pieces) -> str:
    """Host-side helper: int labels -> 'abc...' string (I/O boundary only)."""
    labels = np.asarray(torch.as_tensor(labels).cpu())[: int(n_pieces)]
    alphabet = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
    return "".join(alphabet[int(l) % len(alphabet)] for l in labels)
