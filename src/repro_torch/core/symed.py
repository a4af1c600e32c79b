"""SymED end-to-end pipeline: sender (Alg. 1) -> wire -> receiver (Alg. 2+3).

Port of ``repro.core.symed``:

  * ``symed_encode`` -- one stream in one shot; ``reconstruct=True`` (the
    default) also rebuilds the stream from its pieces and from its symbols
    and scores both in DTW space (``kernels.ops.dtw``: the CUDA kernel on
    the card);
  * ``symed_encode_chunk`` / ``symed_finish`` -- the same stream fed to the
    sender window by window, then closed;
  * ``symed_batch`` -- a slab of streams, one key per stream;
  * ``symed_receive_chunk`` / ``symed_step_chunk`` -- the online receiver
    of one stream: sender, wire and (every ``digitize_every_k`` windows)
    the digitizer, window by window;
  * ``symed_receive_masked_chunk_table`` -- the session table ingests one
    padded, ragged window per slot: per-slot sender scan and wire
    compaction, then one table-level digitize pass whose Lloyd loops can
    run in the CUDA k-means kernel (``use_kernel=True``);
  * ``symed_receive_masked_pieces_table`` -- its compressed-in counterpart:
    the senders ran the compressor and ship piece tuples, which are
    scattered into the wire buffers before the same digitize pass;
  * ``symed_receive_finish`` -- close a stream: flush the tail, digitize the
    rest, emit the closing symbol-delta frame, optionally reconstruct.

A ``ReceiverState`` carries every leaf with a leading slot axis when it is
a table; ``symed_receive_masked_chunk`` / ``symed_receive_masked_pieces`` /
``symed_receive_finish`` also take one slot's state (no leading axis).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.compress import (
    CompressorState, compress_stream, compressor_finalize, compressor_init,
    compressor_scan, compressor_step,
)
from repro_torch.core.digitize import (
    DigitizerState, _select_lanes, digitize_span_table, digitizer_delta,
    digitizer_init,
)
from repro_torch.core.metrics import compression_rate_symed, drr
from repro_torch.core.receiver import (
    append_tail, compact_chunk, compact_events, delta_frame_bytes,
    pieces_from_wire,
)
from repro_torch.core.reconstruct import (
    reconstruct_from_pieces, reconstruct_from_symbols,
)
from repro_torch.kernels import ops

__all__ = [
    "ReceiverState",
    "SymEDConfig",
    "receiver_init",
    "symed_batch",
    "symed_encode",
    "symed_encode_chunk",
    "symed_finish",
    "symed_receive_chunk",
    "symed_receive_finish",
    "symed_receive_masked_chunk",
    "symed_receive_masked_chunk_table",
    "symed_receive_masked_pieces",
    "symed_receive_masked_pieces_table",
    "symed_step_chunk",
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


def _digitize_and_report(table: ReceiverState, live, comp, t0, t_seen,
                         endpoints, steps, n_pieces, chunks, *,
                         cfg: SymEDConfig, digitize_every_k: int,
                         use_kernel: bool, mark):
    """The receiver half of a table step, after the sender or the scatter
    filled the wire buffers: digitize the lanes that are ``live`` and on
    cadence, then assemble the new table and the step's info."""
    n_dig_prev = table.dig.n
    if digitize_every_k:
        emitted = live & (chunks % int(digitize_every_k) == 0)
        dig, symbols_online = _digitize_new_pieces_table(
            table.dig, table.symbols_online, endpoints, steps, n_pieces, t0,
            emitted, cfg=cfg, use_kernel=use_kernel)
    else:
        emitted = torch.zeros_like(live)
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


def _check_cadence(digitize_every_k: int) -> None:
    if digitize_every_k < 0:
        raise ValueError(f"digitize_every_k must be >= 0, got {digitize_every_k}")


def symed_receive_masked_chunk_table(  # symlint-torch: entry(pair=chunk/table, shapes=pair-chunk-table)
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
    digitize pass runs once for the table, its Lloyd loops in the CUDA
    kernel when ``use_kernel``.  ``mark(phase)``, when given, is called
    after the sender half (``"sender"``) and after the digitize pass
    (``"digitize"``).  Returns ``(table, info)``.
    """
    _check_cadence(digitize_every_k)
    n_valid = torch.as_tensor(n_valid, dtype=torch.int32,
                              device=windows.device)
    comp, t0, t_seen, endpoints, steps, n_pieces, chunks = _masked_sender_wire(
        windows.to(torch.float32), n_valid, table, tol=cfg.tol,
        alpha=cfg.alpha, len_max=cfg.len_max)
    if mark is not None:
        mark("sender")
    return _digitize_and_report(
        table, n_valid > 0, comp, t0, t_seen, endpoints, steps, n_pieces,
        chunks, cfg=cfg, digitize_every_k=digitize_every_k,
        use_kernel=use_kernel, mark=mark)


def symed_receive_masked_pieces_table(  # symlint-torch: entry(pair=pieces/table, shapes=pair-pieces-table)
    piece_endpoints: torch.Tensor,
    piece_steps: torch.Tensor,
    n_valid: torch.Tensor,
    hello: torch.Tensor,
    t_seen: torch.Tensor,
    cfg: SymEDConfig,
    table: ReceiverState,
    *,
    digitize_every_k: int = 1,
    use_kernel: bool = False,
    mark: Optional[Callable[[str], None]] = None,
) -> Tuple[ReceiverState, Dict[str, Any]]:
    """Compressed-in counterpart of ``symed_receive_masked_chunk_table``.

    The senders ran the compressor and ship finished pieces: the first
    ``n_valid`` of each slot's padded tuples ``(piece_endpoints (S, P),
    piece_steps (S, P))`` are scattered into its wire buffers, where a
    raw-in ingest of the same stream would have put them, and the table is
    digitized as in the raw-in step.  ``hello (S,)`` is the sender's t0,
    taken only while a slot's ``t_seen == 0``; ``t_seen (S,)`` the sender's
    point clock after this frame (a frame that finished no piece still
    advances it).  The slot compressors never run.  ``mark(phase)`` is
    called after the scatter (``"wire"``) and after the digitize pass
    (``"digitize"``).  Returns ``(table, info)``.
    """
    _check_cadence(digitize_every_k)
    dev = table.t_seen.device
    n_valid = torch.as_tensor(n_valid, dtype=torch.int32, device=dev)
    hello = torch.as_tensor(hello, dtype=torch.float32, device=dev)
    t_seen = torch.as_tensor(t_seen, dtype=torch.int32, device=dev)
    t0 = torch.where(table.t_seen == 0, hello, table.t0)
    p_cap = piece_endpoints.shape[1]
    valid = (torch.arange(p_cap, device=dev)[None, :] < n_valid[:, None])
    endpoints, steps, n_pieces = compact_chunk(
        table.endpoints, table.steps, table.n_pieces, valid,
        torch.as_tensor(piece_endpoints, dtype=torch.float32, device=dev),
        torch.as_tensor(piece_steps, dtype=torch.int32, device=dev))
    t_seen = torch.maximum(table.t_seen, t_seen)
    chunks = table.chunks + (n_valid > 0).to(torch.int32)
    if mark is not None:
        mark("wire")
    return _digitize_and_report(
        table, n_valid > 0, table.comp, t0, t_seen, endpoints, steps,
        n_pieces, chunks, cfg=cfg, digitize_every_k=digitize_every_k,
        use_kernel=use_kernel, mark=mark)


def _batch1(state):
    return type(state)(*(_batch1(x) if isinstance(x, tuple) else x[None]
                         for x in state))


def _unbatch1(tree):
    if isinstance(tree, dict):
        return {k: _unbatch1(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_unbatch1(x) for x in tree))
    return tree[0]


def symed_receive_masked_chunk(ts_chunk, n_valid, cfg: SymEDConfig,  # symlint-torch: entry(pair=chunk/slot, shapes=pair-chunk-slot)
                               state: ReceiverState, *,
                               digitize_every_k: int = 1):
    """One slot ingests the first ``n_valid`` points of ``ts_chunk (C,)``."""
    table, info = symed_receive_masked_chunk_table(
        torch.as_tensor(ts_chunk)[None], torch.as_tensor(n_valid).reshape(1),
        cfg, _batch1(state), digitize_every_k=digitize_every_k)
    return _unbatch1(table), _unbatch1(info)


def symed_receive_masked_pieces(piece_endpoints, piece_steps, n_valid, hello,  # symlint-torch: entry(pair=pieces/slot, shapes=pair-pieces-slot)
                                t_seen, cfg: SymEDConfig,
                                state: ReceiverState, *,
                                digitize_every_k: int = 1):
    """One slot scatters the first ``n_valid`` of the piece tuples
    ``(piece_endpoints (P,), piece_steps (P,))``; ``hello`` and ``t_seen``
    are scalars (see ``symed_receive_masked_pieces_table``).  The sender's
    trailing flush arrives as an ordinary tuple with ``step = t_seen``, so
    the blank slot compressor has nothing to flush at
    ``symed_receive_finish``."""
    dev = state.t_seen.device
    one = lambda v, dt: torch.as_tensor(v, dtype=dt, device=dev).reshape(1)
    table, info = symed_receive_masked_pieces_table(
        torch.as_tensor(piece_endpoints)[None],
        torch.as_tensor(piece_steps)[None], one(n_valid, torch.int32),
        one(hello, torch.float32), one(t_seen, torch.int32), cfg,
        _batch1(state), digitize_every_k=digitize_every_k)
    return _unbatch1(table), _unbatch1(info)


def _receive_chunk_table(chunk, cfg: SymEDConfig,
                         state: Optional[ReceiverState], keys, *,
                         digitize_every_k: int, use_kernel: bool,
                         single: bool):
    """The online receiver of a batch of streams: ingest one ``(B, C)``
    window per stream (one batched sender, one wire compaction, one
    digitize pass over the batch).

    ``state=None`` opens each stream at its window's first point and seeds
    its digitizer from ``keys (B, 2)``.  ``single`` picks the sender's EWMV
    rounding (``normalize.ewm_step``); ``use_kernel`` runs the Lloyd loops
    in the CUDA k-means kernel.  Returns ``(state, info)`` with a leading
    ``B`` axis.
    """
    dev = chunk.device
    if state is None:
        blank = receiver_init(cfg, keys)
        state = blank._replace(comp=compressor_init(chunk[:, 0]),
                               t0=chunk[:, 0],
                               t_seen=torch.ones_like(blank.t_seen))
        chunk = chunk[:, 1:]
    comp, ev = compressor_scan(chunk, state.comp, tol=cfg.tol,
                               len_max=cfg.len_max, alpha=cfg.alpha,
                               single=single)
    step_idx = state.t_seen[:, None] + torch.arange(
        chunk.shape[1], dtype=torch.int32, device=dev)
    endpoints, steps, n_pieces = compact_chunk(
        state.endpoints, state.steps, state.n_pieces, ev.emit, ev.endpoint,
        step_idx)
    table, info = _digitize_and_report(
        state, torch.ones_like(state.t0, dtype=torch.bool), comp, state.t0,
        state.t_seen + chunk.shape[1], endpoints, steps, n_pieces,
        state.chunks + 1, cfg=cfg, digitize_every_k=digitize_every_k,
        use_kernel=use_kernel, mark=None)
    del info["t_seen"]  # the reference's per-stream info has no clock
    return table, info


def symed_receive_chunk(ts_chunk, cfg: SymEDConfig,  # symlint-torch: entry(drive=chunked, budget=218, cpu_budget=458, shapes=receive-chunk)
                        state: Optional[ReceiverState] = None, key=None, *,
                        digitize_every_k: int = 1, device=None):
    """The online receiver of one stream: ingest one ``(C,)`` window.

    ``state=None`` opens the stream at the window's first point and needs
    ``key`` (two uint32 key words) to seed the digitizer.  Every call runs
    the sender over the window and compacts its pieces into the wire
    buffers; every ``digitize_every_k``-th call also digitizes the pieces
    that arrived since the last digitize (the plain k-means, as in the
    reference), so symbols stream out while the stream arrives.
    ``digitize_every_k=0`` defers them to ``symed_receive_finish``.

    Returns ``(state, info)``: ``info["n_pieces"]`` pieces so far, of which
    ``info["n_digitized"]`` have symbols in ``info["symbols_online"]``, and
    ``info["symbol_delta"]`` the window's wire-out frame.  ``device``: where
    it runs, ``cuda`` unless ``"cpu"`` is passed; the window, the state and
    the key move there.
    """
    if state is None and key is None:
        raise ValueError("opening a stream (state=None) requires a PRNG key")
    _check_cadence(digitize_every_k)
    dev = resolve_device(device)
    chunk = torch.as_tensor(ts_chunk, dtype=torch.float32,
                            device=dev).reshape(1, -1)
    if state is None:
        keys = _key1(key, dev)
    else:
        keys, state = None, _batch1(_to_device(state, dev))
    # the rank-1 sender: the reference's single-stream rounding
    table, info = _receive_chunk_table(
        chunk, cfg, state, keys, digitize_every_k=digitize_every_k,
        use_kernel=False, single=True)
    return _unbatch1(table), _unbatch1(info)


def symed_step_chunk(ts_chunk, cfg: SymEDConfig,
                     state: Optional[ReceiverState] = None, key=None, *,
                     device=None):
    """Sender and wire only: ``symed_receive_chunk(digitize_every_k=0)``;
    the digitizer catches up in ``symed_receive_finish``."""
    return symed_receive_chunk(ts_chunk, cfg, state, key, digitize_every_k=0,
                               device=device)


def _score(out, ts, lens, incs, n_pieces, t0) -> None:
    """Rebuild each stream from its pieces and from its symbols and score
    both against ``ts (B, T)`` in DTW space (batched: one DTW launch per
    mode on the card)."""
    t_len = ts.shape[-1]
    rec_p = reconstruct_from_pieces(lens, incs, n_pieces, t0, t_len)
    rec_s = reconstruct_from_symbols(out["symbols"], out["centers"], n_pieces,
                                     t0, t_len)
    out["recon_pieces"] = rec_p
    out["recon_symbols"] = rec_s
    out["re_pieces"] = ops.dtw(ts, rec_p)
    out["re_symbols"] = ops.dtw(ts, rec_s)


def symed_receive_finish(state: ReceiverState, cfg: SymEDConfig,  # symlint-torch: entry(drive=chunked, budget=8, cpu_budget=18, shapes=receive-finish)
                         ts=None, reconstruct: bool = False, *,
                         with_delta: bool = False,
                         use_kernel: bool = False) -> Dict[str, Any]:
    """Close a stream: flush the tail, digitize the rest.

    Takes one slot's state (or a table).  The output dict matches
    ``symed_encode``'s; ``with_delta=True`` adds ``out["symbol_delta"]``,
    the closing wire-out frame.  ``reconstruct=True`` also rebuilds and
    scores the stream against ``ts``, the raw points it ingested (``(T,)``,
    or ``(S, T)`` for a table).  ``use_kernel`` runs the Lloyd loops in the
    CUDA k-means kernel.
    """
    if reconstruct and ts is None:
        raise ValueError("reconstruct=True requires the raw stream ts")
    single = state.t_seen.dim() == 0
    st = _batch1(state) if single else state
    tail = compressor_finalize(st.comp)
    endpoints, steps, n_pieces = append_tail(
        st.endpoints, st.steps, st.n_pieces, tail, st.t_seen)
    lens, incs = pieces_from_wire(endpoints, steps, n_pieces, st.t0)
    dig, span_syms = digitize_span_table(
        st.dig, lens, incs, st.dig.n, n_pieces, use_kernel=use_kernel,
        **cfg.digitize_kw())
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
    if reconstruct:
        ts = torch.as_tensor(ts, dtype=torch.float32, device=n_pieces.device)
        _score(out, ts[None] if single else ts, lens, incs, n_pieces, st.t0)
    return _unbatch1(out) if single else out


def _receive(events, keys, ts, n_points: int, cfg: SymEDConfig, *,
             reconstruct: bool,
             use_kernel: bool = False) -> Dict[str, torch.Tensor]:
    """Wire -> receiver for a batch of whole streams: compact, digitize,
    score.  Shared by ``symed_encode``, ``symed_finish`` and ``symed_batch``
    so their outputs agree by construction.  ``events`` carry per-step
    ``emit``/``endpoint`` and the trailing ``tail``, time on the last axis
    of ``(B, T)``; ``keys (B, 2)`` seed the digitizers; ``ts (B, T)`` is the
    raw stream (its first points anchor the wire).  ``use_kernel`` runs
    the Lloyd loops in the CUDA k-means kernel."""
    t0 = ts[:, 0]
    wire = compact_events(events, n_max=cfg.n_max, t0=t0)
    n_pieces = wire["n_pieces"]
    dig = digitizer_init(cfg.n_max, cfg.k_max, keys)
    dig, symbols = digitize_span_table(
        dig, wire["lengths"], wire["incs"], torch.zeros_like(n_pieces),
        n_pieces, use_kernel=use_kernel, **cfg.digitize_kw())
    points = torch.tensor(n_points, dtype=torch.int32, device=ts.device)
    out = {
        "symbols": dig.labels,
        "symbols_online": symbols,
        "centers": dig.centers,
        "k": dig.k,
        "pieces_len": wire["lengths"],
        "pieces_inc": wire["incs"],
        "n_pieces": n_pieces,
        "wire_bytes": 4.0 + 4.0 * n_pieces.float(),
        "cr": compression_rate_symed(n_pieces, points),
        "drr": drr(n_pieces, points),
    }
    if reconstruct:
        _score(out, ts, wire["lengths"], wire["incs"], n_pieces, t0)
    return out


def symed_encode(ts, cfg: SymEDConfig, key, reconstruct: bool = True,
                 device=None) -> Dict[str, torch.Tensor]:
    """Encode one stream ``ts (T,)`` in one shot: sender, wire, receiver.

    ``key (2,)`` seeds the digitizer.  ``reconstruct=True`` adds
    ``recon_pieces``/``recon_symbols`` (the stream rebuilt from its pieces
    and from its symbols) and their DTW errors ``re_pieces``/``re_symbols``.
    ``device``: where it runs, ``cuda`` unless ``"cpu"`` is passed
    (``repro_torch.resolve_device``); the stream and the key move there.
    """
    dev = resolve_device(device)
    ts = torch.as_tensor(ts, dtype=torch.float32, device=dev)[None]
    events = compress_stream(ts, tol=cfg.tol, len_max=cfg.len_max,
                             alpha=cfg.alpha)  # one stream: its own rounding
    out = _receive(events, _key1(key, ts.device), ts, ts.shape[-1], cfg,
                   reconstruct=reconstruct)
    return _unbatch1(out)


def symed_encode_chunk(ts_chunk, cfg: SymEDConfig,  # symlint-torch: entry(drive=chunked, budget=132, cpu_budget=124, shapes=encode-chunk)
                       state: Optional[CompressorState] = None, device=None):
    """Resumable sender: ingest one ``(..., C)`` window of the stream.

    ``state=None`` opens the stream at the window's first point.  Returns
    ``(state, events)``: per-step ``emit``/``endpoint``/``length``/``inc``
    shaped like the window.  Step for step the same as ``compress_stream``
    over the joined windows.  ``device`` as for ``symed_encode``; the window
    and the state move there.
    """
    dev = resolve_device(device)
    ts_chunk = torch.as_tensor(ts_chunk, dtype=torch.float32, device=dev)
    if state is not None:
        state = _to_device(state, dev)
    state, ev = compressor_scan(ts_chunk, state, tol=cfg.tol,
                                len_max=cfg.len_max, alpha=cfg.alpha)
    return state, {"emit": ev.emit, "endpoint": ev.endpoint,
                   "length": ev.length, "inc": ev.inc}


def symed_finish(events: Dict[str, torch.Tensor], state: CompressorState,  # symlint-torch: entry(drive=chunked, budget=90, cpu_budget=344, shapes=finish)
                 cfg: SymEDConfig, key, ts, reconstruct: bool = True,
                 device=None) -> Dict[str, torch.Tensor]:
    """Close a chunked stream: flush the open segment, wire-compact,
    digitize.

    ``events`` are the ``symed_encode_chunk`` outputs joined along the step
    axis (one stream, ``(T,)``); ``ts`` is the whole raw stream (only
    ``ts[0]`` enters the wire; the DTW errors are scored against it).  The
    output dict matches ``symed_encode``'s.  ``device`` as for
    ``symed_encode``; the events, the state, the key and ``ts`` move there.
    """
    dev = resolve_device(device)
    ts = torch.as_tensor(ts, dtype=torch.float32, device=dev)
    events, state = _to_device(events, dev), _to_device(state, dev)
    joined = {**{k: v[None] for k, v in events.items()},
              "tail": _batch1(compressor_finalize(state))}
    out = _receive(joined, _key1(key, ts.device), ts[None],
                   events["emit"].shape[-1], cfg, reconstruct=reconstruct)
    return _unbatch1(out)


def symed_batch(ts, cfg: SymEDConfig, key, reconstruct: bool = True,
                device=None) -> Dict[str, torch.Tensor]:
    """A fleet slab ``ts (B, T)``; the digitizer keys are ``split(key, B)``.

    The outputs carry a leading ``B`` axis.  The sender rounds EWMV as the
    reference's vmapped program does: the single-stream form for at most
    three streams, the batched form for more.  ``device`` as for
    ``symed_encode``.
    """
    ts = torch.as_tensor(ts, dtype=torch.float32,
                         device=resolve_device(device))
    b = ts.shape[0]
    keys = prng.split(prng.as_key(key, ts.device), b)
    return _encode_batch(ts, keys, cfg, single=b <= 3,
                         reconstruct=reconstruct)


def _encode_batch(ts, keys, cfg: SymEDConfig, *, single: bool,
                  reconstruct: bool,
                  use_kernel: bool = False) -> Dict[str, torch.Tensor]:
    """Whole streams ``ts (B, T)`` with their digitizer keys ``keys (B,
    2)``: one batched sender (``single`` picks its EWMV rounding), then
    ``_receive`` (``use_kernel`` as there)."""
    events = compress_stream(ts, tol=cfg.tol, len_max=cfg.len_max,
                             alpha=cfg.alpha, single=single)
    return _receive(events, keys, ts, ts.shape[-1], cfg,
                    reconstruct=reconstruct, use_kernel=use_kernel)


def _key1(key, device) -> torch.Tensor:
    return prng.as_key(key, device).reshape(1, 2)


def _to_device(tree, device):
    """A tensor, or a dict or NamedTuple of them (nested), on ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(v, device) for v in tree))
    return torch.as_tensor(tree).to(device)


def symbols_to_string(labels, n_pieces) -> str:
    """Host-side helper: int labels -> 'abc...' string (I/O boundary only)."""
    labels = np.asarray(torch.as_tensor(labels).cpu())[: int(n_pieces)]
    alphabet = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
    return "".join(alphabet[int(l) % len(alphabet)] for l in labels)
