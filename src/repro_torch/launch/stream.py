"""Resident SymED session service: the paper's deployment shape.

Port of ``repro.launch.stream``.  A ``StreamServer`` owns a slot table of
batched ``ReceiverState``s on one device (one slot per live stream) and
drives every arrival round through one table step
(``symed_receive_masked_chunk_table``): ragged arrivals are padded to
``window_cap`` with per-slot valid counts, fresh and resumed sessions share
the same step, idle slots ride along as masked no-ops.  On CUDA the
digitize pass's Lloyd loops run in the hand-written k-means kernel.

Compressed-in sessions (``ingest_pieces_many``): the senders ran the
compressor and ship piece tuples, which one table step
(``symed_receive_masked_pieces_table``) scatters into the wire buffers
before the same digitize pass.  Raw-in and compressed-in sessions share one
table; each session stays in one mode.

Wire out: every digitize pass emits a symbol-delta frame ``(new_labels,
new_piece_endpoints, n_new)``; joining every delta of a session plus its
closing frame reproduces ``symed_encode``'s ``symbols_online`` and wire
endpoints.

An online DTW monitor (``dtw_every=m``) scores each session's
reconstruction from its pieces against the raw points seen so far every
``m`` windows (``reconstruct_from_pieces`` + ``kernels.ops.dtw``: on CUDA
the DTW kernel, one launch for all due sessions of one length).

Slot lifecycle: ``open`` allocates a free slot (growing the table on the
autoscale ladder, or with ``evict_idle`` closing the least-recently-active
session, whose final output is parked in ``server.evicted``); ``close``
flushes the tail, emits the closing delta frame and frees the slot.

CLI (round-robin arrivals from ``make_fleet``):

    PYTHONPATH=src python -m repro_torch.launch.stream --sessions 6 \
        --max-slots 4 --length 384 --window 48 --evict --dtw-every 2 \
        --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.receiver import (
    DELTA_FRAME_HEADER_BYTES, DELTA_SYMBOL_BYTES, PIECE_TUPLE_BYTES,
    pieces_from_wire,
)
from repro_torch.core.reconstruct import reconstruct_from_pieces
from repro_torch.core.symed import (
    SymEDConfig, receiver_init, symbols_to_string, symed_receive_finish,
    symed_receive_masked_chunk_table, symed_receive_masked_pieces_table,
)
from repro_torch.kernels import ops

__all__ = ["StreamServer", "PhaseClock", "main"]


def _new_delta() -> dict:
    """Empty merged symbol-delta accumulator (one per sid per ingest call)."""
    return {"labels": [], "endpoints": [], "n_new": 0, "frames": 0,
            "bytes": 0.0}


def _finalize_deltas(deltas: Dict[str, dict]) -> Dict[str, dict]:
    """Concatenate each accumulator's per-round slices into flat arrays."""
    for out in deltas.values():
        out["labels"] = (np.concatenate(out["labels"])
                         if out["labels"] else np.zeros((0,), np.int32))
        out["endpoints"] = (np.concatenate(out["endpoints"])
                            if out["endpoints"] else np.zeros((0,), np.float32))
    return deltas


def _map(fn, *trees):
    """Apply ``fn`` leaf-wise over (nested) NamedTuples of tensors."""
    if isinstance(trees[0], tuple):
        return type(trees[0])(*(_map(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


class PhaseClock:
    """Per-phase time of the table steps: device time from CUDA events on a
    CUDA table, host time otherwise.

    ``mark(name)`` closes the phase ``name`` that started at the previous
    mark (``start`` opens a step); ``collect()`` folds the finished steps
    into ``totals`` (milliseconds), synchronising on the last event.
    """

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.totals: Dict[str, float] = {}
        self._pending: List[tuple] = []
        self._last = None

    def _stamp(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> None:
        self._last = self._stamp()

    def mark(self, name: str) -> None:
        now = self._stamp()
        self._pending.append((name, self._last, now))
        self._last = now

    def collect(self) -> Dict[str, float]:
        if self.cuda and self._pending:
            self._pending[-1][2].synchronize()
        for name, a, b in self._pending:
            ms = a.elapsed_time(b) if self.cuda else 1e3 * (b - a)
            self.totals[name] = self.totals.get(name, 0.0) + ms
        self._pending.clear()
        return self.totals


@dataclasses.dataclass
class _Session:
    """Host-side bookkeeping for one live slot (device state is the table)."""

    stream_id: str
    slot: int
    chunks: int = 0           # non-empty windows ingested
    t_seen: int = 0           # stream points ingested
    symbols_out: int = 0      # symbols emitted across delta frames
    frames_out: int = 0       # delta frames emitted
    bytes_out: float = 0.0    # outbound delta-frame bytes
    last_active: int = 0      # server clock at last arrival (LRU eviction)
    raw: Optional[List[np.ndarray]] = None  # raw points (DTW monitor only)
    dtw: Optional[float] = None             # latest monitor reading


class StreamServer:
    """Session-table SymED service: resident ``ReceiverState`` per stream.

    ``open(stream_id)`` allocates a slot, ``ingest(stream_id, window)``
    feeds a ragged arrival and returns the symbol-delta frame it produced,
    ``close(stream_id)`` flushes the stream and frees the slot;
    ``ingest_many`` advances concurrent arrivals in one table step per
    round, ``ingest_pieces_many`` the arrivals of compressed-in sessions.

    Args:
      cfg: SymED hyperparameters (shared by every session).
      max_sessions: slot-table capacity.
      window_cap: padded arrival width; longer arrivals are split into
        ``window_cap``-sized rounds host-side.
      digitize_every_k: digitize cadence in non-empty windows per session
        (0 defers symbols to ``close``).
      dtw_every: every this-many windows per session, reconstruct from the
        pieces so far and score DTW against the raw points seen so far
        (0 disables; enabling keeps each session's raw history on the host).
      dtw_band: Sakoe-Chiba radius for the monitor (None = full DTW).
      evict_idle: when the table is full and cannot grow, ``open`` evicts
        the least-recently active session instead of raising.
      autoscale: walk the capacity along a power-of-two ladder from
        ``min_slots`` to ``max_sessions``: ``open`` on a full table doubles
        it, ``close`` shrinks it once occupancy has stayed at or below a
        quarter of the capacity for ``shrink_patience`` consecutive closes.
        Resizes are pure gathers and concatenations of the table's tensors.
      min_slots: the autoscale floor, the ladder's first rung.
      use_kernel: run the Lloyd loops in the CUDA k-means kernel
        (default: on when the table lives on CUDA).
      seed: base PRNG seed for per-session digitizer keys.
      device: where the table lives; ``cuda`` unless ``"cpu"`` is passed.
        Without CUDA, only ``device="cpu"`` works.
      clock: a ``PhaseClock`` that times the phases of every round
        (optional): sender (raw in) or wire (compressed in), digitize,
        harvest.
    """

    def __init__(
        self,
        cfg: SymEDConfig,
        *,
        max_sessions: int = 8,
        window_cap: int = 64,
        digitize_every_k: int = 1,
        dtw_every: int = 0,
        dtw_band: Optional[int] = None,
        evict_idle: bool = False,
        autoscale: bool = False,
        min_slots: int = 1,
        shrink_patience: int = 3,
        use_kernel: Optional[bool] = None,
        seed: int = 0,
        device=None,
        clock: Optional[PhaseClock] = None,
    ):
        if max_sessions < 1:
            raise ValueError(f"max_sessions must be >= 1, got {max_sessions}")
        if window_cap < 1:
            raise ValueError(f"window_cap must be >= 1, got {window_cap}")
        if digitize_every_k < 0:
            raise ValueError(
                f"digitize_every_k must be >= 0, got {digitize_every_k}")
        if not 1 <= min_slots <= max_sessions:
            raise ValueError(
                f"min_slots={min_slots} must be in [1, {max_sessions}]")
        if shrink_patience < 1:
            raise ValueError(
                f"shrink_patience must be >= 1, got {shrink_patience}")
        if dtw_every < 0:
            raise ValueError(f"dtw_every must be >= 0, got {dtw_every}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_sessions = int(max_sessions)
        self.window_cap = int(window_cap)
        self.digitize_every_k = int(digitize_every_k)
        self.dtw_every = int(dtw_every)
        self.dtw_band = dtw_band
        self._dtw_due: set = set()  # sessions whose DTW cadence fired
        self.evict_idle = bool(evict_idle)
        self.autoscale = bool(autoscale)
        self.min_slots = int(min_slots)
        self.shrink_patience = int(shrink_patience)
        self._low_ticks = 0
        self.use_kernel = (bool(use_kernel) if use_kernel is not None
                           else self.device.type == "cuda")
        self.clock = clock
        self._ladder = [self.min_slots]
        while self._ladder[-1] < self.max_sessions:
            self._ladder.append(min(self._ladder[-1] * 2, self.max_sessions))
        self.capacity = self.min_slots if autoscale else self.max_sessions
        self._base_key = prng.key(seed, device=self.device)
        self._serial = 0
        self._clock = 0
        self._sessions: Dict[str, _Session] = {}
        self._free = list(range(self.capacity))
        self.evicted: Dict[str, dict] = {}
        self.totals = {
            "points_in": 0, "bytes_in": 0.0, "symbols_out": 0,
            "frames_out": 0, "bytes_out": 0.0, "steps": 0,
            "opened": 0, "closed": 0, "evicted": 0,
            "grows": 0, "shrinks": 0, "dtw_readings": 0, "dtw_seconds": 0.0,
        }
        self._table = self._blanks(self.capacity)

    def _blanks(self, n: int):
        """``n`` fresh blank slots (keys are placeholders; ``open`` reseeds)."""
        return receiver_init(self.cfg, prng.split(self._base_key, n))

    # ------------------------------------------------------------------ API

    @property
    def active_sessions(self) -> int:
        return len(self._sessions)

    def __contains__(self, stream_id: str) -> bool:
        return stream_id in self._sessions

    def session_ids(self) -> List[str]:
        """Open session ids, in open order."""
        return list(self._sessions)

    def session_stats(self, stream_id: str) -> dict:
        """Live bookkeeping for one open session (monitoring surface)."""
        sess = self._sessions[stream_id]
        return {
            "slot": sess.slot, "chunks": sess.chunks, "t_seen": sess.t_seen,
            "symbols_out": sess.symbols_out, "frames_out": sess.frames_out,
            "bytes_out": sess.bytes_out, "dtw": sess.dtw,
        }

    def open(self, stream_id: str, key=None) -> int:
        """Allocate a slot for ``stream_id``; returns the slot index.

        ``key`` (two uint32 key words, as ``prng.key`` makes) seeds the
        session's digitizer; by default it is ``fold_in(key(seed), serial)``
        with the session serial, so every session is reproducible.
        """
        if stream_id in self._sessions:
            raise ValueError(f"session {stream_id!r} is already open")
        if not self._free and self.capacity < self.max_sessions:
            self._grow()
        if not self._free:
            if not self.evict_idle:
                raise RuntimeError(
                    f"session table full ({self.max_sessions} slots); "
                    "close a session or construct with evict_idle=True")
            lru = min(self._sessions.values(), key=lambda s: s.last_active)
            self.evicted[lru.stream_id] = self.close(lru.stream_id)
            self.totals["evicted"] += 1
            self.totals["closed"] -= 1  # eviction is not a clean close
        slot = self._free.pop()
        self._serial += 1
        if key is None:
            key = prng.fold_in(self._base_key, self._serial)
        blank = receiver_init(self.cfg, prng.as_key(key, self.device))
        self._table = _map(lambda l, b: l.index_copy(0, self._slot_t(slot),
                                                     b[None]),
                           self._table, blank)
        self._sessions[stream_id] = _Session(
            stream_id=stream_id, slot=slot, last_active=self._clock,
            raw=[] if self.dtw_every else None)
        self.totals["opened"] += 1
        self.totals["bytes_in"] += 4.0  # the t0 "hello" payload
        return slot

    def _slot_t(self, slot: int) -> torch.Tensor:
        return torch.tensor([slot], dtype=torch.long, device=self.device)

    def ingest(self, stream_id: str, window) -> dict:
        """Feed one ragged arrival; returns its symbol-delta frame."""
        return self.ingest_many({stream_id: window})[stream_id]

    def ingest_many(self, arrivals: Dict[str, object]) -> Dict[str, dict]:
        """Feed concurrent arrivals through one table step per round.

        ``arrivals`` maps open stream ids to 1-D float windows of any
        length; windows longer than ``window_cap`` are split into
        consecutive rounds.  Returns the merged symbol-delta frame per
        stream: ``{"labels", "endpoints", "n_new", "frames", "bytes"}``.

        Rounds are double-buffered (``_run_rounds``).  The DTW monitor
        runs once at the end, for every session whose cadence fired.
        """
        wins = {}
        for sid, w in arrivals.items():
            if sid not in self._sessions:
                raise KeyError(f"unknown session {sid!r} (open it first)")
            wins[sid] = np.asarray(w, np.float32).reshape(-1)
        cap = self.window_cap

        def pack_round(r):
            padded = np.zeros((self.capacity, cap), np.float32)
            n_valid = np.zeros((self.capacity,), np.int32)
            active = []
            for sid, w in wins.items():
                part = w[r * cap: (r + 1) * cap]
                if not len(part):
                    continue
                sess = self._sessions[sid]
                padded[sess.slot, : len(part)] = part
                n_valid[sess.slot] = len(part)
                active.append((sid, part))
            return active, (padded, n_valid)

        rounds = max(((len(w) + cap - 1) // cap for w in wins.values()),
                     default=0)
        deltas = self._run_rounds(wins, rounds, pack_round, self._dispatch,
                                  self._harvest_round)
        self._run_dtw_monitor()
        return _finalize_deltas(deltas)

    def _run_rounds(self, sids, rounds, pack_round, dispatch, harvest):
        """Run ``rounds`` table steps, double-buffered: round ``r`` is
        dispatched, round ``r+1`` is packed on the host, and only then are
        round ``r``'s outputs copied to the host, in one transfer.
        ``pack_round(r)`` gives the round's ``(active, host arrays)``,
        ``dispatch(*host arrays)`` its packed outputs, and ``harvest``
        folds them into the per-stream deltas, which are returned."""
        deltas = {sid: _new_delta() for sid in sids}
        pend = None  # (active, packed outputs, clock) of the round in flight
        for r in range(rounds):
            active, host = pack_round(r)
            flight = None
            if active:
                flight = (active, dispatch(*host), self._clock)
            # harvest the previous round only after this one is in flight
            if pend is not None:
                harvest(*pend, deltas)
            pend = flight
        if pend is not None:
            harvest(*pend, deltas)
        return deltas

    def _dispatch(self, padded: np.ndarray, n_valid: np.ndarray):
        """Run one raw-in table step; returns its outputs packed for one
        host transfer (``_pack``)."""
        windows = torch.from_numpy(padded).to(self.device)
        counts = torch.from_numpy(n_valid).to(self.device)
        if self.clock is not None:
            self.clock.start()
        self._table, info = symed_receive_masked_chunk_table(
            windows, counts, self.cfg, self._table,
            digitize_every_k=self.digitize_every_k,
            use_kernel=self.use_kernel,
            mark=self.clock.mark if self.clock is not None else None)
        return self._pack(info)

    def _dispatch_pieces(self, *host_args: np.ndarray):
        """Run one compressed-in table step on the padded ``(endpoints,
        steps, n_valid, hello, t_seen)``; returns its outputs packed for one
        host transfer (``_pack``)."""
        args = [torch.from_numpy(a).to(self.device) for a in host_args]
        if self.clock is not None:
            self.clock.start()
        self._table, info = symed_receive_masked_pieces_table(
            *args, self.cfg, self._table,
            digitize_every_k=self.digitize_every_k,
            use_kernel=self.use_kernel,
            mark=self.clock.mark if self.clock is not None else None)
        return self._pack(info)

    def _pack(self, info):
        """A table step's outputs in one int32 device tensor (``labels |
        endpoints bits | n_new | emitted | t_seen`` per slot)."""
        d = info["symbol_delta"]
        packed = torch.cat([
            d["labels"], d["endpoints"].view(torch.int32),
            d["n_new"][:, None], d["emitted"].to(torch.int32)[:, None],
            info["t_seen"][:, None]], dim=1)
        self.totals["steps"] += 1
        self._clock += 1
        return packed

    def _unpack(self, packed):
        """Copy one round's packed outputs to the host (the round's one
        device-to-host copy): ``(labels, endpoints, n_new, emitted,
        t_seen)`` per slot."""
        host = packed.cpu().numpy()
        n_max = self.cfg.n_max
        if self.clock is not None:
            self.clock.mark("harvest")
            self.clock.collect()
        return (host[:, :n_max], host[:, n_max: 2 * n_max].view(np.float32),
                *(host[:, 2 * n_max + i] for i in range(3)))

    def _harvest_round(self, active, packed, clock, deltas) -> None:
        """Fold one raw-in round's outputs into the books."""
        labels, endpoints, n_new, emitted, t_seen = self._unpack(packed)
        for sid, part in active:
            sess = self._sessions[sid]
            n = int(n_new[sess.slot])
            self._account_delta(sess, deltas[sid], labels[sess.slot],
                                endpoints[sess.slot], n,
                                bool(emitted[sess.slot]))
            sess.chunks += 1
            sess.t_seen = int(t_seen[sess.slot])
            sess.last_active = clock
            self.totals["points_in"] += len(part)
            self.totals["bytes_in"] += 4.0 * len(part)
            if sess.raw is not None:
                sess.raw.append(part.copy())
                if sess.chunks % self.dtw_every == 0:
                    self._dtw_due.add(sid)

    def ingest_pieces_many(self, arrivals: Dict[str, dict]) -> Dict[str, dict]:
        """Compressed-in counterpart of ``ingest_many``.

        Each arrival carries the pieces its sender's compressor finished:
        ``{"endpoints": (n,) f32, "steps": (n,) i32 arrival steps,
        "t_seen": the sender's point clock, "t0": its hello,
        "wire_bytes": the payload's bytes (optional; else
        ``PIECE_TUPLE_BYTES`` per piece)}``.  Arrivals of more than
        ``window_cap`` pieces split into consecutive rounds; an arrival of
        no pieces still advances its session's clock.  Returns the merged
        symbol-delta frame per stream, as ``ingest_many`` does; rounds are
        double-buffered the same way.  The DTW monitor needs raw points, so
        it never fires for these sessions.
        """
        pends = {}
        for sid, a in arrivals.items():
            if sid not in self._sessions:
                raise KeyError(f"unknown session {sid!r} (open it first)")
            pends[sid] = {
                "endpoints": np.asarray(a["endpoints"], np.float32).reshape(-1),
                "steps": np.asarray(a["steps"], np.int32).reshape(-1),
                "t_seen": int(a["t_seen"]),
                "t0": float(a["t0"]),
                "wire_bytes": float(a.get("wire_bytes", 0.0)),
            }
        cap = self.window_cap

        def pack_round(r):
            pad_e = np.zeros((self.capacity, cap), np.float32)
            pad_s = np.zeros((self.capacity, cap), np.int32)
            n_valid = np.zeros((self.capacity,), np.int32)
            hello = np.zeros((self.capacity,), np.float32)
            t_seen_in = np.zeros((self.capacity,), np.int32)
            active = []
            for sid, p in pends.items():
                part_e = p["endpoints"][r * cap: (r + 1) * cap]
                if r > 0 and not len(part_e):
                    continue
                sess = self._sessions[sid]
                pad_e[sess.slot, : len(part_e)] = part_e
                pad_s[sess.slot, : len(part_e)] = (
                    p["steps"][r * cap: (r + 1) * cap])
                n_valid[sess.slot] = len(part_e)
                hello[sess.slot] = p["t0"]
                t_seen_in[sess.slot] = p["t_seen"]
                active.append((sid, len(part_e)))
                if r == 0:
                    self.totals["bytes_in"] += (
                        p["wire_bytes"]
                        or PIECE_TUPLE_BYTES * len(p["endpoints"]))
            return active, (pad_e, pad_s, n_valid, hello, t_seen_in)

        rounds = max((((len(p["endpoints"]) + cap - 1) // cap) or 1
                      for p in pends.values()), default=0)
        deltas = self._run_rounds(pends, rounds, pack_round,
                                  self._dispatch_pieces,
                                  self._harvest_pieces_round)
        return _finalize_deltas(deltas)

    def _harvest_pieces_round(self, active, packed, clock, deltas) -> None:
        """Fold one compressed-in round's outputs into the books: a round
        counts as a window where it carried pieces, and ``points_in``
        follows the senders' clocks."""
        labels, endpoints, n_new, emitted, t_seen = self._unpack(packed)
        for sid, n_in in active:
            sess = self._sessions[sid]
            n = int(n_new[sess.slot])
            self._account_delta(sess, deltas[sid], labels[sess.slot],
                                endpoints[sess.slot], n,
                                bool(emitted[sess.slot]))
            if n_in:
                sess.chunks += 1
            now_seen = int(t_seen[sess.slot])
            self.totals["points_in"] += max(now_seen - sess.t_seen, 0)
            sess.t_seen = now_seen
            sess.last_active = clock

    def close(self, stream_id: str) -> dict:
        """Flush the tail, emit the closing delta frame, free the slot.

        Returns ``{"out", "delta", "symbols", "n_pieces", "t_seen", "dtw",
        ...}`` where ``out`` is the ``symed_receive_finish`` dict (host
        numpy) and ``dtw`` the session's latest monitor reading.
        """
        sess = self._sessions.pop(stream_id, None)
        if sess is None:
            raise KeyError(f"unknown session {stream_id!r}")
        delta = {"labels": np.zeros((0,), np.int32),
                 "endpoints": np.zeros((0,), np.float32),
                 "n_new": 0, "frames": 0, "bytes": 0.0}
        out = None
        n_pieces = 0
        if sess.t_seen:  # a never-fed session has nothing to flush
            sub = _map(lambda l: l[sess.slot], self._table)
            res = symed_receive_finish(sub, self.cfg, with_delta=True)
            out = {k: v.cpu().numpy() for k, v in res.items()
                   if k != "symbol_delta"}
            d = out["symbol_delta"] = {
                k: v.cpu().numpy() for k, v in res["symbol_delta"].items()}
            n = int(d["n_new"])
            frame = DELTA_FRAME_HEADER_BYTES + DELTA_SYMBOL_BYTES * n
            delta = {"labels": d["labels"][:n],
                     "endpoints": d["endpoints"][:n],
                     "n_new": n, "frames": 1, "bytes": frame}
            n_pieces = int(out["n_pieces"])
            sess.symbols_out += n
            sess.frames_out += 1
            sess.bytes_out += frame
            self.totals["symbols_out"] += n
            self.totals["frames_out"] += 1
            self.totals["bytes_out"] += frame
        self._free.append(sess.slot)
        self.totals["closed"] += 1
        self._maybe_shrink()
        return {
            "stream_id": stream_id,
            "out": out,
            "delta": delta,
            "symbols": (symbols_to_string(out["symbols_online"], n_pieces)
                        if out is not None else ""),
            "n_pieces": n_pieces,
            "t_seen": sess.t_seen,
            "symbols_out": sess.symbols_out,
            "bytes_out": sess.bytes_out,
            "dtw": sess.dtw,
        }

    def report(self, wall_seconds: float) -> Dict[str, float]:
        """Host-side service summary; every value is a float."""
        t = {k: float(v) for k, v in self.totals.items()}
        dt = max(wall_seconds, 1e-9)
        raw_bytes = 4.0 * t["points_in"]
        return {
            **t,
            "active": float(self.active_sessions),
            "capacity": float(self.capacity),
            "wall_seconds": wall_seconds,
            "points_per_s": t["points_in"] / dt,
            "symbols_per_s": t["symbols_out"] / dt,
            "ms_per_symbol": 1e3 * dt / max(t["symbols_out"], 1.0),
            "raw_bytes": raw_bytes,
            "wire_in_bytes": t["bytes_in"],
            "wire_in_ratio": t["bytes_in"] / max(raw_bytes, 1.0),
            "wire_out_ratio": t["bytes_out"] / max(raw_bytes, 1.0),
        }

    # ------------------------------------------------------------- internals

    def _account_delta(self, sess: _Session, out: dict, labels_row,
                       endpoints_row, n: int, emitted: bool) -> None:
        """Fold one round's symbol delta for one session into its merged
        accumulator and the session/fleet wire-out books."""
        out["labels"].append(labels_row[:n].copy())
        out["endpoints"].append(endpoints_row[:n].copy())
        out["n_new"] += n
        sess.symbols_out += n
        self.totals["symbols_out"] += n
        if emitted:
            frame = DELTA_FRAME_HEADER_BYTES + DELTA_SYMBOL_BYTES * n
            sess.frames_out += 1
            sess.bytes_out += frame
            out["frames"] += 1
            out["bytes"] += frame
            self.totals["frames_out"] += 1
            self.totals["bytes_out"] += frame

    def _grow(self) -> None:
        """Move one rung up the ladder, carrying all state (live slots keep
        their indices, the new upper part is blank)."""
        new_cap = self._ladder[self._ladder.index(self.capacity) + 1]
        self._table = _map(lambda l, b: torch.cat([l, b], dim=0), self._table,
                           self._blanks(new_cap - self.capacity))
        self._free.extend(range(self.capacity, new_cap))
        self.capacity = new_cap
        self.totals["grows"] += 1

    def _maybe_shrink(self) -> None:
        """Walk down the ladder once occupancy has stayed at or below a
        quarter of the capacity for ``shrink_patience`` consecutive closes;
        live slots are compacted into the low indices by a pure gather."""
        if not (self.autoscale and self.capacity > self.min_slots):
            self._low_ticks = 0
            return
        target = self._ladder[self._ladder.index(self.capacity) - 1]
        if len(self._sessions) > target // 2:
            self._low_ticks = 0
            return
        self._low_ticks += 1
        if self._low_ticks < self.shrink_patience:
            return
        self._low_ticks = 0
        while self.autoscale and self.capacity > self.min_slots:
            target = self._ladder[self._ladder.index(self.capacity) - 1]
            if len(self._sessions) > target // 2:
                return
            live = sorted(self._sessions.values(), key=lambda s: s.slot)
            perm = [s.slot for s in live]
            perm += sorted(self._free)[: target - len(perm)]
            idx = torch.tensor(perm, dtype=torch.long, device=self.device)
            self._table = _map(lambda l: l[idx], self._table)
            for new_slot, sess in enumerate(live):
                sess.slot = new_slot
            self._free = list(range(len(live), target))
            self.capacity = target
            self.totals["shrinks"] += 1

    def _run_dtw_monitor(self) -> None:
        """Online reconstruction error for every session whose DTW cadence
        fired during this ingest call: DTW(raw so far, pieces so far).

        The due slots are read out of the table in one gather; sessions
        whose raw histories have one length share one batched
        reconstruction and one DTW call (the pairs are independent, so each
        reading is the one a call of its own gives); the readings come to
        the host in one copy.
        """
        due = [self._sessions[sid] for sid in sorted(self._dtw_due)
               if sid in self._sessions]
        self._dtw_due.clear()
        if not due:
            return
        t_start = time.perf_counter()
        idx = torch.tensor([s.slot for s in due], dtype=torch.long,
                           device=self.device)
        t = self._table
        endpoints, steps, n_pieces, t0 = (
            leaf.index_select(0, idx)
            for leaf in (t.endpoints, t.steps, t.n_pieces, t.t0))
        lens, incs = pieces_from_wire(endpoints, steps, n_pieces, t0)
        raws = [np.concatenate(s.raw) for s in due]
        by_len: Dict[int, List[int]] = {}
        for i, raw in enumerate(raws):
            by_len.setdefault(raw.shape[0], []).append(i)
        readings = torch.empty(len(due), dtype=torch.float32,
                               device=self.device)
        for length, rows in by_len.items():
            r = torch.tensor(rows, dtype=torch.long, device=self.device)
            rec = reconstruct_from_pieces(lens[r], incs[r], n_pieces[r],
                                          t0[r], length)
            raw = torch.from_numpy(np.stack([raws[i] for i in rows]))
            readings[r] = ops.dtw(raw.to(self.device), rec,
                                  band=self.dtw_band)
        for sess, val in zip(due, readings.cpu().tolist()):
            sess.dtw = val
        self.totals["dtw_readings"] += len(due)
        self.totals["dtw_seconds"] += time.perf_counter() - t_start


# ----------------------------------------------------------------- CLI


def _round_robin(server: StreamServer, data: np.ndarray, window: int):
    """Open every session, then each tick every open session sends its next
    window; close them all at the end.  A session evicted to make room
    sends nothing more (its output is parked in ``server.evicted``)."""
    sids = [f"s{s}" for s in range(data.shape[0])]
    for sid in sids:
        server.open(sid)
    for w in range(0, data.shape[1], window):
        server.ingest_many({sid: data[s, w: w + window]
                            for s, sid in enumerate(sids) if sid in server})
    return {sid: server.close(sid) for sid in server.session_ids()}


def main(argv=None):
    from repro_torch.data.synthetic import make_fleet
    from repro_torch.launch.cli import (
        add_slot_table_args, add_symed_args, validate_shared_args)

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--sessions", type=int, default=6,
                    help="simulated streams arriving at the service")
    ap.add_argument("--length", type=int, default=384)
    ap.add_argument("--window", type=int, default=48,
                    help="arrival window cap (ragged arrivals are padded)")
    ap.add_argument("--dtw-every", type=int, default=0,
                    help="online DTW monitor cadence in windows (0: off)")
    add_slot_table_args(ap)
    add_symed_args(ap)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    # the reference's checks and messages, before any torch work
    validate_shared_args(ap, args)
    if args.dtw_every < 0:
        ap.error(f"--dtw-every must be >= 0, got {args.dtw_every}")
    if args.sessions > args.max_slots and not args.evict:
        ap.error(f"--sessions {args.sessions} exceeds --max-slots "
                 f"{args.max_slots}; pass --evict to allow LRU eviction")

    cfg = SymEDConfig(tol=args.tol, alpha=args.alpha, n_max=256, k_max=32,
                      len_max=256)
    server = StreamServer(cfg, max_sessions=args.max_slots,
                          window_cap=args.window,
                          digitize_every_k=args.digitize_every,
                          evict_idle=args.evict, dtw_every=args.dtw_every,
                          autoscale=args.autoscale,
                          min_slots=args.min_slots,
                          shrink_patience=args.shrink_patience,
                          seed=args.seed, device=args.device)
    data = make_fleet(args.sessions, args.length, seed=args.seed)
    t0 = time.perf_counter()
    closed = _round_robin(server, data, args.window)
    if server.device.type == "cuda":
        torch.cuda.synchronize(server.device)
    rep = server.report(time.perf_counter() - t0)
    print(f"device                  : {server.device} "
          f"(k-means kernel {'on' if server.use_kernel else 'off'})")
    print(f"slot table              : {args.max_slots} slots"
          f"{' (autoscaled)' if args.autoscale else ''}, "
          f"window cap {args.window}, round-robin arrivals")
    print(f"sessions                : {int(rep['opened'])} opened, "
          f"{int(rep['closed'])} closed, {int(rep['evicted'])} evicted")
    # stable machine-readable summary: the same keys as the JAX CLI's line
    print("stream_summary "
          f"opened={int(rep['opened'])} closed={int(rep['closed'])} "
          f"evicted={int(rep['evicted'])} capacity={int(rep['capacity'])} "
          f"grows={int(rep['grows'])} shrinks={int(rep['shrinks'])} "
          f"wire_in_bytes={int(rep['wire_in_bytes'])} "
          f"wire_out_bytes={int(rep['bytes_out'])}")
    print(f"wall time               : {rep['wall_seconds']:.2f}s "
          f"({int(rep['steps'])} table steps)")
    print(f"points in               : {int(rep['points_in'])} "
          f"({int(rep['bytes_in'])} wire-in bytes)")
    print(f"symbols out             : {int(rep['symbols_out'])} in "
          f"{int(rep['frames_out'])} delta frames "
          f"({int(rep['bytes_out'])} wire-out bytes)")
    if args.dtw_every:
        vals = [r["dtw"] for r in (*closed.values(), *server.evicted.values())
                if r["dtw"] is not None]
        if vals:
            print(f"online DTW monitor      : mean {np.mean(vals):.3f} "
                  f"over {len(vals)} sessions")
    return rep


if __name__ == "__main__":
    main()
