"""Resident SymED session service: the paper's deployment shape.

Port of ``repro.launch.stream``.  A ``StreamServer`` owns a slot table of
batched ``ReceiverState``s on one device (one slot per live stream) and
drives every arrival round through one table step
(``symed_receive_masked_chunk_table``): ragged arrivals are padded to
``window_cap`` with per-slot valid counts, fresh and resumed sessions share
the same step, idle slots ride along as masked no-ops.  On CUDA the
digitize pass's Lloyd half-steps run in the hand-written k-means kernel.

Wire out: every digitize pass emits a symbol-delta frame ``(new_labels,
new_piece_endpoints, n_new)``; joining every delta of a session plus its
closing frame reproduces ``symed_encode``'s ``symbols_online`` and wire
endpoints.

Slot lifecycle: ``open`` allocates a free slot (growing the table on the
autoscale ladder, or with ``evict_idle`` closing the least-recently-active
session, whose final output is parked in ``server.evicted``); ``close``
flushes the tail, emits the closing delta frame and frees the slot.

CLI (round-robin arrivals from ``make_fleet``):

    PYTHONPATH=src python -m repro_torch.launch.stream --sessions 6 \
        --max-slots 4 --length 384 --window 48 --evict --device cpu
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
    DELTA_FRAME_HEADER_BYTES, DELTA_SYMBOL_BYTES,
)
from repro_torch.core.symed import (
    SymEDConfig, receiver_init, symbols_to_string, symed_receive_finish,
    symed_receive_masked_chunk_table,
)

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


class StreamServer:
    """Session-table SymED service: resident ``ReceiverState`` per stream.

    ``open(stream_id)`` allocates a slot, ``ingest(stream_id, window)``
    feeds a ragged arrival and returns the symbol-delta frame it produced,
    ``close(stream_id)`` flushes the stream and frees the slot;
    ``ingest_many`` advances concurrent arrivals in one table step per
    round.

    Args:
      cfg: SymED hyperparameters (shared by every session).
      max_sessions: slot-table capacity.
      window_cap: padded arrival width; longer arrivals are split into
        ``window_cap``-sized rounds host-side.
      digitize_every_k: digitize cadence in non-empty windows per session
        (0 defers symbols to ``close``).
      evict_idle: when the table is full and cannot grow, ``open`` evicts
        the least-recently active session instead of raising.
      autoscale: walk the capacity along a power-of-two ladder from 1 to
        ``max_sessions``: ``open`` on a full table doubles it, ``close``
        shrinks it once occupancy has stayed at or below a quarter of the
        capacity for ``shrink_patience`` consecutive closes.
        Resizes are pure gathers and concatenations of the table's tensors.
      use_kernel: run the Lloyd half-steps in the CUDA k-means kernel
        (default: on when the table lives on CUDA).
      seed: base PRNG seed for per-session digitizer keys.
      device: where the table lives; ``cuda`` unless ``"cpu"`` is passed.
        Without CUDA, only ``device="cpu"`` works.
      clock: a ``PhaseClock`` that times the sender, digitize and harvest
        phases of every round (optional).
    """

    def __init__(
        self,
        cfg: SymEDConfig,
        *,
        max_sessions: int = 8,
        window_cap: int = 64,
        digitize_every_k: int = 1,
        evict_idle: bool = False,
        autoscale: bool = False,
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
        if shrink_patience < 1:
            raise ValueError(
                f"shrink_patience must be >= 1, got {shrink_patience}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_sessions = int(max_sessions)
        self.window_cap = int(window_cap)
        self.digitize_every_k = int(digitize_every_k)
        self.evict_idle = bool(evict_idle)
        self.autoscale = bool(autoscale)
        self.shrink_patience = int(shrink_patience)
        self._low_ticks = 0
        self.use_kernel = (bool(use_kernel) if use_kernel is not None
                           else self.device.type == "cuda")
        self.clock = clock
        self._ladder = [1]
        while self._ladder[-1] < self.max_sessions:
            self._ladder.append(min(self._ladder[-1] * 2, self.max_sessions))
        self.capacity = 1 if autoscale else self.max_sessions
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
            "grows": 0, "shrinks": 0,
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
            stream_id=stream_id, slot=slot, last_active=self._clock)
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

        Rounds are double-buffered: round ``r`` is dispatched, round
        ``r+1`` is packed on the host, and only then are round ``r``'s
        outputs copied to the host, in one transfer.
        """
        wins = {}
        for sid, w in arrivals.items():
            if sid not in self._sessions:
                raise KeyError(f"unknown session {sid!r} (open it first)")
            wins[sid] = np.asarray(w, np.float32).reshape(-1)
        deltas = {sid: _new_delta() for sid in wins}
        cap = self.window_cap
        rounds = max(((len(w) + cap - 1) // cap for w in wins.values()),
                     default=0)
        pend = None  # (active, packed outputs, clock) of the round in flight
        for r in range(rounds):
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
            flight = None
            if active:
                flight = (active, self._dispatch(padded, n_valid), self._clock)
            # harvest the previous round only after this one is in flight
            if pend is not None:
                self._harvest_round(*pend, deltas)
            pend = flight
        if pend is not None:
            self._harvest_round(*pend, deltas)
        return _finalize_deltas(deltas)

    def _dispatch(self, padded: np.ndarray, n_valid: np.ndarray):
        """Run one table step; returns its outputs packed into one int32
        device tensor (``labels | endpoints bits | n_new | emitted |
        t_seen`` per slot) for a single host transfer."""
        windows = torch.from_numpy(padded).to(self.device)
        counts = torch.from_numpy(n_valid).to(self.device)
        if self.clock is not None:
            self.clock.start()
        self._table, info = symed_receive_masked_chunk_table(
            windows, counts, self.cfg, self._table,
            digitize_every_k=self.digitize_every_k,
            use_kernel=self.use_kernel,
            mark=self.clock.mark if self.clock is not None else None)
        d = info["symbol_delta"]
        packed = torch.cat([
            d["labels"], d["endpoints"].view(torch.int32),
            d["n_new"][:, None], d["emitted"].to(torch.int32)[:, None],
            info["t_seen"][:, None]], dim=1)
        self.totals["steps"] += 1
        self._clock += 1
        return packed

    def _harvest_round(self, active, packed, clock, deltas) -> None:
        """Copy one round's outputs to the host and fold them into the
        books."""
        host = packed.cpu().numpy()  # the round's one device-to-host copy
        n_max = self.cfg.n_max
        labels = host[:, :n_max]
        endpoints = host[:, n_max: 2 * n_max].view(np.float32)
        n_new, emitted, t_seen = (host[:, 2 * n_max + i] for i in range(3))
        if self.clock is not None:
            self.clock.mark("harvest")
            self.clock.collect()
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

    def close(self, stream_id: str) -> dict:
        """Flush the tail, emit the closing delta frame, free the slot.

        Returns ``{"out", "delta", "symbols", "n_pieces", "t_seen", ...}``
        where ``out`` is the ``symed_receive_finish`` dict (host numpy).
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
        if not (self.autoscale and self.capacity > 1):
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
        while self.autoscale and self.capacity > 1:
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

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--sessions", type=int, default=6,
                    help="simulated streams arriving at the service")
    ap.add_argument("--length", type=int, default=384)
    ap.add_argument("--window", type=int, default=48,
                    help="arrival window cap (ragged arrivals are padded)")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--evict", action="store_true",
                    help="LRU-evict when the slot table is full")
    ap.add_argument("--autoscale", action="store_true",
                    help="grow/shrink the slot table on a power-of-two ladder")
    ap.add_argument("--tol", type=float, default=0.5)
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    if args.sessions > args.max_slots and not args.evict:
        ap.error(f"--sessions {args.sessions} exceeds --max-slots "
                 f"{args.max_slots}; pass --evict to allow LRU eviction")

    cfg = SymEDConfig(tol=args.tol, alpha=args.alpha, n_max=256, k_max=32,
                      len_max=256)
    server = StreamServer(cfg, max_sessions=args.max_slots,
                          window_cap=args.window, evict_idle=args.evict,
                          autoscale=args.autoscale, seed=args.seed,
                          device=args.device)
    data = make_fleet(args.sessions, args.length, seed=args.seed)
    t0 = time.perf_counter()
    _round_robin(server, data, args.window)
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
    return rep


if __name__ == "__main__":
    main()
