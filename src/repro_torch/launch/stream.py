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

Sharded table (``mesh=``): the slots are held as ``mesh.devices.size``
contiguous blocks, block ``i`` on ``mesh.devices.flat[i]`` (the layout
``P("data")`` gives the reference's table).  Each round packs and stages
its arrivals per block and runs one table step per block; the blocks'
outputs are joined on the first device, so a round still makes one
device-to-host copy.  Every resize re-splits the table at the new
capacity, and live slots move between blocks unchanged.  One process
drives every block.

Slot lifecycle: ``open`` allocates a free slot (growing the table on the
autoscale ladder, or with ``evict_idle`` closing the least-recently-active
session, whose final output is parked in ``server.evicted``); ``close``
flushes the tail, emits the closing delta frame and frees the slot.

The flight recorder (``repro_torch.obs``, ``obs=``) times every round's
pack, dispatch and harvest on the host clock, records each symbol's
latency from its window's arrival to its delta frame
(``symed_symbol_latency_seconds``, the paper's 42 ms metric) and exposes
the totals as Prometheus series.

CLI (trace-driven, as the reference's: arrivals come from a
``repro_torch.workload`` trace -- ``--workload`` names a scenario or a
recorded ``workload_trace/v1`` jsonl, and the legacy ``--arrival-pattern``
values are deprecated shims that synthesize the equivalent trace):

    PYTHONPATH=src python -m repro_torch.launch.stream --sessions 6 \
        --max-slots 4 --length 384 --window 48 --workload bursty --evict \
        --verify --dtw-every 2 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
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
from repro_torch.obs import annotate, as_obs

__all__ = ["StreamServer", "PhaseClock", "main"]

# the shared inert context of an unannotated table step (stateless and
# reentrant, so one instance serves every round)
_NULL_ANN_CTX = contextlib.nullcontext()


def _null_annotation(name: str):
    return _NULL_ANN_CTX


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
      min_slots: the autoscale floor, the ladder's first rung (default: the
        mesh device count, else 1).
      use_kernel: run the Lloyd loops (every round's and each close's) in
        the CUDA k-means kernel (default: on when the table lives on CUDA).
      seed: base PRNG seed for per-session digitizer keys.
      device: where the table lives; ``cuda`` unless ``"cpu"`` is passed.
        Without CUDA, only ``device="cpu"`` works.  With a mesh, the mesh
        places the table; ``device``, if given, must name its devices'
        kind.
      mesh: optional 1-D ``(data,)`` mesh (``repro_torch.launch.mesh``);
        the slot table shards over it (``max_sessions``, ``min_slots`` and
        every ladder capacity must divide over the mesh devices).
      clock: a ``PhaseClock`` that times the phases of every round
        (optional): sender (raw in) or wire (compressed in), digitize,
        harvest.
      pretrace: at construction, step a blank table once raw in and once
        compressed in (zero valid points, no state kept) at every capacity
        on the autoscale ladder, so that no serving round is the first
        step at its capacity.  Eager PyTorch keeps no trace cache; what a
        first step pays is the caching allocator's growth to the new
        shapes.  ``symed_table_retraces_total`` counts the (mode,
        capacity) pairs first stepped after construction: 0 under
        ``pretrace``.
      obs: the flight recorder (``repro_torch.obs``).  ``None`` (default)
        makes a fresh enabled ``Observability``; ``False`` disables
        recording (shared null instruments); passing a bundle lets the
        transport front end share one registry, which admits one
        ``StreamServer`` (its totals-backed callback series are
        per-server).  Spans and latency stamps read the host clock, so
        recording adds no device sync: a round's syncs stay the digitize
        loops' tests and its one harvest copy.
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
        min_slots: Optional[int] = None,
        shrink_patience: int = 3,
        use_kernel: Optional[bool] = None,
        seed: int = 0,
        device=None,
        clock: Optional[PhaseClock] = None,
        pretrace: bool = False,
        mesh=None,
        obs=None,
    ):
        if max_sessions < 1:
            raise ValueError(f"max_sessions must be >= 1, got {max_sessions}")
        if window_cap < 1:
            raise ValueError(f"window_cap must be >= 1, got {window_cap}")
        if digitize_every_k < 0:
            raise ValueError(
                f"digitize_every_k must be >= 0, got {digitize_every_k}")
        if dtw_every < 0:
            raise ValueError(f"dtw_every must be >= 0, got {dtw_every}")
        if mesh is not None and max_sessions % mesh.devices.size:
            raise ValueError(
                f"max_sessions={max_sessions} must divide over the "
                f"{mesh.devices.size}-device mesh")
        if min_slots is None:
            min_slots = mesh.devices.size if mesh is not None else 1
        if not 1 <= min_slots <= max_sessions:
            raise ValueError(
                f"min_slots={min_slots} must be in [1, {max_sessions}]")
        if mesh is not None and min_slots % mesh.devices.size:
            raise ValueError(
                f"min_slots={min_slots} must divide over the "
                f"{mesh.devices.size}-device mesh")
        if shrink_patience < 1:
            raise ValueError(
                f"shrink_patience must be >= 1, got {shrink_patience}")
        if mesh is None:
            self.block_devices = [resolve_device(device)]
        else:
            self.block_devices = [torch.device(d) for d in mesh.devices.flat]
            if device is not None and (torch.device(device).type
                                       != self.block_devices[0].type):
                raise ValueError(
                    f"device={device!r} does not name the mesh's devices "
                    f"({self.block_devices[0].type})")
        self.device = self.block_devices[0]
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
        # the reference's keys exactly: a replay's fingerprint hashes them
        self.totals = {
            "points_in": 0, "bytes_in": 0.0, "symbols_out": 0,
            "frames_out": 0, "bytes_out": 0.0, "steps": 0,
            "opened": 0, "closed": 0, "evicted": 0,
            "grows": 0, "shrinks": 0,
        }
        # the DTW monitor's books (``dtw_seconds`` is wall time, so it stays
        # out of ``totals``); ``report()`` merges them
        self.monitor = {"dtw_readings": 0, "dtw_seconds": 0.0}
        self._blocks = self._split(self._blanks(self.capacity))
        self.obs = as_obs(obs)
        self._obs_on = self.obs.enabled
        self._annotate = (annotate if self.obs.torch_annotate
                          else _null_annotation)
        self._stepped: set = set()  # (mode, capacity) pairs stepped so far
        self._retraces = 0          # ... of them first stepped after init
        if pretrace:
            self._pretrace_ladder()
        self._register_metrics()

    def _register_metrics(self) -> None:
        """Wire the flight recorder to this server (the reference's series
        names and help strings).

        Histograms are recorded in the serving loop (integer bucket adds);
        everything already counted in ``self.totals`` is exposed as
        scrape-time callback series instead -- zero added hot-path work.
        """
        m = self.obs.metrics
        self._h_symbol_lat = m.histogram(
            "symed_symbol_latency_seconds",
            "per-symbol latency: window arrival to delta-frame emit "
            "(the paper's 42 ms metric)", unit="ns")
        self._h_tick = m.histogram(
            "symed_ingest_tick_seconds",
            "per-round ingest latency: pack + dispatch + harvest", unit="ns")
        if not self._obs_on:
            return
        t = self.totals
        for key, name, help_text in (
            ("points_in", "symed_points_in_total", "raw points ingested"),
            ("bytes_in", "symed_wire_in_bytes_total", "inbound wire bytes"),
            ("symbols_out", "symed_symbols_out_total", "symbols emitted"),
            ("frames_out", "symed_frames_out_total", "delta frames emitted"),
            ("bytes_out", "symed_wire_out_bytes_total", "outbound wire bytes"),
            ("steps", "symed_batched_steps_total", "donated table steps run"),
            ("opened", "symed_sessions_opened_total", "sessions opened"),
            ("closed", "symed_sessions_closed_total", "sessions closed"),
            ("evicted", "symed_sessions_evicted_total", "sessions LRU-evicted"),
            ("grows", "symed_table_grows_total", "autoscale ladder grows"),
            ("shrinks", "symed_table_shrinks_total", "autoscale ladder shrinks"),
        ):
            m.counter_fn(name, help_text, (lambda k=key: float(t[k])))
        m.gauge_fn("symed_active_sessions", "open sessions",
                   lambda: float(len(self._sessions)))
        m.gauge_fn("symed_table_capacity", "slot-table capacity",
                   lambda: float(self.capacity))
        m.counter_fn("symed_table_retraces_total",
                     "batched-step compiles observed since server init",
                     lambda: float(self._retraces))

    def _pretrace_ladder(self) -> None:
        """Step a blank table once raw in and once compressed in, with zero
        valid points, at every capacity the table can take (block by block,
        as the table is split at that capacity); the blank tables are
        dropped, so no state is left behind."""
        t0 = time.perf_counter_ns()
        ladder = self._ladder if self.autoscale else [self.capacity]
        kw = dict(digitize_every_k=self.digitize_every_k,
                  use_kernel=self.use_kernel)
        for cap in ladder:
            for block in self._split(self._blanks(cap)):
                n, dev = block.t0.shape[0], block.t0.device
                win_f = torch.zeros((n, self.window_cap), dtype=torch.float32,
                                    device=dev)
                win_i = torch.zeros((n, self.window_cap), dtype=torch.int32,
                                    device=dev)
                cnt = torch.zeros((n,), dtype=torch.int32, device=dev)
                hello = torch.zeros((n,), dtype=torch.float32, device=dev)
                block, _ = symed_receive_masked_chunk_table(
                    win_f, cnt, self.cfg, block, **kw)
                symed_receive_masked_pieces_table(
                    win_f, win_i, cnt, hello, cnt, self.cfg, block, **kw)
            self._stepped.update({("", cap), ("_pieces", cap)})
        self.obs.tracer.add("stream.pretrace", t0, {"capacities": ladder})

    def _note_step(self, mode: str) -> None:
        """Count a (mode, capacity) pair's first step after construction,
        and mark it on the timeline (a step ``pretrace`` did not cover)."""
        if (mode, self.capacity) in self._stepped:
            return
        self._stepped.add((mode, self.capacity))
        self._retraces += 1
        self.obs.tracer.instant("stream.retrace", {"capacity": self.capacity})

    def _blanks(self, n: int):
        """``n`` fresh blank slots (keys are placeholders; ``open`` reseeds)."""
        return receiver_init(self.cfg, prng.split(self._base_key, n))

    def _split(self, table):
        """A whole table as its blocks: block ``i`` holds the ``i``-th
        contiguous run of ``capacity / n_blocks`` slots, on device ``i``."""
        n = table.t0.shape[0] // len(self.block_devices)
        return [_map(lambda l: l[i * n: (i + 1) * n].to(dev), table)
                for i, dev in enumerate(self.block_devices)]

    @property
    def _table(self):
        """The whole slot table, its blocks joined on the first device."""
        return self._gather(list(range(self.capacity)))

    def _locate(self, slot: int):
        """``(block, slot within the block)`` of a table slot."""
        return divmod(slot, self.capacity // len(self._blocks))

    def _gather(self, slots: List[int]):
        """The states of ``slots``, in that order, on the first device: one
        gather per block that holds any of them."""
        parts, order = [], []
        for b, block in enumerate(self._blocks):
            rows = [i for i, s in enumerate(slots) if self._locate(s)[0] == b]
            if not rows:
                continue
            idx = torch.tensor([self._locate(slots[i])[1] for i in rows],
                               dtype=torch.long, device=block.t0.device)
            parts.append(_map(lambda l: l.index_select(0, idx).to(
                self.device), block))
            order += rows
        if len(parts) == 1:
            joined = parts[0]
        else:
            joined = _map(lambda *ls: torch.cat(ls), *parts)
        if order == sorted(order):
            return joined
        inv = torch.tensor(np.argsort(order), dtype=torch.long,
                           device=self.device)
        return _map(lambda l: l.index_select(0, inv), joined)

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
            self.obs.tracer.instant("stream.evict", {"session": lru.stream_id})
            self.evicted[lru.stream_id] = self.close(lru.stream_id)
            self.totals["evicted"] += 1
            self.totals["closed"] -= 1  # eviction is not a clean close
        slot = self._free.pop()
        self._serial += 1
        if key is None:
            key = prng.fold_in(self._base_key, self._serial)
        b, local = self._locate(slot)
        dev = self.block_devices[b]
        blank = receiver_init(self.cfg, prng.as_key(key, dev))
        at = torch.tensor([local], dtype=torch.long, device=dev)
        self._blocks[b] = _map(lambda l, x: l.index_copy(0, at, x[None]),
                               self._blocks[b], blank)
        self._sessions[stream_id] = _Session(
            stream_id=stream_id, slot=slot, last_active=self._clock,
            raw=[] if self.dtw_every else None)
        self.totals["opened"] += 1
        self.totals["bytes_in"] += 4.0  # the t0 "hello" payload
        return slot

    def ingest(self, stream_id: str, window) -> dict:
        """Feed one ragged arrival; returns its symbol-delta frame."""
        return self.ingest_many({stream_id: window})[stream_id]

    def ingest_many(self, arrivals: Dict[str, object]) -> Dict[str, dict]:  # symlint-torch: hot-path; symlint-torch: entry(drive=stream, budget=2, cpu_budget=2)
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

    def _run_rounds(self, sids, rounds, pack_round, dispatch, harvest,  # symlint-torch: hot-path
                    mode=""):
        """Run ``rounds`` table steps, double-buffered: round ``r`` is
        dispatched, round ``r+1`` is packed on the host, and only then are
        round ``r``'s outputs copied to the host, in one transfer.
        ``pack_round(r)`` gives the round's ``(active, host arrays)``,
        ``dispatch(*host arrays)`` its packed outputs, and ``harvest``
        folds the copied outputs into the per-stream deltas (which are
        returned) and gives the round's new symbols.  ``mode`` ("" raw in,
        "_pieces" compressed in) suffixes the spans' names.

        The round's arrival stamp (the host clock when its packing starts)
        rides with it, so the latency histograms measure arrival to
        delta-frame emit across the double buffer."""
        deltas = {sid: _new_delta() for sid in sids}
        obs_on = self._obs_on
        tracer = self.obs.tracer
        pend = None  # (active, packed outputs, clock, arrival) in flight
        for r in range(rounds):
            t_arrive = time.perf_counter_ns() if obs_on else 0
            active, host = pack_round(r)
            flight = None
            if active:
                if obs_on:
                    tracer.add("stream.pack" + mode, t_arrive,
                               {"round": r, "sessions": len(active)})
                self._note_step(mode)
                t_disp = time.perf_counter_ns() if obs_on else 0
                with self._annotate("symed.table_step" + mode):
                    packed = dispatch(*host)
                if obs_on:
                    tracer.add("stream.dispatch" + mode, t_disp)
                flight = (active, packed, self._clock, t_arrive)
            # harvest the previous round only after this one is in flight
            if pend is not None:
                self._harvest_flight(pend, harvest, deltas, mode)
            pend = flight
        if pend is not None:
            self._harvest_flight(pend, harvest, deltas, mode)
        return deltas

    def _harvest_flight(self, flight, harvest, deltas, mode) -> None:  # symlint-torch: hot-path
        """Copy one round's outputs to the host and fold them in; the
        latency is taken right after the copy."""
        active, packed, clock, t_arrive = flight
        obs_on = self._obs_on
        t_h = time.perf_counter_ns() if obs_on else 0
        outs = self._unpack(packed)
        lat = (time.perf_counter_ns() - t_arrive) if obs_on else 0
        n_new = harvest(active, outs, clock, deltas)
        if obs_on:
            self._h_symbol_lat.observe_n(lat, n_new)
            self._h_tick.observe(lat)
            self.obs.tracer.add("stream.harvest" + mode, t_h,
                                {"sessions": len(active)})

    def _dispatch(self, padded: np.ndarray, n_valid: np.ndarray):
        """Run one raw-in table step, one per block; returns its outputs
        packed for one host transfer (``_pack``)."""
        return self._step_blocks(symed_receive_masked_chunk_table,
                                 (padded, n_valid))

    def _dispatch_pieces(self, *host_args: np.ndarray):
        """Run one compressed-in table step, one per block, on the padded
        ``(endpoints, steps, n_valid, hello, t_seen)``; returns its outputs
        packed for one host transfer (``_pack``)."""
        return self._step_blocks(symed_receive_masked_pieces_table,
                                 host_args)

    def _step_blocks(self, block_step, host_args):  # symlint-torch: hot-path; symlint-torch: entry(drive=stream, budget=87, cpu_budget=195, shapes=table-step)
        """Stage each block's rows of the host arrays on its device, run
        ``block_step`` on the block, and join the blocks' packed outputs on
        the first device."""
        n = self.capacity // len(self._blocks)
        packed = []
        for i, dev in enumerate(self.block_devices):
            args = [torch.from_numpy(a[i * n: (i + 1) * n]).to(dev)
                    for a in host_args]
            if self.clock is not None:
                self.clock.start()
            self._blocks[i], info = block_step(
                *args, self.cfg, self._blocks[i],
                digitize_every_k=self.digitize_every_k,
                use_kernel=self.use_kernel,
                mark=self.clock.mark if self.clock is not None else None)
            packed.append(self._pack(info).to(self.device))
        self.totals["steps"] += 1
        self._clock += 1
        return packed[0] if len(packed) == 1 else torch.cat(packed)

    def _pack(self, info):
        """A table step's outputs in one int32 device tensor (``labels |
        endpoints bits | n_new | emitted | t_seen`` per slot)."""
        d = info["symbol_delta"]
        return torch.cat([
            d["labels"], d["endpoints"].view(torch.int32),
            d["n_new"][:, None], d["emitted"].to(torch.int32)[:, None],
            info["t_seen"][:, None]], dim=1)

    def _unpack(self, packed: torch.Tensor):  # symlint-torch: hot-path
        """Copy one round's packed outputs to the host (the round's one
        device-to-host copy): ``(labels, endpoints, n_new, emitted,
        t_seen)`` per slot."""
        host = packed.cpu().numpy()  # sync: ok
        n_max = self.cfg.n_max
        if self.clock is not None:
            self.clock.mark("harvest")
            self.clock.collect()
        return (host[:, :n_max], host[:, n_max: 2 * n_max].view(np.float32),
                *(host[:, 2 * n_max + i] for i in range(3)))

    def _harvest_round(self, active, outs, clock, deltas) -> int:  # symlint-torch: hot-path
        """Fold one raw-in round's outputs into the books; returns its new
        symbols."""
        labels, endpoints, n_new, emitted, t_seen = outs
        total = 0
        for sid, part in active:
            sess = self._sessions[sid]
            n = int(n_new[sess.slot])
            total += n
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
        return total

    def ingest_pieces_many(self, arrivals: Dict[str, dict]) -> Dict[str, dict]:  # symlint-torch: hot-path; symlint-torch: entry(drive=stream, budget=2, cpu_budget=2)
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
                                  self._harvest_pieces_round, "_pieces")
        return _finalize_deltas(deltas)

    def _harvest_pieces_round(self, active, outs, clock, deltas) -> int:  # symlint-torch: hot-path
        """Fold one compressed-in round's outputs into the books: a round
        counts as a window where it carried pieces, and ``points_in``
        follows the senders' clocks.  Returns the round's new symbols."""
        labels, endpoints, n_new, emitted, t_seen = outs
        total = 0
        for sid, n_in in active:
            sess = self._sessions[sid]
            n = int(n_new[sess.slot])
            total += n
            self._account_delta(sess, deltas[sid], labels[sess.slot],
                                endpoints[sess.slot], n,
                                bool(emitted[sess.slot]))
            if n_in:
                sess.chunks += 1
            now_seen = int(t_seen[sess.slot])
            self.totals["points_in"] += max(now_seen - sess.t_seen, 0)
            sess.t_seen = now_seen
            sess.last_active = clock
        return total

    def close(self, stream_id: str) -> dict:  # symlint-torch: hot-path; symlint-torch: entry(drive=stream, budget=80, cpu_budget=94)
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
            sub = _map(lambda l: l[0], self._gather([sess.slot]))
            res = symed_receive_finish(sub, self.cfg, with_delta=True,
                                       use_kernel=self.use_kernel)
            out = {k: v.cpu().numpy() for k, v in res.items()  # sync: ok
                   if k != "symbol_delta"}
            d = out["symbol_delta"] = {
                k: v.cpu().numpy()  # sync: ok
                for k, v in res["symbol_delta"].items()}
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

    def report(self, wall_seconds: float) -> Dict[str, object]:
        """Host-side service summary: the totals, the DTW monitor's books
        and rates, all floats; with the recorder on, ``"obs"`` holds its
        snapshot (counters, gauges, histogram digests with p50/p99/p999)."""
        t = {k: float(v) for k, v in self.totals.items()}
        dt = max(wall_seconds, 1e-9)
        raw_bytes = 4.0 * t["points_in"]
        rep: Dict[str, object] = {
            **t,
            **{k: float(v) for k, v in self.monitor.items()},
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
        if self._obs_on:
            rep["obs"] = self.obs.snapshot()
        return rep

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
        grown = _map(lambda l, b: torch.cat([l.to(self.device), b], dim=0),
                     self._table, self._blanks(new_cap - self.capacity))
        self._blocks = self._split(grown)
        self._free.extend(range(self.capacity, new_cap))
        self.capacity = new_cap
        self.totals["grows"] += 1
        self.obs.tracer.instant("stream.grow", {"capacity": new_cap})

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
            self._blocks = self._split(self._gather(perm))
            for new_slot, sess in enumerate(live):
                sess.slot = new_slot
            self._free = list(range(len(live), target))
            self.capacity = target
            self.totals["shrinks"] += 1
            self.obs.tracer.instant("stream.shrink", {"capacity": target})

    def _run_dtw_monitor(self) -> None:  # symlint-torch: hot-path
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
        t_start = time.perf_counter_ns()
        t = self._gather([s.slot for s in due])
        endpoints, steps, n_pieces, t0 = (t.endpoints, t.steps, t.n_pieces,
                                          t.t0)
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
        for sess, val in zip(due, readings.cpu().tolist()):  # sync: ok
            sess.dtw = val
        self.monitor["dtw_readings"] += len(due)
        self.monitor["dtw_seconds"] += 1e-9 * (time.perf_counter_ns() - t_start)
        self.obs.tracer.add("stream.dtw_monitor", t_start,
                            {"sessions": len(due)})


# ----------------------------------------------------------------- CLI


def validate_cli_args(ap: argparse.ArgumentParser, args) -> None:
    """Fail fast (exit 2) before any torch work, with the reference's checks
    and messages."""
    from repro_torch.launch.cli import validate_shared_args

    validate_shared_args(ap, args)
    if args.dtw_every < 0:
        ap.error(f"--dtw-every must be >= 0, got {args.dtw_every}")
    if args.sessions > args.max_slots and not args.evict \
            and args.workload is None:
        ap.error(f"--sessions {args.sessions} exceeds --max-slots "
                 f"{args.max_slots}; pass --evict to allow LRU eviction")
    if args.workload is not None and args.arrival_pattern is not None:
        ap.error("--workload and --arrival-pattern are mutually exclusive")


def _build_workload(args):
    """Resolve the CLI's arrival flags into a ``repro_torch.workload`` trace.

    Precedence: ``--workload FILE.jsonl`` (recorded trace) >
    ``--workload SCENARIO`` (synthesized with the CLI's shape knobs) >
    ``--arrival-pattern`` (deprecated shim) > silent ``roundrobin``.
    """
    from repro_torch.workload import SCENARIOS, Trace, Workload, scenario_seed

    if args.workload is not None and args.workload not in SCENARIOS:
        return Trace.load(args.workload)  # recorded workload_trace/v1 jsonl
    if args.workload is not None:
        wl = Workload(args.workload,
                      seed=scenario_seed(args.workload, args.seed),
                      sessions=args.sessions, length=args.length,
                      window=args.window)
        return wl.trace()
    pattern = args.arrival_pattern
    wl = Workload.from_pattern(
        pattern if pattern is not None else "roundrobin",
        sessions=args.sessions, length=args.length, window=args.window,
        seed=args.seed, _warn=pattern is not None)
    return wl.trace()


def main(argv=None):
    from repro_torch.launch.cli import (
        add_devices_arg, add_metrics_args, add_slot_table_args,
        add_symed_args)
    from repro_torch.launch.fleet import fleet_data_mesh
    from repro_torch.launch.mesh import describe_devices
    from repro_torch.obs import Observability
    from repro_torch.obs.export import start_exporter
    from repro_torch.workload import replay_trace

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--sessions", type=int, default=6,
                    help="simulated streams arriving at the service")
    ap.add_argument("--length", type=int, default=384)
    ap.add_argument("--window", type=int, default=48,
                    help="arrival window cap (ragged arrivals are padded)")
    ap.add_argument("--workload", default=None, metavar="NAME|FILE",
                    help="arrival trace: a repro_torch.workload scenario "
                         "name or a recorded workload_trace/v1 jsonl "
                         "(default: roundrobin)")
    ap.add_argument("--arrival-pattern", default=None,
                    choices=("roundrobin", "random", "bursty"),
                    help="(deprecated: use --workload) legacy arrival shim")
    ap.add_argument("--dtw-every", type=int, default=0,
                    help="online DTW monitor cadence in windows (0: off)")
    ap.add_argument("--verify", action="store_true",
                    help="check delta concatenation against symed_encode "
                         "(endpoints bitwise; every symbol on the CPU, 99%% "
                         "on cuda)")
    add_slot_table_args(ap)
    add_devices_arg(
        ap, help="table shards: host shards with --device cpu, round-robin "
                 "over the cards with cuda; >1 shards the slot table")
    add_symed_args(ap)
    add_metrics_args(ap)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    validate_cli_args(ap, args)

    trace = _build_workload(args)
    window_cap = trace.window  # a recorded trace carries its own shape
    cfg = SymEDConfig(tol=args.tol, alpha=args.alpha, n_max=256, k_max=32,
                      len_max=256)
    mesh = (fleet_data_mesh(args.devices, device=args.device)
            if args.devices > 1 else None)
    obs = Observability(trace_capacity=65536)
    server = StreamServer(
        cfg, max_sessions=args.max_slots, window_cap=window_cap,
        digitize_every_k=args.digitize_every, dtw_every=args.dtw_every,
        evict_idle=args.evict, autoscale=args.autoscale,
        min_slots=args.min_slots, shrink_patience=args.shrink_patience,
        seed=args.seed, pretrace=args.pretrace, mesh=mesh, obs=obs,
        device=args.device)
    exporter = start_exporter(obs, args.metrics_port)
    if exporter is not None:
        print(f"metrics exporter        : {exporter.url}/metrics")

    res = replay_trace(trace, cfg=cfg, server=server, verify=args.verify)

    rep = server.report(res.wall_seconds)
    print(f"devices / table shards  : {args.devices}")
    print(f"shard devices           : "
          f"{describe_devices(server.block_devices)} "
          f"(k-means kernel {'on' if server.use_kernel else 'off'})")
    print(f"slot table              : {args.max_slots} slots"
          f"{' (autoscaled)' if args.autoscale else ''}, "
          f"window cap {window_cap}, workload {trace.name}")
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
    print(f"symbol latency          : {rep['ms_per_symbol']:.3f} ms/symbol "
          f"(paper: 42ms single-CPU)")
    if args.dtw_every:
        vals = [s["dtw"] for s in res.sessions.values()
                if s["dtw"] is not None]
        if vals:
            print(f"online DTW monitor      : mean {np.mean(vals):.3f} "
                  f"over {len(vals)} sessions")
    if args.verify:
        # replay_trace(verify=True) raised on any session that failed
        # transport.check_deltas
        print(f"delta equivalence       : OK ({res.verified} sessions)")

    # flight-recorder summary (stable key=value line, like stream_summary)
    snap = obs.snapshot()
    lat = snap["histograms"].get("symed_symbol_latency_seconds", {})
    print("obs_summary "
          f"symbol_p50_ms={1e3 * lat.get('p50', 0.0):.3f} "
          f"symbol_p99_ms={1e3 * lat.get('p99', 0.0):.3f} "
          f"symbol_p999_ms={1e3 * lat.get('p999', 0.0):.3f} "
          f"symbols={int(lat.get('count', 0))} "
          f"spans={int(snap['spans_recorded'])}")
    if args.trace_out:
        obs.tracer.write(args.trace_out)
        print(f"trace written           : {args.trace_out} "
              f"({obs.tracer.recorded} events, load at ui.perfetto.dev)")
    if exporter is not None:
        if args.metrics_linger:
            print(f"metrics exporter        : lingering "
                  f"{args.metrics_linger:.0f}s for scrapes", flush=True)
            time.sleep(args.metrics_linger)
        exporter.close()
    rep["fingerprint"] = res.fingerprint()
    return rep


if __name__ == "__main__":
    main()
