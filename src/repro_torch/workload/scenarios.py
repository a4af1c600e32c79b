"""Seeded trace synthesizers: the workload scenario zoo.

A copy of ``repro.workload.scenarios``: the same seed gives the same
trace, digest for digest.

Every synthesizer is a pure function of its keyword parameters -- a fresh
``np.random.default_rng(seed)`` per call, no module state -- so synthesis
order can never change a trace (``scenario_seed`` derives independent
per-scenario seeds from one base, the same crc32 mix the transport uses
for per-session digitizer seeds).

The zoo (``SCENARIOS``):

    ``diurnal``        sinusoidal arrival intensity (day/night load)
    ``flash_crowd``    a quiet baseline fleet, then a cohort arriving at once
    ``dropout_churn``  sensors dropping mid-stream and reconnecting as new
                       sessions that resume the same source row
    ``mixed_fleet``    raw-mode and pieces-mode senders sharing one table
    ``slot_churn``     adversarial short-lived session waves sized past the
                       slot table, forcing autoscale thrash + LRU eviction

plus the three legacy ``--arrival-pattern`` shapes (``roundrobin``,
``random``, ``bursty``) as shims: :func:`legacy_arrival_schedule` is the
verbatim port of ``launch.stream._arrival_schedule``, so a legacy trace's
``schedule()`` is tick-for-tick what the retired generator yielded for the
same seed (pinned by the shim-equivalence battery).
"""
from __future__ import annotations

import dataclasses
import warnings
import zlib
from typing import Callable, Dict, Mapping, Optional

import numpy as np

from repro_torch.workload.trace import TICK_MS, Trace, TraceBuilder

__all__ = [
    "Scenario", "SCENARIOS", "Workload", "scenario_seed", "synthesize",
    "legacy_arrival_schedule",
]


def scenario_seed(name: str, base_seed: int = 0) -> int:
    """Deterministic per-scenario seed (same mix as transport sessions)."""
    return (zlib.crc32(name.encode("utf-8")) ^ base_seed) & 0xFFFFFFFF


# ------------------------------------------------------------ legacy shims


def legacy_arrival_schedule(pattern: str, n_sessions: int, n_windows: int,
                            rng):
    """Yield per-tick lists of (session index, window index) arrivals.

    Verbatim port of the retired ``launch.stream._arrival_schedule`` --
    the rng call sequence is the contract (same seed => same schedule), so
    this function must not be "improved".
    """
    cursors = [0] * n_sessions
    if pattern == "roundrobin":
        while any(c < n_windows for c in cursors):
            tick = [(s, cursors[s]) for s in range(n_sessions)
                    if cursors[s] < n_windows]
            for s, _ in tick:
                cursors[s] += 1
            yield tick
    elif pattern == "random":
        while any(c < n_windows for c in cursors):
            live = [s for s in range(n_sessions) if cursors[s] < n_windows]
            pick = [s for s in live if rng.random() < 0.6] or live[:1]
            tick = [(s, cursors[s]) for s in pick]
            for s, _ in tick:
                cursors[s] += 1
            yield tick
    elif pattern == "bursty":
        s = 0
        while any(c < n_windows for c in cursors):
            live = [i for i in range(n_sessions) if cursors[i] < n_windows]
            s = live[s % len(live)]
            burst = min(int(rng.integers(1, 4)), n_windows - cursors[s])
            for _ in range(burst):
                yield [(s, cursors[s])]
                cursors[s] += 1
            s += 1
    else:
        raise ValueError(f"unknown arrival pattern {pattern!r}")


def _synth_legacy(pattern: str):
    def synth(*, sessions: int, length: int, window: int, seed: int,
              tick_ms: int = TICK_MS) -> Trace:
        rng = np.random.default_rng(seed)
        n_windows = -(-length // window)
        b = TraceBuilder(pattern, seed, sessions, length, window)
        opened: set = set()
        for t, tick in enumerate(legacy_arrival_schedule(
                pattern, sessions, n_windows, rng)):
            t_ms = t * tick_ms
            for s, w in tick:
                sid = f"stream-{s}"
                if s not in opened:
                    b.open(t_ms, sid, s)
                    opened.add(s)
                b.data(t_ms, sid, w)
                if w == n_windows - 1:
                    b.close(t_ms, sid)
        return b.build()
    return synth


# ------------------------------------------------------------ scenario zoo


def _synth_diurnal(*, sessions: int, length: int, window: int, seed: int,
                   tick_ms: int = TICK_MS, period: int = 16,
                   floor: float = 0.15) -> Trace:
    """Sinusoidal arrival intensity: every stream delivers its next window
    with a probability that swings from ``floor`` (night) toward 1 (noon)."""
    rng = np.random.default_rng(seed)
    n_windows = -(-length // window)
    b = TraceBuilder("diurnal", seed, sessions, length, window)
    cursors = [0] * sessions
    t = 0
    while any(c < n_windows for c in cursors):
        phase = 0.5 - 0.5 * np.cos(2.0 * np.pi * t / period)
        p = floor + (1.0 - floor) * phase
        t_ms = t * tick_ms
        if t < sessions:  # staggered dawn arrival for stream t
            b.open(t_ms, f"stream-{t}", t)
        for s in range(sessions):
            if cursors[s] >= n_windows or t < s:  # not yet dawned
                continue
            if rng.random() < p or t > 50 * n_windows:  # force-drain tail
                sid = f"stream-{s}"
                b.data(t_ms, sid, cursors[s])
                cursors[s] += 1
                if cursors[s] == n_windows:
                    b.close(t_ms, sid)
        t += 1
    return b.build()


def _synth_flash_crowd(*, sessions: int, length: int, window: int, seed: int,
                       tick_ms: int = TICK_MS, baseline: Optional[int] = None,
                       spike_tick: int = 6) -> Trace:
    """A small steady fleet, then the rest of the crowd lands in one tick."""
    rng = np.random.default_rng(seed)
    n_windows = -(-length // window)
    base = max(1, sessions // 4) if baseline is None else baseline
    base = min(base, sessions)
    b = TraceBuilder("flash_crowd", seed, sessions, length, window)
    cursors = [0] * sessions
    started = [0 if s < base else None for s in range(sessions)]
    for s in range(base):
        b.open(0, f"stream-{s}", s)
    t = 0
    while any(c < n_windows for c in cursors):
        t_ms = t * tick_ms
        if t == spike_tick:
            # arrival order inside the spike is part of the workload: a
            # seeded shuffle, not index order
            for s in rng.permutation(np.arange(base, sessions)):
                b.open(t_ms, f"stream-{int(s)}", int(s))
                started[int(s)] = t
        for s in range(sessions):
            if started[s] is None or t < started[s]:
                continue
            if cursors[s] >= n_windows:
                continue
            sid = f"stream-{s}"
            b.data(t_ms, sid, cursors[s])
            cursors[s] += 1
            if cursors[s] == n_windows:
                b.close(t_ms, sid)
        t += 1
    return b.build()


def _synth_dropout_churn(*, sessions: int, length: int, window: int,
                         seed: int, tick_ms: int = TICK_MS,
                         p_drop: float = 0.12) -> Trace:
    """Sensors drop mid-stream and reconnect: the source row resumes under
    a fresh session id after a seeded silence gap (the paper's flaky edge
    links, exercised against slot reuse)."""
    rng = np.random.default_rng(seed)
    n_windows = -(-length // window)
    b = TraceBuilder("dropout_churn", seed, sessions, length, window)
    cursors = [0] * sessions
    gen = [0] * sessions          # reconnect generation per stream
    silent_until = [0] * sessions
    live = [False] * sessions

    def sid_of(s):
        return f"stream-{s}" if gen[s] == 0 else f"stream-{s}-r{gen[s]}"

    t = 0
    while any(c < n_windows for c in cursors):
        t_ms = t * tick_ms
        for s in range(sessions):
            if cursors[s] >= n_windows or t < silent_until[s]:
                continue
            if not live[s]:
                b.open(t_ms, sid_of(s), s)
                live[s] = True
            b.data(t_ms, sid_of(s), cursors[s])
            cursors[s] += 1
            if cursors[s] == n_windows:
                b.close(t_ms, sid_of(s))
                live[s] = False
            elif rng.random() < p_drop:  # drop mid-stream
                b.close(t_ms, sid_of(s))
                live[s] = False
                gen[s] += 1
                silent_until[s] = t + 1 + int(rng.integers(1, 5))
        t += 1
    return b.build()


def _synth_mixed_fleet(*, sessions: int, length: int, window: int, seed: int,
                       tick_ms: int = TICK_MS) -> Trace:
    """Raw-in and compressed-in senders interleaving on one slot table
    (even rows raw, odd rows pieces), staggered opens, round-robin data."""
    n_windows = -(-length // window)
    b = TraceBuilder("mixed_fleet", seed, sessions, length, window)
    cursors = [0] * sessions
    t = 0
    while any(c < n_windows for c in cursors):
        t_ms = t * tick_ms
        for s in range(sessions):  # stream s dawns at tick min(s, 3)
            if min(s, 3) == t:
                b.open(t_ms, f"stream-{s}", s,
                       mode="raw" if s % 2 == 0 else "pieces")
        for s in range(sessions):
            if cursors[s] >= n_windows or t < min(s, 3):
                continue
            sid = f"stream-{s}"
            b.data(t_ms, sid, cursors[s])
            cursors[s] += 1
            if cursors[s] == n_windows:
                b.close(t_ms, sid)
        t += 1
    return b.build()


def _synth_slot_churn(*, sessions: int, length: int, window: int, seed: int,
                      tick_ms: int = TICK_MS, phases: int = 3,
                      gap_ticks: int = 4) -> Trace:
    """Adversarial autoscale thrash: ``phases`` waves of ``sessions``
    short-lived sessions land nearly at once (sized past the slot table, so
    LRU eviction fires), separated by quiet gaps where only one background
    session trickles -- the table must grow, shrink, and regrow.
    """
    rng = np.random.default_rng(seed)
    short_windows = 2
    n_streams = phases * sessions + 1
    bg_row = n_streams - 1
    n_windows = -(-length // window)
    b = TraceBuilder("slot_churn", seed, n_streams, length, window)
    b.open(0, "bg", bg_row)
    bg_cursor = 0
    t = 0

    def bg_tick(t_ms):
        nonlocal bg_cursor
        if bg_cursor < n_windows:
            b.data(t_ms, "bg", bg_cursor)
            bg_cursor += 1
            if bg_cursor == n_windows:
                b.close(t_ms, "bg")

    for phase in range(phases):
        # the wave: all of this phase's sessions open in one tick, in a
        # seeded shuffle, then deliver a couple of windows and leave
        order = rng.permutation(np.arange(sessions))
        t_ms = t * tick_ms
        for i in order:
            b.open(t_ms, f"p{phase}s{int(i)}", phase * sessions + int(i))
        for w in range(short_windows):
            t_ms = t * tick_ms
            bg_tick(t_ms)
            for i in range(sessions):
                b.data(t_ms, f"p{phase}s{i}", w)
            t += 1
        t_ms = (t - 1) * tick_ms
        for i in range(sessions):
            b.close(t_ms, f"p{phase}s{i}")
        for _ in range(gap_ticks):  # quiet: occupancy collapses to bg
            bg_tick(t * tick_ms)
            t += 1
    while bg_cursor < n_windows:
        bg_tick(t * tick_ms)
        t += 1
    return b.build()


# --------------------------------------------------------------- registry


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named synthesizer plus the server shape and SLOs it is scored
    against.  ``defaults`` feed the synthesizer; ``server_kw`` feed
    ``StreamServer``; ``slos`` are the default thresholds
    (``repro_torch.workload.slo``) a replay of this scenario must meet."""
    name: str
    synth: Callable[..., Trace]
    description: str
    defaults: Mapping[str, object]
    server_kw: Mapping[str, object]
    slos: Mapping[str, float]
    legacy: bool = False


_COMMON_SLOS = {
    "p99_symbol_ms": 2000.0,   # generous: shared CI runners, cold caches
    "max_queue_depth": 64.0,
    "evict_rate": 0.0,
}

SCENARIOS: Dict[str, Scenario] = {}


def _register(sc: Scenario) -> None:
    SCENARIOS[sc.name] = sc


_register(Scenario(
    "diurnal", _synth_diurnal,
    "sinusoidal day/night arrival intensity over a steady fleet",
    defaults=dict(sessions=8, length=192, window=32),
    server_kw=dict(max_sessions=8, pretrace=True),
    slos=dict(_COMMON_SLOS),
))
_register(Scenario(
    "flash_crowd", _synth_flash_crowd,
    "quiet baseline fleet, then a cohort lands in one tick (autoscale up)",
    defaults=dict(sessions=12, length=192, window=32),
    server_kw=dict(max_sessions=16, min_slots=4, autoscale=True,
                   shrink_patience=2, pretrace=True),
    slos=dict(_COMMON_SLOS),
))
_register(Scenario(
    "dropout_churn", _synth_dropout_churn,
    "sensors drop mid-stream and reconnect as fresh sessions (slot reuse)",
    defaults=dict(sessions=6, length=192, window=32),
    server_kw=dict(max_sessions=8, pretrace=True),
    slos=dict(_COMMON_SLOS),
))
_register(Scenario(
    "mixed_fleet", _synth_mixed_fleet,
    "raw-mode and pieces-mode senders sharing one slot table",
    defaults=dict(sessions=8, length=192, window=32),
    server_kw=dict(max_sessions=8, pretrace=True),
    slos=dict(_COMMON_SLOS),
))
_register(Scenario(
    "slot_churn", _synth_slot_churn,
    "short-lived session waves sized past the table: autoscale thrash + "
    "LRU eviction",
    defaults=dict(sessions=6, length=192, window=32),
    server_kw=dict(max_sessions=4, min_slots=1, autoscale=True,
                   evict_idle=True, shrink_patience=1, pretrace=True),
    slos={**_COMMON_SLOS, "evict_rate": 0.6},
))
for _pattern in ("roundrobin", "random", "bursty"):
    _register(Scenario(
        _pattern, _synth_legacy(_pattern),
        f"legacy --arrival-pattern {_pattern} shim",
        defaults=dict(sessions=6, length=384, window=48),
        server_kw=dict(max_sessions=8, pretrace=True),
        slos=dict(_COMMON_SLOS),
        legacy=True,
    ))


def synthesize(name: str, *, seed: int, **overrides) -> Trace:
    """Build ``name``'s trace with ``seed`` and parameter ``overrides``.

    The seed is explicit on purpose -- callers thread
    ``scenario_seed(name, base)`` (or their own) so no shared rng state can
    couple rows (the fleet_scale reorder-invariance pin).
    """
    sc = SCENARIOS.get(name)
    if sc is None:
        raise ValueError(
            f"unknown scenario {name!r} (have: {', '.join(sorted(SCENARIOS))})")
    params = {**sc.defaults, **overrides}
    return sc.synth(seed=seed, **params)


class Workload:
    """A scenario bound to its parameters: the first-class load object.

    ``Workload("flash_crowd").trace()`` synthesizes the trace;
    ``server_kw()`` / ``slos()`` expose the scenario's replay defaults with
    any construction-time overrides merged in.  The legacy
    ``--arrival-pattern`` values construct through :meth:`from_pattern`,
    which is the deprecation seam.
    """

    def __init__(self, scenario: str, *, seed: Optional[int] = None,
                 server_kw: Optional[dict] = None,
                 slos: Optional[dict] = None, **params):
        if scenario not in SCENARIOS:
            raise ValueError(
                f"unknown scenario {scenario!r} "
                f"(have: {', '.join(sorted(SCENARIOS))})")
        self.scenario = SCENARIOS[scenario]
        self.name = scenario
        self.seed = scenario_seed(scenario) if seed is None else int(seed)
        self.params = params
        self._server_kw = dict(server_kw or {})
        self._slos = dict(slos or {})

    @classmethod
    def from_pattern(cls, pattern: str, *, sessions: int, length: int,
                     window: int, seed: int, _warn: bool = True) -> "Workload":
        """Shim for the retired ``--arrival-pattern`` string toggles."""
        if _warn:
            warnings.warn(
                f"--arrival-pattern {pattern!r} is deprecated; use "
                f"workload.Workload({pattern!r}, ...) or a workload_trace/v1 "
                "file (same seed synthesizes the identical tick schedule)",
                DeprecationWarning, stacklevel=2)
        return cls(pattern, seed=seed, sessions=sessions, length=length,
                   window=window)

    def trace(self) -> Trace:
        return synthesize(self.name, seed=self.seed, **self.params)

    def server_kw(self) -> dict:
        return {**self.scenario.server_kw, **self._server_kw}

    def slos(self) -> dict:
        return {**self.scenario.slos, **self._slos}
