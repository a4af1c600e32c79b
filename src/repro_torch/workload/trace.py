"""``workload_trace/v1``: the arrival-trace schema the replay engine drives.

A copy of ``repro.workload.trace``: a trace the reference writes loads
here, and the digests agree.

A trace is a totally ordered list of per-tick session events --
``(t_ms, session_id, kind, window_ref)`` -- plus a header binding them to
a deterministic synthetic source fleet (``repro_torch.data.synthetic.make_fleet``
rows).  ``window_ref`` indexes the owning stream row's consecutive
``window``-point slices, so a trace is *self-contained*: the same
``(trace, seed)`` pair reproduces the same bytes on the wire anywhere.

Event kinds:

    ``open``   session arrives (allocates a slot / OPEN frame)
    ``data``   session delivers source window ``window_ref``
    ``close``  session ends cleanly (flush tail / CLOSE frame)

On-disk form is jsonl: a header line (schema, name, seed, fleet shape,
per-session metadata) followed by one compact line per event.  The
canonical serialization also backs :meth:`Trace.digest`, the identity the
reorder-invariance and determinism batteries compare.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Iterator, List, Tuple

SCHEMA = "workload_trace/v1"
KINDS = ("open", "data", "close")

#: trace clock quantum the synthesizers emit on (one service tick)
TICK_MS = 10


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One scheduled session event; ``window_ref`` is -1 for open/close."""
    t_ms: int
    sid: str
    kind: str
    window_ref: int = -1


@dataclasses.dataclass
class Trace:
    """An arrival trace plus the synthetic-source binding that replays it.

    ``sessions`` maps every sid to ``{"stream": row, "mode": "raw"|"pieces"}``:
    the ``make_fleet(n_streams, length, seed)`` row the session reads and
    the transport mode its sender uses.  Several sids may share one stream
    row (reconnect churn resumes the row under a fresh sid).
    """
    name: str
    seed: int
    n_streams: int
    length: int
    window: int
    events: List[TraceEvent]
    sessions: Dict[str, dict]
    service_every_ms: int = TICK_MS

    # ------------------------------------------------------------- views

    @property
    def n_windows(self) -> int:
        """Source windows per stream row (last one may be partial)."""
        return -(-self.length // self.window)

    def ticks(self) -> Iterator[Tuple[int, List[TraceEvent]]]:
        """Yield ``(t_ms, events)`` groups in trace order."""
        group: List[TraceEvent] = []
        t = None
        for ev in self.events:
            if t is not None and ev.t_ms != t:
                yield t, group
                group = []
            t = ev.t_ms
            group.append(ev)
        if group:
            yield t, group

    def schedule(self) -> List[List[Tuple[int, int]]]:
        """Per-tick ``(stream row, window_ref)`` data arrivals.

        The exact shape ``launch.stream``'s retired ``_arrival_schedule``
        generator yielded -- the shim-equivalence battery compares against
        a frozen copy of it.
        """
        out = []
        for _, evs in self.ticks():
            tick = [(self.sessions[ev.sid]["stream"], ev.window_ref)
                    for ev in evs if ev.kind == "data"]
            if tick:
                out.append(tick)
        return out

    def counts(self) -> Dict[str, int]:
        """Event totals (the schedule-determined half of a bench row)."""
        data = sum(1 for ev in self.events if ev.kind == "data")
        return {
            "events": len(self.events),
            "windows": data,
            "sessions": len(self.sessions),
        }

    # ------------------------------------------------------- serialization

    def header(self) -> dict:
        return {
            "schema": SCHEMA,
            "name": self.name,
            "seed": self.seed,
            "n_streams": self.n_streams,
            "length": self.length,
            "window": self.window,
            "service_every_ms": self.service_every_ms,
            "sessions": self.sessions,
        }

    def to_jsonl(self) -> str:
        lines = [json.dumps(self.header(), sort_keys=True,
                            separators=(",", ":"))]
        for ev in self.events:
            lines.append(json.dumps(
                {"t": ev.t_ms, "sid": ev.sid, "k": ev.kind,
                 "w": ev.window_ref},
                sort_keys=True, separators=(",", ":")))
        return "\n".join(lines) + "\n"

    @classmethod
    def from_jsonl(cls, text: str) -> "Trace":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty trace file")
        head = json.loads(lines[0])
        if head.get("schema") != SCHEMA:
            raise ValueError(
                f"expected schema {SCHEMA!r}, got {head.get('schema')!r}")
        events = [
            TraceEvent(t_ms=int(d["t"]), sid=str(d["sid"]),
                       kind=str(d["k"]), window_ref=int(d["w"]))
            for d in map(json.loads, lines[1:])
        ]
        trace = cls(
            name=str(head["name"]), seed=int(head["seed"]),
            n_streams=int(head["n_streams"]), length=int(head["length"]),
            window=int(head["window"]), events=events,
            sessions={str(k): dict(v) for k, v in head["sessions"].items()},
            service_every_ms=int(head["service_every_ms"]),
        )
        trace.validate()
        return trace

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_jsonl(f.read())

    def digest(self) -> str:
        """sha256 over the canonical jsonl -- the trace's identity."""
        return hashlib.sha256(self.to_jsonl().encode("utf-8")).hexdigest()

    # ---------------------------------------------------------- invariants

    def validate(self) -> None:
        """Raise ``ValueError`` on any schema violation."""
        if self.n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {self.n_streams}")
        if not 1 <= self.window <= self.length:
            raise ValueError(
                f"window {self.window} outside [1, length {self.length}]")
        if self.service_every_ms < 1:
            raise ValueError(
                f"service_every_ms must be >= 1, got {self.service_every_ms}")
        n_windows = self.n_windows
        opened: set = set()
        closed: set = set()
        last_ref: Dict[str, int] = {}
        prev_t = 0
        for i, ev in enumerate(self.events):
            if ev.kind not in KINDS:
                raise ValueError(f"event {i}: unknown kind {ev.kind!r}")
            if ev.t_ms < prev_t:
                raise ValueError(
                    f"event {i}: t_ms {ev.t_ms} goes backwards from {prev_t}")
            prev_t = ev.t_ms
            meta = self.sessions.get(ev.sid)
            if meta is None:
                raise ValueError(f"event {i}: sid {ev.sid!r} not in sessions")
            if ev.sid in closed:
                raise ValueError(f"event {i}: sid {ev.sid!r} already closed")
            if ev.kind == "open":
                if ev.sid in opened:
                    raise ValueError(f"event {i}: sid {ev.sid!r} reopened")
                opened.add(ev.sid)
            elif ev.sid not in opened:
                raise ValueError(
                    f"event {i}: {ev.kind} for unopened sid {ev.sid!r}")
            if ev.kind == "data":
                if not 0 <= ev.window_ref < n_windows:
                    raise ValueError(
                        f"event {i}: window_ref {ev.window_ref} outside "
                        f"[0, {n_windows})")
                if ev.window_ref <= last_ref.get(ev.sid, -1):
                    raise ValueError(
                        f"event {i}: sid {ev.sid!r} window_ref "
                        f"{ev.window_ref} not increasing")
                last_ref[ev.sid] = ev.window_ref
            if ev.kind == "close":
                closed.add(ev.sid)
        for sid, meta in self.sessions.items():
            if not 0 <= int(meta.get("stream", -1)) < self.n_streams:
                raise ValueError(
                    f"sid {sid!r}: stream row {meta.get('stream')} outside "
                    f"[0, {self.n_streams})")
            if meta.get("mode", "raw") not in ("raw", "pieces"):
                raise ValueError(
                    f"sid {sid!r}: mode must be raw|pieces, got "
                    f"{meta.get('mode')!r}")
            if sid not in opened:
                raise ValueError(f"sid {sid!r} declared but never opened")


class TraceBuilder:
    """Append-only event builder the synthesizers share.

    Events must be appended in nondecreasing ``t_ms`` order; ``build``
    validates the full invariant set.
    """

    def __init__(self, name: str, seed: int, n_streams: int, length: int,
                 window: int, service_every_ms: int = TICK_MS):
        self.name = name
        self.seed = seed
        self.n_streams = n_streams
        self.length = length
        self.window = window
        self.service_every_ms = service_every_ms
        self.events: List[TraceEvent] = []
        self.sessions: Dict[str, dict] = {}

    def open(self, t_ms: int, sid: str, stream: int,
             mode: str = "raw") -> None:
        self.sessions[sid] = {"stream": int(stream), "mode": mode}
        self.events.append(TraceEvent(int(t_ms), sid, "open"))

    def data(self, t_ms: int, sid: str, window_ref: int) -> None:
        self.events.append(
            TraceEvent(int(t_ms), sid, "data", int(window_ref)))

    def close(self, t_ms: int, sid: str) -> None:
        self.events.append(TraceEvent(int(t_ms), sid, "close"))

    def build(self) -> Trace:
        trace = Trace(
            name=self.name, seed=self.seed, n_streams=self.n_streams,
            length=self.length, window=self.window, events=self.events,
            sessions=self.sessions, service_every_ms=self.service_every_ms,
        )
        trace.validate()
        return trace
