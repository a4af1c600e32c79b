"""Bounded ring-buffer span tracer emitting Chrome trace-event JSON.

A copy of ``repro.obs.tracing``, except ``annotate``.  The tracer records
complete spans (``ph: "X"``) and instant events (``ph: "i"``) into a
fixed-capacity ring; when full, the oldest events are overwritten and
``dropped`` counts what fell off.  Recording is a tuple store into a
preallocated list -- no allocation growth, no device syncs.  Timestamps
are the host's ``perf_counter_ns``: a span measures host time, which on
the card is the time to issue the work, not the device's time to run it.

``chrome_trace()`` renders the ring as a Chrome trace-event document
that loads directly in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.  Timestamps are microseconds, durations
microseconds, per the spec.

``annotate`` is ``torch.profiler.record_function``: it puts a named range
into a ``torch.profiler`` trace, beside the device kernels it launched.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["SpanTracer", "annotate"]

# Event record layout: (name, phase, ts_ns, dur_ns, args)
_Event = Tuple[str, str, int, int, Optional[Dict[str, object]]]


def annotate(name: str):
    """Context manager adding ``name`` to an active ``torch.profiler``
    trace.  Negligible cost without a profiler, but still a
    context-manager entry per call: the serving loop enters it only when
    ``Observability(torch_annotate=True)``."""
    import torch

    return torch.profiler.record_function(name)


class SpanTracer:
    """Fixed-capacity ring of trace events.

    Hot-path usage is the two-call pattern::

        t0 = time.perf_counter_ns()
        ...work...
        tracer.add("stream.dispatch", t0)

    which costs one clock read plus a list store.  ``span()`` offers a
    context-manager form for non-hot call sites.
    """

    __slots__ = ("capacity", "enabled", "dropped", "_ring", "_n", "_pid", "_t0_ns")

    def __init__(self, capacity: int = 4096, enabled: bool = True, pid: int = 0):
        if capacity < 1:
            capacity = 1
        self.capacity = capacity
        self.enabled = bool(enabled)
        self.dropped = 0
        self._ring: List[Optional[_Event]] = [None] * capacity
        self._n = 0  # total events ever recorded
        self._pid = pid
        # trace epoch: event timestamps are reported relative to tracer
        # creation so Perfetto opens at t=0 rather than host-uptime
        self._t0_ns = time.perf_counter_ns()

    # -- recording ----------------------------------------------------------

    def _push(self, ev: _Event) -> None:
        i = self._n
        slot = i % self.capacity
        if i >= self.capacity:
            self.dropped += 1
        self._ring[slot] = ev
        self._n = i + 1

    def add(self, name: str, t0_ns: int, args: Optional[Dict[str, object]] = None) -> None:
        """Record a complete span from ``t0_ns`` (perf_counter_ns) to now."""
        if not self.enabled:
            return
        now = time.perf_counter_ns()
        self._push((name, "X", t0_ns, now - t0_ns, args))

    def add_span(self, name: str, t0_ns: int, t1_ns: int,
                 args: Optional[Dict[str, object]] = None) -> None:
        """Record a complete span with both endpoints already measured."""
        if not self.enabled:
            return
        self._push((name, "X", t0_ns, t1_ns - t0_ns, args))

    def instant(self, name: str, args: Optional[Dict[str, object]] = None) -> None:
        """Record a zero-duration marker (autoscale grow/shrink, retrace...)."""
        if not self.enabled:
            return
        self._push((name, "i", time.perf_counter_ns(), 0, args))

    def span(self, name: str, args: Optional[Dict[str, object]] = None):
        """Context-manager form for non-hot call sites."""
        return _SpanCtx(self, name, args)

    # -- reading ------------------------------------------------------------

    @property
    def recorded(self) -> int:
        """Total events ever recorded (including those since overwritten)."""
        return self._n

    def events(self) -> List[_Event]:
        """Retained events, oldest first."""
        n = self._n
        cap = self.capacity
        if n <= cap:
            return [e for e in self._ring[:n] if e is not None]
        start = n % cap
        out = self._ring[start:] + self._ring[:start]
        return [e for e in out if e is not None]

    def chrome_trace(self, tid: int = 0) -> Dict[str, object]:
        """Render retained events as a Chrome trace-event JSON document."""
        t0 = self._t0_ns
        trace_events: List[Dict[str, object]] = []
        for name, ph, ts_ns, dur_ns, args in self.events():
            ev: Dict[str, object] = {
                "name": name,
                "ph": ph,
                "ts": (ts_ns - t0) / 1e3,  # microseconds
                "pid": self._pid,
                "tid": tid,
            }
            if ph == "X":
                ev["dur"] = dur_ns / 1e3
            if ph == "i":
                ev["s"] = "t"  # thread-scoped instant
            if args:
                ev["args"] = args
            trace_events.append(ev)
        return {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def write(self, path: str, tid: int = 0) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(tid=tid), f)


class _SpanCtx:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: SpanTracer, name: str, args):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._tracer.add(self._name, self._t0, self._args)
        return False
