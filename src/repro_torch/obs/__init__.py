"""Flight recorder for the edge pipeline.

Port of ``repro.obs``.  One ``Observability`` bundle per serving process:
a ``MetricsRegistry`` (counters / gauges / log-bucketed histograms with
p50/p99/p999) plus a ``SpanTracer`` (bounded ring of Chrome trace
events).  The stream and transport layers record into the same bundle, so
one ``/metrics`` scrape or ``/trace`` download covers the whole pipeline.

Recording is host-side integer arithmetic and host clock reads
(``time.perf_counter_ns``), never a device sync, so it adds no sync to a
round on the card.  Pass ``obs=False`` to a server to get shared null
instruments with zero recording cost.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

from repro_torch.obs.metrics import (
    NULL_INSTRUMENT,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullInstrument,
    bucket_bounds,
    bucket_index,
)
from repro_torch.obs.tracing import SpanTracer, annotate

__all__ = [
    "Observability",
    "as_obs",
    "disabled",
    "MetricsRegistry",
    "SpanTracer",
    "Counter",
    "Gauge",
    "Histogram",
    "NullInstrument",
    "NULL_INSTRUMENT",
    "bucket_index",
    "bucket_bounds",
    "annotate",
]


class Observability:
    """Metrics registry + span tracer, enabled or fully inert as a unit."""

    def __init__(self, enabled: bool = True, trace_capacity: int = 4096,
                 torch_annotate: bool = False):
        self.enabled = bool(enabled)
        self.metrics = MetricsRegistry(enabled=self.enabled)
        self.tracer = SpanTracer(capacity=trace_capacity, enabled=self.enabled)
        # opt-in (the reference's ``jax_annotate``): also wrap each table
        # step in ``torch.profiler.record_function`` so the spans land in a
        # torch.profiler trace beside the device kernels
        self.torch_annotate = bool(torch_annotate) and self.enabled

    def snapshot(self) -> Dict[str, object]:
        """JSON-able state for merging into server reports."""
        snap = self.metrics.snapshot()
        snap["spans_recorded"] = float(self.tracer.recorded)
        snap["spans_dropped"] = float(self.tracer.dropped)
        return snap


_DISABLED: Optional[Observability] = None


def disabled() -> Observability:
    """The shared inert bundle (no per-call state, safe to share)."""
    global _DISABLED
    if _DISABLED is None:
        _DISABLED = Observability(enabled=False)
    return _DISABLED


def as_obs(obs: Union[None, bool, Observability]) -> Observability:
    """Normalize a server's ``obs=`` argument.

    ``None`` / ``True`` -> a fresh enabled bundle (per-server registry, so
    two servers never collide on callback metrics); ``False`` -> the shared
    disabled bundle; an ``Observability`` instance passes through.
    """
    if isinstance(obs, Observability):
        return obs
    if obs is False:
        return disabled()
    return Observability()
