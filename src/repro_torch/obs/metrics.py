"""Process-local metrics: counters, gauges, and log-bucketed histograms.

A copy of ``repro.obs.metrics`` (host-only code; the port imports nothing
of ``repro``).  The flight-recorder contract:

- **Hot-path safe.** Recording a histogram sample is one integer
  ``bit_length`` bucket computation plus three int adds on a plain
  Python object -- no torch import, no device sync, no allocation beyond
  the fixed bucket list created at registration time.  The serving loop
  (``StreamServer.ingest_many``, ``TransportServer._tick``) records on
  every round, and nothing here ever touches a device value.
- **Scrape-anytime.** The Prometheus exporter thread reads instruments
  concurrently with the serving loop.  All mutations are single-field
  int/float writes (GIL-atomic enough for monitoring), so scrapes never
  block the hot path and never see torn multi-field invariants worse
  than one sample of skew.
- **Bucket-derived quantiles.** Histograms use base-2 log buckets with
  ``_SUB_BITS`` extra resolution bits per octave (4 sub-buckets ->
  bucket width <= 25% of the value), so p50/p99/p999 read off the
  cumulative bucket walk with bounded relative error and zero per-sample
  cost beyond the increment.

Callback instruments (``counter_fn`` / ``gauge_fn``) read an existing
host-side total (e.g. ``StreamServer.totals``) lazily at scrape time --
the cheapest possible instrumentation: zero added hot-path work.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "bucket_index",
    "bucket_bounds",
    "N_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "NullInstrument",
    "NULL_INSTRUMENT",
    "MetricsRegistry",
]

# ---------------------------------------------------------------------------
# log-bucket scheme
# ---------------------------------------------------------------------------

# Sub-bucket resolution bits: each power-of-two octave [2^e, 2^(e+1)) is
# split into 2**_SUB_BITS equal sub-buckets, so a bucket spans at most
# 2^-_SUB_BITS = 25% of its lower bound.  Values 0..3 get exact unit
# buckets (they are below the first splittable octave).
_SUB_BITS = 2
_SUBS = 1 << _SUB_BITS

# Enough buckets to cover any 64-bit nanosecond count (~584 years).
N_BUCKETS = _SUBS + ((64 - _SUB_BITS) << _SUB_BITS)


def bucket_index(value: int) -> int:
    """Map a non-negative int to its log-bucket index (monotone in value)."""
    if value < _SUBS:
        return value if value > 0 else 0
    e = value.bit_length() - 1
    return ((e - _SUB_BITS) << _SUB_BITS) + ((value >> (e - _SUB_BITS)) & (_SUBS - 1)) + _SUBS


def bucket_bounds(index: int) -> Tuple[int, int]:
    """Half-open [lo, hi) value range of bucket ``index``."""
    if index < _SUBS:
        return index, index + 1
    j = index - _SUBS
    e = (j >> _SUB_BITS) + _SUB_BITS
    sub = j & (_SUBS - 1)
    width = 1 << (e - _SUB_BITS)
    lo = (1 << e) + sub * width
    return lo, lo + width


# Exposition scale per declared unit: sample values are stored in the
# instrument's native unit and divided by this on export.
UNIT_SCALE = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0, "": 1.0, "bytes": 1.0}


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------


class Counter:
    """Monotonically increasing value.  Name it ``*_total`` (Prometheus idiom)."""

    __slots__ = ("name", "help", "labels", "value", "_fn")
    kind = "counter"

    def __init__(self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None,
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.value = 0.0
        self._fn = fn

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def read(self) -> float:
        return float(self._fn()) if self._fn is not None else self.value


class Gauge:
    """Point-in-time value (can go up and down)."""

    __slots__ = ("name", "help", "labels", "value", "_fn")
    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None,
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def read(self) -> float:
        return float(self._fn()) if self._fn is not None else self.value


class Histogram:
    """Log-bucketed histogram of non-negative integer samples.

    Samples are recorded in the native ``unit`` (default nanoseconds) and
    scaled to base units (seconds) on export.  ``observe`` is the hot-path
    entry: bucket index + three int adds, nothing else.
    """

    __slots__ = ("name", "help", "labels", "unit", "buckets", "count", "total")
    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None,
                 unit: str = "ns"):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.unit = unit
        self.buckets: List[int] = [0] * N_BUCKETS
        self.count = 0
        self.total = 0

    def observe(self, value: int) -> None:
        v = int(value)
        if v < 0:
            v = 0
        self.buckets[bucket_index(v)] += 1
        self.count += 1
        self.total += v

    def observe_n(self, value: int, n: int) -> None:
        """Record ``n`` samples of the same ``value`` (one bucket update)."""
        if n <= 0:
            return
        v = int(value)
        if v < 0:
            v = 0
        self.buckets[bucket_index(v)] += n
        self.count += n
        self.total += v * n

    @property
    def scale(self) -> float:
        return UNIT_SCALE.get(self.unit, 1.0)

    @property
    def mean(self) -> float:
        return (self.total / self.count) if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-midpoint estimate of the ``q`` quantile, in native units.

        Relative error is bounded by half the bucket width (<= 12.5%) plus
        within-bucket rank placement; good enough for p50/p99/p999 SLO
        tracking without storing samples.
        """
        if self.count <= 0:
            return 0.0
        target = q * self.count
        if target < 1.0:
            target = 1.0
        cum = 0
        last = 0
        for i, c in enumerate(self.buckets):
            if not c:
                continue
            cum += c
            last = i
            if cum >= target:
                lo, hi = bucket_bounds(i)
                return (lo + hi) / 2.0
        lo, hi = bucket_bounds(last)
        return (lo + hi) / 2.0

    def quantiles(self, qs: Sequence[float] = (0.5, 0.99, 0.999)) -> Tuple[float, ...]:
        return tuple(self.quantile(q) for q in qs)

    def nonzero_buckets(self) -> Iterable[Tuple[int, int]]:
        """Yield (index, count) for occupied buckets, ascending."""
        for i, c in enumerate(self.buckets):
            if c:
                yield i, c


class NullInstrument:
    """Shared no-op stand-in for every instrument kind when obs is disabled.

    All mutators are empty; all readers return 0.  One instance serves the
    whole process, so a disabled registry allocates nothing per metric.
    """

    __slots__ = ()
    kind = "null"
    name = ""
    unit = ""
    count = 0
    total = 0
    mean = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, value: int) -> None:
        pass

    def observe_n(self, value: int, n: int) -> None:
        pass

    def read(self) -> float:
        return 0.0

    def quantile(self, q: float) -> float:
        return 0.0

    def quantiles(self, qs: Sequence[float] = (0.5, 0.99, 0.999)) -> Tuple[float, ...]:
        return tuple(0.0 for _ in qs)


NULL_INSTRUMENT = NullInstrument()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def _key(name: str, labels: Optional[Dict[str, str]]) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    return name, tuple(sorted((labels or {}).items()))


class MetricsRegistry:
    """Ordered collection of instruments, keyed by (name, labels).

    Value instruments (``counter``/``gauge``/``histogram``) are
    get-or-create: asking twice for the same (name, labels) returns the
    same object, so layered components (stream server + transport front
    end) can share one registry.  Callback instruments (``counter_fn`` /
    ``gauge_fn``) bind a closure and therefore refuse duplicates -- two
    owners silently sharing one callback series would misreport.

    A disabled registry hands out the shared ``NULL_INSTRUMENT`` and
    collects nothing.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._instruments: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}

    # -- registration -------------------------------------------------------

    def _get_or_create(self, cls, name, help, labels, **kw):
        if not self.enabled:
            return NULL_INSTRUMENT
        k = _key(name, labels)
        inst = self._instruments.get(k)
        if inst is not None:
            if inst.kind != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {inst.kind}, not {cls.kind}")
            return inst
        inst = cls(name, help, labels, **kw)
        self._instruments[k] = inst
        return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None, unit: str = "ns") -> Histogram:
        return self._get_or_create(Histogram, name, help, labels, unit=unit)

    def _register_fn(self, cls, name, help, labels, fn):
        if not self.enabled:
            return NULL_INSTRUMENT
        k = _key(name, labels)
        if k in self._instruments:
            raise ValueError(f"callback metric {name!r}{dict(k[1])!r} already registered")
        inst = cls(name, help, labels, fn=fn)
        self._instruments[k] = inst
        return inst

    def counter_fn(self, name: str, help: str, fn: Callable[[], float],
                   labels: Optional[Dict[str, str]] = None) -> Counter:
        """Counter whose value is read from ``fn()`` at scrape time."""
        return self._register_fn(Counter, name, help, labels, fn)

    def gauge_fn(self, name: str, help: str, fn: Callable[[], float],
                 labels: Optional[Dict[str, str]] = None) -> Gauge:
        """Gauge whose value is read from ``fn()`` at scrape time."""
        return self._register_fn(Gauge, name, help, labels, fn)

    # -- collection ---------------------------------------------------------

    def instruments(self) -> List[object]:
        return list(self._instruments.values())

    def families(self) -> List[Tuple[str, List[object]]]:
        """Instruments grouped by metric name, registration-ordered."""
        fams: Dict[str, List[object]] = {}
        for inst in self._instruments.values():
            fams.setdefault(inst.name, []).append(inst)
        return list(fams.items())

    def snapshot(self) -> Dict[str, object]:
        """JSON-able dump: counters/gauges by labeled name, histogram digests.

        Histogram values are converted to base units (seconds for ``ns``).
        """
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, Dict[str, float]] = {}
        for inst in self._instruments.values():
            label = inst.name
            if getattr(inst, "labels", None):
                inner = ",".join(f"{k}={v}" for k, v in sorted(inst.labels.items()))
                label = f"{inst.name}{{{inner}}}"
            if inst.kind == "counter":
                counters[label] = inst.read()
            elif inst.kind == "gauge":
                gauges[label] = inst.read()
            elif inst.kind == "histogram":
                s = inst.scale
                p50, p99, p999 = inst.quantiles()
                hists[label] = {
                    "count": float(inst.count),
                    "sum": inst.total * s,
                    "mean": inst.mean * s,
                    "p50": p50 * s,
                    "p99": p99 * s,
                    "p999": p999 * s,
                }
        return {"counters": counters, "gauges": gauges, "histograms": hists}
