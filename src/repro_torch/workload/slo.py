"""Declarative SLO thresholds checked against replay measurements.

A copy of ``repro.workload.slo``.

An SLO set is a flat ``{key: limit}`` mapping; every key is an upper bound
on one measurement the replay engine reports (scraped from the
``repro_torch.obs`` registry plus the engine's queue accounting).  ``check_slos``
returns the violations, so "gate this scenario" is::

    violations = check_slos(result.measured(), slos)
    sys.exit(1 if violations else 0)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence

__all__ = ["KNOWN_SLOS", "SLOViolation", "parse_slo", "parse_slo_specs",
           "check_slos"]

#: key -> human description; every SLO is an upper bound on the same-named
#: measurement in ``ReplayResult.measured()``
KNOWN_SLOS: Dict[str, str] = {
    "p50_symbol_ms": "median arrival->delta-frame latency per symbol (ms)",
    "p99_symbol_ms": "99th-percentile per-symbol latency (ms)",
    "p999_symbol_ms": "99.9th-percentile per-symbol latency (ms)",
    "max_queue_depth": "max windows staged at any service drain",
    "mean_queue_depth": "mean windows staged per service drain",
    "evict_rate": "LRU evictions / sessions opened",
}


@dataclasses.dataclass(frozen=True)
class SLOViolation:
    key: str
    limit: float
    measured: float

    def __str__(self) -> str:
        return (f"{self.key}: measured={self.measured:.3f} "
                f"limit={self.limit:.3f}")


def parse_slo(spec: str) -> tuple:
    """Parse one ``key=limit`` CLI spec into ``(key, float(limit))``."""
    key, sep, raw = spec.partition("=")
    key = key.strip()
    if not sep or not raw.strip():
        raise ValueError(f"SLO spec must be key=limit, got {spec!r}")
    if key not in KNOWN_SLOS:
        raise ValueError(
            f"unknown SLO {key!r} (have: {', '.join(sorted(KNOWN_SLOS))})")
    try:
        limit = float(raw)
    except ValueError:
        raise ValueError(f"SLO limit must be a number, got {spec!r}")
    return key, limit


def parse_slo_specs(specs: Sequence[str]) -> Dict[str, float]:
    """Parse repeated ``--slo key=limit`` flags (later specs win)."""
    out: Dict[str, float] = {}
    for spec in specs:
        key, limit = parse_slo(spec)
        out[key] = limit
    return out


def check_slos(measured: Mapping[str, float],
               slos: Mapping[str, float]) -> List[SLOViolation]:
    """Upper-bound every declared SLO against ``measured``.

    A declared SLO whose measurement is missing is itself a violation
    (measured as NaN): silently passing an unmeasurable threshold would
    make the gate decorative.
    """
    out: List[SLOViolation] = []
    for key, limit in sorted(slos.items()):
        got = measured.get(key)
        if got is None:
            out.append(SLOViolation(key, float(limit), float("nan")))
        elif float(got) > float(limit):
            out.append(SLOViolation(key, float(limit), float(got)))
    return out
