"""Trace-driven workload harness: scenarios, replay, tail-latency SLOs.

Port of ``repro.workload``.  Seeded synthesizers build
``workload_trace/v1`` arrival traces for a scenario zoo (the same seed
gives the reference's trace, digest for digest), a replay engine drives
them through the port's ``StreamServer`` in process or over the loopback
TCP transport, and an SLO layer turns the recorder's quantiles into a
pass/fail verdict.

    PYTHONPATH=src python -m repro_torch.workload --scenario flash_crowd \
        --slo p99_symbol_ms=50 --device cpu
"""
from repro_torch.workload.replay import ReplayResult, replay_trace
from repro_torch.workload.scenarios import (
    SCENARIOS, Scenario, Workload, legacy_arrival_schedule, scenario_seed,
    synthesize,
)
from repro_torch.workload.slo import (
    KNOWN_SLOS, SLOViolation, check_slos, parse_slo, parse_slo_specs,
)
from repro_torch.workload.trace import (
    SCHEMA, TICK_MS, Trace, TraceBuilder, TraceEvent,
)

__all__ = [
    "SCHEMA", "TICK_MS", "Trace", "TraceBuilder", "TraceEvent",
    "SCENARIOS", "Scenario", "Workload", "legacy_arrival_schedule",
    "scenario_seed", "synthesize",
    "KNOWN_SLOS", "SLOViolation", "check_slos", "parse_slo",
    "parse_slo_specs",
    "ReplayResult", "replay_trace",
]
