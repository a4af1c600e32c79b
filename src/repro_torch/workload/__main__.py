"""Workload harness CLI: replay scenarios, check SLOs, write bench rows.

    PYTHONPATH=src python -m repro_torch.workload --scenario flash_crowd \
        --slo p99_symbol_ms=50 --device cpu

Port of ``python -m repro.workload``.  Replays each ``--scenario`` (or a
recorded ``--trace`` jsonl) through the port's in-process ``StreamServer``
-- or the loopback TCP transport with ``--transport`` -- on ``--device``
(``cuda`` unless ``cpu``), and checks the scenario's SLOs plus any
``--slo`` overrides against the measured quantiles.  Exit status: 0 clean,
1 on any SLO violation, 3 if ``--runs N`` replays disagree, 2 on bad
flags.

``--devices N`` (N > 1) shards the server's slot table over a data mesh of
N shards (``repro_torch.launch.mesh``: host shards with ``--device cpu``,
round-robin over the cards with ``cuda``); each scenario's table must
divide over it.

``--out FILE`` writes the per-scenario artifact (schema
``bench_transport/v1``) to ``FILE``, and nothing is written without it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.launch.cli import (
    add_devices_arg, add_symed_args, validate_shared_args)
from repro_torch.workload import (
    SCENARIOS, Trace, Workload, check_slos, parse_slo_specs, replay_trace,
    scenario_seed,
)

BENCH_SCHEMA = "bench_transport/v1"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.workload",
        description=__doc__.split("\n", 1)[0])
    ap.add_argument("--scenario", action="append", default=None,
                    metavar="NAME",
                    help="scenario to replay (repeatable; 'all' = the "
                         f"non-legacy zoo; have: "
                         f"{', '.join(sorted(SCENARIOS))})")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="replay a recorded workload_trace/v1 jsonl instead "
                         "of synthesizing")
    ap.add_argument("--dump-trace", default=None, metavar="FILE",
                    help="write the synthesized trace jsonl and exit "
                         "(single --scenario only)")
    ap.add_argument("--sessions", type=int, default=None,
                    help="override the scenario's session count")
    ap.add_argument("--length", type=int, default=None,
                    help="override the scenario's points per stream")
    ap.add_argument("--window", type=int, default=None,
                    help="override the scenario's arrival window")
    ap.add_argument("--slo", action="append", default=[],
                    metavar="KEY=LIMIT",
                    help="SLO threshold override (repeatable), e.g. "
                         "p99_symbol_ms=50")
    ap.add_argument("--no-slos", action="store_true",
                    help="measure only; skip the scenario's default SLO gate")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="pace drains against the trace clock at this "
                         "multiple of real time (0: unpaced)")
    ap.add_argument("--transport", action="store_true",
                    help="drive the loopback TCP transport tier instead of "
                         "the in-process server")
    ap.add_argument("--runs", type=int, default=1,
                    help="replay N times and require identical fingerprints "
                         "(delta bytes + counters)")
    ap.add_argument("--verify", action="store_true",
                    help="check every session's delta concatenation against "
                         "symed_encode (endpoints bitwise; every symbol on "
                         "the CPU, 99%% on cuda)")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help=f"write the {BENCH_SCHEMA} artifact here")
    add_devices_arg(ap)
    add_symed_args(ap)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the server's table and the senders run")
    return ap


def _resolve_scenarios(ap, args) -> list:
    names = []
    for name in args.scenario or ["all"]:
        if name == "all":
            names.extend(n for n, sc in SCENARIOS.items() if not sc.legacy)
        elif name in SCENARIOS:
            names.append(name)
        else:
            ap.error(f"unknown scenario {name!r} "
                     f"(have: {', '.join(sorted(SCENARIOS))}, all)")
    return names


def _check_mesh_fit(name: str, server_kw: dict, devices: int) -> None:
    cap = int(server_kw.get("max_sessions", 8))
    lo = server_kw.get("min_slots")
    if cap % devices or (lo is not None and int(lo) % devices):
        raise SystemExit(
            f"scenario {name!r}: slot table (max_sessions={cap}, "
            f"min_slots={lo}) must divide over --devices {devices}")


def _run_scenario(name: str, trace, server_kw: dict, slos: dict, args,
                  cfg, mesh) -> tuple:
    """Replay (possibly repeatedly); returns (bench_row, violations,
    determinism)."""
    if mesh is not None:
        server_kw = {**server_kw, "mesh": mesh}
    results = []
    for _ in range(max(args.runs, 1)):
        results.append(replay_trace(
            trace, cfg=cfg, server_kw=server_kw, rate=args.rate,
            transport=args.transport, verify=args.verify,
            device=args.device))
    res = results[0]
    prints = set(r.fingerprint() for r in results)
    determinism = "n/a" if len(results) == 1 else (
        "OK" if len(prints) == 1 else "MISMATCH")
    measured = res.measured()
    violations = check_slos(measured, slos)
    for v in violations:
        print(f"slo_check scenario={name} {v.key}: "
              f"measured={v.measured:.3f} limit={v.limit:.3f} -> VIOLATION")
    for key, limit in sorted(slos.items()):
        if not any(v.key == key for v in violations):
            print(f"slo_check scenario={name} {key}: "
                  f"measured={measured.get(key, 0.0):.3f} "
                  f"limit={limit:.3f} -> ok")
    c = res.counters
    extra = f"verified={res.verified} " if args.verify else ""
    print("workload_summary "
          f"scenario={name} transport={int(args.transport)} "
          f"runs={len(results)} determinism={determinism} "
          f"delta_sha256={res.delta_sha256[:16]} "
          f"opened={int(c.get('opened', 0))} "
          f"closed={int(c.get('closed', 0))} "
          f"evicted={int(c.get('evicted', 0))} "
          f"points_in={int(c.get('points_in', 0))} "
          f"symbols_out={int(c.get('symbols_out', 0))} "
          f"grows={int(c.get('grows', 0))} "
          f"shrinks={int(c.get('shrinks', 0))} "
          f"queue_max={int(res.queue['max_depth'])} "
          f"queue_mean={res.queue['mean_depth']:.2f} "
          f"p50_ms={res.latency['p50_ms']:.3f} "
          f"p99_ms={res.latency['p99_ms']:.3f} "
          f"p999_ms={res.latency['p999_ms']:.3f} "
          f"wall_s={res.wall_seconds:.2f} "
          f"{extra}"
          f"violations={len(violations)}", flush=True)
    row = {
        "scenario": name,
        "seed": trace.seed,
        "transport": int(args.transport),
        "trace_digest": trace.digest(),
        **{k: int(v) for k, v in trace.counts().items()},
        "opened": int(c.get("opened", 0)),
        "closed": int(c.get("closed", 0)),
        "evicted": int(c.get("evicted", 0)),
        "evict_rate": res.evict_rate,
        "points_in": int(c.get("points_in", 0)),
        "symbols_out": int(c.get("symbols_out", 0)),
        "drains": int(res.queue["drains"]),
        "max_queue_depth": int(res.queue["max_depth"]),
        "mean_queue_depth": round(res.queue["mean_depth"], 4),
        "p50_symbol_ms": round(res.latency["p50_ms"], 4),
        "p99_symbol_ms": round(res.latency["p99_ms"], 4),
        "p999_symbol_ms": round(res.latency["p999_ms"], 4),
        "delta_sha256": res.delta_sha256,
        "slos": {k: float(v) for k, v in sorted(slos.items())},
        "violations": [str(v) for v in violations],
    }
    return row, violations, determinism


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    validate_shared_args(ap, args)
    if args.runs < 1:
        ap.error(f"--runs must be >= 1, got {args.runs}")
    if args.rate < 0:
        ap.error(f"--rate must be >= 0, got {args.rate}")
    try:
        parse_slo_specs(args.slo)
    except ValueError as e:
        ap.error(str(e))
    if args.trace is not None and args.scenario is not None:
        ap.error("--trace and --scenario are mutually exclusive")
    overrides = {k: getattr(args, k) for k in ("sessions", "length", "window")
                 if getattr(args, k) is not None}

    # (name, trace, server_kw, slos) per replay target
    targets = []
    if args.trace is not None:
        trace = Trace.load(args.trace)
        wl = (Workload(trace.name) if trace.name in SCENARIOS else None)
        server_kw = wl.server_kw() if wl else {"max_sessions": 8,
                                               "pretrace": True}
        slos = dict(wl.slos()) if (wl and not args.no_slos) else {}
        slos.update(parse_slo_specs(args.slo))
        targets.append((trace.name, trace, server_kw, slos))
    else:
        for name in _resolve_scenarios(ap, args):
            wl = Workload(name, seed=scenario_seed(name, args.seed),
                          **overrides)
            slos = {} if args.no_slos else dict(wl.slos())
            slos.update(parse_slo_specs(args.slo))
            targets.append((name, wl.trace(), wl.server_kw(), slos))

    if args.dump_trace is not None:
        if len(targets) != 1:
            ap.error("--dump-trace needs exactly one scenario")
        _, trace, _, _ = targets[0]
        trace.save(args.dump_trace)
        print(f"trace written           : {args.dump_trace} "
              f"({trace.counts()['events']} events, digest "
              f"{trace.digest()[:16]})")
        return 0

    for name, _, server_kw, _ in targets:
        _check_mesh_fit(name, server_kw, args.devices)

    from repro_torch.core.symed import SymEDConfig
    from repro_torch.launch.fleet import fleet_data_mesh

    cfg = SymEDConfig(tol=args.tol, alpha=args.alpha, n_max=256, k_max=32,
                      len_max=256)
    mesh = (fleet_data_mesh(args.devices, device=args.device)
            if args.devices > 1 else None)
    rows = []
    n_violations = 0
    mismatch = False
    t0 = time.perf_counter()
    for name, trace, server_kw, slos in targets:
        sc = SCENARIOS.get(name)
        print(f"--- scenario {name}"
              + (f": {sc.description}" if sc else " (recorded trace)"),
              flush=True)
        row, violations, determinism = _run_scenario(
            name, trace, server_kw, slos, args, cfg, mesh)
        rows.append(row)
        n_violations += len(violations)
        mismatch = mismatch or determinism == "MISMATCH"

    if args.out:
        doc = {
            "schema": BENCH_SCHEMA,
            "generated_by": "python -m repro_torch.workload",
            "config": {
                "tol": args.tol, "alpha": args.alpha, "seed": args.seed,
                "rate": args.rate, "device": args.device,
                "devices": args.devices,
                "runs": args.runs, "transport": int(args.transport),
            },
            "rows": rows,
            "summary": {
                "scenarios": len(rows),
                "violations": n_violations,
                "wall_seconds": round(time.perf_counter() - t0, 2),
            },
        }
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"bench artifact          : {args.out} "
              f"({len(rows)} scenario rows)")

    if mismatch:
        return 3
    return 1 if n_violations else 0


if __name__ == "__main__":
    sys.exit(main())
