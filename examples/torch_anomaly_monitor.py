"""SymED telemetry + straggler watchdog demo (paper Alg. 1 dogfooded).

The port's counterpart of ``examples/anomaly_monitor.py``, on the port's
``StreamServer`` and ``StepWatchdog``; it prints what that example prints.
On the card the slot table's Lloyd loops run in the k-means kernel.

Simulates a 16-host training fleet emitting per-step wall times and losses.
The coordinator runs the resident ``repro_torch.launch.stream.StreamServer``: one
session per telemetry stream (32 total), fed through the batched donated
table step once per round, with the slot table autoscaling from
``min_slots`` up as sessions open.  The symbol-delta frames the service
emits are the bytes a dashboard would receive -- their size *is* the wire
accounting -- and the EWMA/EWMV z-score watchdog flags the injected
straggler and hang from the raw step times on the host side.

Run:  PYTHONPATH=src python examples/torch_anomaly_monitor.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.symed import SymEDConfig
from repro_torch.launch.stream import StreamServer
from repro_torch.train.telemetry import StepWatchdog

N_HOSTS = 16
STEPS = 400
ROUND = 16          # telemetry points buffered per batched ingest round
METRICS = ("step_time", "loss")


def simulate(server: StreamServer):
    rng = np.random.default_rng(3)
    dogs = {h: StepWatchdog(alpha=0.1, z_threshold=4.0) for h in range(N_HOSTS)}
    events = []
    deltas = {}          # sid -> accumulated symbol-delta wire bytes
    raw_bytes = 0.0

    for sid in (f"host{h:02d}/{m}" for h in range(N_HOSTS) for m in METRICS):
        server.open(sid)
    pending = {sid: [] for sid in server.session_ids()}

    for step in range(STEPS):
        for host in range(N_HOSTS):
            dt = rng.normal(1.0, 0.03)
            if host == 7 and 200 <= step < 220:     # injected slow host
                dt += 0.8
            if host == 3 and step == 350:           # injected hang
                dt = 15.0
            loss = 3.0 * np.exp(-step / 150) + rng.normal(0, 0.02)
            pending[f"host{host:02d}/step_time"].append(dt)
            pending[f"host{host:02d}/loss"].append(loss)
            ev = dogs[host].observe(step, dt)
            if ev:
                events.append((host, ev))
        if (step + 1) % ROUND == 0:
            out = server.ingest_many(pending)       # one device program
            for sid, d in out.items():
                deltas[sid] = deltas.get(sid, 0.0) + d["bytes"]
                raw_bytes += 4.0 * len(pending[sid])
            pending = {sid: [] for sid in pending}
    return events, deltas, raw_bytes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the slot table lives (default: cuda)")
    args = ap.parse_args(argv)
    # small buffers: 400-point telemetry streams need nowhere near the
    # paper-scale defaults, and trace time tracks n_max/len_max/k_max
    cfg = SymEDConfig(tol=0.4, alpha=0.05, n_max=256, len_max=64, k_max=12)
    server = StreamServer(
        cfg, max_sessions=2 * N_HOSTS, window_cap=ROUND,
        autoscale=True, min_slots=4, seed=11, device=args.device)
    events, deltas, raw_bytes = simulate(server)
    peak_capacity = server.capacity  # close() lets autoscale shrink back

    closed = {sid: server.close(sid) for sid in list(server.session_ids())}
    wire_bytes = sum(deltas.values()) + sum(
        c["delta"]["bytes"] for c in closed.values())

    print(f"telemetry streams     : {len(closed)} "
          f"(slot table grew 4 -> {peak_capacity})")
    print(f"batched device steps  : {server.totals['steps']}")
    print(f"raw bytes             : {raw_bytes:,.0f}")
    print(f"wire bytes            : {wire_bytes:,.0f}  "
          f"(CR={wire_bytes / raw_bytes:.3f}, paper avg 0.095)")

    sym = closed["host07/step_time"]["symbols"]
    print(f"host07 step_time syms : {sym[:60]}{'...' if len(sym) > 60 else ''}"
          f"  (n_pieces={closed['host07/step_time']['n_pieces']})")

    print("\nwatchdog events:")
    for host, ev in events:
        print(f"  host{host:02d} step {ev['step']:3d}: {ev['kind']:9s} "
              f"dt={ev['dt']:.2f}s z={ev['z']:.1f}")
    flagged = {h for h, e in events}
    assert 7 in flagged and 3 in flagged, "injected anomalies must be caught"
    assert wire_bytes < raw_bytes, "symbol deltas must beat raw telemetry"
    print("\ninjected straggler (host07) and hang (host03) both detected.")


if __name__ == "__main__":
    main()
