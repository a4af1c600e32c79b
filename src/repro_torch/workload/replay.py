"""Deterministic trace replay against the stream service or the transport.

Port of ``repro.workload.replay``.  The engine walks a ``workload_trace/v1``
trace in drain buckets (``service_every_ms`` of trace time per service
call), and drives either:

* **in-process** (default): the port's ``StreamServer`` directly -- all of
  a drain's arrivals go through one ``ingest_many`` / ``ingest_pieces_many``
  pair, exactly the transport loop's flush shape.  Same trace + seed =>
  identical delta bytes and counter totals; on the CPU they equal the
  reference's (``ReplayResult.fingerprint``).
* **over loopback TCP** (``transport=True``): a ``TransportServer`` thread
  plus one ``SenderClient`` socket carrying every session (mixed raw and
  pieces modes per the trace's session metadata).  Socket scheduling makes
  byte timing nondeterministic, so only the schedule-determined counters
  participate in this mode's fingerprint.

A pieces-mode session compresses on the server's device, one
``symed_encode_chunk`` per window and session, as the reference's senders
do (batching a drain's senders would change the EWMV rounding, and with it
the piece boundaries).

Pacing: ``rate=0`` replays as fast as the service drains; ``rate=r``
paces drains against the trace clock scaled by ``r`` (1.0 = real time).
Pacing changes wall time, never batch composition.

Queue depth is measured at the drain boundary (windows staged since the
last service call), eviction rate and totals come from the server, and
per-symbol latency comes from the ``repro_torch.obs`` histogram the service
records -- the SLO keys in ``repro_torch.workload.slo`` map 1:1 onto
:meth:`ReplayResult.measured`.

``verify`` holds each closed session's concatenated deltas to the one-shot
``symed_encode`` of the points it ingested by the rule of
``launch.transport.check_deltas``: ``n_pieces`` equal, endpoints bitwise,
and every symbol equal on the CPU, at least 99% on CUDA (where labels
follow the Lloyd kernel's order of summation).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.workload.trace import Trace

__all__ = ["ReplayResult", "replay_trace", "LOOSE_COUNTER_KEYS"]

#: counters that socket scheduling cannot perturb (transport fingerprint)
LOOSE_COUNTER_KEYS = ("opened", "closed", "evicted", "points_in",
                      "symbols_out")


def _default_cfg():
    from repro_torch.core.symed import SymEDConfig
    return SymEDConfig(tol=0.5, alpha=0.01, n_max=256, k_max=32, len_max=256)


@dataclasses.dataclass
class ReplayResult:
    """One replay's measurements, identity, and per-session outcomes."""
    trace_name: str
    trace_digest: str
    seed: int
    transport: bool
    wall_seconds: float
    counters: Dict[str, float]
    queue: Dict[str, float]
    latency: Dict[str, float]
    delta_sha256: str
    sessions: Dict[str, dict]
    closed: Dict[str, dict] = dataclasses.field(default_factory=dict)
    verified: int = -1

    @property
    def evict_rate(self) -> float:
        return self.counters.get("evicted", 0.0) / max(
            self.counters.get("opened", 0.0), 1.0)

    def measured(self) -> Dict[str, float]:
        """The flat measurement map the SLO layer checks (slo.KNOWN_SLOS)."""
        return {
            "p50_symbol_ms": self.latency.get("p50_ms", 0.0),
            "p99_symbol_ms": self.latency.get("p99_ms", 0.0),
            "p999_symbol_ms": self.latency.get("p999_ms", 0.0),
            "max_queue_depth": self.queue.get("max_depth", 0.0),
            "mean_queue_depth": self.queue.get("mean_depth", 0.0),
            "evict_rate": self.evict_rate,
        }

    def fingerprint(self) -> str:
        """Replay identity for the determinism battery.

        In-process: the delta-stream hash plus *every* counter total.
        Over transport: only the schedule-determined counter subset
        (socket coalescing legitimately perturbs step/frame counts).
        """
        if self.transport:
            counters = {k: self.counters.get(k, 0.0)
                        for k in LOOSE_COUNTER_KEYS}
        else:
            counters = dict(self.counters)
        payload = json.dumps(
            {"delta_sha256": self.delta_sha256, "counters": counters},
            sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(payload.encode("utf-8")).hexdigest()


def _slice_window(data: np.ndarray, row: int, ref: int, window: int,
                  length: int) -> np.ndarray:
    lo = ref * window
    return data[row, lo: min(lo + window, length)]


def _delta_sha256(sids, deltas, closed) -> str:
    """Order-independent hash of every session's concatenated delta stream."""
    h = hashlib.sha256()
    for sid in sorted(sids):
        labels = [np.asarray(d["labels"], np.int32)
                  for d in deltas.get(sid, [])]
        endpoints = [np.asarray(d["endpoints"], np.float32)
                     for d in deltas.get(sid, [])]
        res = closed.get(sid)
        if res is not None:
            labels.append(np.asarray(res["delta"]["labels"], np.int32))
            endpoints.append(
                np.asarray(res["delta"]["endpoints"], np.float32))
        lab = np.concatenate(labels) if labels else np.zeros((0,), np.int32)
        eps = (np.concatenate(endpoints) if endpoints
               else np.zeros((0,), np.float32))
        h.update(sid.encode("utf-8"))
        h.update(lab.tobytes())
        h.update(eps.tobytes())
    return h.hexdigest()


def _check_session(sid, fed, labels, endpoints, result, cfg, seed,
                   device) -> None:
    """``launch.transport.check_deltas`` on the points ``sid`` ingested."""
    import torch

    from repro_torch.launch.transport import check_deltas

    fed = np.concatenate(fed)
    if len(fed) != result["t_seen"]:
        raise AssertionError(f"{sid}: fed {len(fed)} points, the server saw "
                             f"{result['t_seen']}")
    check_deltas(sid, np.asarray(labels, np.int32),
                 np.asarray(endpoints, np.float32), result,
                 torch.from_numpy(fed).to(device), cfg, seed,
                 1.0 if device.type == "cpu" else 0.99)


class _PieceSender:
    """Sender-side compressor for an in-process pieces-mode session
    (the ``SenderClient`` arithmetic without the socket), on ``device``."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.device = device
        self.state = None
        self.t0 = 0.0
        self.t_seen = 0

    def compress(self, window: np.ndarray):
        from repro_torch.core.compress import pieces_on_wire
        from repro_torch.core.symed import symed_encode_chunk

        if self.state is None and self.t_seen == 0:
            self.t0 = float(window[0])
        self.state, events = symed_encode_chunk(
            window, self.cfg, self.state, device=self.device)
        endpoints, steps = pieces_on_wire(events, self.t_seen)
        self.t_seen += len(window)
        return endpoints, steps

    def tail(self):
        from repro_torch.core.compress import compressor_finalize

        if self.state is None:
            return None
        t = compressor_finalize(self.state)
        return float(t.endpoint) if bool(t.emit) else None


class _InProcess:
    """Drain adapter driving a ``StreamServer`` directly."""

    def __init__(self, trace: Trace, cfg, server, data: np.ndarray):
        from repro_torch.core import prng
        from repro_torch.core.receiver import PIECE_TUPLE_BYTES
        from repro_torch.launch.transport import session_seed

        self._prng = prng
        self._piece_bytes = PIECE_TUPLE_BYTES
        self._session_seed = session_seed
        self.trace = trace
        self.cfg = cfg
        self.server = server
        self.data = data
        self.deltas: Dict[str, List[dict]] = {}
        self.closed: Dict[str, dict] = {}
        self.fed: Dict[str, List[np.ndarray]] = {}
        self._senders: Dict[str, _PieceSender] = {}

    def _terminated(self, sid: str) -> bool:
        return sid in self.closed or sid in self.server.evicted

    def drain(self, events) -> None:
        trace = self.trace
        staged: Dict[str, List[np.ndarray]] = {}
        closes: List[str] = []
        for ev in events:
            if self._terminated(ev.sid):
                continue  # eviction drops the stream's remainder
            if ev.kind == "open":
                meta = trace.sessions[ev.sid]
                key = self._prng.key(self._session_seed(ev.sid, trace.seed),
                                     self.server.device)
                self.server.open(ev.sid, key=key)
                if meta["mode"] == "pieces":
                    self._senders[ev.sid] = _PieceSender(
                        self.cfg, self.server.device)
            elif ev.kind == "data":
                win = _slice_window(
                    self.data, trace.sessions[ev.sid]["stream"],
                    ev.window_ref, trace.window, trace.length)
                staged.setdefault(ev.sid, []).append(win)
            else:
                closes.append(ev.sid)
        # opening a session may LRU-evict one staged earlier this drain
        raw_batch: Dict[str, np.ndarray] = {}
        pieces_batch: Dict[str, dict] = {}
        for sid, wins in staged.items():
            if sid not in self.server:
                continue
            self.fed.setdefault(sid, []).extend(wins)
            sender = self._senders.get(sid)
            if sender is None:
                raw_batch[sid] = (np.concatenate(wins) if len(wins) > 1
                                  else wins[0])
            else:
                eps, steps, wire = [], [], 0.0
                for w in wins:
                    e, s = sender.compress(w)
                    eps.append(e)
                    steps.append(s)
                    wire += 12.0 + self._piece_bytes * len(e)
                pieces_batch[sid] = {
                    "endpoints": (np.concatenate(eps) if eps
                                  else np.zeros((0,), np.float32)),
                    "steps": (np.concatenate(steps) if steps
                              else np.zeros((0,), np.int32)),
                    "t_seen": sender.t_seen, "t0": sender.t0,
                    "wire_bytes": wire,
                }
        # a closing pieces session ships its sender tail in the same drain
        # (the transport loop's CLOSE handling)
        for sid in closes:
            sender = self._senders.get(sid)
            if sender is None or sid not in self.server:
                continue
            tail = sender.tail()
            if tail is None:
                continue
            p = pieces_batch.setdefault(sid, {
                "endpoints": np.zeros((0,), np.float32),
                "steps": np.zeros((0,), np.int32),
                "t_seen": sender.t_seen, "t0": sender.t0, "wire_bytes": 0.0,
            })
            p["endpoints"] = np.concatenate(
                [p["endpoints"], np.asarray([tail], np.float32)])
            p["steps"] = np.concatenate(
                [p["steps"], np.asarray([sender.t_seen], np.int32)])
            p["wire_bytes"] += 4.0
        if raw_batch:
            for sid, d in self.server.ingest_many(raw_batch).items():
                self.deltas.setdefault(sid, []).append(d)
        if pieces_batch:
            for sid, d in self.server.ingest_pieces_many(
                    pieces_batch).items():
                self.deltas.setdefault(sid, []).append(d)
        for sid in closes:
            if sid in self.server:
                self.closed[sid] = self.server.close(sid)

    def finish(self):
        self.closed.update(self.server.evicted)
        sids = set(self.trace.sessions)
        delta_sha = _delta_sha256(sids, self.deltas, self.closed)
        sessions = {}
        for sid in sorted(sids):
            res = self.closed.get(sid)
            sessions[sid] = {
                "t_seen": int(res["t_seen"]) if res else 0,
                "n_pieces": int(res["n_pieces"]) if res else 0,
                "evicted": sid in self.server.evicted,
                "dtw": (res or {}).get("dtw"),
            }
        return delta_sha, sessions

    def verify(self) -> int:
        """``check_deltas`` on each closed session's delta concatenation
        over the windows it actually ingested.

        Evicted *pieces-mode* sessions are skipped: the sender's unfinished
        tail piece is legitimately lost at eviction, so no whole-stream
        reference exists for them (raw-mode evictions verify fine -- the
        receiver's own compressor flushes its tail over the ingested
        prefix).
        """
        checked = 0
        for sid in sorted(self.closed):
            if sid not in self.trace.sessions:
                continue
            res = self.closed[sid]
            if not res["t_seen"]:
                continue
            if sid in self.server.evicted and sid in self._senders:
                continue
            parts = self.deltas.get(sid, []) + [res["delta"]]
            _check_session(
                sid, self.fed[sid],
                np.concatenate([np.asarray(d["labels"], np.int32)
                                for d in parts]),
                np.concatenate([np.asarray(d["endpoints"], np.float32)
                                for d in parts]),
                res, self.cfg, self._session_seed(sid, self.trace.seed),
                self.server.device)
            checked += 1
        return checked


class _OverTransport:
    """Drain adapter driving a loopback ``TransportServer`` + one
    ``SenderClient`` socket carrying every session; the client compresses
    on the server's device."""

    def __init__(self, trace: Trace, cfg, server, data: np.ndarray,
                 close_timeout: float):
        from repro_torch.launch.transport import (
            SenderClient, TransportServer, session_seed)

        self._session_seed = session_seed
        self.trace = trace
        self.cfg = cfg
        self.server = server
        self.data = data
        self.close_timeout = close_timeout
        self.transport = TransportServer(server, host="127.0.0.1", port=0)
        self.thread = threading.Thread(
            target=self.transport.serve,
            kwargs={"expect_sessions": len(trace.sessions)}, daemon=True)
        self.thread.start()
        self.client = SenderClient(
            "127.0.0.1", self.transport.port, cfg, mode="raw",
            reply_timeout=close_timeout, device=server.device)
        self.results: Dict[str, dict] = {}
        self.fed: Dict[str, List[np.ndarray]] = {}

    def drain(self, events) -> None:
        trace = self.trace
        for ev in events:
            if self.client.settled(ev.sid):
                continue  # receiver already closed it (eviction)
            meta = trace.sessions[ev.sid]
            if ev.kind == "open":
                self.client.open(ev.sid,
                                 self._session_seed(ev.sid, trace.seed),
                                 mode=meta["mode"])
            elif ev.kind == "data":
                win = _slice_window(self.data, meta["stream"], ev.window_ref,
                                    trace.window, trace.length)
                self.fed.setdefault(ev.sid, []).append(win)
                self.client.send(ev.sid, win)
            else:
                self.results[ev.sid] = self.client.close(ev.sid)

    def finish(self):
        # every session settles via close() or a parked eviction CLOSED;
        # sids whose trace close was skipped (settled mid-run) still hold
        # their parked result
        for sid in self.trace.sessions:
            if sid not in self.results:
                self.results[sid] = self.client.close(sid)
        self.thread.join(timeout=self.close_timeout)
        if self.thread.is_alive():
            raise RuntimeError("the transport server did not exit after "
                               "every session closed")
        deltas = {}
        for sid in self.results:
            labels, endpoints = self.client.delta_concat(sid)
            deltas[sid] = [{"labels": labels, "endpoints": endpoints}]
        # no separate closing frame: delta_concat already folds it in
        delta_sha = _delta_sha256(set(self.trace.sessions), deltas, {})
        sessions = {
            sid: {"t_seen": int(res["t_seen"]),
                  "n_pieces": int(res["n_pieces"]),
                  "evicted": bool(res["evicted"]), "dtw": None}
            for sid, res in sorted(self.results.items())
        }
        self.client.shutdown()
        return delta_sha, sessions

    def verify(self) -> int:
        """``check_deltas`` on each cleanly-closed session's returned deltas
        (evicted sessions skip: in-flight frames make the ingested prefix
        racy by design)."""
        checked = 0
        for sid in sorted(self.results):
            res = self.results[sid]
            if res["evicted"] or not res["t_seen"]:
                continue
            _check_session(sid, self.fed[sid],
                           *self.client.delta_concat(sid), res, self.cfg,
                           self._session_seed(sid, self.trace.seed),
                           self.server.device)
            checked += 1
        return checked


def replay_trace(trace: Trace, *, cfg=None, server=None,
                 server_kw: Optional[dict] = None, obs=None,
                 rate: float = 0.0, transport: bool = False,
                 verify: bool = False, close_timeout: float = 300.0,
                 device=None) -> ReplayResult:
    """Replay ``trace``; returns the measured :class:`ReplayResult`.

    ``server`` reuses a caller-built ``StreamServer`` (the stream CLI path:
    its obs wiring stays in charge, and it sets the device); otherwise one
    is constructed from ``server_kw`` (scenario defaults) with
    ``window_cap=trace.window`` on ``device`` (``cuda`` unless ``"cpu"``);
    a ``"mesh"`` in ``server_kw`` shards its slot table (``device``, if
    given, must name the mesh's devices' kind).
    """
    from repro_torch.data.synthetic import make_fleet

    if cfg is None:
        cfg = _default_cfg()
    if server is None:
        from repro_torch.launch.stream import StreamServer
        from repro_torch.obs import Observability

        kw = {"max_sessions": 8, **(server_kw or {})}
        kw.setdefault("window_cap", trace.window)
        if obs is None:
            obs = Observability()
        server = StreamServer(cfg, obs=obs, device=device, **kw)
    obs = server.obs
    data = make_fleet(trace.n_streams, trace.length, seed=trace.seed)

    h_depth = obs.metrics.histogram(
        "workload_queue_depth", "windows staged per service drain", unit="")
    if transport:
        backend = _OverTransport(trace, cfg, server, data, close_timeout)
    else:
        backend = _InProcess(trace, cfg, server, data)

    service = trace.service_every_ms
    depth_max = 0
    depth_sum = 0
    drains = 0
    t0 = time.perf_counter()
    for bucket, group in itertools.groupby(
            trace.ticks(), key=lambda kv: kv[0] // service):
        events = [ev for _, evs in group for ev in evs]
        if rate > 0.0:
            target = t0 + ((bucket + 1) * service) / (1e3 * rate)
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
        depth = sum(1 for ev in events if ev.kind == "data")
        h_depth.observe(depth)
        depth_max = max(depth_max, depth)
        depth_sum += depth
        drains += 1
        backend.drain(events)
    delta_sha, sessions = backend.finish()
    wall = time.perf_counter() - t0

    snap = obs.snapshot()
    lat = snap.get("histograms", {}).get("symed_symbol_latency_seconds", {})
    latency = {
        "p50_ms": 1e3 * float(lat.get("p50", 0.0)),
        "p99_ms": 1e3 * float(lat.get("p99", 0.0)),
        "p999_ms": 1e3 * float(lat.get("p999", 0.0)),
        "mean_ms": 1e3 * float(lat.get("mean", 0.0)),
        "count": float(lat.get("count", 0.0)),
    }
    counts = trace.counts()
    queue = {
        "max_depth": float(depth_max),
        "mean_depth": depth_sum / max(drains, 1),
        "drains": float(drains),
        "events": float(counts["events"]),
        "windows": float(counts["windows"]),
    }
    result = ReplayResult(
        trace_name=trace.name,
        trace_digest=trace.digest(),
        seed=trace.seed,
        transport=transport,
        wall_seconds=wall,
        counters={k: float(v) for k, v in server.totals.items()},
        queue=queue,
        latency=latency,
        delta_sha256=delta_sha,
        sessions=sessions,
        closed=getattr(backend, "closed", {}),
    )
    if verify:
        result.verified = backend.verify()
    return result
