"""The port's flight recorder (``repro_torch.obs``) against the reference's.

The cases of ``tests/test_obs.py``, on the port: the log-bucket scheme,
histogram quantiles against numpy, the span ring and its Chrome trace
schema, the registry, and the Prometheus text, which must equal the
reference's byte for byte for one fixed sequence of registry operations.
Then the wiring: a loopback ``TransportServer`` of the port scraped over
HTTP agrees with the server's own report, ``obs=False`` changes no delta,
and two servers never collide on their callback series.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import json
import threading
import urllib.request

import numpy as np
import pytest

from conftest import make_stream

from repro.obs import Observability as RefObservability
from repro.obs.export import prometheus_text as ref_prometheus_text
from repro.obs.metrics import bucket_bounds as ref_bucket_bounds
from repro.obs.metrics import bucket_index as ref_bucket_index
from repro_torch.core.symed import SymEDConfig
from repro_torch.launch.stream import StreamServer
from repro_torch.launch.transport import (
    SenderClient, TransportServer, session_seed,
)
from repro_torch.obs import Observability, annotate, as_obs, disabled
from repro_torch.obs.export import (
    PROM_CONTENT_TYPE, ObsHTTPServer, prometheus_text,
)
from repro_torch.obs.metrics import (
    N_BUCKETS, NULL_INSTRUMENT, Histogram, MetricsRegistry, bucket_bounds,
    bucket_index,
)
from repro_torch.obs.tracing import SpanTracer

CFG = SymEDConfig(tol=0.5, alpha=0.02, scl=1.0, k_min=3, k_max=8,
                  len_max=32, n_max=64, lloyd_iters=5)


# ------------------------------------------------------------- bucket scheme


class TestBuckets:
    def test_bounds_partition_the_line(self):
        prev_hi = 0
        for i in range(2048):
            lo, hi = bucket_bounds(i)
            assert lo == prev_hi, i
            assert hi > lo, i
            assert bucket_index(lo) == i
            assert bucket_index(hi - 1) == i
            assert bucket_index(hi) == i + 1
            prev_hi = hi

    def test_index_monotone_and_value_in_bounds(self):
        rng = np.random.default_rng(42)
        vals = sorted(int(v) for v in
                      np.concatenate([rng.integers(0, 1 << b, size=64)
                                      for b in (4, 10, 20, 32, 48, 62)]))
        prev = -1
        for v in vals:
            i = bucket_index(v)
            lo, hi = bucket_bounds(i)
            assert lo <= v < hi
            assert i >= prev
            prev = i

    def test_relative_width_bound(self):
        for i in range(4, 2048):
            lo, hi = bucket_bounds(i)
            assert (hi - lo) * 4 <= lo

    def test_covers_64bit_nanoseconds(self):
        assert bucket_index((1 << 63) - 1) < N_BUCKETS

    def test_same_buckets_as_the_reference(self):
        rng = np.random.default_rng(1)
        for v in rng.integers(0, 1 << 62, size=2000):
            assert bucket_index(int(v)) == ref_bucket_index(int(v))
        for i in range(N_BUCKETS):
            assert bucket_bounds(i) == ref_bucket_bounds(i)


# ---------------------------------------------------------------- histogram


class TestHistogram:
    def test_quantiles_vs_numpy(self):
        rng = np.random.default_rng(7)
        samples = np.exp(rng.normal(12.0, 1.2, size=20000)).astype(np.int64)
        h = Histogram("t", unit="ns")
        for v in samples:
            h.observe(int(v))
        for q in (0.5, 0.9, 0.99, 0.999):
            got = h.quantile(q)
            want = float(np.quantile(samples, q))
            assert abs(got - want) / want < 0.15, (q, got, want)

    def test_empty_and_single(self):
        h = Histogram("t")
        assert h.quantile(0.5) == 0.0
        assert h.mean == 0.0
        h.observe(1000)
        lo, hi = bucket_bounds(bucket_index(1000))
        assert h.quantile(0.5) == (lo + hi) / 2.0
        assert h.quantile(0.999) == (lo + hi) / 2.0
        assert h.count == 1 and h.total == 1000

    def test_observe_n_equals_repeated_observe(self):
        a, b = Histogram("a"), Histogram("b")
        for v in (3, 77, 1 << 20):
            a.observe_n(v, 5)
            for _ in range(5):
                b.observe(v)
        assert a.buckets == b.buckets
        assert (a.count, a.total) == (b.count, b.total)
        a.observe_n(123, 0)
        assert a.count == b.count

    def test_negative_clamped_to_zero(self):
        h = Histogram("t")
        h.observe(-5)
        assert h.buckets[0] == 1 and h.total == 0


# ---------------------------------------------------------------- span ring


class TestSpanRing:
    def test_wraparound_keeps_newest_oldest_first(self):
        tr = SpanTracer(capacity=8)
        for i in range(20):
            tr.instant(f"ev{i}")
        assert tr.recorded == 20
        assert tr.dropped == 12
        evs = tr.events()
        assert [e[0] for e in evs] == [f"ev{i}" for i in range(12, 20)]
        ts = [e[2] for e in evs]
        assert ts == sorted(ts)

    def test_under_capacity_no_drops(self):
        tr = SpanTracer(capacity=8)
        for i in range(5):
            tr.instant(f"ev{i}")
        assert tr.dropped == 0
        assert [e[0] for e in tr.events()] == [f"ev{i}" for i in range(5)]

    def test_disabled_records_nothing(self):
        tr = SpanTracer(capacity=8, enabled=False)
        tr.instant("x")
        tr.add("y", 0)
        with tr.span("z"):
            pass
        assert tr.recorded == 0 and tr.events() == []

    def test_span_context_manager(self):
        tr = SpanTracer(capacity=8)
        with tr.span("work", {"k": 1}):
            pass
        (name, ph, _, dur, args), = tr.events()
        assert (name, ph, args) == ("work", "X", {"k": 1})
        assert dur >= 0

    def test_chrome_trace_schema(self, tmp_path):
        tr = SpanTracer(capacity=16, pid=7)
        t0 = tr._t0_ns
        tr.add_span("dispatch", t0 + 1000, t0 + 51000, {"rounds": 2})
        tr.instant("grow", {"capacity": 4})
        path = tmp_path / "trace.json"
        tr.write(str(path), tid=3)
        doc = json.loads(path.read_text())
        assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
        assert doc["otherData"]["dropped_events"] == 0
        evs = doc["traceEvents"]
        assert len(evs) == 2
        for ev in evs:
            assert {"name", "ph", "ts", "pid", "tid"} <= set(ev)
            assert (ev["pid"], ev["tid"]) == (7, 3)
            assert ev["ts"] >= 0.0
        span, instant = evs
        assert span["ph"] == "X" and span["dur"] == pytest.approx(50.0)
        assert span["ts"] == pytest.approx(1.0)
        assert span["args"] == {"rounds": 2}
        assert instant["ph"] == "i" and instant["s"] == "t"

    def test_annotate_lands_in_a_torch_profile(self):
        """``annotate`` is a ``torch.profiler`` range: inside a profile its
        name shows among the recorded events."""
        import torch

        with annotate("symed.table_step"):
            pass  # no profiler: a plain context manager
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with annotate("symed.table_step"):
                torch.ones(4).sum()
        assert "symed.table_step" in {e.key for e in prof.key_averages()}

    def test_torch_annotate_is_off_by_default(self):
        assert not Observability().torch_annotate
        assert Observability(torch_annotate=True).torch_annotate
        assert not Observability(enabled=False, torch_annotate=True) \
            .torch_annotate


# ----------------------------------------------------------------- registry


class TestRegistry:
    def test_value_instruments_get_or_create(self):
        m = MetricsRegistry()
        c1 = m.counter("x_total", "help")
        c2 = m.counter("x_total")
        assert c1 is c2
        assert m.counter("x_total", labels={"mode": "raw"}) is not c1

    def test_kind_mismatch_raises(self):
        m = MetricsRegistry()
        m.counter("x_total")
        with pytest.raises(ValueError, match="already registered"):
            m.gauge("x_total")

    def test_callback_duplicates_refused(self):
        m = MetricsRegistry()
        m.counter_fn("cb_total", "h", lambda: 1.0)
        with pytest.raises(ValueError, match="already registered"):
            m.counter_fn("cb_total", "h", lambda: 2.0)

    def test_disabled_registry_hands_out_null(self):
        m = MetricsRegistry(enabled=False)
        h = m.histogram("t")
        assert h is NULL_INSTRUMENT
        h.observe(5)
        assert m.counter_fn("c", "h", lambda: 1.0) is NULL_INSTRUMENT
        assert m.instruments() == []

    def test_snapshot_shape_and_units(self):
        m = MetricsRegistry()
        m.counter("c_total").inc(3)
        m.gauge("g").set(1.5)
        h = m.histogram("lat_seconds", unit="ns")
        h.observe(2_000_000)
        snap = m.snapshot()
        assert snap["counters"] == {"c_total": 3.0}
        assert snap["gauges"] == {"g": 1.5}
        d = snap["histograms"]["lat_seconds"]
        assert d["count"] == 1.0
        assert d["sum"] == pytest.approx(2e-3)
        assert 1e-3 < d["p50"] < 4e-3


# --------------------------------------------------------------- exposition


def _operate(obs):
    """One fixed sequence of registry operations (every instrument kind,
    labels, callbacks, units) on either package's ``Observability``."""
    m = obs.metrics
    m.counter("req_total", "requests", labels={"mode": "raw"}).inc(4)
    m.counter("req_total", "requests", labels={"mode": "pieces"}).inc(2.5)
    m.gauge("conns", "open connections").set(2)
    m.gauge("temp", "a gauge that goes down").dec(0.125)
    state = {"n": 7}
    m.counter_fn("cb_total", "callback counter", lambda: float(state["n"]))
    m.gauge_fn("cb_gauge", "callback gauge", lambda: 1e16)
    h = m.histogram("lat_seconds", "latency", unit="ns")
    rng = np.random.default_rng(11)
    for v in rng.integers(0, 1 << 34, size=300):
        h.observe(int(v))
    h.observe_n(123456, 9)
    q = m.histogram("depth", "queue depth", unit="")
    for v in (0, 1, 1, 5, 64, 3):
        q.observe(v)
    m.histogram("empty_seconds", "no samples", unit="ms")
    state["n"] = 9
    return obs


class TestPrometheus:
    def test_exposition_format(self):
        m = MetricsRegistry()
        m.counter("req_total", "requests", labels={"mode": "raw"}).inc(4)
        m.gauge("conns", "open connections").set(2)
        h = m.histogram("lat_seconds", "latency", unit="ns")
        for v in (100, 100, 5000, 90000):
            h.observe(v)
        lines = prometheus_text(m).splitlines()
        assert "# TYPE req_total counter" in lines
        assert 'req_total{mode="raw"} 4' in lines
        assert "# TYPE conns gauge" in lines
        assert "conns 2" in lines
        assert "# HELP lat_seconds latency" in lines
        assert "# TYPE lat_seconds histogram" in lines
        assert "lat_seconds_count 4" in lines
        for q in ("p50", "p99", "p999"):
            assert any(line.startswith(f"lat_seconds_{q} ") for line in lines)

    def test_buckets_cumulative_and_inf_equals_count(self):
        m = MetricsRegistry()
        h = m.histogram("lat_seconds", unit="ns")
        rng = np.random.default_rng(3)
        for v in rng.integers(1, 1 << 30, size=500):
            h.observe(int(v))
        cums, les = [], []
        for line in prometheus_text(m).splitlines():
            if not line.startswith("lat_seconds_bucket"):
                continue
            lbl, val = line.rsplit(" ", 1)
            cums.append(int(val))
            le = lbl.split('le="', 1)[1].rstrip('"}')
            les.append(float("inf") if le == "+Inf" else float(le))
        assert cums == sorted(cums)
        assert les == sorted(les)
        assert cums[-1] == 500 and les[-1] == float("inf")

    def test_text_byte_equal_to_the_reference(self):
        mine = _operate(Observability())
        theirs = _operate(RefObservability())
        text = prometheus_text(mine.metrics)
        assert text.encode() == ref_prometheus_text(theirs.metrics).encode()
        assert "cb_total 9" in text.splitlines()
        assert mine.snapshot() == theirs.snapshot()


# -------------------------------------------------- loopback serving scrape


def _http_get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.headers.get("Content-Type"), resp.read().decode()


def _prom_value(text, series):
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"series {series!r} not in exposition:\n{text}")


class TestServingIntegration:
    def test_loopback_scrape_matches_report(self, rng):
        """Real senders over a socket to the port's ``TransportServer`` on
        the CPU; ``/metrics`` scraped over HTTP agrees with the server's
        report and the transport's counts."""
        obs = Observability(trace_capacity=256)
        stream = StreamServer(CFG, max_sessions=4, window_cap=32,
                              device="cpu", obs=obs)
        transport = TransportServer(stream, port=0)
        streams = {f"obs-{i}": make_stream(rng, 96) for i in range(3)}
        thread = threading.Thread(
            target=transport.serve, kwargs={"expect_sessions": len(streams)},
            daemon=True)
        thread.start()
        exporter = ObsHTTPServer(obs, port=0)
        client = SenderClient("127.0.0.1", transport.port, CFG, mode="raw",
                              device="cpu")
        try:
            for sid, ts in streams.items():
                client.open(sid, session_seed(sid, 5))
                client.send(sid, ts)
            results = {sid: client.close(sid) for sid in streams}
            assert all(r["t_seen"] == 96 for r in results.values())
            ctype, text = _http_get(exporter.url + "/metrics")
            assert ctype == PROM_CONTENT_TYPE
            snap = json.loads(_http_get(exporter.url + "/metrics.json")[1])
            trace = json.loads(_http_get(exporter.url + "/trace")[1])
        finally:
            client.shutdown()
            exporter.close()
            thread.join(timeout=60)
        assert not thread.is_alive(), "transport server failed to exit"

        n = len(streams)
        rep = stream.report(wall_seconds=1.0)
        assert _prom_value(text, "symed_points_in_total") == rep["points_in"]
        assert _prom_value(text, "symed_symbols_out_total") \
            == rep["symbols_out"]
        assert _prom_value(text, "symed_frames_out_total") == rep["frames_out"]
        assert _prom_value(text, "symed_sessions_opened_total") == n
        assert _prom_value(text, "symed_sessions_closed_total") == n
        assert _prom_value(text, 'transport_frames_in_total{type="open"}') == n
        assert _prom_value(text,
                           'transport_frames_in_total{type="close"}') == n
        assert _prom_value(text, "transport_sessions_closed_total") == n
        assert _prom_value(text, 'transport_frames_in_total{type="data"}') > 0
        assert _prom_value(text, "transport_rx_bytes_total") \
            == transport.frame_bytes > 0
        assert _prom_value(text, "transport_tx_bytes_total") > 0
        lat_count = _prom_value(text, "symed_symbol_latency_seconds_count")
        assert 0 < lat_count <= rep["symbols_out"]
        assert _prom_value(text, "symed_symbol_latency_seconds_p99") > 0.0
        assert rep["obs"]["counters"]["symed_points_in_total"] \
            == snap["counters"]["symed_points_in_total"]
        assert snap["histograms"]["symed_symbol_latency_seconds"]["p99"] > 0
        assert snap["spans_recorded"] > 0
        names = {ev["name"] for ev in trace["traceEvents"]}
        assert {"stream.dispatch", "stream.harvest", "transport.decode",
                "transport.route"} <= names

    def test_disabled_obs_is_inert_and_bitwise_identical(self, rng):
        """obs=False changes no delta, raw in or compressed in, and adds no
        report key."""
        ts = make_stream(rng, 96)
        pieces = {"endpoints": [0.5, -0.25, 1.0, 0.75],
                  "steps": [4, 9, 15, 30], "t_seen": 32, "t0": 0.0}
        outs = {}
        for flag in (True, False):
            srv = StreamServer(CFG, max_sessions=2, window_cap=32,
                               device="cpu", obs=flag, pretrace=True)
            srv.open("s0")
            srv.open("p0")
            raw = srv.ingest("s0", ts)
            pcs = srv.ingest_pieces_many({"p0": pieces})["p0"]
            outs[flag] = (raw, pcs, srv.close("s0"), srv.close("p0"))
            rep = srv.report(wall_seconds=1.0)
            if flag:
                assert "obs" in rep
                assert rep["obs"]["histograms"][
                    "symed_symbol_latency_seconds"]["count"] > 0
            else:
                assert "obs" not in rep
                assert not srv.obs.enabled and srv.obs is disabled()
        for a, b in zip(outs[True][:2], outs[False][:2]):
            np.testing.assert_array_equal(a["labels"], b["labels"])
            np.testing.assert_array_equal(a["endpoints"], b["endpoints"])
        for a, b in zip(outs[True][2:], outs[False][2:]):
            np.testing.assert_array_equal(a["delta"]["labels"],
                                          b["delta"]["labels"])
            np.testing.assert_array_equal(a["delta"]["endpoints"],
                                          b["delta"]["endpoints"])
            assert a["symbols"] == b["symbols"]

    def test_as_obs_normalization(self):
        bundle = Observability()
        assert as_obs(bundle) is bundle
        assert as_obs(False) is disabled()
        fresh_a, fresh_b = as_obs(None), as_obs(True)
        assert fresh_a.enabled and fresh_b.enabled
        assert fresh_a is not fresh_b

    def test_two_servers_never_collide_on_callbacks(self):
        a = StreamServer(CFG, max_sessions=2, window_cap=32, device="cpu")
        b = StreamServer(CFG, max_sessions=2, window_cap=32, device="cpu")
        assert a.obs is not b.obs
        shared = Observability()
        StreamServer(CFG, max_sessions=2, window_cap=32, device="cpu",
                     obs=shared)
        with pytest.raises(ValueError, match="already registered"):
            StreamServer(CFG, max_sessions=2, window_cap=32, device="cpu",
                         obs=shared)

    def test_retraces_count_first_steps_after_init(self, rng):
        """``symed_table_retraces_total``: each (mode, capacity) pair first
        stepped after construction counts once, with a ``stream.retrace``
        instant; under ``pretrace`` it stays 0 through grows and shrinks."""
        ts = make_stream(rng, 64)
        counts = {}
        for pretrace in (False, True):
            srv = StreamServer(CFG, max_sessions=4, min_slots=1,
                               autoscale=True, shrink_patience=1,
                               window_cap=32, device="cpu",
                               pretrace=pretrace)
            for i in range(3):  # grows 1 -> 2 -> 4
                srv.open(f"s{i}")
                srv.ingest(f"s{i}", ts)
            srv.ingest("s0", ts)
            for i in range(3):
                srv.close(f"s{i}")
            snap = srv.report(1.0)["obs"]
            counts[pretrace] = snap["counters"]["symed_table_retraces_total"]
            names = [e[0] for e in srv.obs.tracer.events()]
            assert names.count("stream.retrace") == counts[pretrace]
            assert srv.totals["grows"] == 2 and srv.totals["shrinks"] >= 1
        assert counts == {False: 3.0, True: 0.0}
