"""The port's stream and transport CLIs (``repro_torch.launch.stream``,
``repro_torch.launch.transport``) reject what the reference's reject: exit
2 and the same message, from the shared surface ``repro_torch.launch.cli``
before any torch work.  The messages are pinned here letter for letter;
where JAX is installed each is also held against the reference's parser,
run in this process.  The stream CLI's trace-driven runs print the
reference's ``stream_summary`` line and an ``obs_summary`` line with the
reference's keys; the transport's recorder flags reach its server.
``--devices`` shards the slot table (stream, transport, workload) or the
fleet slab (``repro_torch.launch.fleet``): host shards on the CPU, and the
counters and fingerprint do not depend on it."""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import json
import sys
import warnings

import pytest

from repro_torch.launch.fleet import main as port_fleet_main
from repro_torch.launch.stream import main as port_main
from repro_torch.launch.transport import main as port_transport_main

try:
    from repro.launch.fleet import main as reference_fleet_main
    from repro.launch.stream import main as reference_main
    from repro.launch.transport import main as reference_transport_main
except ImportError:
    reference_main = reference_transport_main = reference_fleet_main = None

# (flags, the message after "error: ")
CASES = {
    "tol 0": (["--tol", "0"], "--tol must be > 0, got 0.0"),
    "tol -1": (["--tol", "-1"], "--tol must be > 0, got -1.0"),
    "alpha 0": (["--alpha", "0"], "--alpha must be in (0, 1], got 0.0"),
    "alpha 1.5": (["--alpha", "1.5"], "--alpha must be in (0, 1], got 1.5"),
    "window 0": (["--window", "0"], "--window must be >= 1, got 0"),
    "window over length": (["--window", "500", "--length", "96"],
                           "--window 500 exceeds --length 96"),
    "length 1": (["--length", "1"], "--length must be >= 2, got 1"),
    "sessions 0": (["--sessions", "0"], "--sessions must be >= 1, got 0"),
    "digitize-every -1": (["--digitize-every", "-1"],
                          "--digitize-every must be >= 0, got -1"),
    "shrink-patience 0": (["--shrink-patience", "0"],
                          "--shrink-patience must be >= 1, got 0"),
    "max-slots 0": (["--max-slots", "0", "--evict"],
                    "--max-slots must be >= 1, got 0"),
    "min-slots 0": (["--min-slots", "0"],
                    "--min-slots 0 must be in [1, --max-slots 4]"),
    "min-slots over max-slots": (["--min-slots", "8"],
                                 "--min-slots 8 must be in [1, --max-slots 4]"),
    "sessions over max-slots": (["--sessions", "5"],
                                "--sessions 5 exceeds --max-slots 4; pass "
                                "--evict to allow LRU eviction"),
    "workload and arrival-pattern": (
        ["--workload", "bursty", "--arrival-pattern", "random"],
        "--workload and --arrival-pattern are mutually exclusive"),
    "metrics-port 70000": (["--metrics-port", "70000"],
                           "--metrics-port must be in [0, 65535], got 70000"),
    "metrics-linger -1": (["--metrics-linger", "-1"],
                          "--metrics-linger must be >= 0, got -1.0"),
    "devices 0": (["--devices", "0"], "--devices must be >= 1, got 0"),
    "max-slots over devices": (["--devices", "3"],
                               "--max-slots 4 must divide over --devices 3"),
    "min-slots over devices": (["--devices", "2", "--min-slots", "3"],
                               "--min-slots 3 must divide over --devices 2"),
}

# the transport CLI's (its --max-slots defaults to 8, its --length to 256)
TRANSPORT_CASES = {
    "streams 0": (["--streams", "0"], "--streams must be >= 1, got 0"),
    "streams -3": (["--send", "--streams", "-3"],
                   "--streams must be >= 1, got -3"),
    "min-slots 0": (["--serve", "--min-slots", "0"],
                    "--min-slots 0 must be in [1, --max-slots 8]"),
    "min-slots over max-slots": (["--min-slots", "5", "--max-slots", "4"],
                                 "--min-slots 5 must be in [1, --max-slots 4]"),
    "tol 0": (["--tol", "0"], "--tol must be > 0, got 0.0"),
    "alpha 1.5": (["--alpha", "1.5"], "--alpha must be in (0, 1], got 1.5"),
    "window 0": (["--window", "0"], "--window must be >= 1, got 0"),
    "window over length": (["--window", "300"],
                           "--window 300 exceeds --length 256"),
    "length 1": (["--length", "1"], "--length must be >= 2, got 1"),
    "digitize-every -1": (["--digitize-every", "-1"],
                          "--digitize-every must be >= 0, got -1"),
    "shrink-patience 0": (["--shrink-patience", "0"],
                          "--shrink-patience must be >= 1, got 0"),
    "max-slots 0": (["--max-slots", "0"], "--max-slots must be >= 1, got 0"),
    "metrics-port -1": (["--serve", "--metrics-port", "-1"],
                        "--metrics-port must be in [0, 65535], got -1"),
    "metrics-linger -2": (["--metrics-linger", "-2"],
                          "--metrics-linger must be >= 0, got -2.0"),
    "devices 3": (["--serve", "--devices", "3"],
                  "--max-slots 8 must divide over --devices 3"),
}


def _error(run, capsys):
    """Run a CLI that must exit 2; returns its message after "error: "."""
    with pytest.raises(SystemExit) as exc:
        run()
    assert exc.value.code == 2
    last = capsys.readouterr().err.strip().splitlines()[-1]
    return last.split("error: ", 1)[1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_exits_2_with_the_message(case, capsys):
    flags, message = CASES[case]
    assert _error(lambda: port_main(flags), capsys) == message


@pytest.mark.skipif(reference_main is None, reason="needs the JAX reference")
@pytest.mark.parametrize("case", sorted(CASES))
def test_same_message_as_the_reference(case, capsys, monkeypatch):
    flags, _ = CASES[case]
    got = _error(lambda: port_main(flags), capsys)
    monkeypatch.setattr(sys, "argv", ["stream", *flags])
    assert got == _error(reference_main, capsys)


@pytest.mark.parametrize("case", sorted(TRANSPORT_CASES))
def test_transport_exits_2_with_the_message(case, capsys):
    flags, message = TRANSPORT_CASES[case]
    assert _error(lambda: port_transport_main(flags), capsys) == message


@pytest.mark.skipif(reference_transport_main is None,
                    reason="needs the JAX reference")
@pytest.mark.parametrize("case", sorted(TRANSPORT_CASES))
def test_transport_same_message_as_the_reference(case, capsys, monkeypatch):
    flags, _ = TRANSPORT_CASES[case]
    got = _error(lambda: port_transport_main(flags), capsys)
    monkeypatch.setattr(sys, "argv", ["transport", *flags])
    assert got == _error(reference_transport_main, capsys)


@pytest.mark.parametrize("flags", [["--devices", "2"]])
def test_transport_rejects_flags_of_unported_parts(flags, capsys):
    """The sharded table is ported: ``--devices`` is taken, and a value
    the table does not divide over is refused with the reference's
    message."""
    message = _error(lambda: port_transport_main(
        [*flags, "--max-slots", "3", "--min-slots", "2"]), capsys)
    assert message == "--max-slots 3 must divide over --devices 2"


@pytest.mark.parametrize("cli", ["stream", "workload"])
def test_devices_unrecognized_until_the_fleet_is_ported(cli, capsys):
    """The fleet is ported: ``--devices`` is a flag of both CLIs, checked
    with the reference's message."""
    from repro_torch.workload.__main__ import main as workload_main

    run = {"stream": port_main, "workload": workload_main}[cli]
    message = _error(lambda: run(["--devices", "0"]), capsys)
    assert message == "--devices must be >= 1, got 0"


def _serve(flags, tmp_path, capsys):
    """``--serve`` on the CPU with no session to wait for: returns its
    stdout and the trace it wrote."""
    trace = tmp_path / "serve.json"
    assert port_transport_main(
        ["--serve", "--device", "cpu", "--expect-sessions", "0",
         "--max-slots", "4", "--autoscale", "--min-slots", "2",
         "--trace-out", str(trace), *flags]) == 0
    return capsys.readouterr().out, json.loads(trace.read_text())


def test_transport_trace_out_reaches_the_server(tmp_path, capsys):
    out, doc = _serve([], tmp_path, capsys)
    assert f"trace written           : {tmp_path / 'serve.json'}" in out
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
    assert "stream.pretrace" not in {ev["name"] for ev in doc["traceEvents"]}


def test_transport_pretrace_reaches_the_server(tmp_path, capsys):
    """Every rung of the 2..4 ladder is stepped at init."""
    _, doc = _serve(["--pretrace"], tmp_path, capsys)
    spans = [ev for ev in doc["traceEvents"] if ev["name"] == "stream.pretrace"]
    assert len(spans) == 1 and spans[0]["args"]["capacities"] == [2, 4]


def test_transport_metrics_port_reaches_the_server(tmp_path, capsys):
    out, _ = _serve(["--metrics-port", "0"], tmp_path, capsys)
    assert "metrics exporter        : http://127.0.0.1:" in out
    assert "lingering" not in out


def test_transport_metrics_linger_reaches_the_server(tmp_path, capsys):
    out, _ = _serve(["--metrics-port", "0", "--metrics-linger", "0.05"],
                    tmp_path, capsys)
    assert "metrics exporter        : lingering 0s for scrapes" in out


# the stream CLI's trace-driven runs, on a small fleet: (flags, deprecated)
RUNS = {
    "workload bursty, verify": (["--workload", "bursty", "--verify"], False),
    "workload diurnal, evict": (["--workload", "diurnal", "--evict",
                                 "--max-slots", "2"], False),
    "arrival-pattern random, pretrace, trace-out": (
        ["--arrival-pattern", "random", "--pretrace", "--autoscale",
         "--min-slots", "1"], True),
    "recorded jsonl": (None, False),
}
SMALL = ["--sessions", "3", "--length", "96", "--window", "48"]


def _lines(out, prefix):
    return [line for line in out.splitlines() if line.startswith(prefix)]


def _run_port(flags, deprecated, capsys):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rep = port_main(flags)
    warned = [w for w in caught if issubclass(w.category, DeprecationWarning)
              and "--arrival-pattern" in str(w.message)]
    assert bool(warned) == deprecated
    return rep, capsys.readouterr().out


def _flags(case, tmp_path):
    flags, _ = RUNS[case]
    if flags is None:  # a trace recorded by the port, replayed by both CLIs
        from repro_torch.workload import Workload

        path = tmp_path / "trace.jsonl"
        Workload("random", seed=3, sessions=3, length=96,
                 window=48).trace().save(str(path))
        flags = ["--workload", str(path)]
    return SMALL + flags


@pytest.mark.parametrize("case", sorted(RUNS))
def test_trace_driven_run(case, tmp_path, capsys):
    flags = _flags(case, tmp_path) + ["--trace-out", str(tmp_path / "t.json")]
    rep, out = _run_port(flags + ["--device", "cpu"], RUNS[case][1], capsys)
    assert int(rep["opened"]) == 3 and int(rep["points_in"]) > 0
    (obs,) = _lines(out, "obs_summary ")
    keys = [kv.split("=")[0] for kv in obs.split()[1:]]
    assert keys == ["symbol_p50_ms", "symbol_p99_ms", "symbol_p999_ms",
                    "symbols", "spans"]
    doc = json.loads((tmp_path / "t.json").read_text())
    names = {ev["name"] for ev in doc["traceEvents"]}
    assert {"stream.dispatch", "stream.harvest"} <= names
    if "--verify" in flags:
        assert _lines(out, "delta equivalence       : OK (3 sessions)")
    if "--pretrace" in flags:
        assert "stream.pretrace" in names
        assert "stream.retrace" not in names


@pytest.mark.skipif(reference_main is None, reason="needs the JAX reference")
@pytest.mark.parametrize("case", sorted(RUNS))
def test_trace_driven_run_same_summary_as_the_reference(
        case, tmp_path, capsys, monkeypatch):
    flags = _flags(case, tmp_path)
    _, out = _run_port(flags + ["--device", "cpu"], RUNS[case][1], capsys)
    monkeypatch.setattr(sys, "argv", ["stream", *flags])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        reference_main()
    ref = capsys.readouterr().out
    assert _lines(out, "stream_summary ") == _lines(ref, "stream_summary ")
    (mine,), (theirs,) = _lines(out, "obs_summary "), _lines(ref, "obs_summary ")
    keys = [[kv.split("=")[0] for kv in line.split()[1:]]
            for line in (mine, theirs)]
    assert keys[0] == keys[1]
    # the recorders saw the same symbols (their span counts differ by the
    # ``stream.retrace`` instants, which in the reference follow the
    # process's jit cache, and by the port's ``stream.pretrace``)
    assert mine.split("symbols=")[1].split()[0] \
        == theirs.split("symbols=")[1].split()[0]


def test_sessions_over_max_slots_allowed_under_workload(capsys):
    rep = port_main(SMALL + ["--sessions", "5", "--max-slots", "2",
                             "--workload", "roundrobin", "--evict",
                             "--device", "cpu"])
    assert int(rep["opened"]) == 5 and int(rep["evicted"]) > 0


def test_min_slots_reaches_the_server(capsys):
    """``--min-slots`` sets the autoscale floor: the table never shrinks
    below it."""
    rep = port_main(["--device", "cpu", "--sessions", "3", "--max-slots", "4",
                     "--min-slots", "2", "--length", "96", "--window", "48",
                     "--autoscale", "--shrink-patience", "1"])
    assert int(rep["opened"]) == int(rep["closed"]) == 3
    assert int(rep["capacity"]) == 2 and int(rep["grows"]) == 1


def test_new_flags_reach_the_server(capsys):
    """``--digitize-every`` and ``--shrink-patience`` are accepted, and a
    small autoscaled run with them on the CPU closes every session."""
    rep = port_main(["--device", "cpu", "--sessions", "3", "--max-slots", "4",
                     "--length", "96", "--window", "48", "--autoscale",
                     "--digitize-every", "2", "--shrink-patience", "1"])
    assert int(rep["opened"]) == int(rep["closed"]) == 3
    assert "stream_summary opened=3 closed=3" in capsys.readouterr().out


def test_stream_cli_devices_invariance(capsys):
    """``--devices 2`` (two host shards of the slot table) gives the
    ``stream_summary`` line, the counters and the fingerprint of
    ``--devices 1``, and prints the reference's ``devices / table shards``
    line."""
    flags = ["--device", "cpu", "--sessions", "3", "--length", "64",
             "--window", "32", "--workload", "flash_crowd", "--max-slots",
             "4", "--min-slots", "2", "--autoscale", "--verify"]
    outs, reps = [], []
    for devices in ("1", "2"):
        reps.append(port_main([*flags, "--devices", devices]))
        outs.append(capsys.readouterr().out)
    assert _lines(outs[0], "stream_summary ") == \
        _lines(outs[1], "stream_summary ")
    assert reps[0]["fingerprint"] == reps[1]["fingerprint"]
    assert "devices / table shards  : 2" in outs[1].splitlines()
    assert "delta equivalence       : OK (3 sessions)" in outs[1]

# ----------------------------------------------------------- fleet CLI


def _parse_fleet_stdout(stdout: str) -> dict:
    """The layout-invariant telemetry totals of a fleet CLI report."""
    vals = {}
    for line in stdout.splitlines():
        name, _, rest = line.partition(":")
        name, rest = name.strip(), rest.strip()
        first = rest.split()[0].replace(",", "") if rest else ""
        if name == "fleet pieces":
            vals["pieces"] = int(first)
        elif name == "fleet wire-in bytes":
            vals["wire_bytes"] = int(first)
        elif name == "fleet wire-out bytes":
            vals["wire_out_bytes"] = int(first)
        elif name == "fleet raw bytes":
            vals["raw_bytes"] = int(first)
        elif name == "compression rate":
            vals["compression_rate"] = float(first)
    return vals


def _port_cli(capsys, *argv):
    port_fleet_main([*argv, "--device", "cpu"])
    return capsys.readouterr().out


def test_fleet_cli_telemetry_is_layout_invariant(capsys, monkeypatch):
    """``--devices 1/4/8`` and a 2 x 2 pod x data grid report the same
    totals (the grid digitizes every window: 4 B more per extra frame), and
    they are the reference CLI's."""
    base = ["--streams", "8", "--length", "64", "--chunk", "16"]
    runs = {name: _parse_fleet_stdout(_port_cli(capsys, *base, *extra))
            for name, extra in (("devices1", ["--devices", "1"]),
                                ("devices4", ["--devices", "4"]),
                                ("devices8", ["--devices", "8"]),
                                ("pods2x2", ["--devices", "4", "--pods", "2",
                                             "--digitize-every", "1"]))}
    ref = runs["devices1"]
    assert set(ref) == {"pieces", "wire_bytes", "raw_bytes",
                        "wire_out_bytes", "compression_rate"}
    for name, vals in runs.items():
        vals = dict(vals)
        if name == "pods2x2":
            extra_frames = 8 * (64 // 16)
            assert (vals.pop("wire_out_bytes")
                    == ref["wire_out_bytes"] + 4 * extra_frames), name
            assert vals == {k: v for k, v in ref.items()
                            if k != "wire_out_bytes"}, name
            continue
        assert vals == ref, name
    if reference_fleet_main is not None:
        monkeypatch.setattr(sys, "argv", ["fleet", *base, "--devices", "1"])
        reference_fleet_main()
        assert _parse_fleet_stdout(capsys.readouterr().out) == ref


def test_fleet_cli_prints_the_reference_lines(capsys):
    out = _port_cli(capsys, "--streams", "4", "--length", "64", "--devices",
                    "2", "--reconstruct")
    lines = out.splitlines()
    assert lines[0] == "devices / data shards   : 2"
    assert lines[1] == "shard devices           : 1 distinct: cpu (host)"
    assert lines[2] == "mesh layout             : data = 2"
    assert lines[3] == "ingestion               : whole-stream"
    assert any(l.startswith("mean DTW err (symbols)  : ") for l in lines)


def test_fleet_cli_default_shards(capsys, monkeypatch):
    """Without ``--devices``: 8 host shards with ``--device cpu`` (the
    reference's dry run), one shard per card with cuda (the reference's
    ``jax.device_count()``)."""
    import repro_torch.launch.fleet as tfleet

    out = _port_cli(capsys, "--streams", "8", "--length", "64")
    assert out.splitlines()[0] == "devices / data shards   : 8"
    seen = []

    def stop(n_pods, n_dev, *, device):
        seen.append((n_pods, n_dev, device))
        raise RuntimeError("stop before the mesh")

    monkeypatch.setattr(tfleet, "device_count", lambda device=None: 1)
    monkeypatch.setattr(tfleet, "resolve_fleet_mesh", stop)
    with pytest.raises(RuntimeError, match="stop before the mesh"):
        port_fleet_main(["--streams", "8", "--length", "64"])
    assert seen == [(1, 1, "cuda")]


@pytest.mark.parametrize("argv", [
    ["--streams", "4", "--length", "128", "--chunk", "256", "--devices", "1"],
    ["--streams", "4", "--length", "128", "--tol", "-0.5", "--devices", "1"],
    ["--digitize-every", "2", "--devices", "1"],
    ["--devices", "4", "--pods", "3"],
    ["--pods", "0"],
    ["--chunk", "-1"],
    ["--devices", "0"],
    ["--streams", "0"],
])
def test_fleet_cli_rejects_as_the_reference(argv, capsys, monkeypatch):
    """Exit 2 and the reference parser's message, before any work."""
    if reference_fleet_main is None:
        pytest.skip("needs the JAX reference")
    errs = []
    for run in (lambda: port_fleet_main([*argv, "--device", "cpu"]),
                reference_fleet_main):
        monkeypatch.setattr(sys, "argv", ["fleet", *argv])
        with pytest.raises(SystemExit) as info:
            run()
        assert info.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0] == errs[1]


