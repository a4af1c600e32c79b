"""The port's workload harness (``repro_torch.workload``) against the
reference's (``repro.workload``).

A ``workload_trace/v1`` trace plus a seed describes a run completely: the
port's synthesizers give the reference's traces digest for digest, its SLO
layer parses and judges as the reference's does, and on the CPU a replay
through the port's ``StreamServer`` gives the reference's delta stream
hash, counter totals and fingerprint, with every closed session verified
against ``symed_encode``.  Over the loopback transport the
schedule-determined counters and the delta hash equal the in-process
replay's.  The workload CLI's exit codes are checked in process.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import json
import warnings

import numpy as np
import pytest
import torch

try:  # the reference; the card's machine has no JAX
    from repro.core.symed import SymEDConfig as JaxConfig
    from repro.workload import SCENARIOS as REF_SCENARIOS
    from repro.workload import Trace as RefTrace
    from repro.workload import check_slos as ref_check_slos
    from repro.workload import parse_slo_specs as ref_parse_slo_specs
    from repro.workload import synthesize as ref_synthesize
    from repro.workload.replay import replay_trace as ref_replay_trace
except ImportError:
    JaxConfig = None
from repro_torch.core.symed import SymEDConfig
from repro_torch.workload import (
    KNOWN_SLOS, SCENARIOS, Trace, Workload, check_slos, parse_slo_specs,
    replay_trace, scenario_seed, synthesize,
)
from repro_torch.workload.__main__ import main as workload_main
from repro_torch.workload.replay import LOOSE_COUNTER_KEYS

PARAMS = dict(tol=0.5, alpha=0.02, scl=1.0, k_min=3, k_max=8, len_max=32,
              n_max=64, lloyd_iters=5)
CFG = SymEDConfig(**PARAMS)
needs_jax = pytest.mark.skipif(JaxConfig is None,
                               reason="needs the JAX reference")
# (scenario, sessions): slot_churn's 5 sessions per wave and its background
# stream oversubscribe its 4-slot table, so LRU eviction fires
REPLAYS = [("mixed_fleet", 4), ("slot_churn", 5), ("flash_crowd", 4)]


# --------------------------------------------------------------- traces


@needs_jax
@pytest.mark.parametrize("base", [0, 7])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_trace_digest_equals_the_reference(name, base):
    assert sorted(SCENARIOS) == sorted(REF_SCENARIOS)
    seed = scenario_seed(name, base)
    mine = synthesize(name, seed=seed)
    theirs = ref_synthesize(name, seed=seed)
    assert mine.to_jsonl() == theirs.to_jsonl()
    assert mine.digest() == theirs.digest()


@needs_jax
def test_recorded_traces_cross_load(tmp_path):
    """A trace either package writes loads in the other, digest intact."""
    ref = ref_synthesize("dropout_churn", seed=5, sessions=4)
    ref.save(str(tmp_path / "ref.jsonl"))
    assert Trace.load(str(tmp_path / "ref.jsonl")).digest() == ref.digest()
    mine = synthesize("diurnal", seed=5, sessions=3)
    mine.save(str(tmp_path / "mine.jsonl"))
    assert RefTrace.load(str(tmp_path / "mine.jsonl")).digest() \
        == mine.digest()


@needs_jax
def test_workload_defaults_and_the_deprecation_seam():
    for name, sc in SCENARIOS.items():
        ref = REF_SCENARIOS[name]
        wl = Workload(name)
        assert (wl.seed, wl.server_kw(), wl.slos()) == (
            scenario_seed(name), dict(ref.server_kw), dict(ref.slos))
        assert (dict(sc.defaults), sc.legacy) == (dict(ref.defaults),
                                                  ref.legacy)
    with pytest.warns(DeprecationWarning, match="--arrival-pattern"):
        Workload.from_pattern("bursty", sessions=3, length=96, window=48,
                              seed=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Workload.from_pattern("bursty", sessions=3, length=96, window=48,
                              seed=1, _warn=False)


# ----------------------------------------------------------------- SLOs


@needs_jax
@pytest.mark.parametrize("specs", [
    [], ["p99_symbol_ms=50"], ["evict_rate=0.5", "evict_rate=0.1"],
    ["max_queue_depth=3", "p50_symbol_ms=1e-3", "mean_queue_depth=2"]])
def test_slo_parsing_and_checking_agree(specs):
    assert set(KNOWN_SLOS) == {
        "p50_symbol_ms", "p99_symbol_ms", "p999_symbol_ms",
        "max_queue_depth", "mean_queue_depth", "evict_rate"}
    slos = parse_slo_specs(specs)
    assert slos == ref_parse_slo_specs(specs)
    for measured in ({}, {"p99_symbol_ms": 60.0, "evict_rate": 0.2,
                          "max_queue_depth": 3.0, "p50_symbol_ms": 0.0}):
        got = [(v.key, v.limit, str(v)) for v in check_slos(measured, slos)]
        want = [(v.key, v.limit, str(v))
                for v in ref_check_slos(measured, slos)]
        assert got == want


@needs_jax
@pytest.mark.parametrize("spec", ["nope=1", "p99_symbol_ms", "evict_rate=x"])
def test_bad_slo_specs_raise_as_the_reference(spec):
    with pytest.raises(ValueError) as mine:
        parse_slo_specs([spec])
    with pytest.raises(ValueError) as theirs:
        ref_parse_slo_specs([spec])
    assert str(mine.value) == str(theirs.value)


# --------------------------------------------------------------- replay


@needs_jax
@pytest.mark.parametrize("name,sessions", REPLAYS)
def test_replay_equals_the_reference(name, sessions):
    wl = Workload(name, seed=scenario_seed(name), sessions=sessions,
                  length=64, window=32)
    trace = wl.trace()
    theirs = ref_replay_trace(RefTrace.from_jsonl(trace.to_jsonl()),
                              cfg=JaxConfig(**PARAMS),
                              server_kw=wl.server_kw(), verify=True)
    mine = replay_trace(trace, cfg=CFG, server_kw=wl.server_kw(),
                        verify=True, device="cpu")
    assert set(mine.counters) == set(theirs.counters)
    assert mine.counters == theirs.counters
    assert mine.delta_sha256 == theirs.delta_sha256
    assert mine.fingerprint() == theirs.fingerprint()
    assert mine.verified == theirs.verified > 0
    if name == "slot_churn":
        assert mine.counters["evicted"] > 0
    else:
        assert mine.verified == len(trace.sessions)
    assert mine.queue == theirs.queue
    assert mine.latency["count"] > 0


def test_transport_matches_inprocess():
    tr = synthesize("mixed_fleet", seed=scenario_seed("mixed_fleet"),
                    sessions=4, length=64, window=32)
    kw = {"max_sessions": 4, "pretrace": True}
    inproc = replay_trace(tr, cfg=CFG, server_kw=kw, device="cpu")
    wire = replay_trace(tr, cfg=CFG, server_kw=kw, transport=True,
                        verify=True, device="cpu")
    assert wire.delta_sha256 == inproc.delta_sha256
    for k in LOOSE_COUNTER_KEYS:
        assert wire.counters[k] == inproc.counters[k], k
    assert wire.verified == len(tr.sessions)


def test_obs_off_changes_nothing_but_the_latency():
    tr = synthesize("flash_crowd", seed=scenario_seed("flash_crowd"),
                    sessions=4, length=64, window=32)
    kw = dict(SCENARIOS["flash_crowd"].server_kw)
    on = replay_trace(tr, cfg=CFG, server_kw=kw, device="cpu")
    off = replay_trace(tr, cfg=CFG, server_kw=kw, device="cpu", obs=False)
    assert on.fingerprint() == off.fingerprint()
    assert on.latency["count"] > 0 and off.latency["count"] == 0


# ------------------------------------------------------------------ CLI

SMALL = ["--scenario", "mixed_fleet", "--sessions", "2", "--length", "64",
         "--window", "32", "--device", "cpu"]


def test_cli_exit_0_and_artifact(tmp_path, capsys):
    """Exit 0 when every SLO holds.  The latency limit is lifted: on a
    loaded CPU a round can take seconds; the scenario's queue-depth and
    eviction SLOs, which the schedule decides, stay."""
    out = tmp_path / "bench.json"
    assert workload_main(SMALL + ["--verify", "--out", str(out),
                                  "--slo", "p99_symbol_ms=1e9"]) == 0
    text = capsys.readouterr().out
    assert "violations=0" in text and "verified=2" in text
    doc = json.loads(out.read_text())
    assert doc["schema"] == "bench_transport/v1"
    assert doc["config"]["device"] == "cpu"
    (row,) = doc["rows"]
    assert row["scenario"] == "mixed_fleet" and row["opened"] == 2
    assert row["slos"] == {"evict_rate": 0.0, "max_queue_depth": 64.0,
                           "p99_symbol_ms": 1e9}
    assert row["trace_digest"] == Workload(
        "mixed_fleet", sessions=2, length=64, window=32).trace().digest()


def test_cli_exit_1_on_violation(capsys):
    assert workload_main(SMALL + ["--slo", "p99_symbol_ms=0.0001"]) == 1
    assert "VIOLATION" in capsys.readouterr().out


@pytest.mark.parametrize("flags,message", [
    (["--runs", "0"], "--runs must be >= 1, got 0"),
    (["--rate", "-1"], "--rate must be >= 0, got -1.0"),
    (["--slo", "nope=1"], "unknown SLO 'nope'"),
    (["--scenario", "nope"], "unknown scenario 'nope'"),
    (["--trace", "t.jsonl", "--scenario", "diurnal"],
     "--trace and --scenario are mutually exclusive"),
    (["--scenario", "all", "--dump-trace", "t.jsonl"],
     "--dump-trace needs exactly one scenario"),
    (["--window", "0"], "--window must be >= 1, got 0"),
])
def test_cli_exit_2_on_bad_flags(flags, message, capsys, tmp_path,
                                 monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        workload_main(flags)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_cli_exit_3_when_runs_disagree(monkeypatch, capsys):
    """Two runs whose fingerprints differ (one counter nudged) exit 3."""
    import repro_torch.workload.__main__ as cli

    calls = []

    def nudged(trace, **kw):
        res = replay_trace(trace, **kw)
        calls.append(res)
        if len(calls) == 2:
            res.counters["steps"] += 1
        return res

    monkeypatch.setattr(cli, "replay_trace", nudged)
    assert workload_main(SMALL + ["--runs", "2"]) == 3
    assert "determinism=MISMATCH" in capsys.readouterr().out


def _summary(text):
    """The ``workload_summary`` line without its wall-clock fields."""
    (line,) = [l for l in text.splitlines()
               if l.startswith("workload_summary ")]
    return [f for f in line.split()
            if not f.startswith(("p50_ms=", "p99_ms=", "p999_ms=",
                                 "wall_s="))]


def test_cli_devices_gives_the_same_replay(capsys):
    """``--devices 2`` shards the server's table over two host shards: the
    same delta hash, counters and verified sessions as ``--devices 1``."""
    flags = SMALL + ["--verify", "--no-slos"]
    summaries = []
    for devices in ("1", "2"):
        assert workload_main(flags + ["--devices", devices]) == 0
        summaries.append(_summary(capsys.readouterr().out))
    assert summaries[0] == summaries[1]
    assert "verified=2" in summaries[1]


@pytest.mark.parametrize("server_kw,devices,fits", [
    ({"max_sessions": 8}, 3, False),
    ({"max_sessions": 8, "min_slots": 2}, 4, False),
    ({}, 16, False),
    ({"max_sessions": 8, "min_slots": 4}, 4, True)])
def test_check_mesh_fit_as_the_reference(server_kw, devices, fits):
    """A scenario's table that does not divide over ``--devices`` stops
    the CLI with the reference's text; one that divides passes."""
    from repro_torch.workload.__main__ import _check_mesh_fit

    if JaxConfig is None:
        pytest.skip("needs the JAX reference")
    from repro.workload.__main__ import _check_mesh_fit as ref_fit

    msgs = []
    for fit in (_check_mesh_fit, ref_fit):
        try:
            fit("flash_crowd", server_kw, devices)
            msgs.append(None)
        except SystemExit as e:
            msgs.append(str(e))
    assert msgs[0] == msgs[1]
    assert (msgs[0] is None) == fits


@needs_jax
def test_cli_dump_trace(tmp_path, capsys):
    path = tmp_path / "t.jsonl"
    assert workload_main(["--scenario", "slot_churn", "--dump-trace",
                          str(path)]) == 0
    assert Trace.load(str(path)).digest() == ref_synthesize(
        "slot_churn", seed=scenario_seed("slot_churn")).digest()


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_replays_on_the_card_are_deterministic():
    """Two replays on the card give one fingerprint; obs on and off give
    the same host syncs (the recorder adds none)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core import digitize

    name = torch.cuda.get_device_name()
    wl = Workload("mixed_fleet", sessions=4, length=64, window=32)
    runs, syncs = [], []
    for obs in (None, None, False):
        digitize.host_syncs = 0
        runs.append(replay_trace(wl.trace(), cfg=CFG,
                                 server_kw=wl.server_kw(), obs=obs,
                                 verify=True))
        syncs.append(digitize.host_syncs)
    assert len({r.fingerprint() for r in runs}) == 1, name
    assert syncs[0] == syncs[1] == syncs[2] > 0, (name, syncs)
    assert runs[0].verified == 4, name
    assert np.isfinite(runs[0].latency["p99_ms"]) and \
        runs[0].latency["count"] > 0, name
