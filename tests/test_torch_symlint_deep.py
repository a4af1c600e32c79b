"""The port's symlint deep tier (SL006, SL007, the sync counter) on the CPU.

``python -m repro_torch.analysis --deep --device cpu`` runs in a child
process on the repository: it exits 0 (every drive within its CPU budget,
every probe's dtypes clean) and imports neither jax nor any ``repro.``
module; without ``--device`` it runs on the card, and here refuses.  Seeded
defects in copies of the port's files trip the rules: one added
``.item()`` per round of the service trips SL006; a table member that
returns one float64 leaf trips both halves of SL007.  On the ``digitize``
drive, and in phase 13's windowed drive of ``chip_smoke.py`` at a small
size, the counter's count at ``digitize._any`` equals the rise of
``digitize.host_syncs``.  The counter counts each sync once.
"""
import _torch_threads  # noqa: F401  -- first: one torch thread

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import deep
from repro_torch.analysis.engine import analyze, default_paths, load_project
from repro_torch.analysis.synccount import Attributor, SyncCounter

REPO_ROOT = Path(__file__).resolve().parent.parent


def run_deep(tmp_path, sources, rules):
    for rel, text in sources.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    project = load_project(tmp_path, [tmp_path])
    ctx = deep.prepare(project, device="cpu")
    return analyze(project, rules, None, include_deep=True), ctx


def source(rel):
    return (REPO_ROOT / rel).read_text()


def test_head_deep_exits_0_without_jax():
    """The whole deep tier on the repository, in a child process: exit 0,
    0 findings, every drive run, and no jax or ``repro.`` module loaded."""
    code = (
        "import json, sys\n"
        "from repro_torch.analysis.cli import main\n"
        "rc = main(['--deep', '--device', 'cpu', '--format', 'json'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m == 'repro' "
        "or m.startswith(('jax.', 'repro.')))\n"
        "print('BAD', json.dumps(bad))\n"
        "sys.exit(rc)\n")
    env = {**os.environ, "PYTHONPATH": str(REPO_ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    body, _, tail = res.stdout.rpartition("BAD ")
    assert json.loads(tail) == []
    doc = json.loads(body)
    assert doc["findings"] == [] and doc["stale_baseline"] == []
    assert doc["deep_device"] == "cpu"
    assert set(doc["sync_counts"]) == set(deep.DRIVES)


def test_every_drive_entry_is_counted():
    """The registry's drives are the four of the reference, and each has
    entries that its drive reaches (a budget no sync reaches guards
    nothing)."""
    project = load_project(REPO_ROOT, default_paths(REPO_ROOT))
    entries, errors = deep.entry_registry(project)
    assert errors == []
    drives = {}
    for e in entries:
        if e.drive:
            drives.setdefault(e.drive, []).append(e)
    assert set(drives) == set(deep.DRIVES) == {
        "stream", "chunked", "digitize", "fleet"}
    assert all(e.budget > 0 and e.cpu_budget > 0
               for group in drives.values() for e in group)


def test_sl006_added_sync_per_round_trips_budget(tmp_path):
    rel = "stream_mut.py"
    text = source("src/repro_torch/launch/stream.py")
    clean, _ = run_deep(tmp_path / "clean", {rel: text}, ["SL006"])
    assert clean.findings == [], [f.message for f in clean.findings]
    needle = '        self.totals["steps"] += 1\n'
    assert text.count(needle) == 1
    mutated = text.replace(
        needle, needle + '        info["t_seen"][0].item()\n')
    result, ctx = run_deep(tmp_path / "mut", {rel: mutated}, ["SL006"])
    assert any(f.rule == "SL006" and "over its declared budget" in f.message
               and f.context == "StreamServer._step_blocks"
               for f in result.findings), [f.message for f in result.findings]
    counts = ctx.drives["stream"]
    budget = {e.qualname: e.cpu_budget for e in ctx.entries}
    # two grow/shrink cycles of one raw and one compressed-in round each
    assert counts["StreamServer._step_blocks"] == (
        budget["StreamServer._step_blocks"] + 4)


def test_sl006_holds_each_device_to_its_own_budget(tmp_path):
    """One count, 7 syncs, between the entry's card budget (5) and its CPU
    budget (9): over budget where the drive ran on the card, within it
    where it ran on the CPU."""
    from repro_torch.analysis.rules import sync_budget
    from repro_torch.analysis.synccount import NO_ENTRY

    (tmp_path / "mod.py").write_text(
        "class Server:\n"
        "    def step(self, x):  # symlint-torch: entry(drive=stream, "
        "budget=5, cpu_budget=9)\n"
        "        return x\n")
    project = load_project(tmp_path, [tmp_path])
    (entry,), errors = deep.entry_registry(project)
    assert errors == []
    counter = SyncCounter("cpu", Attributor({}, tmp_path))
    counter.counts[("Server.step", "mod.py:3", NO_ENTRY)] = 7
    found = {}
    for device in ("cuda", "cpu"):
        project._caches["deep"] = deep.DeepContext(
            device=device, entries=[entry], traces=[], pairs=[],
            drives={"stream": counter.by_entry()},
            drive_reports={"stream": deep.DriveReport(counter)}, errors=[])
        found[device] = [f.message for f in sync_budget.check(project)]
    assert len(found["cuda"]) == 1
    assert "made 7 host sync(s)" in found["cuda"][0]
    assert "on cuda, over its declared budget of 5" in found["cuda"][0]
    assert found["cpu"] == []


# the table member, rewritten to return one float64 leaf; the slot member
# keeps calling the original (a defect of the table path alone)
F64_TABLE = '''

_chunk_table_f32 = symed_receive_masked_chunk_table


def symed_receive_masked_chunk_table(*args, **kwargs):  # symlint-torch: entry(pair=chunk/table, shapes=pair-chunk-table)
    table, info = _chunk_table_f32(*args, **kwargs)
    info["t_seen"] = info["t_seen"].double()
    return table, info
'''


def test_sl007_f64_table_leaf_trips_both_halves(tmp_path):
    text = source("src/repro_torch/core/symed.py")
    head = "def symed_receive_masked_chunk_table(  # symlint-torch: entry("
    assert text.count(head) == 1
    text = text.replace(head, "def symed_receive_masked_chunk_table(  # ("
                        )
    call = "    table, info = symed_receive_masked_chunk_table(\n" \
           "        torch.as_tensor(ts_chunk)[None]"
    assert text.count(call) == 1
    text = text.replace(call, call.replace(
        "symed_receive_masked_chunk_table(", "_chunk_table_f32("))
    sources = {
        "symed_mut.py": text + F64_TABLE,
        # the f64-ok emulations the probes reach, as swept
        "src/repro_torch/core/normalize.py": source(
            "src/repro_torch/core/normalize.py"),
    }
    result, ctx = run_deep(tmp_path, sources, ["SL007"])
    msgs = [f.message for f in result.findings]
    table = "`symed_receive_masked_chunk_table`"
    assert any(table in m and "returns 64-bit leaves" in m
               and "['t_seen']" in m for m in msgs), msgs
    assert any(table in m and "outside f64-ok code" in m
               and "_to_copy" in m for m in msgs), msgs
    assert any("pair `chunk`" in m and "slot=int32 table=float64" in m
               for m in msgs), msgs
    # nothing else is 64-bit: the emulations in normalize.py are f64-ok
    assert all(table in m or "pair `chunk`" in m for m in msgs), msgs


def _any_site():
    """``path:line`` of ``digitize._any``'s host read."""
    rel = "src/repro_torch/core/digitize.py"
    lines = source(rel).splitlines()
    start = lines.index("def _any(pred: torch.Tensor) -> bool:")
    line = next(i for i in range(start, len(lines))
                if "bool(pred.any())" in lines[i])
    return f"{rel}:{line + 1}"


def test_digitize_drive_counts_any_as_host_syncs():
    project = load_project(REPO_ROOT, [REPO_ROOT / "src/repro_torch/core"
                                       / "digitize.py"])
    ctx = deep.prepare(project, device="cpu")
    assert ctx.errors == []
    rep = ctx.drive_reports["digitize"]
    at_any = sum(n for (_, site, _), n in rep.counter.counts.items()
                 if site == _any_site())
    assert rep.notes["host_syncs"] > 0
    assert at_any == rep.notes["host_syncs"]
    # the other syncs of the CPU drive are the CPU-only per-cluster sums
    assert {site.rsplit(":", 1)[0] for (_, site, _) in rep.counter.counts} \
        == {"src/repro_torch/core/digitize.py"}


def test_counter_counts_each_sync_once():
    attributor = Attributor({}, REPO_ROOT)
    t = torch.arange(6)
    with SyncCounter("cpu", attributor) as counter:
        bool(t[0])                       # function mode and dispatch mode
        t.tolist()
        np.asarray(t)
        f"{t[1]}"                        # dispatch mode alone
        t[t > 2]                         # a boolean index
        t.nonzero()
        int(t[2])
        t.repeat_interleave(2)           # its size is known on the host
        t.repeat_interleave(t)
        t.cpu()                          # nothing moves on the CPU
        t + 1
    assert counter.total == 8


class _HostSyncsRise:
    """Context manager: the rise of ``digitize.host_syncs`` inside it, a
    witness of the ``_any`` syncs that owes nothing to the counter."""

    def __enter__(self):
        from repro_torch.core import digitize

        self._module, self._before = digitize, digitize.host_syncs
        return self

    def __exit__(self, *exc):
        self.n = self._module.host_syncs - self._before


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_under_test", REPO_ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_stream_windows_drive_on_cpu():
    """Phase 13's drive (``chip_smoke._stream_windows``) at a small size:
    raw then compressed in, the measured rounds counted per entry; the
    counter's count at ``digitize._any`` equals the rise of
    ``digitize.host_syncs`` over the same rounds."""
    from repro_torch.core.symed import SymEDConfig
    from repro_torch.data.synthetic import make_fleet

    group, attributor = deep.drive_attributor(REPO_ROOT)
    assert {e.qualname for e in group} >= {
        "StreamServer.ingest_many", "StreamServer.ingest_pieces_many",
        "StreamServer._step_blocks"}
    cfg = SymEDConfig(tol=0.5, alpha=0.01, scl=1.0, k_min=3, k_max=8,
                      n_max=32, len_max=32, lloyd_iters=2)
    runs = _chip_smoke()._stream_windows(
        torch, cfg, make_fleet(4, 96, seed=0), "cpu", window=16, warmup=2,
        measured=3, watches=lambda: [SyncCounter("cpu", attributor),
                                     _HostSyncsRise()])
    for mode, entry in (("raw", "StreamServer.ingest_many"),
                        ("pieces", "StreamServer.ingest_pieces_many")):
        (counter, rise), seconds, rounds = runs[mode]
        assert rounds == 3 and seconds > 0
        at_any = sum(n for (_, site, _), n in counter.counts.items()
                     if site == _any_site())
        assert rise.n > 0 and at_any == rise.n
        by_entry = counter.by_entry()
        assert by_entry[entry] == 3            # one harvest copy per round
        assert by_entry["StreamServer._step_blocks"] > 0


def test_deep_without_device_needs_the_card():
    """``--deep`` runs on the card unless ``--device cpu`` is given: with
    no card it refuses (exit 2) and runs nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: --deep runs on it")
    from repro_torch.analysis.cli import main

    assert main(["--deep", "--rules", "SL006"]) == 2


@pytest.mark.cuda
def test_counter_agrees_with_sync_debug_mode_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.analysis.synccount import SyncDebugRecorder

    attributor = Attributor({}, REPO_ROOT)
    t = torch.arange(6, device="cuda")
    with SyncCounter("cuda", attributor) as counter, \
            SyncDebugRecorder(attributor) as recorder:
        bool(t[0])
        t.tolist()
        t[t > 2]
        t.nonzero()
        torch.tensor(2.0, device="cuda")
        torch.from_numpy(np.ones(3)).to("cuda")
        t.cpu()
        t + 1
    assert counter.total == 7
    assert counter.counts == recorder.counts
