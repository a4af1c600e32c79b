"""The port's symlint (``repro_torch.analysis``), AST tier, against the
reference's (``repro.analysis``).

SL005 runs over copies of the reference's codec files and each mutation of
its battery through both tools: the findings must be equal (rule, path,
line, message, fingerprint).  The engine's contracts (suppression,
baseline, stale entries, the TODO gate, ``--changed``, the three formats)
are shown on SL005 fixtures by both tools.  Each JAX fixture of the
reference's SL004 and CFG batteries is transliterated to PyTorch line for
line: the port's SL004 must flag the lines the reference's flags.  The
registry holds a counterpart of each reference entry and hot path.  The
tools' annotation prefixes are disjoint, and the AST tier imports neither
torch nor jax nor any ``repro.`` module (checked in a child process).
"""
import _torch_threads  # noqa: F401  -- first: one torch thread

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import cli as ref_cli
from repro.analysis import engine as ref_engine
from repro_torch.analysis import cli as port_cli
from repro_torch.analysis import deep as port_deep
from repro_torch.analysis import engine as port_engine

REPO_ROOT = Path(__file__).resolve().parent.parent
TOOLS = {"ref": (ref_engine, ref_cli, "symlint"),
         "port": (port_engine, port_cli, "symlint-torch")}


def write(tmp_path, sources):
    for rel, text in sources.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)


def run(tool, tmp_path, sources, rules, baseline=None):
    """Write ``{relpath: source}`` under tmp_path and analyze it with one
    tool's engine (``"ref"`` or ``"port"``)."""
    engine = TOOLS[tool][0]
    write(tmp_path, sources)
    project = engine.load_project(tmp_path, [tmp_path])
    return engine.analyze(project, rules, baseline)


def keyed(result):
    return [(f.rule, f.path, f.line, f.message, f.fingerprint)
            for f in result.findings]


# ------------------------------------------------------ SL005, both tools


REF_CODECS = ("src/repro/launch/transport.py", "src/repro/core/receiver.py")
PORT_CODECS = ("src/repro_torch/launch/transport.py",
               "src/repro_torch/core/receiver.py")
MUTATIONS = [
    ('"!IIB"', '"!IBB"'),     # encode/decode_closed header
    ('"!fII"', '"!fIH"'),     # pieces DATA header
    ('("endpoint", ">f4")', '("endpoint", ">f8")'),  # piece record
]


def sources_of(files):
    return {rel: (REPO_ROOT / rel).read_text() for rel in files}


def mutate(sources, before, after):
    """Flip the first occurrence of ``before``: a one-sided edit."""
    for rel in sorted(sources):
        if before in sources[rel]:
            sources[rel] = sources[rel].replace(before, after, 1)
            return sources
    raise AssertionError(f"pattern {before!r} not found")


class TestSL005Parity:
    def test_reference_codecs_same_findings(self, tmp_path):
        ref = run("ref", tmp_path, sources_of(REF_CODECS), ["SL005"])
        port = run("port", tmp_path, sources_of(REF_CODECS), ["SL005"])
        assert keyed(ref) == keyed(port) == []

    @pytest.mark.parametrize("before,after", MUTATIONS)
    def test_reference_mutation_same_findings(self, tmp_path, before,
                                              after):
        sources = mutate(sources_of(REF_CODECS), before, after)
        ref = run("ref", tmp_path, sources, ["SL005"])
        port = run("port", tmp_path, sources, ["SL005"])
        assert keyed(ref), f"{before} -> {after} not caught by the reference"
        assert keyed(port) == keyed(ref)

    def test_port_codecs_clean(self, tmp_path):
        assert keyed(run("port", tmp_path, sources_of(PORT_CODECS),
                         ["SL005"])) == []

    @pytest.mark.parametrize("before,after", MUTATIONS)
    def test_port_mutation_caught(self, tmp_path, before, after):
        sources = mutate(sources_of(PORT_CODECS), before, after)
        found = run("port", tmp_path, sources, ["SL005"]).findings
        assert any(f.rule == "SL005" for f in found), (
            f"one-sided {before} -> {after} edit not caught")

    @pytest.mark.parametrize("name,src,expect", [
        ("unpaired",
         "import struct\n"
         "def encode_open(sid, mode, seed):\n"
         "    return struct.pack('!BI', mode, seed)\n", "decode_open"),
        ("offset",
         "import struct\n"
         "def encode_close(t, flag):\n"
         "    return struct.pack('!IB', t, flag) + struct.pack('!f', 0.5)\n"
         "def decode_close(buf):\n"
         "    t, flag = struct.unpack_from('!IB', buf)\n"
         "    tail = struct.unpack_from('!f', buf, 6)[0]\n"
         "    return t, flag, tail\n", "offset 6"),
        ("constant",
         "import numpy as np\n"
         "DELTA_SYMBOL_BYTES = 6.0\n"
         '_DELTA_REC = np.dtype([("label", "u1"), ("endpoint", ">f4")])\n',
         "DELTA_SYMBOL_BYTES"),
    ])
    def test_reference_fixtures_same_findings(self, tmp_path, name, src,
                                              expect):
        ref = run("ref", tmp_path, {"mod.py": src}, ["SL005"])
        port = run("port", tmp_path, {"mod.py": src}, ["SL005"])
        assert any(expect in f.message for f in ref.findings)
        assert keyed(port) == keyed(ref)


# -------------------------------------- engine contracts, both tools


OFFSET_FIXTURE = (
    "import struct\n"
    "def encode_close(t, flag):\n"
    "    return struct.pack('!IB', t, flag) + struct.pack('!f', 0.5)\n"
    "def decode_close(buf):\n"
    "    t, flag = struct.unpack_from('!IB', buf)\n"
    "    tail = struct.unpack_from('!f', buf, 6)[0]\n"
    "    return t, flag, tail\n"
)
UNPAIRED_FIXTURE = (
    "import struct\n"
    "def encode_open(sid, mode, seed):\n"
    "    return struct.pack('!BI', mode, seed)\n"
)
PREFIX = {"ref": "symlint", "port": "symlint-torch"}
OFFSET_LINE = "    tail = struct.unpack_from('!f', buf, 6)[0]"


class TestEngineContracts:
    @pytest.mark.parametrize("tool", ["ref", "port"])
    def test_suppression(self, tmp_path, tool):
        src = OFFSET_FIXTURE.replace(
            OFFSET_LINE, OFFSET_LINE + f"  # {PREFIX[tool]}: disable=SL005")
        result = run(tool, tmp_path, {"mod.py": src}, ["SL005"])
        assert result.findings == []
        assert len(result.suppressed) == 1

    @pytest.mark.parametrize("tool,other", [("ref", "port"),
                                            ("port", "ref")])
    def test_prefixes_are_disjoint(self, tmp_path, tool, other):
        """One tool's disable comment leaves the other's finding live."""
        src = OFFSET_FIXTURE.replace(
            OFFSET_LINE, OFFSET_LINE + f"  # {PREFIX[other]}: disable=SL005")
        result = run(tool, tmp_path, {"mod.py": src}, ["SL005"])
        assert len(result.findings) == 1 and result.suppressed == []

    def test_baseline_and_fingerprints(self, tmp_path):
        written = {}
        for tool in ("ref", "port"):
            engine = TOOLS[tool][0]
            result = run(tool, tmp_path, {"mod.py": OFFSET_FIXTURE},
                         ["SL005"])
            bpath = tmp_path / f"{tool}.json"
            engine.Baseline.write(bpath, result.findings, {})
            again = run(tool, tmp_path, {"mod.py": OFFSET_FIXTURE},
                        ["SL005"], engine.Baseline(bpath))
            assert again.findings == [] and len(again.baselined) == 1
            assert again.exit_code == 0
            written[tool] = json.loads(bpath.read_text())
        assert written["ref"] == written["port"]

    @pytest.mark.parametrize("tool", ["ref", "port"])
    def test_stale_entry_fails(self, tmp_path, tool):
        engine = TOOLS[tool][0]
        result = run(tool, tmp_path, {"mod.py": OFFSET_FIXTURE}, ["SL005"])
        bpath = tmp_path / "baseline.json"
        engine.Baseline.write(bpath, result.findings, {})
        project = engine.load_project(tmp_path / "sub", [])
        stale = engine.analyze(project, ["SL005"], engine.Baseline(bpath))
        assert len(stale.stale_baseline) == 1 and stale.exit_code == 1

    @pytest.mark.parametrize("tool", ["ref", "port"])
    def test_update_baseline_refuses_todo(self, tmp_path, capsys,
                                          monkeypatch, tool):
        main = TOOLS[tool][1].main
        write(tmp_path, {"pyproject.toml": "[project]\nname='x'\n",
                         "mod.py": OFFSET_FIXTURE})
        monkeypatch.chdir(tmp_path)
        bpath = tmp_path / "bl.json"
        assert main(["mod.py", "--update-baseline", "--baseline",
                     str(bpath)]) == 1
        assert "placeholder" in capsys.readouterr().out
        doc = json.loads(bpath.read_text())
        doc["entries"][0]["justification"] = "reviewed: fixture only"
        bpath.write_text(json.dumps(doc))
        assert main(["mod.py", "--update-baseline", "--baseline",
                     str(bpath)]) == 0

    @pytest.mark.parametrize("tool", ["ref", "port"])
    def test_changed_filters_to_diff(self, tmp_path, capsys, monkeypatch,
                                     tool):
        main = TOOLS[tool][1].main
        write(tmp_path, {"pyproject.toml": "[project]\nname='x'\n",
                         "old.py": UNPAIRED_FIXTURE})

        def git(*args):
            subprocess.run(
                ["git", "-c", "user.email=t@t", "-c", "user.name=t", *args],
                cwd=tmp_path, check=True, capture_output=True)

        git("init", "-q")
        git("add", ".")
        git("commit", "-qm", "init")
        (tmp_path / "new.py").write_text(OFFSET_FIXTURE)
        monkeypatch.chdir(tmp_path)
        code = main(["old.py", "new.py", "--changed", "--no-baseline",
                     "--rules", "SL005"])
        out = capsys.readouterr().out
        assert code == 1
        assert "new.py" in out and "old.py" not in out

    def test_formats(self, tmp_path, capsys, monkeypatch):
        write(tmp_path, {"pyproject.toml": "[project]\nname='x'\n",
                         "mod.py": OFFSET_FIXTURE})
        monkeypatch.chdir(tmp_path)
        outs = {}
        for tool in ("ref", "port"):
            main = TOOLS[tool][1].main
            for fmt in ("text", "json", "github"):
                code = main(["mod.py", f"--format={fmt}", "--no-baseline",
                             "--rules", "SL005"])
                assert code == 1
                outs[tool, fmt] = capsys.readouterr().out
        assert outs["ref", "text"] == outs["port", "text"]
        assert outs["ref", "github"] == outs["port", "github"]
        assert "::error file=mod.py,line=6" in outs["port", "github"]
        ref, port = (json.loads(outs[t, "json"]) for t in ("ref", "port"))
        assert ref == port and len(port["findings"]) == 1


# ----------------------------------- SL004 and the CFG, line for line


# (reference fixture, its transliteration to PyTorch): same line count,
# each line the counterpart of the other's
SL004_PAIRS = {
    "sync": ("""\
import numpy as np
import jax.numpy as jnp

def hot(x):  # symlint: hot-path
    y = jnp.cumsum(x)
    return np.asarray(y)
""", """\
import numpy as np
import torch

def hot(x):  # symlint-torch: hot-path
    y = torch.cumsum(x, 0)
    return np.asarray(y)
"""),
    "annotated": ("""\
import numpy as np
import jax
import jax.numpy as jnp

def hot(x):  # symlint: hot-path
    y = jnp.cumsum(x)
    return jax.device_get(y)  # sync: ok
""", """\
import numpy as np
import torch
import torch.nn.functional as F

def hot(x):  # symlint-torch: hot-path
    y = torch.cumsum(x, 0)
    return y.cpu()  # sync: ok
"""),
    "branch": ("""\
import jax.numpy as jnp

def hot(x):  # symlint: hot-path
    y = jnp.any(x > 0)
    if y:
        return 1
    return 0
""", """\
import torch

def hot(x):  # symlint-torch: hot-path
    y = torch.any(x > 0)
    if y:
        return 1
    return 0
"""),
    "unmarked": ("""\
import numpy as np
import jax.numpy as jnp

def cold(x):
    y = jnp.cumsum(x)
    return np.asarray(y)
""", """\
import numpy as np
import torch

def cold(x):
    y = torch.cumsum(x, 0)
    return np.asarray(y)
"""),
    "loop_carry": ("""\
import jax.numpy as jnp

def hot(xs, n):  # symlint: hot-path
    prev = None
    for i in range(n):
        if i > 0:
            out = float(prev)
        prev = jnp.sum(xs[i])
    return prev
""", """\
import torch

def hot(xs, n):  # symlint-torch: hot-path
    prev = None
    for i in range(n):
        if i > 0:
            out = float(prev)
        prev = torch.sum(xs[i])
    return prev
"""),
    "cleanse_one": ("""\
import jax.numpy as jnp

def hot(x, cond):  # symlint: hot-path
    v = jnp.sum(x)
    if cond:
        v = 0.0
    return float(v)
""", """\
import torch

def hot(x, cond):  # symlint-torch: hot-path
    v = torch.sum(x)
    if cond:
        v = 0.0
    return float(v)
"""),
    "cleanse_both": ("""\
import jax.numpy as jnp

def hot(x, cond):  # symlint: hot-path
    v = jnp.sum(x)
    if cond:
        v = 0.0
    else:
        v = 1.0
    return float(v)
""", """\
import torch

def hot(x, cond):  # symlint-torch: hot-path
    v = torch.sum(x)
    if cond:
        v = 0.0
    else:
        v = 1.0
    return float(v)
"""),
    "try_edge": ("""\
import jax.numpy as jnp

def hot(x):  # symlint: hot-path
    v = 0.0
    try:
        v = jnp.sum(x)
        v = host_value()
    except ValueError:
        return float(v)
    return v
""", """\
import torch

def hot(x):  # symlint-torch: hot-path
    v = 0.0
    try:
        v = torch.sum(x)
        v = host_value()
    except ValueError:
        return float(v)
    return v
"""),
    "suppressed": ("""\
import numpy as np
import jax.numpy as jnp

def hot(x):  # symlint: hot-path
    y = jnp.cumsum(x)
    return np.asarray(y)  # symlint: disable=SL004
""", """\
import numpy as np
import torch

def hot(x):  # symlint-torch: hot-path
    y = torch.cumsum(x, 0)
    return np.asarray(y)  # symlint-torch: disable=SL004
"""),
}
# the reference battery's expectation for each (lines flagged)
SL004_EXPECT = {"sync": [6], "annotated": [], "branch": [5], "unmarked": [],
                "loop_carry": [7], "cleanse_one": [7], "cleanse_both": [],
                "try_edge": [9], "suppressed": []}


class TestSL004Transliterated:
    @pytest.mark.parametrize("name", sorted(SL004_PAIRS))
    def test_same_lines_flagged(self, tmp_path, name):
        ref_src, port_src = SL004_PAIRS[name]
        assert len(ref_src.splitlines()) == len(port_src.splitlines())
        ref = run("ref", tmp_path / "ref", {"mod.py": ref_src}, ["SL004"])
        port = run("port", tmp_path / "port", {"mod.py": port_src},
                   ["SL004"])
        ref_lines = [f.line for f in ref.findings]
        assert ref_lines == SL004_EXPECT[name]
        assert [f.line for f in port.findings] == ref_lines
        assert len(port.suppressed) == len(ref.suppressed)

    @pytest.mark.parametrize("src,detail", [
        ("def hot(t):  # symlint-torch: hot-path\n"
         "    import torch\n"
         "    return torch.ones(3).sum().item()\n", ".item()"),
        ("def hot(t):  # symlint-torch: hot-path\n"
         "    x = t.to('cuda')\n"
         "    return x.to('cpu')\n", ".to(<cpu>)"),
        ("import torch\n"
         "def hot(t: torch.Tensor):  # symlint-torch: hot-path\n"
         "    return [r.tolist() for r in t.unbind(0)]\n", ".tolist()"),
        ("import torch\n"
         "def hot(t: torch.Tensor):  # symlint-torch: hot-path\n"
         "    return t.sum(0).numpy()\n", ".numpy()"),
    ])
    def test_torch_sinks(self, tmp_path, src, detail):
        found = run("port", tmp_path, {"mod.py": src}, ["SL004"]).findings
        assert len(found) == 1 and detail in found[0].message

    @pytest.mark.parametrize("src", [
        # static metadata and host-made tensors never sync
        "import torch\n"
        "def hot(t: torch.Tensor):  # symlint-torch: hot-path\n"
        "    return int(t.shape[0]) + t.size(0) + len(t) + t.dim()\n",
        "import numpy as np\nimport torch\n"
        "def hot(a):  # symlint-torch: hot-path\n"
        "    return torch.from_numpy(a).numpy()\n",
        "import torch\n"
        "def hot(t: torch.Tensor):  # symlint-torch: hot-path\n"
        "    return t.cpu().numpy()  # sync: ok\n",
    ])
    def test_torch_non_sinks(self, tmp_path, src):
        assert run("port", tmp_path, {"mod.py": src}, ["SL004"]).findings \
            == []

    def test_unannotated_sync_in_stream_caught(self, tmp_path):
        """The reference's SL004 battery on the port's service: a per-round
        host sync on the table step's output, without ``# sync: ok``."""
        rel = "src/repro_torch/launch/stream.py"
        sources = sources_of([rel])
        assert run("port", tmp_path, sources, ["SL004"]).findings == []
        needle = '        self.totals["steps"] += 1\n'
        assert sources[rel].count(needle) == 1
        sources[rel] = sources[rel].replace(
            needle, needle + '        _t0 = float(info["t_seen"][0])\n')
        found = run("port", tmp_path, sources, ["SL004"]).findings
        assert any(f.rule == "SL004" and "float()" in f.message
                   and f.context == "StreamServer._step_blocks"
                   for f in found), [f.message for f in found]

    def test_harvest_copies_are_the_annotated_ones(self, tmp_path):
        """Without their ``# sync: ok`` the service's reviewed copies are
        exactly SL004's findings: the round's harvest, the close's, the DTW
        monitor's readings."""
        sources = sources_of([
            "src/repro_torch/launch/stream.py",
            "src/repro_torch/core/symed.py"])
        rel = "src/repro_torch/launch/stream.py"
        marked = [i + 1 for i, line in enumerate(
            sources[rel].splitlines()) if line.endswith("# sync: ok")]
        sources[rel] = sources[rel].replace("  # sync: ok", "")
        found = run("port", tmp_path, sources, ["SL004"]).findings
        assert sorted(f.line for f in found) == marked
        assert len(marked) == 4


# -------------------------------------------------------- the registry


ENTRY_GOOD = """\
class Server:
    def step(self, state, x):  # symlint-torch: entry(drive=stream, budget=2, cpu_budget=3, shapes=table-step, pair=chunk/table)
        return state + x
"""


def registry(tmp_path, sources):
    write(tmp_path, sources)
    return port_deep.entry_registry(
        port_engine.load_project(tmp_path, [tmp_path]))


class TestRegistry:
    def test_parse_all_keys_on_a_method(self, tmp_path):
        entries, errors = registry(tmp_path, {"mod.py": ENTRY_GOOD})
        assert errors == []
        (e,) = entries
        assert (e.qualname, e.drive, e.budget, e.cpu_budget, e.shapes) == (
            "Server.step", "stream", 2, 3, "table-step")
        assert (e.pair_label, e.pair_role) == ("chunk", "table")

    @pytest.mark.parametrize("mutant,expect", [
        ("drive=stream, budget=two", "not an int"),
        ("drive=stream, colour=red", "unknown"),
        ("pair=chunk", "slot or"),
        ("budget=0", "at least"),
        ("drive=stream, budget=2", "cpu_budget="),
        ("drive=stream, cpu_budget=2", "budget="),
    ])
    def test_malformed_annotation_is_error(self, tmp_path, mutant, expect):
        src = ENTRY_GOOD.replace(
            "entry(drive=stream, budget=2, cpu_budget=3, shapes=table-step, "
            "pair=chunk/table)", f"entry({mutant})")
        entries, errors = registry(tmp_path, {"mod.py": src})
        assert entries == []
        assert len(errors) == 1 and expect in errors[0][2]

    def test_nested_def_is_error(self, tmp_path):
        src = ("def outer():\n"
               "    def inner(x):  # symlint-torch: entry(drive=stream)\n"
               "        return x\n"
               "    return inner\n")
        entries, errors = registry(tmp_path, {"mod.py": src})
        assert entries == [] and "module-level" in errors[0][2]

    def test_dangling_annotation_is_error(self, tmp_path):
        entries, errors = registry(
            tmp_path, {"mod.py": "x = 1  # symlint-torch: entry(drive=s)\n"})
        assert entries == [] and "not attached" in errors[0][2]

    def test_reference_marker_is_not_an_entry(self, tmp_path):
        src = ENTRY_GOOD.replace("symlint-torch:", "symlint:")
        assert registry(tmp_path, {"mod.py": src}) == ([], [])

    def test_f64_ok_needs_a_reason(self, tmp_path):
        write(tmp_path, {"mod.py": (
            "def a(x):  # symlint-torch: f64-ok: emulates f32 rounding\n"
            "    return x\n"
            "def b(x):  # symlint-torch: f64-ok\n"
            "    return x\n")})
        marked, errors = port_deep.f64_ok_registry(
            port_engine.load_project(tmp_path, [tmp_path]))
        assert marked == [("mod.py", "a")]
        assert len(errors) == 1 and "reason" in errors[0][2]

    def test_counterpart_of_every_reference_entry(self):
        from repro.analysis.deep import entry_registry as ref_registry

        paths = [REPO_ROOT / d for d in ("src", "examples", "benchmarks")]
        ref_entries, _ = ref_registry(ref_engine.load_project(REPO_ROOT,
                                                              paths))
        assert len(ref_entries) == 13
        assert ({f"{e.relpath}:{e.qualname}" for e in ref_entries}
                == set(port_deep.REFERENCE_ENTRIES))
        project = port_engine.load_project(
            REPO_ROOT, port_engine.default_paths(REPO_ROOT))
        entries, errors = port_deep.entry_registry(project)
        assert errors == []
        names = {e.qualname for e in entries}
        for ref, ours in port_deep.REFERENCE_ENTRIES.items():
            assert set(ours) <= names, ref
        pairs = {(e.pair_label, e.pair_role) for e in entries
                 if e.pair_label}
        assert {("chunk", "slot"), ("chunk", "table"), ("pieces", "slot"),
                ("pieces", "table"), ("span", "slot"),
                ("span", "table")} <= pairs
        # each pair member stands for the reference's member
        ref_pairs = {(e.pair_label, e.pair_role): f"{e.relpath}:{e.qualname}"
                     for e in ref_entries if e.pair_label}
        ours = {(e.pair_label, e.pair_role): e.qualname for e in entries
                if e.pair_label}
        for key, ref in ref_pairs.items():
            assert ours[key] in port_deep.REFERENCE_ENTRIES[ref]

    def test_counterpart_of_every_reference_hot_path(self):
        from repro.analysis.rules import hostsync as ref_hostsync
        from repro_torch.analysis.rules import hostsync as port_hostsync

        ref_project = ref_engine.load_project(
            REPO_ROOT, [REPO_ROOT / "src" / "repro"])
        ref_hot = {f"{rel}:{qual}"
                   for rel, sf in ref_project.files.items()
                   for qual, node in ref_hostsync.iter_functions(sf.tree)
                   if hasattr(node, "decorator_list")
                   and ref_hostsync._is_hot_path(sf, node)}
        assert ref_hot == set(port_deep.REFERENCE_HOT_PATHS)
        project = port_engine.load_project(
            REPO_ROOT, port_engine.default_paths(REPO_ROOT))
        ours = {qual for _, qual, _ in port_hostsync.hot_paths(project)}
        assert set(port_deep.REFERENCE_HOT_PATHS.values()) <= ours


# ------------------------------------------------------ the head, imports


class TestHead:
    def test_head_is_clean(self):
        project = port_engine.load_project(
            REPO_ROOT, port_engine.default_paths(REPO_ROOT))
        assert "chip_smoke.py" in project.files
        assert any(rel.startswith("examples/torch_")
                   for rel in project.files)
        baseline = port_engine.Baseline(
            REPO_ROOT / port_engine.BASELINE_NAME)
        result = port_engine.analyze(project, None, baseline)
        assert result.parse_errors == []
        assert result.findings == [], [f.to_json() for f in result.findings]
        assert result.stale_baseline == []
        for e in baseline.entries.values():
            assert e["justification"] != port_engine.TODO_JUSTIFICATION

    def test_cli_list_rules(self, capsys):
        assert port_cli.main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for rid in ("SL004", "SL005", "SL006", "SL007"):
            assert f"{rid}  " in out
        for rid in ("SL001", "SL002", "SL003", "SL008"):
            assert f"{rid}  " in out and "no counterpart" in out

    def test_ast_tier_imports_no_torch_jax_or_repro(self):
        code = (
            "import sys\n"
            "from repro_torch.analysis.cli import main\n"
            "rc = main([])\n"
            "bad = sorted(m for m in sys.modules if m in ('torch', 'jax') "
            "or m.startswith(('torch.', 'jax.', 'repro.')) or m == 'repro')\n"
            "print('BAD', bad)\n"
            "sys.exit(rc or (1 if bad else 0))\n")
        env = {**os.environ, "PYTHONPATH": str(REPO_ROOT / "src")}
        res = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert res.returncode == 0, res.stdout + res.stderr
        assert "BAD []" in res.stdout
        assert "symlint: 0 findings" in res.stdout
