"""The port's stream CLI (``repro_torch.launch.stream``) rejects what the
reference's (``repro.launch.stream``) rejects: exit 2 and the same message,
from the shared surface ``repro_torch.launch.cli`` before any torch work.
The messages are pinned here letter for letter; where JAX is installed
each is also held against the reference's parser, run in this process."""
import sys

import pytest

from repro_torch.launch.stream import main as port_main

try:
    from repro.launch.stream import main as reference_main
except ImportError:
    reference_main = None

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


def test_new_flags_reach_the_server(capsys):
    """``--digitize-every`` and ``--shrink-patience`` are accepted, and a
    small autoscaled run with them on the CPU closes every session."""
    rep = port_main(["--device", "cpu", "--sessions", "3", "--max-slots", "4",
                     "--length", "96", "--window", "48", "--autoscale",
                     "--digitize-every", "2", "--shrink-patience", "1"])
    assert int(rep["opened"]) == int(rep["closed"]) == 3
    assert "stream_summary opened=3 closed=3" in capsys.readouterr().out
