"""The port's stream and transport CLIs (``repro_torch.launch.stream``,
``repro_torch.launch.transport``) reject what the reference's reject: exit
2 and the same message, from the shared surface ``repro_torch.launch.cli``
before any torch work.  The messages are pinned here letter for letter;
where JAX is installed each is also held against the reference's parser,
run in this process."""
import sys

import pytest

from repro_torch.launch.stream import main as port_main
from repro_torch.launch.transport import main as port_transport_main

try:
    from repro.launch.stream import main as reference_main
    from repro.launch.transport import main as reference_transport_main
except ImportError:
    reference_main = reference_transport_main = None

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


@pytest.mark.parametrize("flags", [
    ["--devices", "2"], ["--metrics-port", "9100"], ["--trace-out", "t.json"],
    ["--metrics-linger", "1"], ["--pretrace"]])
def test_transport_rejects_flags_of_unported_parts(flags, capsys):
    """Flags of the sharded table, the flight recorder and the CUDA-graph
    ladder are not accepted quietly."""
    message = _error(lambda: port_transport_main(flags), capsys)
    assert message == f"unrecognized arguments: {' '.join(flags)}"


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
