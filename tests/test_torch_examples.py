"""The port's examples against the reference's: ``examples/torch_*.py``
with ``--device cpu`` print what ``examples/quickstart.py``,
``stream_service.py`` and ``transport_link.py`` print, run in the same
process.  The transport link's socket port and its delta-frame count (how
the server's select loop batches arrivals: it varies from run to run in
the reference too) are masked; every other number is compared as printed.
Without ``--device`` each example runs on ``cuda``.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import importlib.util
import re
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _outputs(name, capsys):
    """(the reference example's stdout, the port's with --device cpu)."""
    _load(name).main()
    want = capsys.readouterr().out
    _load(f"torch_{name}").main(["--device", "cpu"])
    return want, capsys.readouterr().out


def test_quickstart(capsys):
    want, got = _outputs("quickstart", capsys)
    assert got == want
    symbols = [l for l in got.splitlines() if l.startswith("symbols")]
    assert len(symbols) == 1 and len(symbols[0].split(": ")[1]) > 0


def test_stream_service(capsys):
    want, got = _outputs("stream_service", capsys)
    assert got == want
    assert "-- closing sessions" in got


def _mask_transport(out):
    out = re.sub(r"listening on 127\.0\.0\.1:\d+", "listening on PORT", out)
    return re.sub(r"\d+ wire-out B in \d+ delta frames",
                  "N wire-out B in N delta frames", out)


def test_transport_link(capsys):
    want, got = _outputs("transport_link", capsys)
    assert _mask_transport(got) == _mask_transport(want)
    assert "pieces sender" in got and "raw sender" in got


@pytest.mark.parametrize("name", ["quickstart", "stream_service",
                                  "transport_link"])
def test_default_device_is_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("the default device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load(f"torch_{name}").main([])
