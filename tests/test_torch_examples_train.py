"""The training slice's examples: ``examples/torch_anomaly_monitor.py``
with ``--device cpu`` prints what ``examples/anomaly_monitor.py`` prints
(run in the same process); ``examples/torch_train_lm.py`` trains its
quick preset a few steps on the CPU (the loop's pipeline cut to small
slabs, as in ``tests/test_torch_train_loop.py``) and prints the reference
example's lines.  Without ``--device`` each runs on ``cuda``.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from repro_torch.data import SymbolPipeline
from repro_torch.launch import train as ttrain

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_anomaly_monitor(capsys):
    _load("anomaly_monitor").main()
    want = capsys.readouterr().out
    _load("torch_anomaly_monitor").main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert "host07 step 200: straggler" in got
    assert "host03 step 350: hang" in got


class _SmallSlabs(SymbolPipeline):
    def __init__(self, cfg, tok, stream_len=1024, slab=32, seed=0,
                 device=None):
        super().__init__(cfg, tok, stream_len=256, slab=4, seed=seed,
                         device=device)


def test_train_lm(capsys, monkeypatch):
    monkeypatch.setattr(ttrain, "SymbolPipeline", _SmallSlabs)
    ref = _load("train_lm")
    cfg = ref.small_config(vocab=68)
    _load("torch_train_lm").main(["--device", "cpu", "--steps", "3",
                                  "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"[train_lm] symlm-6m: {cfg.param_count() / 1e6:.1f}M "
                      "params, vocab=68 (SymED symbols), 3 steps @ batch=2 "
                      "seq=32")
    assert re.fullmatch(r"\[train_lm\] loss \S+ -> \S+ \(-?\d+\.\d% "
                        r"reduction\)", out[-1]), out[-1]
    assert any(l.startswith("[train] step 0: loss=") for l in out)


@pytest.mark.parametrize("name", ["anomaly_monitor", "train_lm"])
def test_default_device_is_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("the default device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load(f"torch_{name}").main(["--steps", "1"] if name == "train_lm"
                                    else [])
