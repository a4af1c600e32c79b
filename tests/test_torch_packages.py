"""The port's package re-exports against the reference's (ROADMAP Queue C
16): ``repro_torch.data`` re-exports what ``repro.data`` does (the
synthetic data; since the training slice the tokenizer and pipeline),
``repro_torch.kernels`` imports ``ops`` and ``ref`` as ``repro.kernels``
does, without building a kernel, and ``repro_torch.sharding`` exports the
names ``repro.sharding`` does.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.data
import repro.kernels
import repro.sharding
import repro_torch.data
import repro_torch.kernels
import repro_torch.sharding

REPO = Path(__file__).resolve().parents[1]
DATA_NAMES = ["FAMILIES", "make_dataset", "make_fleet"]


@pytest.mark.parametrize("name", DATA_NAMES)
def test_data_reexports(name):
    ns = {}
    exec(f"from repro.data import {name} as ref\n"
         f"from repro_torch.data import {name} as port", ns)
    assert name in repro_torch.data.__all__ and name in repro.data.__all__
    if name == "FAMILIES":
        assert tuple(ns["port"]) == tuple(ns["ref"])
    elif name == "make_fleet":
        np.testing.assert_array_equal(ns["port"](4, 64, seed=3),
                                      np.asarray(ns["ref"](4, 64, seed=3)))
    else:
        for a, b in zip(ns["port"]("sensor", 2, 100, seed=5),
                        ns["ref"]("sensor", 2, 100, seed=5)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_data_reexports_every_name():
    """Every name of ``repro.data.__all__``, the training slice's
    ``SymbolTokenizer``, ``SymbolPipeline`` and ``TokenBatcher`` too."""
    assert sorted(repro_torch.data.__all__) == sorted(repro.data.__all__)
    for name in ("SymbolTokenizer", "SymbolPipeline", "TokenBatcher"):
        assert getattr(repro_torch.data, name).__name__ == name


@pytest.mark.parametrize("name", ["ops", "ref"])
def test_kernels_reexports(name):
    ns = {}
    exec(f"from repro.kernels import {name} as ref\n"
         f"from repro_torch.kernels import {name} as port", ns)
    assert name in repro_torch.kernels.__all__
    assert ns["port"] is getattr(repro_torch.kernels, name)
    if name == "ops":   # the reference's entry points, name for name
        for fn in ("ewma_scan", "kmeans_assign", "dtw"):
            assert callable(getattr(ns["port"], fn))
            assert callable(getattr(ns["ref"], fn))


def test_importing_kernels_builds_nothing():
    """In a fresh process with ``subprocess.run`` (what ``nvcc`` runs
    through) made to raise: the package and its entry points import, and
    no kernel library is built or loaded."""
    code = (
        "import subprocess\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('a build started')\n"
        "subprocess.run = boom\n"
        "import repro_torch.kernels as k\n"
        "from repro_torch.kernels import _build\n"
        "assert callable(k.ops.kmeans_lloyd) and callable(k.ref.dtw_batch_ref)\n"
        "assert not _build._LIBS, _build._LIBS\n"
        "print('OK')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", \
        proc.stdout + proc.stderr


def test_sharding_reexports():
    """``repro_torch.sharding`` exports the reference's names, each a
    function of the port's own modules."""
    assert sorted(repro_torch.sharding.__all__) == sorted(
        repro.sharding.__all__)
    for name in repro.sharding.__all__:
        fn = getattr(repro_torch.sharding, name)
        assert callable(fn) and fn.__module__.startswith(
            "repro_torch.sharding."), name
