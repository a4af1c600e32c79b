"""The port's data pipeline and train loop.

``SymbolPipeline``'s documents and ``TokenBatcher``'s batches equal the
JAX reference's exactly (the same keys, bit for bit, and the port's
``symed_batch`` bitwise); the tokenizer is the reference's.  The train
loop fails at a step and resumes from its checkpoint to the target step;
the CLI runs in process.  The reference's ``train_loop`` is not run here
(minutes on this CPU); the loop's pipeline is cut to small slabs
(``stream_len=256``, ``slab=4``) by a subclass, since the loop's own
slabs (32 x 1024) take minutes to symbolize on the CPU.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import itertools

import numpy as np
import pytest
import torch

from repro.core.symed import SymEDConfig as JConfig
from repro.data import SymbolPipeline as JPipeline
from repro.data import SymbolTokenizer as JTokenizer
from repro.data import TokenBatcher as JBatcher
from repro_torch.core.symed import SymEDConfig
from repro_torch.data import SymbolPipeline, SymbolTokenizer, TokenBatcher
from repro_torch.launch import train as ttrain

SMALL = dict(tol=0.5, alpha=0.02, n_max=64, k_max=16, len_max=64)


def _pipes(seed=3):
    jtok, ttok = JTokenizer(k_max=16), SymbolTokenizer(k_max=16)
    return (JPipeline(JConfig(**SMALL), jtok, stream_len=256, slab=4,
                      seed=seed),
            SymbolPipeline(SymEDConfig(**SMALL), ttok, stream_len=256,
                           slab=4, seed=seed, device="cpu"))


def test_pipeline_docs_equal():
    jp, tp = _pipes()
    want = list(itertools.islice(jp.docs(), 12))   # three slabs
    got = list(itertools.islice(tp.docs(), 12))
    assert got == want
    assert all(d[0] == 1 and d[-1] == 2 for d in got)


def test_batches_equal():
    jp, tp = _pipes(seed=5)
    jb, tb = JBatcher(jp, batch=2, seq_len=33), TokenBatcher(tp, batch=2,
                                                            seq_len=33)
    want = list(itertools.islice(iter(jb), 3))
    got = list(itertools.islice(iter(tb), 3))
    jb.close()
    tb.close()
    assert not tb._thread.is_alive()
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (2, 33)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("len_buckets", [None, [2, 8, 32]])
def test_tokenizer(len_buckets):
    j, t = JTokenizer(10, len_buckets), SymbolTokenizer(10, len_buckets)
    assert j.vocab_size == t.vocab_size
    labels = np.array([3, 12, 0, 7], np.int32)
    lens = np.array([1, 9, 40, 2], np.float32)
    assert j.encode(labels, 3, lens) == t.encode(labels, 3, lens)
    docs = [j.encode(labels, n, lens) for n in range(5)]
    np.testing.assert_array_equal(j.pack(docs, 7), t.pack(docs, 7))
    np.testing.assert_array_equal(j.pack(docs[:1], 9), t.pack(docs[:1], 9))


class _SmallSlabs(SymbolPipeline):
    """The loop's pipeline at 4 streams of 256 points."""

    def __init__(self, cfg, tok, stream_len=1024, slab=32, seed=0,
                 device=None):
        super().__init__(cfg, tok, stream_len=256, slab=4, seed=seed,
                         device=device)


@pytest.fixture
def small_slabs(monkeypatch):
    monkeypatch.setattr(ttrain, "SymbolPipeline", _SmallSlabs)


def test_fail_restore_continue(tmp_path, small_slabs):
    """A simulated node failure mid-run; the restart resumes from the
    checkpoint and reaches the target step (the reference's
    ``TestTrainingFaultTolerance`` on a tiny config)."""
    cfg = ttrain.cli_config("xlstm-125m", True)
    kw = dict(steps=6, batch=2, seq=32, ckpt_dir=str(tmp_path), ckpt_every=2,
              log_every=100, symed=SymEDConfig(**SMALL), device="cpu")
    with pytest.raises(RuntimeError, match="simulated node failure"):
        ttrain.train_loop(cfg, fail_at_step=4, **kw)
    assert sorted(p.name for p in tmp_path.glob("ckpt_*")) == [
        "ckpt_00000002", "ckpt_00000004"]
    state, report = ttrain.train_loop(cfg, **kw)
    assert int(state["step"]) == 6
    assert len(report["loss_history"]) == 2
    assert np.isfinite(report["loss_history"]).all()
    assert len(report["step_seconds"]) == len(report["wait_seconds"]) == 2
    assert set(report["telemetry"]) == {"host0/aux", "host0/grad_norm",
                                        "host0/loss", "host0/xent"}


def test_cli(tmp_path, small_slabs, capsys):
    """The CLI in process: a simulated failure propagates (the process
    exits non-zero); a clean run prints the reference's lines and the
    timing line.  (Its checkpoints come every 25 steps: resuming is
    ``test_fail_restore_continue``'s.)"""
    args = ["--arch", "xlstm-125m", "--reduced", "--steps", "3", "--batch",
            "2", "--seq", "64", "--device", "cpu", "--ckpt-dir",
            str(tmp_path)]
    with pytest.raises(RuntimeError, match="at step 2"):
        ttrain.main(args + ["--fail-at-step", "2"])
    assert ttrain.main(args) == 0
    out = capsys.readouterr().out
    assert "[train] step 0: loss=" in out and "[telemetry] raw=" in out
    assert "[train] done in" in out and "ms/step after the first" in out


def test_cli_config():
    from repro.launch.train import lm100m_config

    cfg = ttrain.cli_config(None, False)
    assert cfg.name == "symlm-100m" and cfg.vocab == 128
    assert cfg == ttrain.lm100m_config(128)
    assert cfg.param_count() == lm100m_config(128).param_count() \
        == 113_363_712
    assert ttrain.cli_config("olmoe-1b-7b", True).vocab >= 68


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SymbolPipeline(SymEDConfig(), SymbolTokenizer())


def test_training_imports_no_jax():
    """``repro_torch.train.optimizer``, ``train.steps``,
    ``train.telemetry``, ``ckpt``, ``data`` and ``launch.train``, one
    train step and one compressed step, a checkpoint written and restored,
    a pipeline document and a telemetry digitize leave jax and every module
    of the JAX package out of ``sys.modules``."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    code = (
        "import sys, tempfile, itertools, torch\n"
        "import repro_torch.train.optimizer, repro_torch.train.steps\n"
        "import repro_torch.train.telemetry, repro_torch.ckpt\n"
        "import repro_torch.data, repro_torch.launch.train as lt\n"
        "from repro_torch.train.steps import *\n"
        "from repro_torch.train.optimizer import OptConfig\n"
        "from repro_torch.launch.mesh import make_test_mesh\n"
        "cfg = lt.cli_config('xlstm-125m', True)\n"
        "oc = OptConfig(warmup_steps=1, total_steps=4)\n"
        "st = init_train_state(torch.Generator().manual_seed(0), cfg, oc)\n"
        "b = {'tokens': torch.randint(0, cfg.vocab, (2, 9))}\n"
        "st, m = make_train_step(cfg, oc)(st, b)\n"
        "st['error_fb'] = init_error_fb(st['params'])\n"
        "mesh = make_test_mesh((2,), ('pod',), device='cpu')\n"
        "st, m = make_compressed_train_step(cfg, oc, mesh)(st, b)\n"
        "assert torch.isfinite(m['loss'])\n"
        "d = tempfile.mkdtemp()\n"
        "del st['error_fb']\n"
        "repro_torch.ckpt.save_checkpoint(d, 2, st)\n"
        "back, man = repro_torch.ckpt.restore_checkpoint(d, 2, st)\n"
        "assert man['step'] == 2 and int(back['step']) == 2\n"
        "from repro_torch.core.symed import SymEDConfig\n"
        "p = repro_torch.data.SymbolPipeline(SymEDConfig(n_max=32, k_max=8,"
        " len_max=32), repro_torch.data.SymbolTokenizer(8), stream_len=64,"
        " slab=2, device='cpu')\n"
        "assert next(p.docs())[0] == 1\n"
        "hub = repro_torch.train.telemetry.TelemetryHub()\n"
        "for i in range(60): hub.record('x', float(i % 7))\n"
        "assert hub.digitize('x', device='cpu') is not None\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.') or m == 'msgpack']\n"
        "print('BAD', bad)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(repo / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(repo), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout
