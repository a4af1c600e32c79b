"""The port's ABBA baseline and the paper's configuration against the JAX
reference.

Every case runs ``repro.core.abba_encode`` and
``repro_torch.core.abba.abba_encode`` on the same numpy stream: every field
of ``AbbaResult`` must be exactly equal (integers exact, floats bitwise).
The inputs are the five families of ``data.synthetic.make_dataset`` at the
Fig. 5 benchmark's settings (4 series x 1000 points, seed 11, ``n_max=256``,
``len_max=256``, ``k_max=64``, ``scl=1.0``) at tol 0.5 and 1.9 (0.1 in
``test_torch_abba_fine.py``), the shapes of ``tests/test_core_digitize.py``'s
and ``tests/test_system.py``'s ABBA tests, a constant stream and a stream of
two points.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_stream

from repro.configs import symed_paper as jax_paper
from repro.core import abba_encode as jax_abba
from repro.core import compression_rate_abba as jax_cr_abba
from repro.core import dtw_ref as jax_dtw
from repro.core.reconstruct import reconstruct_from_symbols as jax_rec
from repro.data.synthetic import FAMILIES, make_dataset
from repro_torch.core import (AbbaResult, abba_encode, compression_rate_abba,
                              dtw_ref, reconstruct_from_symbols)

FIG5 = dict(n_max=256, scl=1.0, len_max=256, k_max=64)


def _stream_cases():
    cases = {}
    for s in range(3):  # test_system.py's Fig. 5a check
        cases[f"system{s}"] = (make_stream(np.random.default_rng(s), 600),
                               dict(n_max=256, tol=0.5, len_max=128, k_max=32))
    for i in range(4):  # test_core_digitize.py's CR check
        cases[f"cr{i}"] = (make_stream(np.random.default_rng(i), 800),
                           dict(n_max=512, tol=0.5, len_max=256, k_max=32))
    cases["cover"] = (make_stream(np.random.default_rng(0), 600),
                      dict(n_max=256, tol=0.4, len_max=128, k_max=32))
    cases["constant"] = (np.full(100, 3.0, np.float32),
                         dict(n_max=64, tol=0.5, len_max=64, k_max=16))
    cases["two_points"] = (np.array([1.0, 2.5], np.float32),
                           dict(n_max=8, tol=0.5, len_max=8, k_max=4))
    return cases


CASES = _stream_cases()


def _both(ts, kw):
    want = jax_abba(jnp.asarray(ts), **kw)
    got = abba_encode(torch.from_numpy(ts), device="cpu", **kw)
    return want, got


@functools.lru_cache(maxsize=None)
def _case(name):
    ts, kw = CASES[name]
    return _both(ts, kw)


def _assert_equal(want, got):
    assert isinstance(got, AbbaResult)
    assert got._fields == want._fields
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("tol", (0.5, 1.9))
def test_fig5_families_bitwise(family, tol):
    """tol 0.1, where the buffers fill, is in test_torch_abba_fine.py."""
    for row in make_dataset(family, 4, 1000, seed=11):
        _assert_equal(*_both(row, dict(FIG5, tol=tol)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_shapes_bitwise(name):
    ts = CASES[name][0]
    want, got = _case(name)
    _assert_equal(want, got)
    n = int(got.n_pieces)
    assert int(got.lengths[:n].sum()) == ts.shape[0] - 1
    cr_w = jax_cr_abba(want.n_pieces, want.k, ts.shape[0])
    cr_g = compression_rate_abba(got.n_pieces, got.k, ts.shape[0])
    np.testing.assert_array_equal(cr_g.numpy(), np.asarray(cr_w))


@pytest.mark.parametrize("name", ["system0", "system1", "system2", "cover"])
def test_reconstruction_and_dtw(name):
    """test_system.py's reconstruction of the symbols in raw space, scored
    with ``dtw_ref``: within 1e-5 relative of the reference's."""
    ts = CASES[name][0]
    want, got = _case(name)
    t0_w = jnp.float32((ts[0] - float(want.mean)) / float(want.std))
    rec_w = jax_rec(want.labels, want.centers, want.n_pieces, t0_w, len(ts))
    re_w = float(jax_dtw(jnp.asarray(ts), rec_w * want.std + want.mean))
    t0_g = torch.tensor((ts[0] - float(got.mean)) / float(got.std),
                        dtype=torch.float32)
    rec_g = reconstruct_from_symbols(got.labels, got.centers, got.n_pieces,
                                     t0_g, len(ts))
    np.testing.assert_allclose(rec_g.numpy(), np.asarray(rec_w), rtol=1e-5,
                               atol=1e-5)
    re_g = float(dtw_ref(torch.from_numpy(ts), rec_g * got.std + got.mean))
    assert abs(re_g - re_w) <= 1e-5 * max(abs(re_w), 1.0), (re_g, re_w)


def test_abba_defaults_match_reference():
    """The port's keyword defaults are the reference's."""
    import inspect

    want = inspect.signature(jax_abba).parameters
    got = inspect.signature(abba_encode).parameters
    for name, p in want.items():
        if p.kind is p.KEYWORD_ONLY:
            assert got[name].default == p.default, name
    assert got["device"].default is None


def test_abba_default_device_is_cuda():
    ts = np.linspace(0, 1, 16, dtype=np.float32)
    if torch.cuda.is_available():
        assert abba_encode(ts, n_max=16, k_max=4).labels.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            abba_encode(ts, n_max=16, k_max=4)


@pytest.mark.parametrize("name", ["PAPER_SYMED", "PAPER_RUNNING_EXAMPLE"])
def test_paper_configs_equal(name):
    from repro_torch.configs import symed_paper

    want = dataclasses.asdict(getattr(jax_paper, name))
    got = dataclasses.asdict(getattr(symed_paper, name))
    assert got == want


def test_paper_tol_sweep_and_registry():
    import repro_torch.configs as tcfg
    from repro_torch.configs import symed_paper

    assert symed_paper.PAPER_TOL_SWEEP == jax_paper.PAPER_TOL_SWEEP
    assert tcfg.PAPER_SYMED is symed_paper.PAPER_SYMED
    assert tcfg.PAPER_TOL_SWEEP is symed_paper.PAPER_TOL_SWEEP


@pytest.mark.cuda
def test_abba_on_card_against_cpu():
    """On the card (the Lloyd kernel in the k-search): lengths, incs,
    n_pieces, mean and std bitwise to the CPU port, labels by C2's rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    agree = total = 0
    for family in FAMILIES:
        for row in make_dataset(family, 2, 1000, seed=11):
            cpu = abba_encode(row, device="cpu", **dict(FIG5, tol=0.5))
            gpu = abba_encode(row, device="cuda", **dict(FIG5, tol=0.5))
            for name in ("lengths", "incs", "n_pieces", "mean", "std"):
                np.testing.assert_array_equal(
                    getattr(gpu, name).cpu().numpy(),
                    getattr(cpu, name).numpy(), err_msg=name)
            n = int(cpu.n_pieces)
            agree += int((gpu.labels.cpu()[:n] == cpu.labels[:n]).sum())
            total += n
    assert agree >= 0.99 * total, (agree, total)
    print(f"abba on {torch.cuda.get_device_name()}: labels {agree}/{total}")
