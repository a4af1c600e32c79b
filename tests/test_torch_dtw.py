"""The port's DTW against the JAX reference, and its kernel on the card.

On the CPU ``repro_torch.kernels.ops.dtw`` runs the plain PyTorch version
(``core.metrics.dtw_ref``), which fuses each cell's multiply-add as the
reference's compiled ``dtw_ref`` mostly does (its vectorized loops leave a
few cells unfused, one ulp apart).  It is held against
``repro.kernels.ref.dtw_batch_ref`` and the Pallas kernel in interpret mode
(``repro.kernels.ops.dtw``) at the shapes of ``tests/test_kernels.py``
within rtol = atol = 1e-5, the parity contract's DTW tolerance.
The CUDA kernel runs only on a card (``-m cuda``), where it must be bitwise
equal to the plain version; that test needs no JAX.
"""
import numpy as np
import pytest
import torch

from conftest import make_stream

try:
    import jax.numpy as jnp
    from repro.core import metrics as jm
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    jm = None
needs_jax = pytest.mark.skipif(jm is None, reason="needs the JAX reference")

from repro_torch.core import metrics as tm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dtw import dtw_cuda

FULL = [(1, 32), (4, 150), (8, 128), (3, 257), (16, 64)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(b, n, seed, noise=0.3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n)).cumsum(1).astype(np.float32)
    y = (x + rng.normal(0, noise, (b, n))).astype(np.float32)
    return x, y


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a GPU")
    return torch.cuda.get_device_name()


@needs_jax
@pytest.mark.parametrize("b,n,band", [(b, n, None) for b, n in FULL]
                         + [(4, 200, 5), (4, 200, 20), (4, 200, 64),
                            (3, 96, 0)])
def test_plain_version_matches_reference(b, n, band):
    x, y = _pair(b, n, 1000 * b + n + (band or 0))
    before = dtw_cuda.launches
    got = ops.dtw(torch.from_numpy(x), torch.from_numpy(y), band=band)
    assert dtw_cuda.launches == before  # CPU tensors: no kernel
    assert got.dtype == torch.float32 and got.shape == (b,)
    for name, want in (
            ("ref", jref.dtw_batch_ref(x, y, band)),
            ("pallas interpret", jops.dtw(jnp.asarray(x), jnp.asarray(y),
                                          band=band))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **TOL)
    if band == 0:  # the diagonal path: pointwise L2 on equal lengths
        np.testing.assert_allclose(
            got.numpy(), np.sqrt(((x - y) ** 2).sum(1)), rtol=1e-4)


def test_identity_and_monotone_in_band():
    x, y = _pair(2, 100, 5, noise=3.0)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    assert torch.all(ops.dtw(xt, xt) <= 1e-4)
    d_full, d10, d3 = (ops.dtw(xt, yt, band=b) for b in (None, 10, 3))
    assert torch.all(d3 >= d10 - 1e-4) and torch.all(d10 >= d_full - 1e-4)
    for band in (None, 3):  # force_ref is the same function on the CPU
        assert torch.equal(ops.dtw(xt, yt, band=band),
                           ops.dtw(xt, yt, band=band, force_ref=True))


@needs_jax
@pytest.mark.parametrize("band", [None, 0, 1, 3, 40])
def test_unequal_lengths_band_clamp(band):
    """N != M through ``dtw_ref``: the band clamps to ``|N - M|`` so the
    terminal cell stays reachable; leading batch axes broadcast."""
    rng = np.random.default_rng(0)
    x = make_stream(rng, 90)
    y = make_stream(np.random.default_rng(3), 50)
    got = tm.dtw_ref(torch.from_numpy(x), torch.from_numpy(y), band=band)
    np.testing.assert_allclose(float(got), float(jm.dtw_ref(x, y, band=band)),
                               **TOL)
    assert float(got) < 1e10
    xs = np.stack([x, x[::-1].copy()])
    got2 = tm.dtw_ref(torch.from_numpy(xs), torch.from_numpy(y), band=band)
    np.testing.assert_allclose(got2.numpy(),
                               np.asarray(jm.dtw_ref(xs, y, band=band)),
                               **TOL)
    assert got2[0] == got


def test_compression_rate_abba():
    from repro.core.metrics import compression_rate_abba

    n = np.array([50, 7, 300], np.int32)
    k = np.array([5, 3, 100], np.int32)
    for points in (1000, 97):
        np.testing.assert_array_equal(
            tm.compression_rate_abba(torch.from_numpy(n), torch.from_numpy(k),
                                     points).numpy(),
            np.asarray(compression_rate_abba(jnp.asarray(n), jnp.asarray(k),
                                             points)))


def test_kernel_wrapper_rejects_cpu_tensors():
    x, y = _pair(1, 8, 0)
    with pytest.raises(ValueError, match="CUDA"):
        dtw_cuda(torch.from_numpy(x), torch.from_numpy(y))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,band", [(b, n, None) for b, n in FULL]
                         + [(4, 200, 5), (4, 200, 20), (4, 200, 64),
                            (3, 96, 0), (2, 20000, None), (256, 2048, None),
                            (256, 2048, 64), (0, 16, None)])
def test_kernel_bitwise_equal_to_plain_on_cuda(b, n, band):
    name = _cuda()
    x, y = (torch.from_numpy(a).cuda() for a in _pair(b, n, 7 + n))
    before = dtw_cuda.launches
    got = ops.dtw(x, y, band=band)
    assert dtw_cuda.launches == before + (1 if b else 0), name
    want = ref.dtw_batch_ref(x, y, band)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b,)
    assert torch.equal(got, want), (
        f"DTW kernel differs from its plain version on {name}: max abs "
        f"{(got - want).abs().max().item() if b else 0.0}")
