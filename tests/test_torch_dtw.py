"""The port's DTW against the JAX reference, and its kernel on the card.

On the CPU ``repro_torch.kernels.ops.dtw`` runs the plain PyTorch version
(``core.metrics.dtw_ref``), which fuses each cell's multiply-add as the
reference's compiled ``dtw_ref`` mostly does (its vectorized loops leave a
few cells unfused, one ulp apart).  It is held against
``repro.kernels.ref.dtw_batch_ref`` and the Pallas kernel in interpret mode
(``repro.kernels.ops.dtw``) at the shapes of ``tests/test_kernels.py``
within rtol = atol = 1e-5, the parity contract's DTW tolerance.
The CUDA kernel runs only on a card (``-m cuda``), where it must be bitwise
equal to the plain version; that test needs no JAX.  On the CPU
``_replay`` walks the kernel's tiled wavefront step by step (tile order,
lane shuffles, the boundary buffers and corners, skipped out-of-band tiles,
ragged edges) with small tiles, and is held bitwise to the plain version.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
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
from repro_torch.core.normalize import fma32
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dtw import _lib, dtw_cuda

FULL = [(1, 32), (4, 150), (8, 128), (3, 257), (16, 64)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(b, n, seed, noise=0.3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n)).cumsum(1).astype(np.float32)
    y = (x + rng.normal(0, noise, (b, n))).astype(np.float32)
    return x, y


def _replay(x, y, band, lanes, rows, cols):
    """``csrc/dtw.cu``'s traversal on the CPU, with tiles of ``lanes *
    rows`` rows by ``cols`` columns (the kernel's: 32 * 8 by 128).

    A warp's lanes are one axis of the tensors; ``__shfl_up_sync`` is a
    shift along it.  Buffer slots the kernel leaves stale (those of skipped
    tiles) are NaN here, so reading one shows in the result.  Returns the
    distances and the number of tiles visited.
    """
    b, n = x.shape
    r = n if band is None else min(max(int(band), 0), n)
    t_rows = lanes * rows
    n_p, n_q = -(-n // t_rows), -(-n // cols)
    big = torch.tensor(1e30)
    nan = float("nan")
    top = torch.full((b, n), nan)
    left = torch.full((b, n), nan)
    corner = torch.full((b, n_p, 3), nan)
    lane = torch.arange(lanes)

    def in_band(p, q):
        i0, j0 = p * t_rows, q * cols
        return i0 - (j0 + cols - 1) <= r and j0 - (i0 + t_rows - 1) <= r

    visited = 0
    span = t_rows + cols
    for k in range(n_p + n_q - 1):
        p_lo, p_hi = max(0, k - n_q + 1), min(n_p - 1, k)
        # the kernel's closed form of the band's tiles on this diagonal
        need = k * cols - t_rows + 1 - r
        lo = max(p_lo, -(-need // span) if need > 0 else 0)
        hi = min(p_hi, (r + (k + 1) * cols - 1) // span)
        assert [p for p in range(p_lo, p_hi + 1) if in_band(p, k - p)] \
            == list(range(lo, hi + 1))
        for p in range(p_lo, p_hi + 1):
            q = k - p
            i0, j0 = p * t_rows, q * cols
            if not in_band(p, q):
                top[:, j0:j0 + cols] = nan
                left[:, i0:i0 + t_rows] = nan
                corner[:, p, k % 3] = nan
                continue
            visited += 1
            idx = i0 + lane[:, None] * rows + torch.arange(rows)  # (L, R)
            inrow = idx < n
            safe = idx.clamp(max=n - 1)
            xr = torch.where(inrow, x[:, safe], 0.0)
            cur = big.expand(b, lanes, rows).clone()
            if q > 0 and in_band(p, q - 1):
                cur = torch.where(inrow, left[:, safe], big)
            banded = not (i0 + t_rows - 1 - j0 <= r and j0 + cols - 1 - i0 <= r)
            up_prev = big.expand(b, lanes).clone()
            if p == 0 and q == 0:
                up_prev[:, 0] = 0.0
            elif p > 0 and q > 0 and in_band(p - 1, q - 1):
                up_prev[:, 0] = corner[:, p - 1, (k + 1) % 3]
            has_top = p > 0 and in_band(p - 1, q)
            c_end = min(cols, n - j0)
            live = min(lanes, -(-(n - i0) // rows))
            for st in range(c_end + live - 1):
                head = (top[:, j0 + st] if has_top and st < c_end
                        else big.expand(b))
                up = torch.cat([head[:, None], cur[:, :-1, -1]], dim=1)
                c = st - lane
                valid = (c >= 0) & (c < c_end)
                j = j0 + c.clamp(0, c_end - 1)
                yj = y[:, j]
                diag, u = up_prev, up
                for t in range(rows):
                    prev = cur[:, :, t].clone()
                    diff = xr[:, :, t] - yj
                    v = fma32(diff, diff,
                              torch.minimum(u, torch.minimum(prev, diag)))
                    if banded:
                        v = torch.where((idx[:, t] - j).abs() > r, big, v)
                    v = torch.where(valid, v, prev)
                    cur[:, :, t] = v
                    diag, u = prev, v
                if valid[-1]:
                    top[:, int(j[-1])] = cur[:, -1, -1]
                up_prev = up
            left[:, idx[inrow]] = cur[:, inrow]
            corner[:, p, k % 3] = cur[:, -1, -1]
    return torch.sqrt(left[:, n - 1]), visited


TILES = [(4, 1, 8), (4, 3, 12), (32, 8, 128)]  # lanes, rows per lane, cols


@pytest.mark.parametrize("lanes,rows,cols", TILES)
@pytest.mark.parametrize("b,n,band", [(b, n, None) for b, n in FULL]
                         + [(4, 200, 5), (4, 200, 20), (4, 200, 64),
                            (3, 96, 0), (2, 150, 7)])
def test_kernel_traversal_replayed_bitwise(b, n, band, lanes, rows, cols):
    """The kernel's tile order, boundaries, corners, band skips and ragged
    edges give the plain version's bits (the card's kernel is held to the
    same bits by the ``-m cuda`` test below)."""
    x, y = (torch.from_numpy(a)
            for a in _pair(b, n, 1000 * b + n + (band or 0)))
    got, visited = _replay(x, y, band, lanes, rows, cols)
    want = ref.dtw_batch_ref(x, y, band)
    assert torch.equal(got, want), (got - want).abs().max()
    t_rows = lanes * rows
    tiles = -(-n // t_rows) * -(-n // cols)
    assert visited == tiles if band is None else visited <= tiles
    if band is not None and lanes == 4:  # small tiles: the band skips some
        assert visited < tiles
    if jm is not None and lanes == 4 and rows == 1:
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jops.dtw(jnp.asarray(x.numpy()),
                                             jnp.asarray(y.numpy()),
                                             band=band)), **TOL)


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
                            (3, 96, 0), (2, 20000, None), (256, 512, None),
                            (256, 1024, None), (256, 1536, None),
                            (256, 2048, None), (256, 2048, 64),
                            (0, 16, None)])
def test_kernel_bitwise_equal_to_plain_on_cuda(b, n, band):
    """Every test shape, the monitor's four lengths, band 64, and a pair
    whose buffers overflow shared memory (the global-scratch branch)."""
    name = _cuda()
    if n == 20000:
        assert _lib().dtw_smem_bytes(n) == 0 < _lib().dtw_smem_bytes(2048)
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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 130])
def test_kernel_unaligned_inputs_on_cuda(n):
    """Rows that start off a 16-byte boundary are staged a float at a
    time; the result is the same bits."""
    name = _cuda()
    x, y = _pair(3, n, 11)
    flat = [torch.zeros(3 * n + 1, device="cuda") for _ in range(2)]
    xs, ys = (f[1:].view(3, n) for f in flat)
    xs.copy_(torch.from_numpy(x))
    ys.copy_(torch.from_numpy(y))
    got = dtw_cuda(xs, ys)
    want = ref.dtw_batch_ref(xs, ys)
    torch.cuda.synchronize()
    assert torch.equal(got, want), name
