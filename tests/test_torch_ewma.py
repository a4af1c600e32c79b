"""The port's EWMA/EWMV scan against the JAX reference, and its kernel on
the card.

On the CPU ``repro_torch.kernels.ops.ewma_scan`` runs the plain PyTorch
version (``core.normalize.ewm_scan``), held against the Pallas kernel in
interpret mode (``repro.kernels.ops.ewma_scan``) at the shapes of
``tests/test_kernels.py`` within its tolerances (rtol = atol = 2e-5 on the
means, 2e-4 on the vars), and bitwise against ``repro.kernels.ref.
ewma_scan_ref`` on a fleet slab.  The CUDA kernel composes the steps as
affine maps across the lanes of a warp and the warps of a CTA, so it
rounds the carries at lane, warp and chunk boundaries differently:
``test_scan_order_within_tolerance`` replays that order here with exact
fused multiply-adds, and on a card (``-m cuda``) the kernel itself is held
to the plain version within the same tolerances and to the replay bit for
bit.  Those tests need no JAX.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import re

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.ewma import ewma_scan_pallas
except ImportError:
    jops = None
needs_jax = pytest.mark.skipif(jops is None, reason="needs the JAX reference")

from repro_torch.core.normalize import ewm_coeffs, fma32
from repro_torch.data.synthetic import make_fleet
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.ewma import ewma_scan_cuda

SHAPES = [(1, 64), (3, 300), (8, 1024), (17, 257), (256, 96)]
ALPHAS = [0.01, 0.05, 0.2]
MEAN_TOL = dict(rtol=2e-5, atol=2e-5)
VAR_TOL = dict(rtol=2e-4, atol=2e-4)
# streams offset by 1000 (``tests/test_kernels.py::test_large_values``)
LARGE_MEAN_TOL = dict(rtol=1e-4, atol=0.0)
LARGE_VAR_TOL = dict(rtol=1e-3, atol=1e-2)


def _normal(b, t, seed, loc=0.0, scale=2.0):
    rng = np.random.default_rng(seed)
    return rng.normal(loc, scale, (b, t)).astype(np.float32)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a GPU")
    return torch.cuda.get_device_name()


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **tol)


@needs_jax
@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("b,t", SHAPES)
def test_plain_version_matches_pallas(b, t, alpha):
    ts = _normal(b, t, 1000 * b + t)
    before = ewma_scan_cuda.launches
    m, v = ops.ewma_scan(torch.from_numpy(ts), alpha)
    assert ewma_scan_cuda.launches == before  # CPU tensors: no kernel
    assert m.dtype == v.dtype == torch.float32
    assert m.shape == v.shape == (b, t)
    jm, jv = jops.ewma_scan(jnp.asarray(ts), alpha)
    _close(m, jm, MEAN_TOL, "means")
    _close(v, jv, VAR_TOL, "vars")


@needs_jax
@pytest.mark.parametrize("block_t", [64, 128, 512])
def test_matches_pallas_block_shapes(block_t):
    ts = _normal(4, 777, 7, scale=1.0)
    m, v = ops.ewma_scan(torch.from_numpy(ts), 0.02)
    jm, jv = ewma_scan_pallas(jnp.asarray(ts), 0.02, block_t=block_t,
                              interpret=True)
    _close(m, jm, MEAN_TOL, "means")
    _close(v, jv, VAR_TOL, "vars")


@needs_jax
def test_large_values():
    ts = _normal(2, 512, 8, loc=1000.0, scale=5.0)
    m, v = ops.ewma_scan(torch.from_numpy(ts), 0.05)
    jm, jv = jops.ewma_scan(jnp.asarray(ts), 0.05)
    _close(m, jm, LARGE_MEAN_TOL, "means")
    _close(v, jv, LARGE_VAR_TOL, "vars")


@needs_jax
def test_paper_init():
    """Point 0 keeps the paper's initialization: EWMA_0 = t_0 and
    EWMV_0 = 1.0 exactly in the port, within 1e-6 in the Pallas kernel."""
    ts = _normal(2, 50, 9, scale=1.0)
    m, v = ops.ewma_scan(torch.from_numpy(ts), 0.02)
    assert np.array_equal(m[:, 0].numpy(), ts[:, 0])
    assert bool((v[:, 0] == 1.0).all())
    jm, jv = jops.ewma_scan(jnp.asarray(ts), 0.02)
    np.testing.assert_allclose(m[:, 0].numpy(), np.asarray(jm)[:, 0],
                               rtol=1e-6)
    np.testing.assert_allclose(v[:, 0].numpy(), np.asarray(jv)[:, 0],
                               rtol=1e-6)


@needs_jax
@pytest.mark.parametrize("alpha", [0.01, 0.02, 0.2])
def test_plain_version_bitwise_equal_to_reference_ref(alpha):
    """At the fleet slab where ``test_torch_core``'s ``ewm_scan`` holds
    bitwise, the plain versions of the two packages are bitwise equal."""
    ts = make_fleet(10, 300, seed=1)
    m, v = ref.ewma_scan_ref(torch.from_numpy(ts), alpha)
    jm, jv = jref.ewma_scan_ref(jnp.asarray(ts), alpha)
    assert np.array_equal(m.numpy(), np.asarray(jm))
    assert np.array_equal(v.numpy(), np.asarray(jv))


def test_force_ref_and_alpha_tensor_on_cpu():
    ts = torch.from_numpy(_normal(3, 40, 10))
    m, v = ops.ewma_scan(ts, 0.05)
    for got in (ops.ewma_scan(ts, 0.05, force_ref=True),
                ops.ewma_scan(ts, torch.tensor(0.05)),
                ref.ewma_scan_ref(ts.double(), 0.05)):
        assert torch.equal(got[0], m) and torch.equal(got[1], v)


@pytest.mark.parametrize("case", ["cpu tensor", "rank 1", "rank 3", "f64",
                                  "alpha 0", "alpha negative", "alpha 1.5",
                                  "alpha nan", "alpha underflows"])
def test_wrapper_rejects_before_any_build(case, monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} for a rejected input")

    monkeypatch.setattr(_build, "load", no_build)
    ts, alpha = torch.zeros(2, 8), 0.02
    if case == "rank 1":
        ts = torch.zeros(8)
    elif case == "rank 3":
        ts = torch.zeros(2, 2, 8)
    elif case == "f64":
        ts = ts.double()
    elif case.startswith("alpha"):
        alpha = {"alpha 0": 0.0, "alpha negative": -0.1, "alpha 1.5": 1.5,
                 "alpha nan": float("nan"),
                 "alpha underflows": 1e-50}[case]
    before = ewma_scan_cuda.launches
    with pytest.raises(ValueError):
        ewma_scan_cuda(ts, alpha)
    assert ewma_scan_cuda.launches == before


def _kernel_constants():
    """``kPerLane`` and ``kWarps`` as ``csrc/ewma.cu`` declares them, so the
    replay below follows the kernel's own geometry."""
    src = (_build.CSRC / "ewma.cu").read_text()
    found = dict(re.findall(r"constexpr int (kPerLane|kWarps) = (\d+);", src))
    return int(found["kPerLane"]), int(found["kWarps"])


PER_LANE, WARPS = _kernel_constants()
CHUNK = 32 * PER_LANE * WARPS


def _shift(x, off):
    """Lane ``l`` takes lane ``l - off``'s value (``__shfl_up_sync``); the
    lanes are the last axis."""
    return torch.cat([x[..., :off], x[..., :-off]], dim=-1)


def _scan_maps(A, B):
    lane = torch.arange(32)
    for off in (1, 2, 4, 8, 16):
        A0, B0 = _shift(A, off), _shift(B, off)
        on = lane >= off
        A, B = torch.where(on, A * A0, A), torch.where(on, fma32(A, B0, B), B)
    return A, B


def _pass(x, carry, step, p, valid):
    """One pass over a chunk: the lanes' maps, the warp scan, the warps'
    maps applied in warp order to the chunk's carry-in, then each lane's
    exact walk from its start value.  ``x (R, W, 32, P)``; ``step(state,
    x)`` is the kernel's step, ``p`` its factor of the state."""
    A, B = torch.ones(x.shape[:3]), torch.zeros(x.shape[:3])
    for k in range(x.shape[-1]):
        on = valid[..., k]
        B = torch.where(on, step(B, x[..., k]), B)
        A = torch.where(on, p * A, A)
    A, B = _scan_maps(A, B)
    starts = [carry]  # warp w's start: warps 0..w-1 applied to the carry
    for u in range(x.shape[1] - 1):
        starts.append(fma32(A[:, u, -1], starts[-1], B[:, u, -1]))
    start = torch.stack(starts, dim=1)[..., None].expand_as(A)
    s = fma32(_shift(A, 1), start, _shift(B, 1))
    s[..., 0] = start[..., 0]
    out = torch.empty_like(x)
    for k in range(x.shape[-1]):
        s = torch.where(valid[..., k], step(s, x[..., k]), s)
        out[..., k] = s
    return out


def _kernel_order(ts, alpha, per_lane=PER_LANE, warps=WARPS):
    """``csrc/ewma.cu``'s arithmetic in its order, on the CPU, with
    ``warps`` warps of 32 lanes of ``per_lane`` points per chunk."""
    a, b = ewm_coeffs(alpha)

    def mean_step(m, t):
        return fma32(a, t, b * m)

    def var_step(v, q):
        return fma32(b, v, q)

    rows, n = ts.shape
    chunk = 32 * per_lane * warps
    cm, cv = ts[:, 0].clone(), torch.ones(rows)
    means, vars_ = torch.empty(rows, n), torch.empty(rows, n)
    for c0 in range(0, n, chunk):
        width = min(chunk, n - c0)
        t = torch.zeros(rows, chunk)
        t[:, :width] = ts[:, c0: c0 + width]
        t = t.view(rows, warps, 32, per_lane)
        j = c0 + torch.arange(chunk).view(warps, 32, per_lane)
        valid = (j > 0) & (j < n)
        m = _pass(t, cm, mean_step, b, valid)
        d = t - m
        v = _pass((d * d) * a, cv, var_step, b, valid)
        m, v = m.reshape(rows, chunk), v.reshape(rows, chunk)
        means[:, c0: c0 + width] = m[:, :width]
        vars_[:, c0: c0 + width] = v[:, :width]
        cm, cv = m[:, -1], v[:, -1]  # used only after a full chunk
    return means, vars_


# (B, T, alpha, loc): the first five since the first kernel; then a T that
# is not a multiple of 4 (the kernel's 4-byte path), a chunk whose last
# warps lie wholly past T, and a row of three chunks
ORDER_CASES = [(17, 257, 0.01, 0.0), (3, 700, 0.05, 0.0), (3, 300, 0.5, 0.0),
               (3, 300, 1.0, 0.0), (2, 600, 0.05, 1000.0),
               (3, 1001, 0.02, 0.0), (4, CHUNK + 300, 0.05, 0.0),
               (2, 2 * CHUNK + 777, 0.01, 0.0)]


@pytest.mark.parametrize("b,t,alpha,loc", ORDER_CASES)
def test_scan_order_within_tolerance(b, t, alpha, loc):
    """The kernel's carries, composed across lanes, warps and chunks, stay
    within the parity contract's EWMA tolerances of the sequential scan,
    for every alpha (no alpha <= 0.2 limit as in the Pallas kernel's closed
    form)."""
    ts = torch.from_numpy(_normal(b, t, 11 + t, loc=loc))
    m, v = _kernel_order(ts, alpha)
    pm, pv = ref.ewma_scan_ref(ts, alpha)
    assert torch.equal(m[:, 0], ts[:, 0]) and bool((v[:, 0] == 1.0).all())
    large = loc != 0.0
    _close(m, pm, LARGE_MEAN_TOL if large else MEAN_TOL, "means")
    _close(v, pv, LARGE_VAR_TOL if large else VAR_TOL, "vars")


@pytest.mark.parametrize("per_lane,warps", [(4, 2), (8, 1), (4, 8)])
def test_scan_order_other_geometries(per_lane, warps):
    """The replay at smaller chunks (256 to 1024 points), so that the warp
    and chunk carries are crossed many times at a short T, stays within
    tolerance; and warps wholly past T, which apply the identity map, change
    no bit: one chunk of 2 warps gives what one of 8 gives."""
    ts = torch.from_numpy(_normal(3, 1500, 5))
    m, v = _kernel_order(ts, 0.05, per_lane, warps)
    pm, pv = ref.ewma_scan_ref(ts, 0.05)
    _close(m, pm, MEAN_TOL, "means")
    _close(v, pv, VAR_TOL, "vars")
    assert torch.equal(m[:, 0], ts[:, 0]) and bool((v[:, 0] == 1.0).all())
    short = ts[:, : 32 * per_lane * 2 - 5]
    for got, want in zip(_kernel_order(short, 0.05, per_lane, 2),
                         _kernel_order(short, 0.05, per_lane, 8)):
        assert torch.equal(got, want)


def _on_card(ts, alpha, name, mean_tol=MEAN_TOL, var_tol=VAR_TOL):
    """Kernel against plain on the card: launches counted, point 0 exact,
    two calls bitwise equal, both within tolerance of the plain version."""
    before = ewma_scan_cuda.launches
    m, v = ops.ewma_scan(ts, alpha)
    m2, v2 = ops.ewma_scan(ts, alpha)
    assert ewma_scan_cuda.launches == before + 2, name
    pm, pv = ref.ewma_scan_ref(ts, alpha)
    torch.cuda.synchronize()
    assert m.shape == v.shape == ts.shape
    assert torch.equal(m, m2) and torch.equal(v, v2), name
    assert torch.equal(m[:, 0], ts[:, 0]), name
    assert bool((v[:, 0] == 1.0).all()), name
    _close(m.cpu(), pm.cpu(), mean_tol, f"means on {name}")
    _close(v.cpu(), pv.cpu(), var_tol, f"vars on {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,alpha", [
    (b, t, alpha) for b, t in SHAPES for alpha in ALPHAS + [0.5, 1.0]]
    + [(3, 1, 0.02), (2, 20000, 0.02), (64, 2048, 0.02)]
    + [(b, t, alpha) for b, t, alpha, _ in ORDER_CASES[5:]])
def test_kernel_matches_plain_on_cuda(b, t, alpha):
    name = _cuda()
    ts = torch.from_numpy(_normal(b, t, 1000 * b + t)).cuda()
    _on_card(ts, alpha, name)


@pytest.mark.cuda
def test_kernel_large_values_and_fleet_on_cuda():
    name = _cuda()
    ts = torch.from_numpy(_normal(2, 512, 8, loc=1000.0, scale=5.0)).cuda()
    _on_card(ts, 0.05, name, LARGE_MEAN_TOL, LARGE_VAR_TOL)
    _on_card(torch.from_numpy(make_fleet(256, 2048, seed=0)).cuda(), 0.01,
             name)


@pytest.mark.cuda
def test_kernel_edges_on_cuda():
    name = _cuda()
    ts = torch.from_numpy(_normal(4, 300, 3)).cuda()
    m, v = ops.ewma_scan(ts, torch.tensor(0.05))  # alpha as a 0-d tensor
    assert torch.equal(m, ops.ewma_scan(ts, 0.05)[0]), name
    before = ewma_scan_cuda.launches
    m, v = ewma_scan_cuda(torch.zeros(0, 16, device="cuda"), 0.05)
    assert m.shape == v.shape == (0, 16)
    assert ewma_scan_cuda.launches == before  # nothing to launch
    with pytest.raises(ValueError, match="empty"):
        ewma_scan_cuda(torch.zeros(2, 0, device="cuda"), 0.05)
    with pytest.raises(TypeError):
        ewma_scan_cuda(ts.double(), 0.05)
    with pytest.raises(ValueError, match="contiguous"):
        ewma_scan_cuda(ts.t(), 0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,alpha,loc", ORDER_CASES + [
    (2, 20000, 0.02, 0.0), (64, 2048, 0.02, 0.0), (256, 2048, 0.01, 0.0)])
def test_kernel_bitwise_equal_to_replay_on_cuda(b, t, alpha, loc):
    """The kernel gives the CPU replay's bits: the replay is its order."""
    name = _cuda()
    ts = torch.from_numpy(_normal(b, t, 11 + t, loc=loc))
    m, v = ewma_scan_cuda(ts.cuda(), alpha)
    rm, rv = _kernel_order(ts, alpha)
    assert torch.equal(m.cpu(), rm), f"means on {name}"
    assert torch.equal(v.cpu(), rv), f"vars on {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("t", [2048, 2050, CHUNK + 300])
def test_kernel_unaligned_rows_on_cuda(t):
    """Rows that start off a 16-byte boundary (a contiguous view one float
    into its storage) take the 4-byte copies; the result is the same bits
    as from an aligned copy of the same values."""
    name = _cuda()
    flat = torch.from_numpy(_normal(1, 3 * t + 1, t)).reshape(-1).cuda()
    ts = flat[1:].view(3, t)
    assert ts.is_contiguous() and ts.data_ptr() % 16 != 0
    m, v = ewma_scan_cuda(ts, 0.05)
    am, av = ewma_scan_cuda(ts.clone(), 0.05)
    assert torch.equal(m, am) and torch.equal(v, av), name
    _on_card(ts, 0.05, name)
