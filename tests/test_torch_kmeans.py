"""The port's k-means kernels against the JAX reference.

On the CPU ``repro_torch.kernels.ops.kmeans_assign`` and
``ops.kmeans_lloyd`` run the plain PyTorch versions; they are held against
``repro.kernels.ref.kmeans_assign_ref``, the Pallas kernel in interpret
mode (``repro.kernels.ops.kmeans_assign``) and the reference's
``masked_kmeans_table(use_kernel=True)``.  The CUDA kernels sum each
cluster's rows in another order than the plain version (lane order within
a warp of 32 rows, then the warps in order):
``test_reduction_order_within_tolerance`` replays that order here.  The
kernels themselves run only on a card (``-m cuda``); those tests need no
JAX, so they also run on a GPU machine without the reference installed.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.core import digitize as jd
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    jd = None
needs_jax = pytest.mark.skipif(jd is None, reason="needs the JAX reference")

from repro_torch.core import digitize as td
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.kmeans import kmeans_assign_cuda, kmeans_lloyd_cuda

SHAPES = [(1, 16, 2, 3), (3, 50, 2, 7), (2, 200, 2, 100), (1, 64, 8, 5),
          (2, 128, 128, 16), (1, 300, 2, 1)]


def _problem(s, n, d, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(s, n, d)).astype(np.float32)
    mask = (rng.random((s, n)) > 0.25).astype(np.float32)
    c = rng.normal(size=(s, k, d)).astype(np.float32)
    act = (rng.random((s, k)) > 0.2).astype(np.float32)
    act[:, 0] = 1.0  # at least one active center
    return x, mask, c, act


@needs_jax
@pytest.mark.parametrize("s,n,d,k", SHAPES)
def test_plain_version_matches_reference(s, n, d, k):
    x, mask, c, act = _problem(s, n, d, k, 42 + n)
    before = kmeans_assign_cuda.launches
    lt, st, ct = ops.kmeans_assign(*map(torch.from_numpy, (x, mask, c, act)))
    assert kmeans_assign_cuda.launches == before  # CPU tensors: no kernel
    for name, (lj, sj, cj) in (
            ("ref", jref.kmeans_assign_ref(x, mask, c, act)),
            ("pallas interpret", jops.kmeans_assign(x, mask, c, act))):
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj),
                                      err_msg=f"{name} labels")
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{name} sums")
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj),
                                      err_msg=f"{name} counts")
    assert (lt.numpy()[mask == 0] == 0).all()


def test_force_ref_and_bool_masks_agree():
    x, mask, c, act = _problem(2, 40, 2, 6, 1)
    a = ops.kmeans_assign(*map(torch.from_numpy, (x, mask, c, act)))
    b = ops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(mask > 0),
                          torch.from_numpy(c), torch.from_numpy(act > 0),
                          force_ref=True)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def _table_problem(s, n_max, k_max, seed):
    rng = np.random.default_rng(seed)
    coords = rng.normal(size=(s, n_max, 2)).astype(np.float32)
    n_valid = rng.integers(1, n_max + 1, size=(s,))
    mask = np.arange(n_max)[None, :] < n_valid[:, None]
    k = rng.integers(1, k_max + 1, size=(s,)).astype(np.int32)
    c_init = rng.normal(size=(s, k_max, 2)).astype(np.float32)
    return coords, mask, c_init, k


@needs_jax
@pytest.mark.parametrize("s,n_max,k_max", [(1, 16, 4), (4, 64, 8), (7, 33, 5)])
def test_masked_kmeans_table_reference_path_bitwise(s, n_max, k_max):
    coords, mask, c_init, k = _table_problem(s, n_max, k_max, 11)
    cj, lj = jd.masked_kmeans_table(*map(jnp.asarray, (coords, mask, c_init,
                                                       k)), iters=5)
    ct, lt = td.masked_kmeans_table(*map(torch.from_numpy, (coords, mask,
                                                            c_init, k)),
                                    iters=5)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    # one slot at a time through the per-slot entry point
    for i in range(s):
        c1, l1 = td.masked_kmeans(*(torch.as_tensor(a[i]) for a in
                                    (coords, mask, c_init, k)), iters=5)
        np.testing.assert_array_equal(c1.numpy(), np.asarray(cj)[i])
        np.testing.assert_array_equal(l1.numpy(), np.asarray(lj)[i])


@needs_jax
@pytest.mark.parametrize("s,n_max,k_max", [(2, 32, 4), (5, 48, 8)])
def test_masked_kmeans_table_kernel_path(s, n_max, k_max):
    """``use_kernel=True`` (on the CPU: the kernel's plain version) against
    the reference's kernel path and the port's own plain path."""
    coords, mask, c_init, k = _table_problem(s, n_max, k_max, 23)
    args_j = tuple(map(jnp.asarray, (coords, mask, c_init, k)))
    args_t = tuple(map(torch.from_numpy, (coords, mask, c_init, k)))
    cj, lj = jd.masked_kmeans_table(*args_j, iters=5, use_kernel=True)
    ct, lt = td.masked_kmeans_table(*args_t, iters=5, use_kernel=True)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert (lt.numpy()[~mask] == 0).all()
    cp, lp = td.masked_kmeans_table(*args_t, iters=5)
    np.testing.assert_array_equal(ct.numpy(), cp.numpy())
    np.testing.assert_array_equal(lt.numpy()[mask], lp.numpy()[mask])


def test_kernel_wrapper_rejects_cpu_tensors():
    x, mask, c, act = _problem(1, 8, 2, 3, 0)
    with pytest.raises(ValueError, match="CUDA"):
        kmeans_assign_cuda(torch.from_numpy(x), torch.from_numpy(mask > 0),
                           torch.from_numpy(c), torch.from_numpy(act > 0))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("kmeans_assign")


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernel runs only on a GPU")
@pytest.mark.parametrize("s,n,d,k", SHAPES + [(256, 512, 2, 100)])
def test_kernel_matches_plain_on_cuda(s, n, d, k):
    name = torch.cuda.get_device_name()
    x, mask, c, act = (torch.from_numpy(a).cuda()
                       for a in _problem(s, n, d, k, 7 + n))
    mask, act = mask > 0, act > 0
    before = kmeans_assign_cuda.launches
    lk, sk, ck = ops.kmeans_assign(x, mask, c, act)
    assert kmeans_assign_cuda.launches == before + 1, name
    lp, sp, cp = ref.kmeans_assign_ref(x, mask, c, act)
    torch.cuda.synchronize()
    assert torch.equal(lk, lp), f"labels differ on {name}"
    assert torch.equal(ck, cp), f"counts differ on {name}"
    assert not bool((lk[~mask] != 0).any()), f"masked label on {name}"
    torch.testing.assert_close(sk, sp, rtol=1e-5, atol=1e-5,
                               msg=lambda m: f"{name}: {m}")


# --- the Lloyd loop: kmeans_lloyd ------------------------------------------

def _lloyd_problem(s, n, d, k_max, k_mode, seed):
    """A table of Lloyd problems; ``k_mode`` "one", "all" or "mixed"."""
    rng = np.random.default_rng(seed)
    coords = rng.normal(size=(s, n, d)).astype(np.float32)
    mask = rng.random((s, n)) > 0.25
    c_init = rng.normal(size=(s, k_max, d)).astype(np.float32)
    k = {"one": np.ones(s), "all": np.full(s, k_max),
         "mixed": rng.integers(1, k_max + 1, size=s)}[k_mode].astype(np.int32)
    return coords, mask, c_init, k


def _half_step_loop(coords, mask, c_init, k, iters, half=None):
    """The loop ``masked_kmeans_table(use_kernel=True)`` ran before the Lloyd
    kernel: ``half`` (by default ``kmeans_assign_ref``) and the update, in
    that order, ``iters`` times."""
    half = half or ref.kmeans_assign_ref
    k_max = c_init.shape[1]
    active = torch.arange(k_max, device=coords.device)[None, :] < k[:, None]
    centers = c_init
    labels = torch.zeros(coords.shape[:2], dtype=torch.int32,
                         device=coords.device)
    for _ in range(iters):
        labels, sums, counts = half(coords, mask, centers, active)
        counts = counts[..., None]
        centers = torch.where(counts > 0, sums / torch.clamp_min(counts, 1.0),
                              centers)
    return centers, labels


@needs_jax
@pytest.mark.parametrize("k_mode", ["one", "all"])
@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("iters", [0, 1, 5])
def test_lloyd_matches_reference_kernel_path(iters, d, k_mode):
    """``ops.kmeans_lloyd`` (on the CPU: ``kmeans_lloyd_ref``) against the
    reference's ``masked_kmeans_table(use_kernel=True)``, whose half-steps
    run the Pallas kernel in interpret mode."""
    coords, mask, c_init, k = _lloyd_problem(3, 48, d, 7, k_mode,
                                             100 * iters + d)
    cj, lj = jd.masked_kmeans_table(*map(jnp.asarray, (coords, mask, c_init,
                                                       k)),
                                    iters=iters, use_kernel=True)
    args = tuple(map(torch.from_numpy, (coords, mask, c_init, k)))
    before = kmeans_lloyd_cuda.launches
    ct, lt = ops.kmeans_lloyd(*args, iters)
    assert kmeans_lloyd_cuda.launches == before  # CPU tensors: no kernel
    cr, lr = ref.kmeans_lloyd_ref(*args, iters)
    assert torch.equal(ct, cr) and torch.equal(lt, lr)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-5)
    assert (lt.numpy()[~mask] == 0).all()


@pytest.mark.parametrize("s,n,d,k_max,k_mode,iters", [
    (3, 48, 2, 7, "mixed", 0), (3, 48, 2, 7, "mixed", 1),
    (4, 64, 2, 8, "mixed", 10), (2, 200, 2, 100, "mixed", 10),
    (2, 40, 8, 5, "all", 5), (1, 30, 2, 1, "one", 3)])
def test_lloyd_ref_bitwise_equal_to_half_step_loop(s, n, d, k_max, k_mode,
                                                   iters):
    coords, mask, c_init, k = map(torch.from_numpy, _lloyd_problem(
        s, n, d, k_max, k_mode, 7 + n))
    ct, lt = ops.kmeans_lloyd(coords, mask, c_init, k, iters)
    cw, lw = _half_step_loop(coords, mask, c_init, k, iters)
    assert torch.equal(lt, lw)
    assert torch.equal(ct, cw)
    if iters == 0:
        assert torch.equal(ct, c_init) and not bool(lt.any())


def test_masked_kmeans_table_one_lloyd_call_per_call(monkeypatch):
    """``use_kernel=True`` hands the whole loop to one ``ops.kmeans_lloyd``
    call, whatever ``iters`` is, and never calls the half-step."""
    calls = []
    lloyd = ops.kmeans_lloyd

    def counted(*args, **kwargs):
        calls.append(args[-1])
        return lloyd(*args, **kwargs)

    def no_half_step(*args, **kwargs):
        raise AssertionError("the half-step was called")

    monkeypatch.setattr(ops, "kmeans_lloyd", counted)
    monkeypatch.setattr(ops, "kmeans_assign", no_half_step)
    coords, mask, c_init, k = map(torch.from_numpy,
                                  _table_problem(4, 32, 6, 5))
    for iters in (0, 1, 7):
        c, lab = td.masked_kmeans_table(coords, mask, c_init, k, iters,
                                        use_kernel=True)
        cw, lw = _half_step_loop(coords, mask, c_init, k, iters)
        assert torch.equal(c, cw) and torch.equal(lab, lw)
    assert calls == [0, 1, 7]


def _kernel_order_sums(labels, mask, x, k_max):
    """``csrc/kmeans_assign.cu``'s sums and counts in its order, on the CPU:
    within each 32-row chunk (a warp), each cluster's rows added in row
    order starting from its first row; the chunks' partials then added in
    order onto 0, skipping chunks where the cluster has no row."""
    s, n, d = x.shape
    onehot = td._one_hot(labels, k_max) * mask[..., None].float()
    acc = torch.zeros(s, k_max, d)
    for c in range(0, n, 32):
        oh, v = onehot[:, c: c + 32], x[:, c: c + 32]
        part = torch.zeros(s, k_max, d)
        seen = torch.zeros(s, k_max, dtype=torch.bool)
        for r in range(oh.shape[1]):
            on = oh[:, r] > 0                                 # (S, K)
            row = v[:, r, None, :].expand(-1, k_max, -1)      # (S, K, D)
            part = torch.where((on & ~seen)[..., None], row,
                               torch.where(on[..., None], part + row, part))
            seen = seen | on
        acc = torch.where(seen[..., None], acc + part, acc)
    return acc, onehot.sum(1)


@pytest.mark.parametrize("s,n,d,k_max", [
    (3, 50, 2, 7), (2, 200, 2, 100), (1, 64, 8, 5), (2, 600, 8, 100),
    (16, 512, 2, 100), (1, 300, 2, 1)])
def test_reduction_order_within_tolerance(s, n, d, k_max):
    """The kernel's summation order stays within the parity contract's 1e-5
    of the plain sums, with counts exact, for one half-step and through ten
    Lloyd iterations (labels exact there too)."""
    coords, mask, c_init, k = map(torch.from_numpy, _lloyd_problem(
        s, n, d, k_max, "mixed", 31 + n))
    active = torch.arange(k_max)[None, :] < k[:, None]

    def half(x, m, centers, act):
        labels, sums, counts = ref.kmeans_assign_ref(x, m, centers, act)
        ks, kc = _kernel_order_sums(labels, m, x, k_max)
        np.testing.assert_allclose(ks.numpy(), sums.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(kc, counts)
        return labels, ks, kc

    half(coords, mask, c_init, active)
    ck, lk = _half_step_loop(coords, mask, c_init, k, 10, half)
    cp, lp = ref.kmeans_lloyd_ref(coords, mask, c_init, k, 10)
    assert torch.equal(lk, lp)
    np.testing.assert_allclose(ck.numpy(), cp.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["cpu tensors", "rank 2", "iters negative",
                                  "coords f64", "mask f32", "k i64",
                                  "k shape", "c_init width"])
def test_lloyd_wrapper_rejects_before_any_build(case, monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} for a rejected input")

    monkeypatch.setattr(_build, "load", no_build)
    coords, mask, c_init, k = map(torch.from_numpy,
                                  _lloyd_problem(2, 16, 2, 4, "mixed", 0))
    iters = 3
    if case == "rank 2":
        coords = coords[0]
    elif case == "iters negative":
        iters = -1
    elif case == "coords f64":
        coords = coords.double()
    elif case == "mask f32":
        mask = mask.float()
    elif case == "k i64":
        k = k.long()
    elif case == "k shape":
        k = k[:1]
    elif case == "c_init width":
        c_init = c_init[..., :1].contiguous()
    before = kmeans_lloyd_cuda.launches
    with pytest.raises((ValueError, TypeError),
                       match="iters" if case == "iters negative" else None):
        kmeans_lloyd_cuda(coords, mask, c_init, k, iters)
    assert kmeans_lloyd_cuda.launches == before


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU")
    return torch.cuda.get_device_name()


def _same(a, b):
    """Bitwise equal, NaN where NaN."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _lloyd_on_card(coords, mask, c_init, k, iters, name, *, plain=True):
    """The Lloyd kernel on the card: bitwise equal to the half-step kernel
    iterated with the eager update, two calls bitwise equal, one launch
    each; against its plain version labels exact, centers within 1e-5."""
    before = kmeans_lloyd_cuda.launches
    c1, l1 = ops.kmeans_lloyd(coords, mask, c_init, k, iters)
    c2, l2 = ops.kmeans_lloyd(coords, mask, c_init, k, iters)
    assert kmeans_lloyd_cuda.launches == before + (2 if coords.shape[0] else 0)
    cw, lw = _half_step_loop(coords, mask, c_init, k, iters, kmeans_assign_cuda)
    torch.cuda.synchronize()
    assert torch.equal(l1, l2), f"two calls differ on {name}"
    _same(c1, c2)
    assert torch.equal(l1, lw), f"labels differ from the half-step on {name}"
    _same(c1, cw)
    assert not bool((l1[~mask] != 0).any()), f"masked label on {name}"
    if plain:
        cp, lp = ref.kmeans_lloyd_ref(coords, mask, c_init, k, iters)
        assert torch.equal(l1, lp), f"labels differ from plain on {name}"
        torch.testing.assert_close(c1, cp, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,d,k_max,k_mode", [
    (1, 16, 2, 3, "mixed"), (3, 50, 2, 7, "mixed"), (2, 200, 2, 100, "mixed"),
    (1, 64, 8, 5, "all"), (2, 128, 128, 16, "mixed"), (1, 300, 2, 1, "one"),
    (256, 512, 2, 100, "mixed"), (3, 600, 8, 100, "mixed"),
    (2, 30000, 2, 8, "mixed"), (0, 16, 2, 4, "mixed")])
@pytest.mark.parametrize("iters", [0, 1, 10])
def test_lloyd_kernel_on_cuda(s, n, d, k_max, k_mode, iters):
    """N = 600 > 512 walks tiles over resident pieces; N = 30000 does not
    fit in shared memory and is staged a tile at a time; S = 0 launches
    nothing."""
    name = _cuda()
    coords, mask, c_init, k = (torch.from_numpy(a).cuda() for a in
                               _lloyd_problem(s, n, d, k_max, k_mode, 5 + n))
    _lloyd_on_card(coords, mask, c_init, k, iters, name)


@pytest.mark.cuda
def test_lloyd_kernel_nan_rows_on_cuda():
    """A dead lane: NaN coordinates in one slot and a NaN initial center in
    another.  The labels and centers match the iterated half-step kernel."""
    name = _cuda()
    coords, mask, c_init, k = (torch.from_numpy(a).cuda() for a in
                               _lloyd_problem(4, 100, 2, 10, "mixed", 9))
    coords[1, 40:] = float("nan")
    c_init[2, int(k[2]) - 1] = float("nan")
    for iters in (1, 10):
        _lloyd_on_card(coords, mask, c_init, k, iters, name, plain=False)
