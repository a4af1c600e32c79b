"""The port's k-means assign half-step against the JAX reference.

On the CPU ``repro_torch.kernels.ops.kmeans_assign`` runs the plain PyTorch
version; it is held against ``repro.kernels.ref.kmeans_assign_ref`` and the
Pallas kernel in interpret mode (``repro.kernels.ops.kmeans_assign``) at the
shapes of ``tests/test_kernels.py``.  The CUDA kernel itself runs only on a
card (``-m cuda``); that test needs no JAX, so it also runs on a GPU
machine without the reference installed.
"""
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
from repro_torch.kernels.kmeans import kmeans_assign_cuda

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
