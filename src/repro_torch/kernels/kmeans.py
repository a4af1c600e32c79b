"""Hopper kernels: the k-means assign half-step and the whole Lloyd loop.

Port of ``repro.kernels.kmeans.kmeans_assign_pallas`` and of the loop of
``repro.core.digitize.masked_kmeans_table`` that calls it, for a table of S
independent clustering problems.  Both live in the CUDA C++ source
``csrc/kmeans_assign.cu`` (built for ``sm_90a`` at first use, bound with
ctypes) and share its assign-and-reduce routine: ``kmeans_assign_cuda``
launches one half-step, ``kmeans_lloyd_cuda`` every iteration of the loop
in one launch.  ``repro_torch.kernels.ref.kmeans_assign_ref`` and
``kmeans_lloyd_ref`` are their plain PyTorch versions;
``repro_torch.kernels.ops`` dispatches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["kmeans_assign_cuda", "kmeans_lloyd_cuda"]

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int

_LAUNCH = {}  # the bound C entry points, once built


def _fn(name, argtypes):
    if name not in _LAUNCH:
        fn = getattr(_build.load("kmeans_assign"), name)
        fn.argtypes = argtypes
        fn.restype = _INT
        _LAUNCH[name] = fn
    return _LAUNCH[name]


def kmeans_assign_cuda(x, mask, centers, center_active):
    """Launch the half-step kernel on the current stream.

    Args: ``x (S, N, D) f32``, ``mask (S, N) bool``, ``centers (S, K, D)
    f32``, ``center_active (S, K) bool``, all contiguous CUDA tensors on one
    device.  Returns ``labels (S, N) i32`` (0 on masked rows), ``sums
    (S, K, D) f32`` and ``counts (S, K) f32``.  Raises on any other input and
    when the launch fails.
    """
    if x.dim() != 3 or centers.dim() != 3:
        raise ValueError("kmeans_assign_cuda: x and centers must be 3-D")
    s, n, d = x.shape
    k = centers.shape[1]
    dev = x.device
    for name, t, dtype, shape in (
            ("x", x, torch.float32, (s, n, d)),
            ("mask", mask, torch.bool, (s, n)),
            ("centers", centers, torch.float32, (s, k, d)),
            ("center_active", center_active, torch.bool, (s, k))):
        _build.check_tensor("kmeans_assign_cuda", name, t, dtype, shape, dev)
    labels = torch.empty((s, n), dtype=torch.int32, device=dev)
    sums = torch.empty((s, k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((s, k), dtype=torch.float32, device=dev)
    if s == 0:
        return labels, sums, counts
    fn = _fn("kmeans_assign_launch", [_VOIDP] * 7 + [_INT] * 4 + [_VOIDP])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), mask.data_ptr(), centers.data_ptr(),
                 center_active.data_ptr(), labels.data_ptr(), sums.data_ptr(),
                 counts.data_ptr(), s, n, d, k, stream)
    if err != 0:
        raise RuntimeError(f"kmeans_assign kernel launch failed: CUDA error "
                           f"{err} (S={s}, N={n}, D={d}, K={k})")
    kmeans_assign_cuda.launches += 1
    return labels, sums, counts


kmeans_assign_cuda.launches = 0


def kmeans_lloyd_cuda(coords, mask, c_init, k, iters: int):
    """Launch the Lloyd kernel on the current stream: ``iters`` half-steps,
    each followed by ``centers = where(counts > 0, sums / max(counts, 1),
    centers)``, in one launch.

    Args: ``coords (S, N, D) f32``, ``mask (S, N) bool``, ``c_init (S, K, D)
    f32``, ``k (S,) i32`` (centers ``[0, k_s)`` of slot s are active), all
    contiguous CUDA tensors on one device, with ``K, D >= 1``; ``iters >=
    0``.  Returns ``centers (S, K, D) f32`` and the last iteration's
    ``labels (S, N) i32`` (0 on masked rows); ``c_init`` and zero labels
    when ``iters = 0``.  Raises on any other input, before any build, and
    when the launch fails.
    """
    if coords.dim() != 3 or c_init.dim() != 3:
        raise ValueError("kmeans_lloyd_cuda: coords and c_init must be 3-D")
    iters = int(iters)
    if iters < 0:
        raise ValueError(f"kmeans_lloyd_cuda: iters must be >= 0, got {iters}")
    s, n, d = coords.shape
    k_max = c_init.shape[1]
    dev = coords.device
    for name, t, dtype, shape in (
            ("coords", coords, torch.float32, (s, n, d)),
            ("mask", mask, torch.bool, (s, n)),
            ("c_init", c_init, torch.float32, (s, k_max, d)),
            ("k", k, torch.int32, (s,))):
        _build.check_tensor("kmeans_lloyd_cuda", name, t, dtype, shape, dev)
    if k_max == 0 or d == 0:
        raise ValueError(f"kmeans_lloyd_cuda: needs K, D >= 1, got K={k_max}, "
                         f"D={d}")
    centers = torch.empty((s, k_max, d), dtype=torch.float32, device=dev)
    labels = torch.empty((s, n), dtype=torch.int32, device=dev)
    if s == 0:
        return centers, labels
    fn = _fn("kmeans_lloyd_launch", [_VOIDP] * 6 + [_INT] * 5 + [_VOIDP])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(coords.data_ptr(), mask.data_ptr(), c_init.data_ptr(),
                 k.data_ptr(), centers.data_ptr(), labels.data_ptr(), s, n, d,
                 k_max, iters, stream)
    if err != 0:
        raise RuntimeError(f"kmeans_lloyd kernel launch failed: CUDA error "
                           f"{err} (S={s}, N={n}, D={d}, K={k_max}, "
                           f"iters={iters})")
    kmeans_lloyd_cuda.launches += 1
    return centers, labels


kmeans_lloyd_cuda.launches = 0
