"""Hopper kernel: fused k-means assign + cluster statistics.

Port of ``repro.kernels.kmeans.kmeans_assign_pallas``: one Lloyd
half-step for a table of S independent clustering problems, in the CUDA C++
kernel ``csrc/kmeans_assign.cu`` (built for ``sm_90a`` at first use, bound
with ctypes).  ``repro_torch.kernels.ref.kmeans_assign_ref`` is its plain
PyTorch version; ``repro_torch.kernels.ops.kmeans_assign`` dispatches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["kmeans_assign_cuda"]

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int


_LAUNCH = []  # the bound C entry point, once built


def _fn():
    if not _LAUNCH:
        fn = _build.load("kmeans_assign").kmeans_assign_launch
        fn.argtypes = [_VOIDP] * 7 + [_INT] * 4 + [_VOIDP]
        fn.restype = _INT
        _LAUNCH.append(fn)
    return _LAUNCH[0]


def kmeans_assign_cuda(x, mask, centers, center_active):
    """Launch the kernel on the current stream.

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
    fn = _fn()
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
