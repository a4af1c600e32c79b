"""Hopper kernel: the EWMA/EWMV scan of a batch of streams.

Port of ``repro.kernels.ewma.ewma_scan_pallas``: the paper's damped-window
mean and variance (Eq. 1-2) over ``(B, T)``, in the CUDA C++ kernel
``csrc/ewma.cu`` (built for ``sm_90a`` at first use, bound with ctypes): a
two-level scan over composed affine maps, one CTA of 8 warps per row, a
shuffle scan in each warp and the warps' maps composed in warp order.
``repro_torch.kernels.ref.ewma_scan_ref`` is its plain PyTorch version;
``repro_torch.kernels.ops.ewma_scan`` dispatches.  The sender does not use
it: ``compress.compressor_step`` normalizes one point at a time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.normalize import ewm_coeffs
from repro_torch.kernels import _build

__all__ = ["ewma_scan_cuda"]

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float

_LAUNCH = []  # the bound C entry point, once built


def _fn():
    if not _LAUNCH:
        fn = _build.load("ewma").ewma_launch
        fn.argtypes = [_VOIDP] * 3 + [_INT] * 2 + [_FLOAT] * 2 + [_VOIDP]
        fn.restype = _INT
        _LAUNCH.append(fn)
    return _LAUNCH[0]


def ewma_scan_cuda(ts: torch.Tensor, alpha):
    """Launch the kernel on the current stream.

    Args: ``ts (B, T) f32``, a contiguous CUDA tensor with ``T >= 1``;
    ``alpha`` in (0, 1], a float or a 0-d tensor.  Returns ``means, vars
    (B, T) f32``, with ``means[:, 0] = ts[:, 0]`` and ``vars[:, 0] = 1``.
    Raises on any other input and when the launch fails.
    """
    if ts.dim() != 2:
        raise ValueError(f"ewma_scan_cuda: ts must be (B, T), got "
                         f"{tuple(ts.shape)}")
    b, t = ts.shape
    a, one_minus_a = ewm_coeffs(alpha)
    if not (0.0 < float(alpha) <= 1.0 and a > 0.0):
        raise ValueError(f"ewma_scan_cuda: alpha must be in (0, 1], got "
                         f"{float(alpha)!r}")
    _build.check_tensor("ewma_scan_cuda", "ts", ts, torch.float32, (b, t),
                        ts.device)
    if t == 0:
        raise ValueError("ewma_scan_cuda: the streams must not be empty")
    means = torch.empty_like(ts)
    vars_ = torch.empty_like(ts)
    if b == 0:
        return means, vars_
    fn = _fn()
    with torch.cuda.device(ts.device):
        stream = torch.cuda.current_stream(ts.device).cuda_stream
        err = fn(ts.data_ptr(), means.data_ptr(), vars_.data_ptr(), b, t, a,
                 one_minus_a, stream)
    if err != 0:
        raise RuntimeError(f"ewma kernel launch failed: CUDA error {err} "
                           f"(B={b}, T={t}, alpha={a})")
    ewma_scan_cuda.launches += 1
    return means, vars_


ewma_scan_cuda.launches = 0
