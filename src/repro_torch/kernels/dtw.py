"""Hopper kernel: banded DTW distance of equal-length pairs.

Port of ``repro.kernels.dtw.dtw_pallas``: a tiled wavefront for a batch of
pairs (one CTA per pair, one warp per tile, lanes passing values by
shuffle), in the CUDA C++ kernel ``csrc/dtw.cu`` (built for ``sm_90a`` at
first use, bound with ctypes).  ``repro_torch.kernels.ref.
dtw_batch_ref`` is its plain PyTorch version, bitwise equal on the card;
``repro_torch.kernels.ops.dtw`` dispatches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["dtw_cuda"]

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int

_LIB = []  # the loaded library, once built


def _lib():
    if not _LIB:
        lib = _build.load("dtw")
        lib.dtw_launch.argtypes = [_VOIDP] * 4 + [_INT] * 3 + [_VOIDP]
        lib.dtw_launch.restype = _INT
        lib.dtw_smem_bytes.argtypes = [_INT]
        lib.dtw_smem_bytes.restype = ctypes.c_size_t
        lib.dtw_scratch_floats.argtypes = [_INT]
        lib.dtw_scratch_floats.restype = ctypes.c_size_t
        _LIB.append(lib)
    return _LIB[0]


def dtw_cuda(x: torch.Tensor, y: torch.Tensor,
             band: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel on the current stream.

    Args: ``x, y (B, N) f32``, contiguous CUDA tensors on one device;
    ``band`` the Sakoe-Chiba radius (None = full DTW; the radius is
    ``max(band, 0)`` for these equal-length pairs, as the plain version
    clamps it).  Returns ``(B,) f32`` distances.  Raises on any other input
    and when the launch fails.
    """
    if x.dim() != 2:
        raise ValueError(f"dtw_cuda: x must be (B, N), got {tuple(x.shape)}")
    b, n = x.shape
    dev = x.device
    for name, t in (("x", x), ("y", y)):
        _build.check_tensor("dtw_cuda", name, t, torch.float32, (b, n), dev)
    r = n if band is None else max(int(band), 0)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    if n == 0:
        raise ValueError("dtw_cuda: the series must not be empty")
    lib = _lib()
    scratch = None
    if lib.dtw_smem_bytes(n) == 0:
        scratch = torch.empty((b, lib.dtw_scratch_floats(n)),
                              dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dtw_launch(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                             None if scratch is None else scratch.data_ptr(),
                             b, n, r, stream)
    if err != 0:
        raise RuntimeError(f"dtw kernel launch failed: CUDA error {err} "
                           f"(B={b}, N={n}, band={band})")
    dtw_cuda.launches += 1
    return out


dtw_cuda.launches = 0
