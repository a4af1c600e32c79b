"""The ``jax.random`` calls of the service path, bit for bit, in PyTorch.

A key is a pair of uint32 words held in an int64 tensor of shape
``(..., 2)`` (every value in ``[0, 2**32)``, arithmetic masked with
``& 0xFFFFFFFF``).  The words equal ``jax.random.key_data`` of the
reference's keys under the threefry2x32 implementation with
``jax_threefry_partitionable=True``:

  * ``key(seed)``          -- ``[0, seed mod 2**32]``;
  * ``split(key, num)``    -- threefry of counters ``(0, i)``;
  * ``fold_in(key, data)`` -- threefry of the counter ``(0, data)``;
  * ``choice(key, n, k, p)`` -- ``replace=False`` with probabilities: gumbel
    noise plus ``log(p)``, then the top ``k`` with ties (including the
    ``-inf`` of zero-probability entries) going to the lower index, as
    ``lax.top_k`` breaks them.

Every function is batched over the leading dimensions of ``key``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["key", "as_key", "key_data", "split", "fold_in", "random_bits",
           "uniform", "gumbel", "choice", "threefry2x32"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) on broadcast int64 words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s key data: ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def as_key(data, device=None) -> torch.Tensor:
    """Key words (a tensor, or ``uint32`` key data from numpy) as this
    module's int64 ``(..., 2)`` key tensor on ``device``."""
    if not torch.is_tensor(data):
        data = torch.from_numpy(np.asarray(data).astype(np.int64))
    return (data.to(torch.int64) & _MASK).to(device)


def key_data(key: torch.Tensor) -> np.ndarray:
    """The ``uint32`` key data of ``key`` (``jax.random.key_data``'s)."""
    return key.detach().cpu().numpy().astype(np.uint32)


def _counters(key: torch.Tensor, n: int):
    k1, k2 = key[..., 0:1], key[..., 1:2]
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``(..., 2)`` keys -> ``(..., num, 2)`` subkeys."""
    b1, b2 = _counters(key, num)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """Fold a 32-bit integer into ``key``."""
    d = torch.full_like(key[..., 1], int(data) & _MASK)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``(..., n)`` uint32 words (as int64) for a flat sample of size n."""
    b1, b2 = _counters(key, n)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int, minval: float = 0.0) -> torch.Tensor:
    """f32 uniform on ``[minval, 1)``: the mantissa trick of ``jax.random``."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # floats * (1 - minval) + minval, with 1 - minval == 1 in f32 for the
    # only minval the service draws with (0 or finfo.tiny)
    return torch.clamp_min(floats + minval, minval)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """Standard Gumbel noise, the reference's "low" mode."""
    return -torch.log(-torch.log(uniform(key, n, _F32_TINY)))


def choice(key: torch.Tensor, n: int, k: int, p: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, n, shape=(k,), replace=False, p=p)``.

    ``p`` is ``(..., n)`` f32 matching the key's batch; returns int64
    indices ``(..., k)``.
    """
    if k > n:
        raise ValueError(f"cannot take {k} samples from {n} without replacement")
    g = gumbel(key, n) + torch.log(p)
    return torch.sort(g, dim=-1, descending=True, stable=True).indices[..., :k]
