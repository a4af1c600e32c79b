"""Synthetic UCR-like stream generators (numpy only).

A copy of ``repro.data.synthetic``, kept in the port so that it imports
nothing of the JAX package: the same seed gives the same slab in both.

The UCR archive is not redistributable offline, so the benchmarks sample
these seeded families instead -- chosen to cover the archive's qualitative
range used by the paper (Table 1): smooth spectra, quasi-periodic sensors,
device switching (square events), motion random-walks, and ECG-ish bursts.
Each family yields z-scale-ish series; evaluation averages within family then
across families, mirroring the paper's equal-weight protocol.
"""
from __future__ import annotations

import zlib
from typing import List

import numpy as np

__all__ = ["FAMILIES", "make_dataset", "make_fleet"]


def _grid(n, length):
    return np.linspace(0.0, 1.0, length)[None, :].repeat(n, 0)


def _sensor(rng, n, length):
    """Quasi-periodic sensor (StarLightCurves / CinCECGTorso flavor)."""
    t = _grid(n, length)
    f = rng.uniform(3, 9, (n, 1))
    phase = rng.uniform(0, 2 * np.pi, (n, 1))
    amp2 = rng.uniform(0.1, 0.5, (n, 1))
    x = np.sin(2 * np.pi * f * t + phase) + amp2 * np.sin(4 * np.pi * f * t)
    return x + rng.normal(0, 0.08, x.shape)


def _device(rng, n, length):
    """Switching loads (ACSF1 / HouseTwenty / PLAID flavor)."""
    x = np.zeros((n, length))
    for i in range(n):
        pos = 0
        level = 0.0
        while pos < length:
            dur = int(rng.integers(length // 40 + 2, length // 8 + 4))
            level = rng.choice([0.0, 1.0, 2.0, 3.0]) + rng.normal(0, 0.05)
            x[i, pos: pos + dur] = level
            pos += dur
    return x + rng.normal(0, 0.05, x.shape)


def _motion(rng, n, length):
    """Smoothed random walk (Haptics / InlineSkate flavor)."""
    steps = rng.normal(0, 1.0, (n, length))
    x = np.cumsum(steps, axis=1)
    k = max(length // 100, 3)
    kernel = np.ones(k) / k
    sm = np.stack([np.convolve(r, kernel, mode="same") for r in x])
    return (sm - sm.mean(1, keepdims=True)) / (sm.std(1, keepdims=True) + 1e-9)


def _spectro(rng, n, length):
    """Smooth low-order curves (EthanolLevel / Rock flavor)."""
    t = _grid(n, length)
    c = rng.normal(0, 1, (n, 6))
    x = sum(c[:, k: k + 1] * t ** k for k in range(6))
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-9)
    return x + rng.normal(0, 0.03, x.shape)


def _hemo(rng, n, length):
    """Pulse-train bursts (PigAirwayPressure / ECG flavor)."""
    t = _grid(n, length)
    rate = rng.uniform(8, 16, (n, 1))
    phase = (t * rate) % 1.0
    pulse = np.exp(-((phase - 0.2) ** 2) / 0.004) + 0.4 * np.exp(
        -((phase - 0.5) ** 2) / 0.01
    )
    drift = 0.3 * np.sin(2 * np.pi * t * rng.uniform(0.5, 1.5, (n, 1)))
    return pulse + drift + rng.normal(0, 0.04, pulse.shape)


FAMILIES = {
    "sensor": _sensor,
    "device": _device,
    "motion": _motion,
    "spectro": _spectro,
    "hemo": _hemo,
}


def make_dataset(family: str, n_series: int = 10, length: int = 1500,
                 seed: int = 0) -> np.ndarray:
    """(n_series, length) f32 array for one family.

    Seeding uses a *stable* hash of the family name (``zlib.crc32``):
    Python's builtin ``hash`` is randomized per process (PYTHONHASHSEED), so
    it would silently generate different "seeded" data in every subprocess,
    breaking cross-process reproducibility (e.g. the device-count-invariance
    checks in ``tests/test_fleet.py``).
    """
    rng = np.random.default_rng(seed ^ zlib.crc32(family.encode()) & 0xFFFF)
    return FAMILIES[family](rng, n_series, length).astype(np.float32)


def make_fleet(n_streams: int, length: int, seed: int = 0) -> np.ndarray:
    """Mixed-family fleet slab (n_streams, length) for scale-out runs."""
    rng = np.random.default_rng(seed)
    names = list(FAMILIES)
    per = [n_streams // len(names)] * len(names)
    per[0] += n_streams - sum(per)
    parts: List[np.ndarray] = []
    for name, k in zip(names, per):
        if k:
            parts.append(make_dataset(name, k, length, seed=int(rng.integers(1 << 30))))
    return np.concatenate(parts, axis=0)
