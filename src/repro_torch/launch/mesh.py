"""Mesh builders: named grids of shards, one process driving them all.

Port of ``repro.launch.mesh``.  The reference's mesh is a grid of JAX
devices that one controller drives; here it is a grid of ``torch.device``s
that one process drives.  Shard ``i`` of a slab or of a slot table lives on
``mesh.devices.flat[i]`` (row-major over the named axes, as ``P(axes)``
lays the reference out).  On the CPU every shard is a host shard (the dry
run, as forced host devices are for the reference); on CUDA the shards go
round-robin over the cards, so several shards may share one card.

Single pod: (16, 16) = 256 shards, axes (data, model).
Multi-pod:  (2, 16, 16) = 512 shards, axes (pod, data, model).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["Mesh", "describe_devices", "device_count", "make_pod_data_mesh",
           "make_production_mesh", "make_test_mesh", "mesh_devices",
           "shard_devices"]


class Mesh:
    """A named grid of shard devices.

    ``devices`` is a numpy object array of ``torch.device`` shaped like the
    mesh (``mesh.devices.size``, ``mesh.devices.shape``); ``axis_names``
    names its axes; ``shape`` maps each name to its size.
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != devices.ndim:
            raise ValueError(f"{devices.ndim}-d device grid, axis names "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def device_count(device=None) -> int:
    """Devices of ``device``'s kind: the cards for CUDA, 1 for the host."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def shard_devices(n: int, device=None) -> list:
    """``n`` shard devices: host shards on the CPU, round-robin over the
    cards on CUDA."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [torch.device(dev.type)] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device) -> Mesh:
    n = int(np.prod(shape, dtype=np.int64))
    grid = np.empty((n,), dtype=object)
    grid[:] = shard_devices(n, device)
    return Mesh(grid.reshape(shape), axes)


def mesh_devices(mesh, axes: Tuple[str, ...]) -> list:
    """The shard devices of ``mesh`` over ``axes``, in shard order.

    Axes of the mesh outside ``axes`` hold replicas; their first index
    serves.  Works on any object with ``axis_names`` and a ``devices``
    array (duck-typed meshes included)."""
    grid = np.asarray(mesh.devices)
    names = tuple(mesh.axis_names)
    index = tuple(slice(None) if a in axes else 0 for a in names)
    kept = [a for a in names if a in axes]
    sub = grid[index]
    sub = np.transpose(sub, [kept.index(a) for a in axes])
    return list(sub.reshape(-1))


def describe_devices(devices) -> str:
    """How many distinct devices back the shards on ``devices`` (an
    iterable of them, e.g. ``mesh.devices.flat``), and which: e.g.
    ``1 distinct: cuda:0 (NVIDIA H100 80GB HBM3)``."""
    seen = list(dict.fromkeys(str(torch.device(d)) for d in devices))
    names = []
    for d in seen:
        dev = torch.device(d)
        names.append(f"{d} ({torch.cuda.get_device_name(dev)})"
                     if dev.type == "cuda" else f"{d} (host)")
    return f"{len(seen)} distinct: {', '.join(names)}"


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The dry run's mesh: (16, 16) or (2, 16, 16) shards.  On the CPU it is
    that many host shards; on CUDA it needs as many cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have "
            f"{torch.cuda.device_count()} -- run the dry run with "
            "device='cpu' (host shards)")
    return _mesh(shape, axes, dev)


def make_pod_data_mesh(n_pods: int, n_data: int | None = None, *,
                       device=None) -> Mesh:
    """2-D ``(pod, data)`` fleet mesh.  ``n_data=None`` spreads every device
    of the kind over the pods (``device_count() / n_pods`` each).
    ``n_pods=1`` degenerates to the flat data mesh."""
    if n_pods < 1:
        raise ValueError(f"n_pods must be >= 1, got {n_pods}")
    if n_data is None:
        total = device_count(device)
        if total % n_pods:
            raise ValueError(
                f"{total} devices do not divide over {n_pods} pods; "
                "pass n_data explicitly"
            )
        n_data = total // n_pods
    if n_data < 1:
        raise ValueError(
            f"n_data must be >= 1, got {n_data} "
            f"(more pods ({n_pods}) than devices?)"
        )
    return _mesh((n_pods, n_data), ("pod", "data"), device)


def make_test_mesh(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = ("data", "model"), *,
                   device=None) -> Mesh:
    """Small mesh for unit tests."""
    return _mesh(tuple(shape), tuple(axes), device)
