"""Where a tensor's pieces live on a mesh: ``NamedSharding`` and ``Sharded``.

The counterpart of the ``jax.sharding.NamedSharding`` that the reference
imports from JAX, for the port's one-process meshes (``launch.mesh``): one
process drives every shard, so a sharded tensor is the list of its local
pieces, one per shard device in the mesh's row-major order (as
``launch.mesh`` lays shards out), each the block of the tensor that the
spec gives that shard.  A dim whose spec entry is a tuple of axes splits
over them jointly, the first the major one; the mesh axes the spec does not
name hold replicas.  ``torch.distributed`` stays out, as in the fleet
runtime.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.sharding.partition import P

__all__ = ["NamedSharding", "Sharded"]


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class NamedSharding:
    """``spec`` laid over ``mesh`` (anything with ``axis_names`` and a
    ``devices`` array)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)

    def __repr__(self) -> str:
        return (f"NamedSharding(mesh={dict(self._sizes)}, "
                f"spec={self.spec!r})")

    @property
    def _sizes(self) -> Dict[str, int]:
        return dict(zip(self.mesh.axis_names,
                        np.asarray(self.mesh.devices).shape))

    @property
    def num_devices(self) -> int:
        return int(np.asarray(self.mesh.devices).size)

    def _entries(self, ndim: int) -> list:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec!r} has more entries than the "
                             f"tensor's {ndim} dims")
        return list(self.spec) + [None] * (ndim - len(self.spec))

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The shape of each shard's piece of a tensor of ``shape``."""
        sizes, out = self._sizes, []
        for dim, entry in zip(shape, self._entries(len(shape))):
            n = int(np.prod([sizes[a] for a in _axes(entry)], dtype=np.int64))
            if dim % n:
                raise ValueError(f"dim {dim} does not divide over {entry!r} "
                                 f"({n} shards)")
            out.append(dim // n)
        return tuple(out)

    def indices(self, shape) -> List[Tuple[slice, ...]]:
        """Each shard's block of a tensor of ``shape``, in the mesh's
        row-major shard order."""
        sizes, names = self._sizes, tuple(self.mesh.axis_names)
        entries, local = self._entries(len(shape)), self.shard_shape(shape)
        grid = np.asarray(self.mesh.devices).shape
        out = []
        for coords in np.ndindex(*grid):
            at = dict(zip(names, coords))
            idx = []
            for entry, n in zip(entries, local):
                block = 0
                for a in _axes(entry):
                    block = block * sizes[a] + at[a]
                idx.append(slice(block * n, (block + 1) * n))
            out.append(tuple(idx))
        return out

    def shard(self, t: torch.Tensor) -> "Sharded":
        """``t``'s pieces on the mesh's shard devices.  Pieces that land on
        the device ``t`` already lives on are views of it (replicas on one
        device share one piece)."""
        devices = [torch.device(d) for d in
                   np.asarray(self.mesh.devices).reshape(-1)]
        pieces = [t[idx].to(dev) for idx, dev in
                  zip(self.indices(tuple(t.shape)), devices)]
        return Sharded(pieces, tuple(t.shape), t.dtype, self)


class Sharded:
    """A tensor of ``shape`` and ``dtype`` held as ``pieces`` on the shard
    devices of ``sharding.mesh`` (row-major; ``pieces[i]`` on
    ``mesh.devices.flat[i]``)."""

    def __init__(self, pieces: List[torch.Tensor], shape, dtype,
                 sharding: NamedSharding):
        self.pieces = pieces
        self.shape = tuple(shape)
        self.dtype = dtype
        self.sharding = sharding

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, dtype={self.dtype}, "
                f"{self.sharding!r})")

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (``cuda`` unless told
        otherwise), each block read from its first shard."""
        out = torch.empty(self.shape, dtype=self.dtype,
                          device=resolve_device(device))
        done = set()
        for idx, piece in zip(self.sharding.indices(self.shape), self.pieces):
            key = tuple((s.start, s.stop) for s in idx)
            if key not in done:
                done.add(key)
                out[idx] = piece.to(out.device)
        return out
