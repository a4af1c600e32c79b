"""Elastic scaling: rebuild the mesh from surviving devices and reshard.

Port of ``repro.launch.elastic``.  Policy: keep the ``model`` axis intact
(tensor-parallel groups must be whole -- losing one device kills its group),
shrink the ``data`` axis to the largest full multiple that survives, then
restore the latest checkpoint with the new mesh's shardings (``ckpt``
stores leaves whole, so restore *is* the reshard).

The one-process flow, as the fleet runtime's meshes: the surviving shard
devices -> ``elastic_mesh`` -> ``CheckpointManager.restore_latest(...,
shardings=state_shardings(...))`` -> each leaf in pieces on the new mesh.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.launch.mesh import Mesh, device_count, shard_devices

__all__ = ["elastic_mesh", "resume_on_mesh"]


def elastic_mesh(model_size: int, *, devices: Optional[Sequence] = None,
                 device=None) -> Mesh:
    """Largest ``(data, model)`` mesh fitting the surviving devices:
    ``devices``, or every device of ``device``'s kind (``cuda`` unless told
    otherwise: one shard per card; one host shard on the CPU)."""
    devices = list(devices if devices is not None
                   else shard_devices(device_count(device), device))
    if len(devices) < model_size:
        raise RuntimeError(
            f"{len(devices)} devices cannot host a model axis of {model_size}")
    data = len(devices) // model_size
    grid = np.empty((data * model_size,), dtype=object)
    grid[:] = devices[:data * model_size]
    return Mesh(grid.reshape(data, model_size), ("data", "model"))


def resume_on_mesh(ckpt_dir, abstract_state, mesh):
    """Restore the latest checkpoint resharded onto ``mesh``: each leaf a
    ``sharding.layout.Sharded`` on its shard devices (the parameters as the
    dict of their reference-named leaves).  ``abstract_state``: the state's
    structure (``launch.specs.abstract_train_state`` does)."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch.specs import state_shardings

    mgr = CheckpointManager(ckpt_dir)
    shardings = state_shardings(abstract_state, mesh)
    state, manifest = mgr.restore_latest(abstract_state, shardings=shardings)
    if state is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return state, manifest
