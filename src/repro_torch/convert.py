"""Carry receiver state across between the JAX package and the port.

States travel as trees of numpy arrays: NamedTuples whose field names match
the port's state classes (``ReceiverState``, ``DigitizerState``,
``CompressorState``, ``EwmState``), with the PRNG key as its ``uint32`` key
data of shape ``(..., 2)``.  A JAX state becomes such a tree with
``jax.random.key_data`` on its key leaf and ``jax.tree.map(np.asarray, ...)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.compress import CompressorState
from repro_torch.core.digitize import DigitizerState
from repro_torch.core.normalize import EwmState
from repro_torch.core.symed import ReceiverState

__all__ = ["receiver_state_from_numpy", "receiver_state_to_numpy"]

_CLASSES = {cls._fields: cls
            for cls in (ReceiverState, DigitizerState, CompressorState,
                        EwmState)}


def receiver_state_from_numpy(tree, device="cpu"):
    """A numpy tree (see the module doc) -> the port's state on ``device``."""
    cls = _CLASSES.get(getattr(tree, "_fields", None))
    if cls is None:
        raise TypeError(f"not a receiver-state tree: {type(tree).__name__}")
    leaves = []
    for name, leaf in zip(cls._fields, tree):
        if hasattr(leaf, "_fields"):
            leaves.append(receiver_state_from_numpy(leaf, device))
            continue
        arr = np.array(leaf)
        if name == "key":
            arr = arr.astype(np.uint32).astype(np.int64)
        leaves.append(torch.as_tensor(arr).to(device))
    return cls(*leaves)


def receiver_state_to_numpy(state):
    """The port's state -> the same tree of numpy arrays (key as uint32)."""
    leaves = []
    for name, leaf in zip(state._fields, state):
        if hasattr(leaf, "_fields"):
            leaves.append(receiver_state_to_numpy(leaf))
            continue
        arr = leaf.detach().cpu().numpy()
        leaves.append(arr.astype(np.uint32) if name == "key" else arr)
    return type(state)(*leaves)
