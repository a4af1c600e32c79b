"""Carry receiver state and model parameters across between the JAX
package and the port.

States travel as trees of numpy arrays: NamedTuples whose field names match
the port's state classes (``ReceiverState``, ``DigitizerState``,
``CompressorState``, ``EwmState``), with the PRNG key as its ``uint32`` key
data of shape ``(..., 2)``.  A JAX state becomes such a tree with
``jax.random.key_data`` on its key leaf and ``jax.tree.map(np.asarray, ...)``.

Model parameters travel as the JAX package's parameter tree (nested dicts
and tuples) of numpy arrays, ``jax.tree.map(np.asarray, params)``: every
leaf of ``blocks`` and ``enc_blocks`` carries the superblocks on its leading
axis, which the port's module unstacks into one ``ModuleList`` entry each.
A ``bfloat16`` leaf is taken as the 16-bit words it is (any 2-byte dtype,
``uint16`` included), and ``params_to_numpy`` gives those words back as
``uint16``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.compress import CompressorState
from repro_torch.core.digitize import DigitizerState
from repro_torch.core.normalize import EwmState
from repro_torch.core.symed import ReceiverState

__all__ = ["receiver_state_from_numpy", "receiver_state_to_numpy",
           "params_from_numpy", "params_to_numpy"]

_CLASSES = {cls._fields: cls
            for cls in (ReceiverState, DigitizerState, CompressorState,
                        EwmState)}


def receiver_state_from_numpy(tree, device=None):
    """A numpy tree (see the module doc) -> the port's state on ``device``
    (``cuda`` unless told otherwise; raises when CUDA is absent)."""
    device = resolve_device(device)
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


_STACKED = ("blocks", "enc_blocks")


def _leaf_path(name: str):
    """A port parameter name -> (keys into the reference's tree, the
    superblock index or None): ``blocks.3.0.wq`` -> (``blocks``, 0, ``wq``),
    3."""
    parts = name.split(".")
    if parts[0] in _STACKED:
        return [parts[0], int(parts[2])] + parts[3:], int(parts[1])
    return [int(p) if p.isdigit() else p for p in parts], None


def _tensor(arr, dtype: torch.dtype) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2:
            raise TypeError(f"a bfloat16 leaf needs 2-byte words, got "
                            f"{arr.dtype}")
        return torch.from_numpy(arr.view(np.int16).copy()).view(dtype)
    return torch.from_numpy(arr.copy()).to(dtype)


def params_from_numpy(tree, cfg, device=None):
    """The JAX package's parameter tree of numpy arrays -> the port's model
    (``models.init_params``'s module) on ``device`` (``cuda`` unless told
    otherwise).  Raises on a missing leaf or a shape that differs."""
    from repro_torch.models.transformer import init_params

    device = resolve_device(device)
    model = init_params(None, cfg, device="meta").to_empty(device=device)
    with torch.no_grad():
        for name, param in model.named_parameters():
            keys, block = _leaf_path(name)
            leaf = tree
            for key in keys:
                leaf = leaf[key]
            if block is not None:
                leaf = np.asarray(leaf)[block]
            if tuple(leaf.shape) != tuple(param.shape):
                raise ValueError(f"{name}: shape {tuple(leaf.shape)} != "
                                 f"{tuple(param.shape)}")
            param.copy_(_tensor(leaf, param.dtype))
    return model


def _set(tree, keys, value):
    for i, key in enumerate(keys[:-1]):
        nxt = keys[i + 1]
        if isinstance(key, int):
            while len(tree) <= key:
                tree.append({} if not isinstance(nxt, int) else [])
        elif key not in tree:
            tree[key] = [] if isinstance(nxt, int) else {}
        tree = tree[key]
    tree[keys[-1]] = value


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return tuple(_tuples(v) for v in tree)
    return tree


def params_to_numpy(model):
    """The port's model -> the JAX package's parameter tree of numpy
    arrays (``blocks``/``enc_blocks`` stacked again; bf16 as ``uint16``)."""
    tree: dict = {}
    stacked: dict = {}
    for name, param in model.named_parameters():
        t = param.detach().cpu()
        arr = (t.view(torch.int16).numpy().view(np.uint16)
               if t.dtype == torch.bfloat16 else t.numpy())
        keys, block = _leaf_path(name)
        if block is None:
            _set(tree, keys, arr)
        else:
            stacked.setdefault(tuple(keys), []).append(arr)
    for keys, arrs in stacked.items():
        _set(tree, list(keys), np.stack(arrs))
    return _tuples(tree)
