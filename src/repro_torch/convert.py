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

Train states travel as the reference's state tree: ``params`` as above,
``opt`` (AdamW's ``m``/``v``, Adafactor's ``f`` with ``vr``/``vc`` or
``v`` under each parameter's path), ``step`` and, for the compressed step,
``error_fb``; outside ``params`` a 2-byte leaf is bf16.

Decode states travel as a dict from each leaf's reference name (its
``_path_str``: ``blocks/0/0/k``, ``pos``) to a numpy array, the superblocks
stacked on the leading axis as the reference's state holds them
(``launch.specs.decode_state_leaves``); bf16 as ``uint16``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.compress import CompressorState
from repro_torch.core.digitize import DigitizerState
from repro_torch.core.normalize import EwmState
from repro_torch.core.symed import ReceiverState
from repro_torch.models.params import leaf_path, path_str, stack_named

__all__ = ["receiver_state_from_numpy", "receiver_state_to_numpy",
           "params_from_numpy", "params_to_numpy", "train_state_from_numpy",
           "train_state_to_numpy", "decode_state_to_numpy",
           "decode_state_from_numpy"]

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


def _tensor(arr, dtype: torch.dtype) -> torch.Tensor:
    arr = np.asarray(arr, order="C")  # keeps a 0-d leaf 0-d
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
            keys, block = leaf_path(name)
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


def _arr(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.numpy())


def params_to_numpy(model):
    """The port's model -> the JAX package's parameter tree of numpy
    arrays (``blocks``/``enc_blocks`` stacked again; bf16 as ``uint16``)."""
    tree: dict = {}
    stacked: dict = {}
    for name, param in model.named_parameters():
        arr = _arr(param)
        keys, block = leaf_path(name)
        if block is None:
            _set(tree, keys, arr)
        else:
            stacked.setdefault(tuple(keys), []).append(arr)
    for keys, arrs in stacked.items():
        _set(tree, list(keys), np.stack(arrs))
    return _tuples(tree)


def _np_leaf(tree, keys):
    for key in keys:
        tree = tree[key]
    return tree


def _half_or_f(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    dtype = torch.bfloat16 if arr.dtype.itemsize == 2 else None
    t = (_tensor(arr, dtype) if dtype is not None
         else torch.from_numpy(np.ascontiguousarray(arr).copy()))
    return t.to(device)


def _keys(name: str):
    return [int(k) if k.isdigit() else k for k in name.split("/")]


def train_state_from_numpy(tree, cfg, device=None):
    """The reference's train state of numpy arrays -> the port's
    (``train.steps``' layout) on ``device`` (``cuda`` unless told
    otherwise); the parameters trainable."""
    device = resolve_device(device)
    params = params_from_numpy(tree["params"], cfg, device).requires_grad_(
        True)
    names = list(stack_named(
        (n, p) for n, p in params.named_parameters()))

    def ref_dict(sub):
        return {n: _half_or_f(_np_leaf(sub, _keys(n)), device) for n in names}

    opt = tree["opt"]
    if "f" in opt:
        new_opt = {"f": {}}
        for n in names:
            node = _np_leaf(opt["f"], _keys(n))
            new_opt["f"][n] = {k: _half_or_f(v, device)
                               for k, v in node.items()}
    else:
        new_opt = {"m": ref_dict(opt["m"]), "v": ref_dict(opt["v"])}
    state = {"params": params, "opt": new_opt,
             "step": torch.as_tensor(np.array(tree["step"]),
                                     dtype=torch.int32).to(device)}
    if "error_fb" in tree:
        state["error_fb"] = ref_dict(tree["error_fb"])
    return state


def _unflatten(named) -> dict:
    tree: dict = {}
    for name, t in named.items():
        if isinstance(t, dict):
            for k, v in t.items():
                _set(tree, _keys(name) + [k], _arr(v))
        else:
            _set(tree, _keys(name), _arr(t))
    return _tuples(tree)


def train_state_to_numpy(state):
    """The port's train state -> the reference's tree of numpy arrays (bf16
    as ``uint16``).  A per-pod ``error_fb`` gives pod 0's buffers, the
    copy the reference's host reads of its replicated-spec output."""
    opt = state["opt"]
    out = {"params": params_to_numpy(state["params"]),
           "opt": {k: _unflatten(v) for k, v in opt.items()},
           "step": np.asarray(int(state["step"]), np.int32)}
    if "error_fb" in state:
        efb = state["error_fb"]
        out["error_fb"] = _unflatten(efb[0] if isinstance(efb, (list, tuple))
                                     else efb)
    return out


def decode_state_to_numpy(state) -> dict:
    """The port's decode state -> ``{reference name: numpy array}``, the
    superblocks stacked (bf16 as ``uint16``)."""
    from repro_torch.launch.specs import decode_state_leaves

    return {k: _arr(t) for k, t in decode_state_leaves(state).items()}


def decode_state_from_numpy(leaves, cfg, device=None):
    """``{reference name: numpy array}`` (a reference state flattened with
    its ``_path_str``) -> the port's decode state of ``cfg`` on ``device``
    (``cuda`` unless told otherwise), each leaf in the dtype the port's
    state holds it in.  Raises on a missing leaf."""
    from repro_torch.launch.specs import map_decode_state
    from repro_torch.models.transformer import init_decode_state

    device = resolve_device(device)
    template = init_decode_state(cfg, 1, 1, device="meta")

    def leaf(name, t, block):
        arr = np.asarray(leaves[name])
        return _tensor(arr if block is None else arr[block], t.dtype).to(
            device)

    return map_decode_state(template, leaf)
