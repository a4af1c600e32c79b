"""Parameter accounting: shapes and counts of a config's parameter tree.

Port of ``repro.models.params``.  The tree is built on the ``meta`` device:
names, shapes and dtypes with no allocation.  Also the map between the
port's parameter names and the reference's leaves (``stack_named``,
``with_leaves``), which the optimizer, the checkpoints and ``convert``
share.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
from torch import nn

__all__ = ["param_shapes", "count_params", "leaf_path", "path_str",
           "stack_named", "with_leaves"]


@functools.lru_cache(maxsize=64)
def param_shapes(cfg):
    """The parameter tree on the ``meta`` device (no allocation)."""
    from repro_torch.models.transformer import init_params

    return init_params(None, cfg, device="meta")


def _leaf_count(path_str: str, leaf, cfg, active_only: bool) -> int:
    n = leaf.numel()
    if active_only and ("_moe" in path_str) and cfg.n_experts:
        # only top_k of n_experts experts touch each token
        n = n * cfg.top_k // cfg.n_experts
    return n


def count_params(cfg, active_only: bool = False) -> int:
    return sum(_leaf_count(name, leaf, cfg, active_only)
               for name, leaf in param_shapes(cfg).named_parameters())


# ---------------------------------------------------------------------------
# The reference's leaf names: stacked superblocks, ``/``-joined paths
# ---------------------------------------------------------------------------

STACKED = ("blocks", "enc_blocks")


def leaf_path(name: str):
    """A port parameter name -> (keys into the reference's tree, the
    superblock index or None): ``blocks.3.0.wq`` -> (``blocks``, 0, ``wq``),
    3."""
    parts = name.split(".")
    if parts[0] in STACKED:
        return [parts[0], int(parts[2])] + parts[3:], int(parts[1])
    return [int(p) if p.isdigit() else p for p in parts], None


def path_str(keys) -> str:
    """The reference's ``_path_str``: the keys joined by ``/``."""
    return "/".join(str(k) for k in keys)


def stack_named(named) -> Dict[str, torch.Tensor]:
    """``(port name, tensor)`` pairs -> the reference's leaves: a dict from
    its path string (``blocks/0/wq``) to the tensor, the superblocks
    stacked on a leading axis as the reference scans them, in the order
    ``jax.tree.leaves`` gives them (sorted keys).  Unstacked leaves are the
    tensors themselves (no copy)."""
    single: Dict[tuple, torch.Tensor] = {}
    stacked: Dict[tuple, list] = {}
    for name, t in named:
        keys, block = leaf_path(name)
        if block is None:
            single[tuple(keys)] = t
        else:
            stacked.setdefault(tuple(keys), []).append((block, t))
    for keys, parts in stacked.items():
        single[keys] = torch.stack([t for _, t in sorted(
            parts, key=lambda bt: bt[0])])
    return {path_str(k): single[k] for k in sorted(single)}


def with_leaves(model: nn.Module, leaves: Dict[str, torch.Tensor],
                requires_grad: bool = False) -> nn.Module:
    """A new module tree shaped as ``model`` whose parameters are the
    reference-named ``leaves`` (a superblock's leaf a view of its row of
    the stacked tensor), trainable when ``requires_grad``."""
    from repro_torch.models.layers import ParamTree

    def leaf(name):
        keys, block = leaf_path(name)
        t = leaves[path_str(keys)]
        return t if block is None else t[block]

    def rebuild(module, prefix):
        if isinstance(module, nn.ModuleList):
            return nn.ModuleList(rebuild(m, f"{prefix}{i}.")
                                 for i, m in enumerate(module))
        kids = {name: leaf(prefix + name) for name in module._parameters}
        for name, m in module._modules.items():
            kids[name] = rebuild(m, f"{prefix}{name}.")
        return ParamTree(**kids)

    with torch.no_grad():
        out = rebuild(model, "")
    return out.requires_grad_(requires_grad)
