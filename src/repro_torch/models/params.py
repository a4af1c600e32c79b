"""Parameter accounting: shapes and counts of a config's parameter tree.

Port of ``repro.models.params``.  The tree is built on the ``meta`` device:
names, shapes and dtypes with no allocation.
"""
from __future__ import annotations

import functools

__all__ = ["param_shapes", "count_params"]


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
