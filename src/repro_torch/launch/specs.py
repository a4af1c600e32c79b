"""``input_specs``: abstract inputs and their shardings for every (arch x
shape) dry-run cell.

Port of ``repro.launch.specs``.  Nothing is allocated: the states come from
the real constructors on the ``meta`` device (``steps.init_train_state``,
``transformer.init_decode_state``), so the specs can never drift from the
model code.  Shardings are dicts from each leaf's reference name (the
reference's ``_path_str`` of its tree: ``params/blocks/0/wq``,
``blocks/0/0/k``) to a ``sharding.layout.NamedSharding``; a single tensor
gets one ``NamedSharding``.

The port's decode state is a list over superblocks of tuples over the
pattern (``transformer.init_decode_state``); the reference stacks each leaf
over the superblocks.  ``decode_state_leaves`` gives the port's state under
the reference's names and shapes, which the decode rules key on.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.ckpt.checkpoint import named_leaves
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.models.layers import model_dtype
from repro_torch.models.transformer import init_decode_state
from repro_torch.sharding.layout import NamedSharding
from repro_torch.sharding.partition import P, logical_to_spec, spec_for_path
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.steps import init_train_state

__all__ = [
    "train_batch_specs", "decode_state_specs", "abstract_train_state",
    "abstract_decode_state", "batch_shardings", "state_shardings",
    "input_specs", "default_accum_steps", "map_decode_state",
    "decode_state_groups", "decode_state_leaves",
]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((b, s), torch.int32)}
    if cfg.frontend == "patches":
        batch["prefix_embeds"] = _meta((b, cfg.num_prefix_embeds,
                                        cfg.d_model), model_dtype(cfg))
    elif cfg.frontend == "frames":
        batch["enc_frames"] = _meta((b, cfg.num_prefix_embeds, cfg.d_model),
                                    model_dtype(cfg))
    return batch


def abstract_train_state(cfg: ModelConfig, oc: OptConfig):
    return init_train_state(None, cfg, oc, device="meta")


def abstract_decode_state(cfg: ModelConfig, batch: int, max_len: int):
    return init_decode_state(cfg, batch, max_len, device="meta")


# ---------------------------------------------------------------------------
# The decode state under the reference's names
# ---------------------------------------------------------------------------

def _walk(tree, prefix: str, block, fn: Callable):
    # module level, not a closure: a nested function that calls itself is a
    # reference cycle, which would keep ``fn``'s results (the state's
    # tensors) alive until the garbage collector runs
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(tree[k], f"{prefix}{k}/", block, fn)
                for k in sorted(tree)}
    if hasattr(tree, "_fields"):  # a cache or recurrent-state tuple
        return type(tree)(*(_walk(getattr(tree, f), f"{prefix}{f}/", block,
                                  fn) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, f"{prefix}{i}/", block, fn)
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree, block)


def map_decode_state(state, fn: Callable):
    """``state``'s structure with each tensor ``t`` replaced by ``fn(name,
    t, block)``: ``name`` the reference's name of the leaf it belongs to,
    ``block`` the superblock index within that stacked leaf (None outside
    ``blocks``).  Dict keys go in sorted order, as the reference's tree
    flattens them; ``None`` (an absent cross cache) stays."""
    out = {}
    for key in sorted(state):
        if key == "blocks":
            out[key] = [_walk(b, "blocks/", i, fn)
                        for i, b in enumerate(state[key])]
        else:
            out[key] = _walk(state[key], f"{key}/", None, fn)
    return out


def decode_state_groups(state) -> Dict[str, List[torch.Tensor]]:
    """Each reference leaf's name -> the port's tensors that make it up (one
    per superblock under ``blocks``, else one), in the reference's leaf
    order (block 0 names every leaf of ``blocks`` before block 1 adds to
    them)."""
    groups: Dict[str, List[torch.Tensor]] = {}

    def collect(name, t, block):
        groups.setdefault(name, []).append(t)
        return t

    map_decode_state(state, collect)
    return groups


def decode_state_leaves(state) -> Dict[str, torch.Tensor]:
    """The state as the reference's leaves: ``{name: tensor}``, the
    superblocks stacked on a leading axis (new tensors; the rest are the
    state's own)."""
    return {k: torch.stack(ts) if k.startswith("blocks/") else ts[0]
            for k, ts in decode_state_groups(state).items()}


# ---------------------------------------------------------------------------
# Sharding specs
# ---------------------------------------------------------------------------

def batch_shardings(batch, mesh):
    """Batch-major shardings: a ``NamedSharding`` for a tensor, a dict of
    them for a dict of tensors."""
    def spec(leaf):
        logical = ("batch",) + (None,) * (len(leaf.shape) - 1)
        return NamedSharding(
            mesh, logical_to_spec(logical, tuple(leaf.shape), mesh))

    if isinstance(batch, dict):
        return {k: spec(v) for k, v in batch.items()}
    return spec(batch)


_DECODE_RULES = {
    # KVCache leaves: (..., B, C, kv, hd) -- kv heads shard when divisible,
    # else head_dim (flash-decoding-style splits stay available via kv_seq)
    "k": ("batch", None, "kv_heads", "head_dim"),
    "v": ("batch", None, "kv_heads", "head_dim"),
    "k_q": ("batch", None, "kv_heads", "head_dim"),
    "v_q": ("batch", None, "kv_heads", "head_dim"),
    "k_s": ("batch", None, "kv_heads", None),
    "v_s": ("batch", None, "kv_heads", None),
    # mamba
    "h": ("batch", "ssm_inner", None),
    "conv_buf": ("batch", None, "ssm_inner"),
    # xlstm
    "c": ("batch", "heads", None, None),
    "n": ("batch", "heads", None),
    "m": ("batch", "heads"),
    "enc_mem": ("batch", None, None),
    "pos": (),
}

_DECODE_RULES_BY_RANK = {  # (name, rank) overrides (slstm c/n are rank 3)
    ("c", 3): ("batch", "heads", None),
}


def decode_state_specs(state, mesh) -> Dict[str, NamedSharding]:
    """Each decode-state leaf's sharding by the reference's name: the rule
    of its last non-digit path name, right-aligned on its stacked shape
    (stacked by ``decode_state_leaves``: an abstract, ``meta`` state costs
    nothing)."""
    out = {}
    for path, leaf in decode_state_leaves(state).items():
        shape, name = tuple(leaf.shape), None
        for part in reversed(path.split("/")):
            if not part.isdigit():
                name = part
                break
        logical = _DECODE_RULES_BY_RANK.get((name, len(shape)))
        if logical is None:
            logical = _DECODE_RULES.get(name)
        if logical is None:
            out[path] = NamedSharding(mesh, P())
            continue
        pad = (None,) * (len(shape) - len(logical))
        out[path] = NamedSharding(
            mesh, logical_to_spec(pad + tuple(logical), shape, mesh))
    return out


def state_shardings(state, mesh) -> Dict[str, NamedSharding]:
    """Train-state shardings (params and optimizer leaves through the param
    partitioner), by reference name.  Reads only shapes: an abstract
    (``meta``) state costs nothing."""
    return {name: NamedSharding(mesh, spec_for_path(name, tuple(t.shape),
                                                    mesh))
            for name, t in named_leaves(state)}


# ---------------------------------------------------------------------------
# Cell assembly
# ---------------------------------------------------------------------------

def default_accum_steps(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Gradient-accumulation policy: keep per-microbatch activations
    memory-sized."""
    if shape.step != "train":
        return 1
    n = cfg.param_count()
    if n > 1e11:
        return 8
    if n > 2e10:
        return 4
    return 1


def input_specs(cfg: ModelConfig, shape_name: str,
                oc: Optional[OptConfig] = None):
    """Abstract inputs for one dry-run cell.

    Returns a dict with ``kind`` (train|prefill|decode), ``args`` (the step
    function's arguments as ``meta`` tensors and states) and a
    ``shardings(mesh)`` callable giving their shardings.
    """
    shape = SHAPES[shape_name]
    oc = oc or OptConfig(moments_dtype="bfloat16" if cfg.param_count() > 3e10
                         else "float32")

    if shape.step == "train":
        state = abstract_train_state(cfg, oc)
        batch = train_batch_specs(cfg, shape)

        def shardings(mesh):
            return (state_shardings(state, mesh),
                    batch_shardings(batch, mesh))

        return {"kind": "train", "args": (state, batch),
                "shardings": shardings, "opt_config": oc,
                "accum_steps": default_accum_steps(cfg, shape)}

    if shape.step == "prefill":
        batch = train_batch_specs(cfg, shape)
        tokens = batch.pop("tokens")
        args = (tokens, batch)

        def shardings(mesh):
            return (batch_shardings(tokens, mesh),
                    batch_shardings(batch, mesh))

        return {"kind": "prefill", "args": args, "shardings": shardings,
                "opt_config": oc}

    # decode: one new token against a seq_len cache
    state = abstract_decode_state(cfg, shape.global_batch, shape.seq_len)
    token = _meta((shape.global_batch, 1), torch.int32)

    def shardings(mesh):
        return (decode_state_specs(state, mesh),
                batch_shardings(token, mesh))

    return {"kind": "decode", "args": (state, token), "shardings": shardings,
            "opt_config": oc}
