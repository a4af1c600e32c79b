"""Logical-axis -> mesh-axis resolution with divisibility fallback.

Port of ``repro.sharding.partition``, rule for rule.  Every logical name
carries an ordered candidate list of mesh axes (or axis tuples).
Resolution picks the first candidate whose axes all exist in the mesh, whose
product divides the tensor dim, and which is disjoint from axes already used
elsewhere in the same spec -- otherwise the dim is replicated.  This is what
makes one rule table serve every assigned arch: paligemma's 8 q heads fall
back from ``heads`` (16-way) to ``head_dim``; nemotron's 8 kv heads fall back
to replication; olmoe's 64 experts take true expert parallelism while
mixtral's 8 fall back to tensor-parallel d_ff.

Param specs are resolved from leaf *path names* (``_PARAM_RULES``), the
reference's ``/``-joined names of its stacked tree (``blocks/0/wq`` is
``(n_blocks, d, h*hd)``): ``param_specs`` works on ``models.params.
stack_named``'s view of the port's parameters.  A mesh is anything with
``axis_names`` and a ``devices`` array (``launch.mesh.Mesh``, or a
duck-typed stand-in).
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["P", "LOGICAL_RULES", "logical_to_spec", "param_specs",
           "spec_for_path"]


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``
    (replicated), a mesh axis name, or a tuple of names that shard the dim
    jointly (the first the major one).  Entries are normalised as the
    reference's ``PartitionSpec`` normalises them (a 1-tuple becomes its
    name, an empty tuple ``None``), and equality is the tuple's: ``P("a")
    != P("a", None)`` and ``P() != P(None)``, as in the reference."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return None if not p else (p[0] if len(p) == 1 else p)
            return p

        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


# Ordered candidates per logical axis.  Entries are tuples of mesh axes that
# shard the dim jointly (e.g. batch over pod x data).
LOGICAL_RULES: Dict[str, Sequence[Tuple[str, ...]]] = {
    "batch": [("pod", "data"), ("data",)],
    "fsdp": [("data",)],                 # param "long" dim: FSDP sharding
    "vocab": [("model",)],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "head_dim": [("model",)],
    "qkv_fused": [("model",)],           # fused H*hd dim -- always divisible
    "mlp": [("model",)],
    "experts": [("model",)],
    # MoE expert weights: shard the *non-contracting* dims (experts x d_ff)
    # so the contraction dim (d_model) never needs an FSDP weight gather
    "moe_d": [("model",)],
    # matching activation shardings inside moe_apply (expert buffers are
    # token-replicated after the dispatch, so f-over-data is free)
    "experts_act": [("model",)],
    "moe_f_act": [("data",)],
    "ssm_inner": [("model",)],
    "seq": [],                           # sequence stays unsharded (no CP)
    # sequence parallelism at block boundaries: the carry between
    # superblocks is the dominant live tensor under remat; sharding its seq
    # dim over `model` divides boundary storage by the TP degree
    "seq_block": [("model",)],
    "kv_seq": [("model",)],              # decode: flash-decoding style split
    "embed": [],                         # activation d_model: unsharded
    "stack": [],                         # superblock stack's leading axis
}


def _mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _resolve(logical: Optional[str], dim: int, mesh, used: set,
             exclude: Tuple[str, ...] = ()) -> Optional[Tuple[str, ...]]:
    if logical is None:
        return None
    sizes = _mesh_sizes(mesh)
    for cand in LOGICAL_RULES.get(logical, []):
        if not all(a in sizes for a in cand):
            continue
        if any(a in used or a in exclude for a in cand):
            continue
        prod = 1
        for a in cand:
            prod *= sizes[a]
        if prod and dim % prod == 0:
            used.update(cand)
            return cand
    # partial fallback: "batch over (pod, data)" should still use data alone
    # when pod is excluded/absent
    for cand in LOGICAL_RULES.get(logical, []):
        sub = tuple(a for a in cand
                    if a in sizes and a not in used and a not in exclude)
        if not sub or sub == cand:
            continue
        prod = 1
        for a in sub:
            prod *= sizes[a]
        if prod and dim % prod == 0:
            used.update(sub)
            return sub
    return None


def logical_to_spec(logical: Tuple[Optional[str], ...],
                    shape: Tuple[int, ...], mesh,
                    exclude: Tuple[str, ...] = ()) -> P:
    """Resolve a tuple of logical names against a concrete shape + mesh."""
    if len(logical) != len(shape):
        raise AssertionError((logical, shape))
    used: set = set()
    parts = []
    for name, dim in zip(logical, shape):
        axes = _resolve(name, dim, mesh, used, exclude)
        if axes is None:
            parts.append(None)
        elif len(axes) == 1:
            parts.append(axes[0])
        else:
            parts.append(tuple(axes))
    return P(*parts)


# ---------------------------------------------------------------------------
# Param-tree rules: leaf path regex -> logical axes (rightmost dims; leading
# unmatched dims -- e.g. the superblock stack axis -- replicate).
# ---------------------------------------------------------------------------

_PARAM_RULES: Sequence[Tuple[str, Optional[Tuple[Optional[str], ...]]]] = (
    # embeddings / unembedding
    (r"(^|/)embed$", ("vocab", "fsdp")),
    (r"(^|/)lm_head$", ("fsdp", "vocab")),
    # attention (fused head dims stay divisible even when H isn't)
    (r"(^|/)wq$", ("fsdp", "qkv_fused")),
    (r"(^|/)wk$", ("fsdp", "qkv_fused")),
    (r"(^|/)wv$", ("fsdp", "qkv_fused")),
    (r"(^|/)wo$", ("qkv_fused", "fsdp")),
    (r"(^|/)b[qkv]$", ("qkv_fused",)),
    # dense mlp
    (r"(^|/)wi$", ("fsdp", "mlp")),
    (r"(^|/)wo_mlp$", ("mlp", "fsdp")),
    # moe
    (r"(^|/)router$", (None, None)),
    # (e -> model | d_model -> model when e indivisible | d_ff -> data)
    (r"(^|/)wi_moe$", ("experts", "moe_d", "fsdp")),
    (r"(^|/)wo_moe$", ("experts", "fsdp", "moe_d")),
    # mamba
    (r"(^|/)in_proj$", ("fsdp", "ssm_inner")),
    (r"(^|/)out_proj$", ("ssm_inner", "fsdp")),
    (r"(^|/)x_proj$", ("ssm_inner", None)),
    (r"(^|/)dt_proj$", (None, "ssm_inner")),
    (r"(^|/)(a_log|d_skip|dt_bias|conv_w|conv_b)$", None),  # replicate
    # xlstm
    (r"(^|/)up$", ("fsdp", "ssm_inner")),
    (r"(^|/)down$", ("ssm_inner", "fsdp")),
    (r"(^|/)w[qkv]_m$", ("ssm_inner", None)),
    (r"(^|/)(wi_g|wf_g|bi|bf|b)$", None),
    (r"(^|/)wx$", ("fsdp", "mlp")),
    (r"(^|/)r$", None),
    (r"(^|/)ffn_up$", ("fsdp", "mlp")),
    (r"(^|/)ffn_down$", ("mlp", "fsdp")),
    # norms & leftovers
    (r"(^|/)(ln\w*|scale|norm\w*)$", None),
)


def spec_for_path(path: str, shape: Tuple[int, ...], mesh) -> P:
    """Partition spec of one leaf named as the reference names it
    (``blocks/0/wq``, or a port parameter name such as ``blocks.3.0.wq``,
    whose ``.`` separators count as ``/``); unmatched paths replicate.
    The logical axes right-align onto the trailing dims, so a stacked
    leaf's leading axis and a single superblock's leaf get the same
    trailing entries."""
    path = path.replace(".", "/")
    for pat, logical in _PARAM_RULES:
        if re.search(pat, path):
            if logical is None:
                return P()
            pad = (None,) * (len(shape) - len(logical))
            return logical_to_spec(pad + tuple(logical), tuple(shape), mesh)
    return P()


def param_specs(params, mesh) -> Dict[str, P]:
    """The spec of every parameter leaf of the port's model ``params``
    (``meta`` parameters do), by the reference's name: the model's
    parameters seen as the reference's stacked leaves (``stack_named``'s
    names and shapes)."""
    from repro_torch.models.params import stack_named

    return {name: spec_for_path(name, tuple(t.shape), mesh)
            for name, t in stack_named(params.named_parameters()).items()}
