"""The reference's side of the sharding and dry-run tests, resolved without
devices: specs through ``repro.sharding.partition`` on a duck-typed mesh (an
object with ``axis_names`` and a ``devices`` array, as
``tests/test_models.py`` builds one), the decode rules from
``repro.launch.specs``' own tables, and per-device shapes from
``jax.sharding.AbstractMesh``.  ``repro.launch.dryrun`` is never imported
here: it sets ``XLA_FLAGS`` at import.
"""
import jax
import numpy as np
from jax.sharding import AbstractMesh, NamedSharding

from repro.launch import specs as ref_specs
from repro.sharding.partition import _path_str, logical_to_spec, spec_for_path

MESHES = {
    "pod": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
}


class DuckMesh:
    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


def flat(tree):
    """``{_path_str: leaf}`` of a reference tree, in its leaf order."""
    return {_path_str(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def param_spec(name, shape, mesh):
    return spec_for_path(name, tuple(shape), mesh)


def batch_spec(shape, mesh):
    return logical_to_spec(("batch",) + (None,) * (len(shape) - 1),
                           tuple(shape), mesh)


def decode_spec(path, shape, mesh):
    """``repro.launch.specs.decode_state_specs``' rule for one leaf, from its
    own ``_DECODE_RULES`` tables."""
    name = next((p for p in reversed(path.split("/")) if not p.isdigit()),
                None)
    logical = ref_specs._DECODE_RULES_BY_RANK.get((name, len(shape)))
    if logical is None:
        logical = ref_specs._DECODE_RULES.get(name)
    if logical is None:
        return logical_to_spec((), (), mesh)  # P()
    pad = (None,) * (len(shape) - len(logical))
    return logical_to_spec(pad + tuple(logical), tuple(shape), mesh)


def dev_bytes(spec, leaf, kind):
    """Bytes per device of ``leaf`` laid out by ``spec`` on the production
    mesh ``kind``."""
    shape, names = MESHES[kind]
    local = NamedSharding(AbstractMesh(shape, names), spec).shard_shape(
        tuple(leaf.shape))
    return int(np.prod(local, dtype=np.int64)) * np.dtype(leaf.dtype).itemsize
