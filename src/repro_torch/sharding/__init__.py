"""Sharding: logical-axis rules -> partition specs with divisibility fallback.

Port of ``repro.sharding``: ``partition`` maps parameter names and logical
activation axes onto mesh axes (t5x/MaxText style); ``ctx`` provides the
ambient-mesh constraint helper used inside model code; ``layout`` holds a
tensor's pieces on a one-process mesh (the reference takes that from JAX).
"""
from repro_torch.sharding.ctx import constrain, current_mesh, use_mesh_rules
from repro_torch.sharding.partition import (
    logical_to_spec,
    param_specs,
    spec_for_path,
)

__all__ = [
    "constrain", "use_mesh_rules", "current_mesh",
    "logical_to_spec", "param_specs", "spec_for_path",
]
