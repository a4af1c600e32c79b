"""The port's symlint rule modules -- importing this package populates the
registry.

The deep-tier modules (sync_budget, dtype_discipline) register here too but
import torch only inside ``deep.prepare`` -- importing this package never
pulls in torch, so the AST tier stays interpreter-only.
"""
from repro_torch.analysis.rules import (  # noqa: F401
    dtype_discipline, hostsync, sync_budget, wire,
)
