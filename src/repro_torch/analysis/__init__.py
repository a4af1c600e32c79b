"""symlint for the port: static analysis of ``repro_torch``.

``python -m repro_torch.analysis`` (or the ``symlint-torch`` entry point)
sweeps ``src/repro_torch``, ``examples/torch_*.py`` and ``chip_smoke.py``
and enforces the contracts that the reference's symlint
(``repro.analysis``) enforces on the JAX package, where the port has them:

  ======  ==================  ==============================================
  SL004   host-sync           no hidden device syncs in marked hot paths
  SL005   wire-consistency    encoder/decoder struct layouts agree by bytes
  SL006   sync-budget         (--deep) an entry's syncs within its budget
  SL007   dtype-discipline    (--deep) no f64 leaks; slot/table dtypes agree
  ======  ==================  ==============================================

The reference's rules with no counterpart here:

  ======  ==================  ==============================================
  SL001   compat-policy       the port has no compat shim
  SL002   retrace-hazard      the port traces and compiles nothing at run
                              time: its counterpart of a steady-state
                              retrace, the hidden host stall, is a host
                              sync, which SL006 budgets
  SL003   donation-aliasing   PyTorch has no donation
  SL008   donation-effect     PyTorch has no donation
  ======  ==================  ==============================================

The AST tier (SL004, SL005) imports neither ``torch`` nor ``jax`` and
nothing of ``repro``; ``--deep`` imports ``torch`` and runs on the card
unless ``--device cpu`` is given, holding each entry to the budget of the
device it ran on.  Annotations ride on comments with the
port's own prefix (``# symlint-torch: hot-path``, ``# symlint-torch:
entry(...)``, ``# symlint-torch: disable=SL004``, ``# symlint-torch:
f64-ok``); ``# sync: ok`` is shared with the reference.  Grandfathered
findings live in ``.symlint-torch-baseline.json`` with written
justifications.
"""
from repro_torch.analysis.engine import (  # noqa: F401
    AnalysisResult, Baseline, Finding, Project, RULES, analyze, load_project,
)
from repro_torch.analysis.cli import main  # noqa: F401

__all__ = [
    "AnalysisResult", "Baseline", "Finding", "Project", "RULES",
    "analyze", "load_project", "main",
]
