"""The paper's own hyperparameter settings (SymED Sec. 4.1 / 4.3).

Port of ``repro.configs.symed_paper``.  Main-results configuration:
alpha=0.01, scl=1.0 (2D clustering), k_min=3, k_max=100, tol swept 0.1..2.0
in 0.1 steps.  The running example (Fig. 3) uses tol=0.4, alpha=0.02, scl=0
(1D).
"""
from repro_torch.core.symed import SymEDConfig

PAPER_SYMED = SymEDConfig(tol=0.5, alpha=0.01, scl=1.0, k_min=3, k_max=100)

PAPER_RUNNING_EXAMPLE = SymEDConfig(
    tol=0.4, alpha=0.02, scl=0.0, k_min=3, k_max=100, n_max=128, len_max=128
)

PAPER_TOL_SWEEP = tuple(round(0.1 * i, 1) for i in range(1, 21))
