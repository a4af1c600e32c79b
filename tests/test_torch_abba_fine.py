"""The port's ABBA baseline at the fine end of the Fig. 5 tolerance sweep.

``tests/test_torch_abba.py``'s bitwise check on the five families of
``data.synthetic.make_dataset`` at the Fig. 5 settings, at tol 0.1: the
piece buffer fills (``n_pieces = n_max``) on the sensor and hemo families
and the k-search grows to ``k_max`` there, the longest searches of the
sweep.  Every field of ``AbbaResult`` exactly equal to the reference's.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import pytest

from repro.data.synthetic import FAMILIES, make_dataset
from test_torch_abba import FIG5, _assert_equal, _both


@pytest.mark.parametrize("family", FAMILIES)
def test_fig5_families_bitwise_tol_0_1(family):
    for row in make_dataset(family, 4, 1000, seed=11):
        _assert_equal(*_both(row, dict(FIG5, tol=0.1)))
