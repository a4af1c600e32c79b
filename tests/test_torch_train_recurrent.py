"""The port's train step on the recurrent reduced configs (jamba's Mamba
layers with MoE, xlstm's mLSTM and sLSTM) against the JAX reference: the
tolerances and the setup of ``tests/test_torch_train.py``."""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import pytest

from _torch_train_ref import _check


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m"])
def test_train_step_matches_reference(arch):
    _check(arch)
