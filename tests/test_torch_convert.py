"""``repro_torch.convert``: the state carried across from the JAX package
lands on the card unless the caller asks for the CPU.  Needs no JAX; the
JAX-side round trip is in ``tests/test_torch_stream.py``."""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import numpy as np
import pytest
import torch

from repro_torch.convert import (receiver_state_from_numpy,
                                 receiver_state_to_numpy)
from repro_torch.core.symed import SymEDConfig, receiver_init

CFG = SymEDConfig(tol=0.5, alpha=0.02, scl=1.0, k_min=3, k_max=8, len_max=32,
                  n_max=64, lloyd_iters=5)


def _leaves(tree):
    for leaf in tree:
        if hasattr(leaf, "_fields"):
            yield from _leaves(leaf)
        else:
            yield leaf


def _tree():
    return receiver_state_to_numpy(receiver_init(CFG, torch.tensor([0, 5])))


def test_default_device_is_cuda():
    """Without a card the default raises; on one the state lands there."""
    tree = _tree()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            receiver_state_from_numpy(tree)
        return
    state = receiver_state_from_numpy(tree)
    assert all(leaf.device.type == "cuda" for leaf in _leaves(state))


def test_cpu_round_trip_keeps_every_leaf():
    tree = _tree()
    state = receiver_state_from_numpy(tree, device="cpu")
    assert all(leaf.device.type == "cpu" for leaf in _leaves(state))
    back = receiver_state_to_numpy(state)
    for a, b in zip(_leaves(tree), _leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
