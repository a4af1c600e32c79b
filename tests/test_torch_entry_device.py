"""The one-shot entry points of ``repro_torch.core.symed`` run on the card
unless the caller asks for the CPU: ``symed_encode``, ``symed_finish`` and
``symed_batch`` raise without a card by default, and run where ``device``
says, whatever device their inputs came on.  Needs no JAX."""
import numpy as np
import pytest
import torch

from repro_torch.core.symed import (SymEDConfig, symed_batch, symed_encode,
                                    symed_encode_chunk, symed_finish)
from repro_torch.data.synthetic import make_fleet

CFG = SymEDConfig(tol=0.5, alpha=0.02, scl=1.0, k_min=3, k_max=8, len_max=32,
                  n_max=64, lloyd_iters=5)
KEY = np.array([0, 7], np.uint32)


def _encode(device=None):
    ts = make_fleet(1, 160, seed=3)[0]
    return symed_encode(ts, CFG, KEY, device=device)


def _finish(device=None):
    ts = torch.from_numpy(make_fleet(1, 160, seed=3)[0])
    state, events = symed_encode_chunk(ts, CFG)  # on the CPU, as its input
    return symed_finish(events, state, CFG, KEY, ts, device=device)


def _batch(device=None):
    return symed_batch(make_fleet(4, 160, seed=3), CFG, KEY, device=device)


ENTRY_POINTS = {"symed_encode": _encode, "symed_finish": _finish,
                "symed_batch": _batch}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_cuda(name):
    """Without a card the default raises; on one every output is there."""
    run = ENTRY_POINTS[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
        return
    out = run()
    assert all(v.device.type == "cuda" for v in out.values()), name


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cpu_when_asked(name):
    """``device="cpu"`` runs on the CPU, and ``symed_finish`` gives what the
    one-shot encode gives."""
    out = ENTRY_POINTS[name](device="cpu")
    assert all(v.device.type == "cpu" for v in out.values()), name
    assert int(out["n_pieces"].reshape(-1)[0]) > 0
    if name == "symed_finish":
        whole = _encode(device="cpu")
        assert set(out) == set(whole)
        for k in out:
            assert torch.equal(out[k], whole[k]), k
