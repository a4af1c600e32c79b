"""The entry points of ``repro_torch`` run on the card unless the caller
asks for the CPU: ``symed_encode``, ``symed_finish``, ``symed_batch``,
``symed_encode_chunk``, ``symed_receive_chunk`` and the transport's
``SenderClient`` raise without a card by default, and run where ``device``
says, whatever device their inputs came on.  Needs no JAX."""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.symed import (SymEDConfig, symed_batch, symed_encode,
                                    symed_encode_chunk, symed_finish,
                                    symed_receive_chunk)
from repro_torch.data.synthetic import make_fleet

CFG = SymEDConfig(tol=0.5, alpha=0.02, scl=1.0, k_min=3, k_max=8, len_max=32,
                  n_max=64, lloyd_iters=5)
KEY = np.array([0, 7], np.uint32)


def _encode(device=None):
    ts = make_fleet(1, 160, seed=3)[0]
    return symed_encode(ts, CFG, KEY, device=device)


def _finish(device=None):
    ts = torch.from_numpy(make_fleet(1, 160, seed=3)[0])
    state, events = symed_encode_chunk(ts, CFG, device="cpu")  # CPU events
    return symed_finish(events, state, CFG, KEY, ts, device=device)


def _batch(device=None):
    return symed_batch(make_fleet(4, 160, seed=3), CFG, KEY, device=device)


def _encode_chunk(device=None):
    """Two windows of a numpy stream; the outputs and the carry."""
    ts = make_fleet(1, 160, seed=3)[0]
    state, first = symed_encode_chunk(ts[:80], CFG, device=device)
    state, rest = symed_encode_chunk(ts[80:], CFG, state, device=device)
    emit = torch.cat([first["emit"], rest["emit"]])
    return {**{k: torch.cat([first[k], rest[k]]) for k in first},
            "state.last": state.last, "state.norm.var": state.norm.var,
            "n_pieces": emit.sum()}


def _receive_chunk(device=None):
    """Two windows through the online receiver; its info and state leaves."""
    ts = make_fleet(1, 160, seed=3)[0]
    state, _ = symed_receive_chunk(ts[:80], CFG, None, KEY, device=device)
    state, info = symed_receive_chunk(ts[80:], CFG, state, device=device)
    return {**{k: v for k, v in info.items() if k != "symbol_delta"},
            "endpoints": state.endpoints, "t_seen": state.t_seen,
            "dig.centers": state.dig.centers}


ENTRY_POINTS = {"symed_encode": _encode, "symed_finish": _finish,
                "symed_batch": _batch, "symed_encode_chunk": _encode_chunk,
                "symed_receive_chunk": _receive_chunk}


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


def _sender_client(device=None):
    """A pieces-mode ``SenderClient`` against a CPU server on loopback;
    returns the client after one session's round trip."""
    from repro_torch.launch.stream import StreamServer
    from repro_torch.launch.transport import SenderClient, TransportServer

    server = TransportServer(StreamServer(CFG, max_sessions=2, window_cap=32,
                                          device="cpu"), port=0)
    thread = threading.Thread(target=server.serve,
                              kwargs={"expect_sessions": 1}, daemon=True)
    thread.start()
    client = SenderClient("127.0.0.1", server.port, CFG, device=device)
    ts = make_fleet(1, 96, seed=3)[0]
    client.open("a", 1)
    for c in range(0, 96, 32):
        client.send("a", ts[c: c + 32])
    result = client.close("a")
    client.shutdown()
    thread.join(timeout=60)
    assert not thread.is_alive()
    return client, result


def test_sender_client_default_device_is_cuda():
    """Without a card the default raises before any socket is opened; on
    one the sender's compressor state lives there."""
    from repro_torch.launch.transport import SenderClient

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SenderClient("127.0.0.1", 9, CFG)
        return
    client, result = _sender_client()
    assert client.device.type == "cuda"
    assert client._sessions["a"].state.npts.device.type == "cuda"
    assert result["n_pieces"] > 0


def test_sender_client_cpu_when_asked():
    client, result = _sender_client(device="cpu")
    assert client.device.type == "cpu"
    assert client._sessions["a"].state.npts.device.type == "cpu"
    assert result["n_pieces"] > 0 and result["t_seen"] == 96
