"""The port's training telemetry against the JAX reference's.

``NumpySender`` and ``StepWatchdog`` are the same plain Python in both
packages: on the same inputs the sender's wire (every transmission's step
and endpoint) and the watchdog's events are equal, and so is the hub's
traffic report.  ``TelemetryHub.digitize`` runs the port's digitizer with
the reference's key: bitwise on every state leaf and symbol (the parity
contract of ``tests/test_torch_digitize.py``).
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import jax
import numpy as np
import pytest
import torch

from repro.train import telemetry as jtel
from repro_torch.core import prng
from repro_torch.train import telemetry as ttel


def _streams():
    rng = np.random.default_rng(0)
    walk = np.cumsum(rng.normal(0, 0.3, 400)).astype(np.float32)
    loss = 3 * np.exp(-np.arange(300) / 80) + rng.normal(0, 0.02, 300)
    flat = np.ones(50)
    return {"walk": walk, "loss": loss, "flat": flat,
            "sine": np.sin(np.linspace(0, 10, 500))}


@pytest.mark.parametrize("name", ["walk", "loss", "flat", "sine"])
@pytest.mark.parametrize("tol,alpha,len_max", [(0.4, 0.02, 64),
                                               (0.5, 0.05, 256)])
def test_sender_wire(name, tol, alpha, len_max):
    ts = _streams()[name]
    a = jtel.NumpySender(tol=tol, alpha=alpha, len_max=len_max)
    b = ttel.NumpySender(tol=tol, alpha=alpha, len_max=len_max)
    for t in ts:
        assert a.push(t) == b.push(t)
    assert a.wire == b.wire
    assert (a.raw_bytes, a.wire_bytes, a.compression_rate()) == (
        b.raw_bytes, b.wire_bytes, b.compression_rate())


def _dts(seed):
    rng = np.random.default_rng(seed)
    dts = 1.0 + rng.normal(0, 0.02, 120)
    dts[50], dts[80], dts[81] = 2.5, 30.0, 0.5
    return dts


@pytest.mark.parametrize("kw", [dict(alpha=0.1, z_threshold=4.0, warmup=3),
                                dict(), dict(hang_factor=2.0, warmup=0)])
def test_watchdog_events(kw):
    a, b = jtel.StepWatchdog(**kw), ttel.StepWatchdog(**kw)
    for i, dt in enumerate(_dts(2)):
        assert a.observe(i, dt) == b.observe(i, dt)
    assert a.events == b.events and a.events
    assert (a.mean, a.var, a.count, a.deadline()) == (
        b.mean, b.var, b.count, b.deadline())


def test_watchdog_clock():
    dog = ttel.StepWatchdog()
    dog.start_step()
    assert dog.end_step(0) is None and dog.count == 1
    mean = dog.mean
    assert dog.end_step(1) is None  # no start: dt 0
    assert dog.mean == pytest.approx((1 - dog.alpha) * mean)


def _hubs():
    a = jtel.TelemetryHub(tol=0.4, alpha=0.05)
    b = ttel.TelemetryHub(tol=0.4, alpha=0.05)
    rng = np.random.default_rng(1)
    for i in range(300):
        m = {"loss": 3 * np.exp(-i / 80) + rng.normal(0, 0.02),
             "grad_norm": 1 + 0.1 * np.sin(i / 7) + rng.normal(0, 0.01)}
        a.record_metrics("h0", m)
        b.record_metrics("h0", m)
    return a, b


def test_traffic_report():
    a, b = _hubs()
    assert a.traffic_report() == b.traffic_report()


@pytest.mark.parametrize("name,k_max", [("h0/loss", 8), ("h0/grad_norm", 16)])
def test_digitize_bitwise(name, k_max):
    a, b = _hubs()
    want = a.digitize(name, k_max=k_max)
    got = b.digitize(name, k_max=k_max, device="cpu")
    for f in ("labels", "centers", "k", "symbols"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]),
                                      err_msg=f)
    for field in want["state"]._fields:
        w, g = getattr(want["state"], field), getattr(got["state"], field)
        if field == "key":
            w, g = jax.random.key_data(w), prng.key_data(g)
        else:
            g = g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=field)


def test_digitize_short_stream_and_default_device():
    hub = ttel.TelemetryHub()
    hub.record("x", 1.0)
    assert hub.digitize("x") is None
    for i in range(40):
        hub.record("y", float(np.sin(i)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            hub.digitize("y")
