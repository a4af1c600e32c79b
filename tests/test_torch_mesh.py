"""The port's mesh builders against the JAX reference's.

``repro_torch.launch.mesh`` lays shards out as ``repro.launch.mesh`` lays
devices out (row-major over the named axes) and raises the reference's
messages.  On the CPU every shard is a host shard; on CUDA the shards go
round-robin over the cards (checked here with a stubbed card count).
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import types

import numpy as np
import pytest
import torch

from repro.launch import mesh as jmesh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.fleet import fleet_data_mesh, resolve_fleet_mesh


def _message(fn, *args, **kw):
    with pytest.raises((ValueError, RuntimeError)) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


@pytest.mark.parametrize("shape,axes", [((4,), ("data",)),
                                        ((2, 2), ("data", "model")),
                                        ((2, 3), ("pod", "data")),
                                        ((2, 2, 2), ("pod", "data", "model"))])
def test_test_mesh_layout(shape, axes):
    mesh = tmesh.make_test_mesh(shape, axes, device="cpu")
    assert mesh.axis_names == axes
    assert mesh.devices.shape == shape and mesh.devices.size == np.prod(shape)
    assert mesh.shape == dict(zip(axes, shape))
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)


def _one_jax_device(monkeypatch):
    """The reference as it runs on one host device, whatever the count
    this worker's jax was started with."""
    import jax

    first = jax.devices()[:1]
    monkeypatch.setattr(jmesh.jax, "device_count", lambda: 1)
    monkeypatch.setattr(jmesh.jax, "devices", lambda: first)


@pytest.mark.parametrize("args", [(0,), (-1, 2), (2,), (3,), (2, 0)])
def test_pod_data_mesh_messages_match_the_reference(args, monkeypatch):
    """One host device each: the reference's and the port's errors."""
    _one_jax_device(monkeypatch)
    assert _message(tmesh.make_pod_data_mesh, *args, device="cpu") == \
        _message(jmesh.make_pod_data_mesh, *args)


def test_pod_data_mesh_shape(monkeypatch):
    _one_jax_device(monkeypatch)
    mesh = tmesh.make_pod_data_mesh(2, 3, device="cpu")
    assert mesh.axis_names == ("pod", "data")
    assert mesh.devices.shape == (2, 3)
    ref = jmesh.make_pod_data_mesh(1)  # n_pods=1: the flat data mesh
    port = tmesh.make_pod_data_mesh(1, device="cpu")
    assert port.axis_names == tuple(ref.axis_names)
    assert port.devices.shape == ref.devices.shape == (1, 1)


def test_production_mesh_on_host_shards(monkeypatch):
    """The dry run's meshes: host shards on the CPU (the reference needs
    forced host devices for the same shapes)."""
    _one_jax_device(monkeypatch)
    for multi_pod, shape in ((False, (16, 16)), (True, (2, 16, 16))):
        mesh = tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert mesh.devices.shape == shape
        assert mesh.axis_names == (("pod", "data", "model") if multi_pod
                                   else ("data", "model"))
    kind, text = _message(jmesh.make_production_mesh)
    assert kind is RuntimeError and "needs 256 devices, have 1" in text


def _stub_cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def test_cuda_shards_go_round_robin(monkeypatch):
    _stub_cards(monkeypatch, 2)
    mesh = tmesh.make_pod_data_mesh(2, 2, device="cuda")
    assert [str(d) for d in mesh.devices.flat] == [
        "cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    assert tmesh.device_count("cuda") == 2
    assert fleet_data_mesh(device="cuda").devices.shape == (2,)
    _stub_cards(monkeypatch, 1)
    mesh = fleet_data_mesh(4, device="cuda")  # four shards on one card
    assert {str(d) for d in mesh.devices.flat} == {"cuda:0"}
    kind, text = _message(tmesh.make_production_mesh, device="cuda")
    assert kind is RuntimeError and "needs 256 devices, have 1" in text
    assert _message(tmesh.make_pod_data_mesh, 2, device="cuda") == (
        ValueError, "1 devices do not divide over 2 pods; pass n_data "
                    "explicitly")


def test_cuda_mesh_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fleet_data_mesh(2)


def test_mesh_devices_shard_order():
    """Shard i is ``mesh.devices.flat[i]`` over the sharded axes; axes
    outside them hold replicas (their first index serves), and a sequence
    of axes is taken in the order given."""
    grid = np.arange(12).reshape(2, 3, 2).astype(object)
    mesh = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                 devices=grid)
    assert tmesh.mesh_devices(mesh, ("pod", "data", "model")) == list(
        range(12))
    assert tmesh.mesh_devices(mesh, ("pod", "data")) == [0, 2, 4, 6, 8, 10]
    assert tmesh.mesh_devices(mesh, ("data",)) == [0, 2, 4]
    assert tmesh.mesh_devices(mesh, ("data", "pod")) == [0, 6, 2, 8, 4, 10]


def test_resolve_fleet_mesh_matches_the_reference():
    """The layout strings and axes of the reference's CLI helper."""
    mesh, axes, layout = resolve_fleet_mesh(1, 4, device="cpu")
    assert (axes, layout, mesh.devices.shape) == ("data", "data = 4", (4,))
    mesh, axes, layout = resolve_fleet_mesh(2, 4, device="cpu")
    assert axes == ("pod", "data") and layout == "pod x data = 2 x 2"
    assert mesh.devices.shape == (2, 2)
    from repro.launch.fleet import resolve_fleet_mesh as jresolve

    assert _message(resolve_fleet_mesh, 3, 4, device="cpu") == \
        _message(jresolve, 3, 4)


def test_describe_devices():
    mesh = fleet_data_mesh(4, device="cpu")
    assert tmesh.describe_devices(mesh.devices.flat) == "1 distinct: cpu (host)"
