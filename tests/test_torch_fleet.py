"""The port's fleet runtime against the JAX reference's.

``repro_torch.launch.fleet.run_fleet`` on host shards and
``repro.launch.fleet.run_fleet`` receive the same slab (numpy, from a
seed) and the same key.  On one shard the outputs match leaf by leaf:
integers exactly, floats bitwise, DTW within 1e-5.  The port's meshes of
4 and 8 shards and (2, 2) equal its one shard bitwise, and its 4-shard
telemetry equals the reference's on 4 forced host devices (a child
process) at shard widths 2 and 8, with crafted streams that show the
sender's EWMV rounding.  The argument checks carry the reference's
messages (the fleet CLI's tests are in ``test_torch_cli.py``).
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import hashlib
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.symed import SymEDConfig as JaxConfig
from repro.launch import fleet as jfleet
from repro_torch.core import prng
from repro_torch.core.symed import SymEDConfig
from repro_torch.data.synthetic import make_fleet
from repro_torch.launch import fleet as tfleet
from repro_torch.launch.mesh import make_pod_data_mesh, make_test_mesh
from test_torch_core import CRAFTED, _crafted

REPO = Path(__file__).resolve().parents[1]
PARAMS = dict(tol=0.5, alpha=0.01, n_max=64, k_max=8, len_max=64)
CFG, JCFG = SymEDConfig(**PARAMS), JaxConfig(**PARAMS)
SLAB = make_fleet(8, 192, seed=3)
MODES = {"whole": {}, "stream0": dict(chunk_len=32),
         "stream1": dict(chunk_len=64, digitize_every_k=1),
         "stream2": dict(chunk_len=48, digitize_every_k=2)}


def _one_shard():
    return tfleet.fleet_data_mesh(1, device="cpu")


def _port(slab, mesh=None, axis="data", **kw):
    return tfleet.run_fleet(slab, CFG, prng.key(5),
                            _one_shard() if mesh is None else mesh,
                            axis=axis, **kw)


def _assert_same(want, got, ctx, dtw_tol=None):
    """Every leaf of ``want`` (numpy-able) equal to ``got``'s: DTW scores
    within ``dtw_tol`` where it is given, all else bitwise."""
    assert set(want) == set(got), ctx
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, k)
        if dtw_tol is not None and k.startswith("re_"):
            np.testing.assert_allclose(b, a, rtol=dtw_tol, atol=dtw_tol,
                                       err_msg=f"{ctx}: {k}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{ctx}: {k}")


def _np(tree):
    return {k: v.numpy() for k, v in tree.items()}


@pytest.mark.parametrize("reconstruct", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_one_shard_matches_the_reference(mode, reconstruct):
    """Both ingestion modes, cadence 0, 1 and 2, with and without the
    DTW scores: outputs leaf by leaf, telemetry exactly."""
    kw = dict(MODES[mode], reconstruct=reconstruct)
    want, want_tele = jfleet.run_fleet(
        jnp.asarray(SLAB), JCFG, jax.random.key(5), jfleet.fleet_data_mesh(1),
        **kw)
    got, got_tele = _port(SLAB, **kw)
    _assert_same(want, _np(got), mode, dtw_tol=1e-5)
    _assert_same(want_tele, _np(got_tele), f"{mode} telemetry")


@pytest.mark.parametrize("mode", ["whole", "stream2"])
def test_layouts_match_one_shard(mode):
    """(4,) and (2, 2) meshes, and whole-stream also (8,) and a (2, 2)
    (data, model) mesh sharded over data only: bitwise equal to one
    shard."""
    kw = dict(MODES[mode], reconstruct=mode == "whole")
    base, base_tele = _port(SLAB, **kw)
    layouts = [(tfleet.fleet_data_mesh(4, device="cpu"), "data"),
               (make_pod_data_mesh(2, 2, device="cpu"), ("pod", "data"))]
    if mode == "whole":
        layouts += [(tfleet.fleet_data_mesh(8, device="cpu"), "data"),
                    (make_test_mesh((2, 2), ("data", "model"), device="cpu"),
                     "data")]
    for mesh, axis in layouts:
        got, tele = _port(SLAB, mesh, axis, **kw)
        ctx = f"{mesh.shape} over {axis}"
        _assert_same(_np(base), _np(got), ctx)
        _assert_same(_np(base_tele), _np(tele), ctx)


def test_one_stream_takes_the_batched_rounding():
    """A crafted stream whose last point sits between the two EWMV forms'
    thresholds, alone on one shard: the reference's sharded program takes
    the batched form even at width 1 (``symed_batch`` would take the
    single-stream form), and so does the port.

    Every leaf but ``centers`` is held bitwise: at width 1 the reference's
    batched programs round a raw center one ulp off its own
    ``symed_encode`` (Queue C 11; ``test_width_one_centers`` holds the
    port to ``symed_encode`` there)."""
    from repro_torch.core.compress import compress_stream

    seed, kind, last = CRAFTED[0]
    slab = _crafted(seed, kind, last)[None]
    forms = [int(compress_stream(torch.from_numpy(slab[0]), tol=CFG.tol,
                                 len_max=CFG.len_max, alpha=CFG.alpha,
                                 single=single)["n_pieces"])
             for single in (True, False)]
    assert forms[0] != forms[1]
    for kw in ({}, dict(chunk_len=43, digitize_every_k=2)):
        want, want_tele = jfleet.run_fleet(
            jnp.asarray(slab), JCFG, jax.random.key(5),
            jfleet.fleet_data_mesh(1), **kw)
        got, got_tele = _port(slab, **kw)
        del want["centers"], got["centers"]
        _assert_same(want, _np(got), f"width 1 {kw}")
        _assert_same(want_tele, _np(got_tele), f"width 1 {kw} telemetry")
        assert int(got["n_pieces"][0]) == forms[1]


def test_width_one_centers():
    """Queue C 11: one stream on one shard.  The port's outputs equal the
    reference's ``symed_encode`` of that stream leaf by leaf, centers
    included (but ``cr``/``drr``, which the sharded program rounds as a
    reciprocal multiply); the reference's sharded program at width 1 (as
    its ``symed_batch`` of one stream) rounds a raw center one ulp off it,
    and agrees with the port on every other leaf."""
    from repro.core.symed import symed_encode as jax_encode

    slab = SLAB[:1]
    got, _ = _port(slab)
    enc = jax_encode(jnp.asarray(slab[0]), JCFG,
                     jax.random.split(jax.random.key(5), 1)[0], False)
    rates = ("cr", "drr")
    _assert_same({k: np.asarray(v)[None] for k, v in enc.items()
                  if k not in rates},
                 {k: v for k, v in _np(got).items() if k not in rates},
                 "symed_encode")
    want, _ = jfleet.run_fleet(jnp.asarray(slab), JCFG, jax.random.key(5),
                               jfleet.fleet_data_mesh(1))
    del want["centers"], got["centers"]
    _assert_same(want, _np(got), "width 1 fleet")


# -------------------------------------------- the reference on 4 devices

_CHILD = """
import hashlib, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core.symed import SymEDConfig
from repro.launch.fleet import fleet_data_mesh, run_fleet
from repro.launch.mesh import make_pod_data_mesh

assert jax.device_count() == 4, jax.device_count()
cfg = SymEDConfig(**json.loads(sys.argv[1]))
res = {}
for width in (2, 8):
    slab = jnp.asarray(np.load(sys.argv[2] + f"_{width}.npy"))
    for mode, kw, mesh, axis in (
            ("whole", {}, fleet_data_mesh(4), "data"),
            ("stream", dict(chunk_len=43, digitize_every_k=2),
             make_pod_data_mesh(2, 2), ("pod", "data"))):
        out, tele = run_fleet(slab, cfg, jax.random.key(5), mesh, axis=axis,
                              **kw)
        n = np.asarray(out["n_pieces"])
        sym = np.asarray(out["symbols"]) * (
            np.arange(cfg.n_max)[None, :] < n[:, None])
        res[f"{width}/{mode}"] = {
            "tele": {k: float(v) for k, v in tele.items()},
            "n_pieces": n.tolist(),
            "symbols": hashlib.sha256(sym.astype(np.int32).tobytes())
            .hexdigest()}
print("FLEET4 " + json.dumps(res))
"""


def _crafted_slab(width):
    """4 shards of ``width`` streams, each shard led by a crafted stream."""
    slab = make_fleet(4 * width, 301, seed=width)
    for s in range(4):
        seed, kind, last = CRAFTED[s % len(CRAFTED)]
        slab[s * width] = _crafted(seed, kind, last)
    return slab


def test_four_shards_match_the_reference_on_four_devices(tmp_path):
    """The reference on 4 forced host devices (a child process, its own
    ``XLA_FLAGS``) at shard widths 2 and 8, whole-stream over (4,) and
    streaming over (2, 2): telemetry, ``n_pieces`` and the symbols' hash
    equal the port's 4-shard runs."""
    prefix = str(tmp_path / "slab")
    for width in (2, 8):
        np.save(f"{prefix}_{width}.npy", _crafted_slab(width))
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps(PARAMS), prefix],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=600)
    line = [l for l in proc.stdout.splitlines() if l.startswith("FLEET4 ")]
    assert proc.returncode == 0 and line, proc.stdout[-500:] + proc.stderr[
        -2000:]
    ref = json.loads(line[0][len("FLEET4 "):])
    for width in (2, 8):
        slab = _crafted_slab(width)
        for mode, kw, mesh, axis in (
                ("whole", {}, tfleet.fleet_data_mesh(4, device="cpu"),
                 "data"),
                ("stream", dict(chunk_len=43, digitize_every_k=2),
                 make_pod_data_mesh(2, 2, device="cpu"), ("pod", "data"))):
            out, tele = _port(slab, mesh, axis, **kw)
            n = out["n_pieces"].numpy()
            sym = out["symbols"].numpy() * (
                np.arange(CFG.n_max)[None, :] < n[:, None])
            want = ref[f"{width}/{mode}"]
            ctx = f"width {width} {mode}"
            assert {k: float(v) for k, v in tele.items()} == want["tele"], ctx
            assert n.tolist() == want["n_pieces"], ctx
            assert hashlib.sha256(sym.astype(np.int32).tobytes()).hexdigest() \
                == want["symbols"], ctx


# ------------------------------------------------------ argument checks


def _messages(*args, **kw):
    """The reference's and the port's ``run_fleet`` errors on one input."""
    out = []
    for run, key, zeros in ((jfleet.run_fleet, jax.random.key(0), jnp.zeros),
                            (tfleet.run_fleet, prng.key(0), np.zeros)):
        with pytest.raises(ValueError) as info:
            run(zeros(args[0], np.float32), CFG if run is tfleet.run_fleet
                else JCFG, key, *args[1:], **kw)
        out.append(str(info.value))
    return out


@pytest.mark.parametrize("shape,axis,kw,match", [
    ((4, 64), ("pod", "data"), dict(chunk_len=0), "chunk_len must be >= 1"),
    ((4, 64), "model", {}, "unknown mesh axis 'model'"),
    ((4, 64), ("pod", "replica"), {}, "unknown mesh axis"),
    ((4, 64), (), {}, "at least one mesh axis"),
    ((6, 64), ("pod", "data"), {}, "divide over 4 podxdata"),
    ((4, 64), ("pod", "data"), dict(chunk_len=32, digitize_every_k=-1),
     "digitize_every_k must be >= 0"),
    ((4, 64), ("pod", "data"), dict(digitize_every_k=2), "requires chunk_len"),
    ((3, 64), "data", {}, "divide"),
])
def test_run_fleet_errors_match_the_reference(shape, axis, kw, match):
    """Fake meshes, as the reference's tests build them: every check fails
    before any device is touched, with the reference's message."""
    devices = np.empty((2,) if axis == "data" and shape[0] == 3 else (2, 2),
                       dtype=object)
    names = ("data",) if devices.ndim == 1 else ("pod", "data")
    fake = types.SimpleNamespace(axis_names=names, devices=devices)
    want, got = _messages(shape, fake, axis=axis, **kw)
    assert got == want and match in got


def test_fleet_report_matches_the_reference():
    """Empty fleets, zero wall time, zero pieces and a normal run: the same
    dict as the reference's, every value finite."""
    zero = {k: 0.0 for k in
            ("streams", "points", "pieces", "wire_bytes", "raw_bytes")}
    cases = [(zero, 0.0),
             ({**zero, "streams": 2.0, "points": 128.0, "raw_bytes": 512.0,
               "wire_bytes": 4.0}, 1.0),
             ({"streams": 1.0, "points": 100.0, "pieces": 50.0,
               "wire_bytes": 204.0, "raw_bytes": 400.0,
               "wire_out_bytes": 77.0}, 2.1)]
    for tele, wall in cases:
        want = jfleet.fleet_report(tele, wall)
        got = tfleet.fleet_report(tele, wall)
        assert got == want
        assert all(np.isfinite(v) for v in got.values())


def test_obs_records_the_dispatch_and_the_totals():
    from repro_torch.obs import Observability

    obs = Observability()
    _, tele = _port(SLAB[:4], obs=obs)
    rep = tfleet.fleet_report(tele, 1.0, obs=obs)
    names = [ev[0] for ev in obs.tracer.events()]
    assert names == ["fleet.dispatch"]
    snap = rep["obs"]
    assert snap["histograms"]["fleet_dispatch_seconds"]["count"] == 1
    assert snap["gauges"]["fleet_pieces"] == rep["pieces"] > 0


# ------------------------------------------------------------------ card


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["whole", "stream2"])
def test_run_fleet_on_the_card_against_the_cpu_port(mode):
    """Two shards on the card (the Lloyd kernel, and the DTW kernel for
    the scores) against the CPU port's one shard: telemetry and pieces
    bitwise, at least 99% of symbols equal (Queue C 2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels.dtw import dtw_cuda
    from repro_torch.kernels.kmeans import kmeans_lloyd_cuda

    name = torch.cuda.get_device_name()
    kw = dict(MODES[mode], reconstruct=True)
    lloyd, dtw = kmeans_lloyd_cuda.launches, dtw_cuda.launches
    got, got_tele = _port(SLAB, tfleet.fleet_data_mesh(2, device="cuda"),
                          **kw)
    assert kmeans_lloyd_cuda.launches > lloyd, name
    assert dtw_cuda.launches == dtw + 4, name  # 2 shards x (pieces, symbols)
    want, want_tele = _port(SLAB, **kw)
    got, got_tele = _np({k: v.cpu() for k, v in got.items()}), _np(
        {k: v.cpu() for k, v in got_tele.items()})
    _assert_same(_np(want_tele), got_tele, name)
    for k in ("n_pieces", "pieces_len", "pieces_inc"):
        np.testing.assert_array_equal(want[k].numpy(), got[k], err_msg=k)
    valid = np.arange(CFG.n_max)[None, :] < got["n_pieces"][:, None]
    agree = ((want["symbols"].numpy() == got["symbols"]) & valid).sum()
    assert agree >= 0.99 * valid.sum(), (name, agree, valid.sum())
    np.testing.assert_allclose(got["re_pieces"], want["re_pieces"].numpy(),
                               rtol=1e-4)
