"""The port's resident service against the JAX reference, frame by frame.

``repro_torch.launch.stream.StreamServer`` (device cpu) and
``repro.launch.stream.StreamServer`` (``use_kernel=False``, the bitwise
reference path) receive the same arrivals.  Every delta frame must match:
labels, endpoints and ``n_new`` exactly, endpoints bitwise.  Each closing
``out`` must match leaf by leaf.  The port's own contract is checked too:
concatenated deltas are bitwise equal to its one-shot ``symed_encode``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_stream

from repro.core.symed import SymEDConfig as JaxConfig
from repro.core.symed import receiver_init as jax_receiver_init
from repro.core.symed import symed_receive_masked_chunk_table as jax_table_step
from repro.launch.stream import StreamServer as JaxServer
from repro_torch.convert import (
    receiver_state_from_numpy, receiver_state_to_numpy,
)
from repro_torch.core.compress import compress_stream
from repro_torch.core.symed import SymEDConfig, symed_encode
from repro_torch.core.symed import symed_receive_masked_chunk_table
from repro_torch.launch.stream import StreamServer

REPO = Path(__file__).resolve().parents[1]
PARAMS = dict(tol=0.5, alpha=0.02, scl=1.0, k_min=3, k_max=8, len_max=32,
              n_max=64, lloyd_iters=5)
CFG = SymEDConfig(**PARAMS)
JCFG = JaxConfig(**PARAMS)
WINDOW_CAP = 32


def _pair(**kw):
    return (JaxServer(JCFG, window_cap=WINDOW_CAP, use_kernel=False,
                      obs=False, **kw),
            StreamServer(CFG, window_cap=WINDOW_CAP, device="cpu", **kw))


def _assert_delta_equal(a, b, ctx):
    np.testing.assert_array_equal(a["labels"], b["labels"],
                                  err_msg=f"{ctx}: labels")
    np.testing.assert_array_equal(a["endpoints"], b["endpoints"],
                                  err_msg=f"{ctx}: endpoints")
    assert a["n_new"] == b["n_new"], ctx
    assert a["frames"] == b["frames"], ctx
    assert a["bytes"] == b["bytes"], ctx


def _assert_close_equal(a, b, ctx):
    _assert_delta_equal(a["delta"], b["delta"], f"{ctx} closing delta")
    assert (a["out"] is None) == (b["out"] is None), ctx
    if a["out"] is not None:
        assert set(a["out"]) == set(b["out"]), ctx
        flat = lambda o: {**{k: v for k, v in o.items() if k != "symbol_delta"},
                          **{f"delta.{k}": v
                             for k, v in o["symbol_delta"].items()}}
        want, got = flat(a["out"]), flat(b["out"])
        for name in want:
            np.testing.assert_array_equal(
                np.asarray(want[name]), got[name],
                err_msg=f"{ctx}: out[{name}]")
    assert a["symbols"] == b["symbols"], ctx
    assert a["n_pieces"] == b["n_pieces"] and a["t_seen"] == b["t_seen"]


def _drive(servers, streams, rng, *, opens, close_order):
    """Feed both servers the same interleaved ragged arrivals.

    ``opens[i]`` is the round at which session i opens; every frame of both
    servers is compared as it comes back.
    """
    ref, port = servers
    cursors = [0] * len(streams)

    def pending(i):
        return cursors[i] < len(streams[i]) and f"s{i}" not in port.evicted

    rnd = 0
    while any(pending(i) for i in range(len(streams))):
        assert rnd < 200, "arrivals did not drain"
        for i, r in enumerate(opens):
            if r == rnd:
                ref.open(f"s{i}")
                port.open(f"s{i}")
        batch = {}
        for i, ts in enumerate(streams):
            sid = f"s{i}"
            if sid not in port or cursors[i] >= len(ts) or rng.random() > 0.75:
                continue
            n = int(rng.integers(1, 45))
            batch[sid] = ts[cursors[i]: cursors[i] + n]
            cursors[i] += n
        if batch:
            got_ref, got_port = ref.ingest_many(batch), port.ingest_many(batch)
            for sid in batch:
                _assert_delta_equal(got_ref[sid], got_port[sid],
                                    f"round {rnd} {sid}")
        rnd += 1
    for sid in [s for s in close_order if s in port]:
        _assert_close_equal(ref.close(sid), port.close(sid), f"close {sid}")
    assert set(ref.evicted) == set(port.evicted)
    for sid in ref.evicted:
        _assert_close_equal(ref.evicted[sid], port.evicted[sid],
                            f"evicted {sid}")
    for key in ("opened", "closed", "evicted", "grows", "shrinks",
                "symbols_out", "frames_out", "points_in", "steps"):
        assert ref.totals[key] == port.totals[key], key
    assert ref.totals["bytes_out"] == port.totals["bytes_out"]


class TestServerParity:
    @pytest.mark.parametrize("seed,cadence", [(0, 1), (1, 2)])
    def test_interleaved_sessions_frame_by_frame(self, seed, cadence):
        rng = np.random.default_rng(500 + seed)
        streams = [make_stream(rng, 128, kind) for kind in
                   ("mixed", "sine", "walk")]
        servers = _pair(max_sessions=4, digitize_every_k=cadence, seed=seed)
        _drive(servers, streams, rng, opens=[0, 0, 1],
               close_order=["s2", "s0", "s1"])

    def test_full_buffers_frame_by_frame(self):
        """Sessions that outrun their piece buffer (n_max 16, a piece at
        least every 4 points): the wire drops pieces past the capacity and
        full slots keep riding the digitize loop as dead lanes."""
        params = dict(PARAMS, n_max=16, len_max=4)
        ref = JaxServer(JaxConfig(**params), window_cap=WINDOW_CAP,
                        use_kernel=False, obs=False, max_sessions=4)
        port = StreamServer(SymEDConfig(**params), window_cap=WINDOW_CAP,
                            device="cpu", max_sessions=4)
        rng = np.random.default_rng(13)
        streams = [make_stream(rng, n, "walk") for n in (120, 40, 96)]
        _drive((ref, port), streams, rng, opens=[0, 0, 1],
               close_order=["s0", "s1", "s2"])
        assert port.totals["symbols_out"] == 16 + 16 + 16

    def test_eviction_frame_by_frame(self):
        rng = np.random.default_rng(7)
        streams = [make_stream(rng, 96, "mixed") for _ in range(4)]
        servers = _pair(max_sessions=2, evict_idle=True, seed=3)
        _drive(servers, streams, rng, opens=[0, 0, 2, 4],
               close_order=["s3", "s2", "s1", "s0"])
        assert servers[1].totals["evicted"] == 2

    def test_autoscale_grow_and_shrink_frame_by_frame(self):
        rng = np.random.default_rng(11)
        streams = [make_stream(rng, 64, "walk") for _ in range(4)]
        ref, port = _pair(max_sessions=4, autoscale=True, shrink_patience=1,
                          seed=5)
        for i in range(3):
            ref.open(f"s{i}")
            port.open(f"s{i}")
        assert ref.capacity == port.capacity == 4
        batch = {f"s{i}": streams[i][:40] for i in range(3)}
        a, b = ref.ingest_many(batch), port.ingest_many(batch)
        for sid in batch:
            _assert_delta_equal(a[sid], b[sid], sid)
        for sid in ("s0", "s2"):
            _assert_close_equal(ref.close(sid), port.close(sid), sid)
        assert ref.capacity == port.capacity == 2
        assert port.totals["grows"] == 2 and port.totals["shrinks"] == 1
        ref.open("s3")
        port.open("s3")
        batch = {"s1": streams[1][40:], "s3": streams[3]}
        a, b = ref.ingest_many(batch), port.ingest_many(batch)
        for sid in batch:
            _assert_delta_equal(a[sid], b[sid], sid)
        for sid in ("s1", "s3"):
            _assert_close_equal(ref.close(sid), port.close(sid), sid)

    def test_table_step_from_reference_state(self):
        """A mid-stream JAX table carried across with ``convert`` steps to
        the same state as the reference steps it, leaf by leaf."""
        rng = np.random.default_rng(3)
        s = 3
        keys = jax.random.split(jax.random.key(9), s)
        table = jax.vmap(lambda k: jax_receiver_init(JCFG, k))(keys)
        for _ in range(3):
            win = rng.normal(0, 1, (s, WINDOW_CAP)).cumsum(1).astype(np.float32)
            n_valid = rng.integers(0, WINDOW_CAP + 1, s).astype(np.int32)
            table, _ = jax_table_step(jnp.asarray(win), jnp.asarray(n_valid),
                                      JCFG, table)
        as_np = lambda t: jax.tree.map(np.asarray, t._replace(
            dig=t.dig._replace(key=jax.random.key_data(t.dig.key))))
        port_table = receiver_state_from_numpy(as_np(table))
        win = rng.normal(0, 1, (s, WINDOW_CAP)).cumsum(1).astype(np.float32)
        n_valid = np.array([WINDOW_CAP, 5, 0], np.int32)
        ref_next, ref_info = jax_table_step(
            jnp.asarray(win), jnp.asarray(n_valid), JCFG, table)
        port_next, port_info = symed_receive_masked_chunk_table(
            torch.from_numpy(win), torch.from_numpy(n_valid), CFG, port_table)
        want = jax.tree.leaves(as_np(ref_next))
        got = jax.tree.leaves(receiver_state_to_numpy(port_next))
        assert len(want) == len(got)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)
        for name in ("labels", "endpoints", "n_new", "emitted"):
            np.testing.assert_array_equal(
                np.asarray(ref_info["symbol_delta"][name]),
                port_info["symbol_delta"][name].numpy(), err_msg=name)


def test_masked_chunk_per_slot():
    """One slot's state through ``symed_receive_masked_chunk`` (ragged
    windows, an idle window, the seeding one) and the closing frame."""
    from repro.core.symed import symed_receive_finish as jax_finish
    from repro.core.symed import symed_receive_masked_chunk as jax_chunk
    from repro_torch.core.prng import as_key
    from repro_torch.core.symed import (
        receiver_init, symed_receive_finish, symed_receive_masked_chunk)

    rng = np.random.default_rng(21)
    ts = make_stream(rng, 120, "mixed")
    key = jax.random.key(4)
    ref = jax_receiver_init(JCFG, key)
    port = receiver_init(CFG, as_key(jax.random.key_data(key)))
    pos = 0
    for n in (5, 0, 31, 17, 32, 30, 5):
        win = np.zeros(WINDOW_CAP, np.float32)
        win[:n] = ts[pos: pos + n]
        pos += n
        ref, ri = jax_chunk(jnp.asarray(win), n, JCFG, ref, digitize_every_k=2)
        port, pi = symed_receive_masked_chunk(torch.from_numpy(win), n, CFG,
                                              port, digitize_every_k=2)
        for name in ("labels", "endpoints", "n_new", "emitted"):
            np.testing.assert_array_equal(
                np.asarray(ri["symbol_delta"][name]),
                pi["symbol_delta"][name].numpy(), err_msg=name)
    a = jax_finish(ref, JCFG, with_delta=True)
    b = symed_receive_finish(port, CFG, with_delta=True)
    for name in a:
        if name == "symbol_delta":
            for k in ("labels", "endpoints", "n_new"):
                np.testing.assert_array_equal(np.asarray(a[name][k]),
                                              b[name][k].numpy(), err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(a[name]),
                                          b[name].numpy(), err_msg=name)


class TestPortContract:
    @pytest.mark.parametrize("t_len,cadence", [(96, 1), (160, 3)])
    def test_concat_deltas_equal_encode(self, t_len, cadence):
        rng = np.random.default_rng(40 + t_len + cadence)
        ts = make_stream(rng, t_len)
        server = StreamServer(CFG, max_sessions=2, window_cap=WINDOW_CAP,
                              digitize_every_k=cadence, device="cpu")
        key = np.array([0, 77], np.uint32)
        server.open("s", key=key)
        deltas, pos = [], 0
        while pos < t_len:
            n = int(rng.integers(1, 49))
            deltas.append(server.ingest("s", ts[pos: pos + n]))
            pos += n
        res = server.close("s")
        whole = symed_encode(torch.from_numpy(ts), CFG, torch.tensor([0, 77]))
        n = int(whole["n_pieces"])
        labels = np.concatenate([d["labels"] for d in deltas]
                                + [res["delta"]["labels"]])
        endpoints = np.concatenate([d["endpoints"] for d in deltas]
                                   + [res["delta"]["endpoints"]])
        np.testing.assert_array_equal(labels,
                                      whole["symbols_online"][:n].numpy())
        ev = compress_stream(torch.from_numpy(ts), tol=CFG.tol,
                             len_max=CFG.len_max, alpha=CFG.alpha)
        wire = list(ev["endpoint"][ev["emit"]].numpy())
        if bool(ev["tail"].emit):
            wire.append(float(ev["tail"].endpoint))
        np.testing.assert_array_equal(endpoints, np.asarray(wire, np.float32))
        for name, val in whole.items():
            np.testing.assert_array_equal(res["out"][name], val.numpy(),
                                          err_msg=name)

    def test_cuda_entry_point_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StreamServer(CFG)

    def test_cli_summary_line(self, capsys):
        from repro_torch.launch.stream import main

        rep = main(["--sessions", "3", "--max-slots", "2", "--evict",
                    "--length", "60", "--window", "24", "--device", "cpu"])
        out = capsys.readouterr().out
        line = [l for l in out.splitlines() if l.startswith("stream_summary ")]
        assert line and "opened=3" in line[0] and "evicted=1" in line[0]
        assert rep["points_in"] > 0


def test_port_imports_no_jax():
    """``import repro_torch`` plus one CPU service round leaves jax and
    every module of the JAX package out of ``sys.modules``."""
    code = (
        "import sys, numpy as np\n"
        "import repro_torch\n"
        "from repro_torch.launch.stream import StreamServer\n"
        "from repro_torch.core.symed import SymEDConfig\n"
        "cfg = SymEDConfig(n_max=32, k_max=4, len_max=16, lloyd_iters=2)\n"
        "srv = StreamServer(cfg, max_sessions=2, window_cap=16, device='cpu')\n"
        "srv.open('a')\n"
        "srv.ingest('a', np.sin(np.arange(40, dtype=np.float32) / 3))\n"
        "srv.close('a')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout
