"""The port's resident service against the JAX reference, frame by frame.

``repro_torch.launch.stream.StreamServer`` (device cpu) and
``repro.launch.stream.StreamServer`` (``use_kernel=False``, the bitwise
reference path) receive the same arrivals.  Every delta frame must match:
labels, endpoints and ``n_new`` exactly, endpoints bitwise.  Each closing
``out`` must match leaf by leaf.  The port's own contract is checked too:
concatenated deltas are bitwise equal to its one-shot ``symed_encode``.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
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
        port_table = receiver_state_from_numpy(as_np(table), device="cpu")
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


class TestDtwMonitor:
    """The online DTW monitor against the reference's, and against the
    port's own recomputation from the slot table."""

    @staticmethod
    def _recompute(server, sid, raw):
        """``reconstruct_from_pieces`` + ``dtw_ref`` on one slot's pieces."""
        from repro_torch.core.metrics import dtw_ref
        from repro_torch.core.receiver import pieces_from_wire
        from repro_torch.core.reconstruct import reconstruct_from_pieces

        t = server._table
        slot = server.session_stats(sid)["slot"]
        lens, incs = pieces_from_wire(t.endpoints[slot], t.steps[slot],
                                      t.n_pieces[slot], t.t0[slot])
        rec = reconstruct_from_pieces(lens, incs, t.n_pieces[slot],
                                      t.t0[slot], raw.shape[0])
        return float(dtw_ref(torch.from_numpy(raw), rec,
                             band=server.dtw_band))

    @pytest.mark.parametrize("band", [None, 8])
    def test_readings_match_reference(self, band):
        rng = np.random.default_rng(60)
        ts = make_stream(rng, 200, "mixed")
        ref, port = _pair(max_sessions=2, dtw_every=2, dtw_band=band)
        key = jax.random.key(3)
        ref.open("s", key=key)
        port.open("s", key=np.asarray(jax.random.key_data(key)))
        pos, readings = 0, 0
        while pos < len(ts):
            n = int(rng.integers(1, 30))
            part = ts[pos: pos + n]
            pos += n
            a, b = ref.ingest("s", part), port.ingest("s", part)
            _assert_delta_equal(a, b, f"at {pos}")
            want = ref.session_stats("s")["dtw"]
            got = port.session_stats("s")["dtw"]
            assert (want is None) == (got is None), pos
            if got is not None:
                readings += 1
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            if port.session_stats("s")["chunks"] % 2 == 0:  # fired now
                assert got == self._recompute(port, "s", ts[:pos])
        assert readings >= 5
        a, b = ref.close("s"), port.close("s")
        np.testing.assert_allclose(b["dtw"], a["dtw"], rtol=1e-5, atol=1e-5)

    def test_sessions_of_two_lengths_due_together(self):
        """Three sessions fall due in one ``ingest_many``; two share a raw
        length (one batched reconstruction), one does not."""
        rng = np.random.default_rng(61)
        streams = [make_stream(rng, 160, kind) for kind in
                   ("mixed", "walk", "sine")]
        ref, port = _pair(max_sessions=4, dtw_every=1)
        for i in range(3):
            ref.open(f"s{i}")
            port.open(f"s{i}")
        pos = [0, 0, 0]
        for widths in ((20, 20, 31), (40, 40, 17)):
            batch = {}
            for i, w in enumerate(widths):
                batch[f"s{i}"] = streams[i][pos[i]: pos[i] + w]
                pos[i] += w
            ref.ingest_many(batch)
            port.ingest_many(batch)
            for i in range(3):
                sid = f"s{i}"
                got = port.session_stats(sid)["dtw"]
                np.testing.assert_allclose(
                    got, ref.session_stats(sid)["dtw"], rtol=1e-5, atol=1e-5)
                assert got == self._recompute(port, sid, streams[i][:pos[i]])
        for i in range(3):
            a, b = ref.close(f"s{i}"), port.close(f"s{i}")
            assert a["dtw"] is not None
            np.testing.assert_allclose(b["dtw"], a["dtw"], rtol=1e-5,
                                       atol=1e-5)

    def test_off_by_default_and_validated(self):
        server = StreamServer(CFG, max_sessions=1, window_cap=8,
                              device="cpu")
        server.open("a")
        server.ingest("a", np.arange(20, dtype=np.float32))
        assert server.session_stats("a")["dtw"] is None
        assert server.close("a")["dtw"] is None
        with pytest.raises(ValueError, match="dtw_every"):
            StreamServer(CFG, dtw_every=-1, device="cpu")


def _mesh(n, device="cpu"):
    from repro_torch.launch.fleet import fleet_data_mesh

    return fleet_data_mesh(n, device=device)


def _sharded_pair(n=4, device="cpu", **kw):
    """An unsharded port server and one whose table is in ``n`` blocks."""
    kw = dict(window_cap=WINDOW_CAP, device=device, **kw)
    return (StreamServer(CFG, **kw),
            StreamServer(CFG, mesh=_mesh(n, device), **kw))


def _pieces(ts, width):
    """A compressed-in session's frames: the sender's pieces per window of
    ``width`` points, then its trailing flush (``step = t_seen``)."""
    from repro_torch.core.compress import compressor_finalize, pieces_on_wire
    from repro_torch.core.symed import symed_encode_chunk

    frames, state = [], None
    for c in range(0, len(ts), width):
        state, ev = symed_encode_chunk(ts[c: c + width], CFG, state,
                                       device="cpu")
        e, st = pieces_on_wire(ev, c)
        frames.append({"endpoints": e, "steps": st,
                       "t_seen": min(c + width, len(ts)), "t0": ts[0]})
    tail = compressor_finalize(state)
    if bool(tail.emit):
        frames.append({"endpoints": [float(tail.endpoint)],
                       "steps": [len(ts)], "t_seen": len(ts), "t0": ts[0]})
    return frames


class TestShardedTable:
    """``StreamServer(mesh=...)``: the table in blocks of host shards,
    frame by frame against the unsharded port server, bitwise."""

    def test_interleaved_sessions_frame_by_frame(self):
        rng = np.random.default_rng(540)
        streams = [make_stream(rng, 128, kind) for kind in
                   ("mixed", "sine", "walk", "mixed", "walk")]
        servers = _sharded_pair(max_sessions=8, digitize_every_k=2, seed=1)
        _drive(servers, streams, rng, opens=[0, 0, 1, 2, 2],
               close_order=["s4", "s2", "s0", "s3", "s1"])
        assert servers[1].totals["steps"] == servers[0].totals["steps"] > 0

    def test_eviction_frame_by_frame(self):
        rng = np.random.default_rng(541)
        streams = [make_stream(rng, 96, "mixed") for _ in range(6)]
        servers = _sharded_pair(max_sessions=4, evict_idle=True, seed=3)
        _drive(servers, streams, rng, opens=[0, 0, 1, 1, 2, 4],
               close_order=[f"s{i}" for i in range(5, -1, -1)])
        assert servers[1].totals["evicted"] == 2

    def test_autoscale_across_blocks_frame_by_frame(self):
        """``min_slots`` defaults to the mesh's 4 shards; the ladder 4 -> 8
        -> 16 re-splits the table at each rung (live slots move between
        blocks) and back down as sessions close."""
        rng = np.random.default_rng(542)
        streams = [make_stream(rng, 80, "walk") for _ in range(10)]
        kw = dict(window_cap=WINDOW_CAP, device="cpu", max_sessions=16,
                  autoscale=True, shrink_patience=1, seed=5)
        flat = StreamServer(CFG, min_slots=4, **kw)
        sharded = StreamServer(CFG, mesh=_mesh(4), pretrace=True, **kw)
        assert sharded.min_slots == 4 and sharded.capacity == 4
        _drive((flat, sharded), streams, rng, opens=[0] * 9 + [3],
               close_order=[f"s{i}" for i in (0, 2, 4, 6, 8, 1, 3, 5, 7, 9)])
        assert sharded.totals["grows"] == 2
        assert sharded.totals["shrinks"] == flat.totals["shrinks"] >= 2

    def test_pieces_in_and_raw_in_sessions_frame_by_frame(self):
        rng = np.random.default_rng(543)
        raw = [make_stream(rng, 96, kind) for kind in ("mixed", "sine")]
        comp = [make_stream(rng, 96, kind) for kind in ("walk", "mixed")]
        frames = [_pieces(ts, 24) for ts in comp]
        servers = _sharded_pair(max_sessions=4, seed=7)
        for srv in servers:
            for i in range(2):
                srv.open(f"r{i}")
                srv.open(f"p{i}")
        for r in range(max(len(f) for f in frames)):
            raw_batch = {f"r{i}": raw[i][24 * r: 24 * (r + 1)]
                         for i in range(2) if 24 * r < len(raw[i])}
            pieces_batch = {f"p{i}": frames[i][r] for i in range(2)
                            if r < len(frames[i])}
            for batch, ingest in ((raw_batch, "ingest_many"),
                                  (pieces_batch, "ingest_pieces_many")):
                if batch:
                    a, b = (getattr(srv, ingest)(batch) for srv in servers)
                    for sid in batch:
                        _assert_delta_equal(a[sid], b[sid], f"{r} {sid}")
        for sid in ("r0", "p0", "r1", "p1"):
            _assert_close_equal(servers[0].close(sid), servers[1].close(sid),
                                sid)
        assert servers[0].totals == servers[1].totals

    def test_dtw_monitor_readings(self):
        rng = np.random.default_rng(544)
        streams = [make_stream(rng, 120, kind) for kind in
                   ("mixed", "walk", "sine")]
        servers = _sharded_pair(max_sessions=4, dtw_every=2)
        for srv in servers:
            for i in range(3):
                srv.open(f"s{i}")
        for c in range(0, 120, 20):
            batch = {f"s{i}": streams[i][c: c + 20] for i in range(3)}
            for srv in servers:
                srv.ingest_many(batch)
            for i in range(3):
                a, b = (srv.session_stats(f"s{i}")["dtw"] for srv in servers)
                assert a == b and (a is not None) == (c >= 20), (c, i)
        assert servers[1].monitor["dtw_readings"] == \
            servers[0].monitor["dtw_readings"] == 9

    @pytest.mark.parametrize("kw", [dict(max_sessions=6),
                                    dict(max_sessions=8, min_slots=2),
                                    dict(max_sessions=8, min_slots=9),
                                    dict(max_sessions=4, min_slots=0)])
    def test_constructor_messages_match_the_reference(self, kw):
        """A table that does not divide over a 4-device mesh: the
        reference's checks, in its order, with its messages."""
        import types

        fake = types.SimpleNamespace(axis_names=("data",),
                                     devices=np.empty((4,), dtype=object))
        msgs = []
        for make in (lambda: JaxServer(JCFG, mesh=fake, obs=False, **kw),
                     lambda: StreamServer(CFG, mesh=fake, device="cpu",
                                          **kw)):
            with pytest.raises(ValueError) as info:
                make()
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]

    def test_device_must_name_the_mesh_kind(self, monkeypatch):
        with pytest.raises(ValueError, match="does not name the mesh"):
            StreamServer(CFG, max_sessions=4, mesh=_mesh(2), device="cuda")
        server = StreamServer(CFG, max_sessions=4, mesh=_mesh(2))
        assert server.device == torch.device("cpu")
        assert server.min_slots == 2 and len(server.block_devices) == 2


@pytest.mark.cuda
def test_two_blocks_on_the_card_frame_by_frame():
    """Two blocks on one card against one block: n_new exact, endpoints
    bitwise, every symbol and DTW reading equal (the Lloyd kernel is one
    CTA per slot, so a slot's labels do not depend on its block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels.kmeans import kmeans_lloyd_cuda

    name = torch.cuda.get_device_name()
    rng = np.random.default_rng(545)
    streams = [make_stream(rng, 128, kind) for kind in
               ("mixed", "sine", "walk")]
    before = kmeans_lloyd_cuda.launches
    servers = _sharded_pair(2, "cuda", max_sessions=4, dtw_every=2, seed=2)
    _drive(servers, streams, rng, opens=[0, 0, 1],
           close_order=["s2", "s0", "s1"])
    assert kmeans_lloyd_cuda.launches > before, name
    assert servers[1].block_devices == [torch.device("cuda", 0)] * 2, name


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
        whole = symed_encode(torch.from_numpy(ts), CFG, torch.tensor([0, 77]),
                             reconstruct=False, device="cpu")
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

    def test_close_digitizes_as_the_rounds_do(self, monkeypatch):
        """``close`` hands the server's ``use_kernel`` to
        ``symed_receive_finish`` (the card's closes run the Lloyd kernel);
        on the CPU the flag runs the plain version, so the closes agree
        (the kernel's labels are 0 past the pieces, the plain loop's are
        not)."""
        import repro_torch.launch.stream as tstream

        seen = []
        finish = tstream.symed_receive_finish

        def spy(*args, **kw):
            seen.append(kw.get("use_kernel"))
            return finish(*args, **kw)

        monkeypatch.setattr(tstream, "symed_receive_finish", spy)
        ts = make_stream(np.random.default_rng(41), 120)
        closed = []
        for use_kernel in (False, True):
            server = StreamServer(CFG, max_sessions=2, window_cap=WINDOW_CAP,
                                  use_kernel=use_kernel, device="cpu")
            server.open("s", key=np.array([0, 5], np.uint32))
            for pos in range(0, 120, 30):
                server.ingest("s", ts[pos: pos + 30])
            closed.append(server.close("s"))
        assert seen == [False, True]
        plain, krn = closed
        n = plain["n_pieces"]
        assert n > CFG.k_min and not krn["out"]["symbols"][n:].any()
        for res in closed:
            res["out"]["symbols"] = res["out"]["symbols"][:n]
        _assert_close_equal(plain, krn, "use_kernel on the CPU")

    def test_cuda_entry_point_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StreamServer(CFG)

    def test_cli_summary_line(self, capsys):
        from repro_torch.launch.stream import main

        rep = main(["--sessions", "3", "--max-slots", "2", "--evict",
                    "--length", "60", "--window", "24", "--dtw-every", "1",
                    "--device", "cpu"])
        out = capsys.readouterr().out
        line = [l for l in out.splitlines() if l.startswith("stream_summary ")]
        assert line and "opened=3" in line[0] and "evicted=1" in line[0]
        assert rep["points_in"] > 0
        dtw = [l for l in out.splitlines()
               if l.startswith("online DTW monitor      : mean ")]
        assert dtw and dtw[0].endswith("over 2 sessions")  # s0 evicted unfed
        assert out.rstrip().splitlines()[-1].startswith("obs_summary ")
        with pytest.raises(SystemExit):
            main(["--dtw-every", "-1", "--device", "cpu"])


def test_totals_have_the_reference_keys():
    """A replay's fingerprint hashes every key of ``totals``: the port's
    key set is the reference's, and the DTW monitor's books (one of them
    wall time) live apart, merged by ``report()``."""
    ref, port = _pair(max_sessions=2, dtw_every=1)
    assert set(port.totals) == set(ref.totals)
    port.open("a")
    port.ingest("a", np.sin(np.arange(40, dtype=np.float32) / 3))
    rep = port.report(1.0)
    assert port.monitor["dtw_readings"] == rep["dtw_readings"] == 1
    assert rep["dtw_seconds"] > 0.0
    assert set(port.totals) == set(ref.totals)


def test_port_imports_no_jax():
    """``import repro_torch``, ``repro_torch.core``, the transport, the
    recorder, the workload harness, the fleet runtime, the mesh helpers,
    the models, the configs and the serve CLI module, one CPU service round
    with the DTW monitor on, one compressed-in round, one replay of a
    scenario, one sharded fleet run, one ABBA encode, one reduced serve of
    olmoe-1b-7b, xlstm-125m and jamba-1.5-large-398b each, the ``data``
    and ``kernels`` packages, and the sharding rules, the specs, the dry
    run (one cell on ``meta``, with its collective inventory: DTensor on a
    fake process group), elastic resume and the cost model leave jax and
    every module of the JAX package out of ``sys.modules``."""
    code = (
        "import sys, numpy as np\n"
        "import repro_torch, repro_torch.core\n"
        "import repro_torch.launch.transport\n"
        "import repro_torch.obs, repro_torch.obs.export\n"
        "import repro_torch.workload, repro_torch.workload.__main__\n"
        "import repro_torch.launch.fleet, repro_torch.launch.mesh\n"
        "from repro_torch.launch.stream import StreamServer\n"
        "from repro_torch.core.symed import SymEDConfig\n"
        "cfg = SymEDConfig(n_max=32, k_max=4, len_max=16, lloyd_iters=2)\n"
        "srv = StreamServer(cfg, max_sessions=2, window_cap=16, device='cpu',"
        " dtw_every=1)\n"
        "srv.open('a')\n"
        "srv.ingest('a', np.sin(np.arange(40, dtype=np.float32) / 3))\n"
        "assert srv.session_stats('a')['dtw'] is not None\n"
        "srv.close('a')\n"
        "srv.open('p')\n"
        "d = srv.ingest_pieces_many({'p': {'endpoints': [0.5, -0.25, 1.0],"
        " 'steps': [4, 9, 15], 't_seen': 16, 't0': 0.0}})\n"
        "assert d['p']['n_new'] == 3, d\n"
        "srv.close('p')\n"
        "from repro_torch.workload import Workload, replay_trace\n"
        "wl = Workload('mixed_fleet', sessions=2, length=32, window=16)\n"
        "res = replay_trace(wl.trace(), cfg=cfg, server_kw=wl.server_kw(),"
        " device='cpu', verify=True)\n"
        "assert res.verified == 2 and res.latency['count'] > 0, res\n"
        "from repro_torch.core import prng\n"
        "from repro_torch.launch.fleet import fleet_data_mesh, run_fleet\n"
        "out, tele = run_fleet(np.sin(np.arange(128, dtype=np.float32)"
        ".reshape(2, 64)), cfg, prng.key(0), fleet_data_mesh(2, "
        "device='cpu'), chunk_len=32, digitize_every_k=1)\n"
        "assert float(tele['streams']) == 2 and float(tele['pieces']) > 0\n"
        "import repro_torch.models, repro_torch.launch.serve\n"
        "import repro_torch.core.abba, repro_torch.configs\n"
        "from repro_torch.core.abba import abba_encode\n"
        "res = abba_encode(np.sin(np.arange(64, dtype=np.float32) / 5),"
        " n_max=32, k_max=8, len_max=16, device='cpu')\n"
        "assert int(res.n_pieces) > 0\n"
        "assert repro_torch.launch.serve.main(['--device', 'cpu', '--gen',"
        " '3', '--prompt-len', '4', '--batch', '1']) == 0\n"
        "for arch in ('xlstm-125m', 'jamba-1.5-large-398b'):\n"
        "    assert repro_torch.launch.serve.main(['--device', 'cpu',"
        " '--arch', arch, '--reduced', '--gen', '2', '--prompt-len', '4',"
        " '--batch', '1']) == 0\n"
        "from repro_torch.data import make_fleet\n"
        "import repro_torch.kernels\n"
        "import repro_torch.sharding, repro_torch.sharding.layout\n"
        "import repro_torch.launch.specs, repro_torch.launch.elastic\n"
        "import repro_torch.utils.flopcount, repro_torch.utils.roofline\n"
        "from repro_torch.launch.dryrun import run_cell\n"
        "cell = run_cell('xlstm-125m', 'decode_32k', 'multipod')\n"
        "assert cell['kind'] == 'decode' and cell['collectives']\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout
