"""The port's wire transport (``repro_torch.launch.transport``).

Torch counterparts of ``tests/test_transport.py``: the codec alone (any
re-slicing of the byte stream decodes to the same frames), then a real
``TransportServer`` on 127.0.0.1 in front of the port's ``StreamServer``
(device cpu) with ``SenderClient``s in this process, whose concatenated
delta streams are bitwise equal to the port's one-shot ``symed_encode``.
Against the JAX package: every ``encode_*`` byte for byte, and two
cross-talk runs (the port's sender against the reference's server, the
reference's sender against the port's server) whose delta streams are both
byte for byte the reference's own (its ``symed_encode`` and sender).
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import struct
import threading

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from conftest import make_stream

try:
    import jax
    import jax.numpy as jnp
    from repro.core.compress import compress_stream as jax_compress_stream
    from repro.core.symed import SymEDConfig as JaxConfig
    from repro.core.symed import symed_encode as jax_encode
    from repro.launch import transport as jt
    from repro.launch.stream import StreamServer as JaxServer
except ImportError:
    jt = None
from repro_torch.core import prng
from repro_torch.core.compress import compress_stream
from repro_torch.core.receiver import (
    delta_frame_bytes, pack_delta_frame, pack_piece_tuples,
    unpack_delta_frame, unpack_piece_tuples,
)
from repro_torch.core.symed import SymEDConfig, symed_encode
from repro_torch.launch import transport as tt
from repro_torch.launch.stream import StreamServer
from repro_torch.launch.transport import (
    CLOSE, DATA, DELTA, ERROR, OPEN, FrameDecoder, SenderClient,
    TransportServer, decode_close, decode_data_pieces, decode_data_raw,
    encode_close, encode_data_pieces, encode_data_raw, encode_delta,
    encode_error, encode_open, session_seed,
)

PARAMS = dict(tol=0.5, alpha=0.02, scl=1.0, k_min=3, k_max=8, len_max=32,
              n_max=64, lloyd_iters=5)
CFG = SymEDConfig(**PARAMS)
JCFG = JaxConfig(**PARAMS) if jt is not None else None
needs_jax = pytest.mark.skipif(jt is None, reason="needs the JAX reference")


# ------------------------------------------------------------------ framing


class TestFraming:
    def test_frame_roundtrip_each_type(self):
        dec = FrameDecoder()
        w = np.linspace(-1, 1, 7, dtype=np.float32)
        eps = np.asarray([0.5, -2.0], np.float32)
        steps = np.asarray([3, 9], np.int32)
        wire = (encode_open("sess-a", 1, 0xDEADBEEF)
                + encode_data_raw("sess-a", w)
                + encode_data_pieces("sess-a", 1.5, 17, eps, steps)
                + encode_close("sess-a", 17, -2.5)
                + encode_delta("sess-a", [1, 2], [0.1, 0.2])
                + encode_error("sess-a", "nope"))
        frames = dec.feed(wire)
        assert [f.type for f in frames] == [OPEN, DATA, DATA, CLOSE, DELTA,
                                            ERROR]
        assert all(f.sid == "sess-a" for f in frames)
        np.testing.assert_array_equal(decode_data_raw(frames[1].payload), w)
        t0, t_seen, e, s = decode_data_pieces(frames[2].payload)
        assert (t0, t_seen) == (1.5, 17)
        np.testing.assert_array_equal(e, eps)
        np.testing.assert_array_equal(s, steps)
        assert decode_close(frames[3].payload) == (17, -2.5)
        labels, endpoints = unpack_delta_frame(frames[4].payload)
        np.testing.assert_array_equal(labels, [1, 2])
        np.testing.assert_array_equal(endpoints,
                                      np.asarray([0.1, 0.2], np.float32))

    @given(st.integers(0, 31))
    @settings(max_examples=16, deadline=None)
    def test_partial_frames_across_recv_boundaries(self, seed):
        """Any re-slicing of the byte stream decodes to the same frames --
        split mid-length-prefix, mid-sid, mid-payload, or many per read."""
        rng = np.random.default_rng(7100 + seed)
        frames_in = []
        wire = b""
        for i in range(int(rng.integers(2, 8))):
            sid = f"s{int(rng.integers(0, 4))}"
            kind = int(rng.integers(0, 3))
            if kind == 0:
                wire += encode_open(sid, i % 2, i)
                frames_in.append((OPEN, sid))
            elif kind == 1:
                w = rng.normal(size=int(rng.integers(1, 40))).astype(np.float32)
                wire += encode_data_raw(sid, w)
                frames_in.append((DATA, sid))
            else:
                wire += encode_close(sid, int(rng.integers(0, 100)))
                frames_in.append((CLOSE, sid))
        dec = FrameDecoder()
        out = []
        pos = 0
        while pos < len(wire):
            n = int(rng.integers(1, 11))
            out.extend(dec.feed(wire[pos: pos + n]))
            pos += n
        assert [(f.type, f.sid) for f in out] == frames_in
        assert not dec.feed(b"")  # nothing buffered mid-frame

    def test_bad_length_prefix_rejected(self):
        dec = FrameDecoder()
        with pytest.raises(ValueError, match="bad frame length"):
            dec.feed(b"\xff\xff\xff\xff rest")
        with pytest.raises(ValueError, match="bad frame length"):
            FrameDecoder().feed(b"\x00\x00\x00\x01x")

    def test_delta_frame_bytes_matches_packed_length(self):
        """The accounted DELTA bytes are the actual wire bytes."""
        for n in (0, 1, 7):
            buf = pack_delta_frame(np.arange(n), np.arange(n, dtype=np.float32))
            assert len(buf) == float(delta_frame_bytes(n))

    def test_piece_tuples_roundtrip(self):
        eps = np.asarray([1.25, -3.5, 0.0], np.float32)
        steps = np.asarray([5, 111, 65000], np.int32)
        e, s = unpack_piece_tuples(pack_piece_tuples(eps, steps), 3)
        np.testing.assert_array_equal(e, eps)
        np.testing.assert_array_equal(s, steps)


ENCODERS = {
    "open": ("encode_open", ("sess-a", 1, 0x1DEADBEEF)),
    "data raw": ("encode_data_raw",
                 ("s", np.linspace(-3, 3, 11, dtype=np.float32))),
    "data raw empty": ("encode_data_raw", ("s", np.zeros(0, np.float32))),
    "data pieces": ("encode_data_pieces",
                    ("s9", 0.125, 4000, np.asarray([1.5, -2.25], np.float32),
                     np.asarray([17, 4000], np.int32))),
    "close tail": ("encode_close", ("s", 96, -0.75)),
    "close no tail": ("encode_close", ("s", 96)),
    "delta": ("encode_delta", ("s", [0, 7, 300], [0.5, -1.0, 2.0])),
    "closed": ("encode_closed", ("s", 12, 96, True, [1, 2], [0.25, 3.5])),
    "error": ("encode_error", ("s", "unknown session")),
}


@needs_jax
@pytest.mark.parametrize("case", sorted(ENCODERS))
def test_encoders_byte_equal_to_reference(case):
    name, args = ENCODERS[case]
    assert getattr(tt, name)(*args) == getattr(jt, name)(*args)
    assert tt.MAX_FRAME == jt.MAX_FRAME
    assert (tt.OPEN, tt.DATA, tt.CLOSE, tt.DELTA, tt.CLOSED, tt.ERROR) == (
        jt.OPEN, jt.DATA, jt.CLOSE, jt.DELTA, jt.CLOSED, jt.ERROR)
    assert tt.session_seed(case, 7) == jt.session_seed(case, 7)


# ----------------------------------------------------------------- loopback


class _Loopback:
    """A served StreamServer on 127.0.0.1 with a deterministic shutdown:
    the port's (device cpu), or with ``reference=True`` the JAX one."""

    def __init__(self, expect_sessions, reference=False, **server_kw):
        kw = dict(max_sessions=4, window_cap=32, digitize_every_k=1)
        kw.update(server_kw)
        if reference:
            self.stream = JaxServer(JCFG, use_kernel=False, obs=False, **kw)
            self.transport = jt.TransportServer(self.stream, port=0)
        else:
            self.stream = StreamServer(CFG, device="cpu", **kw)
            self.transport = TransportServer(self.stream, port=0)
        self.thread = threading.Thread(
            target=self.transport.serve,
            kwargs={"expect_sessions": expect_sessions}, daemon=True)
        self.thread.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.thread.join(timeout=60)
        assert not self.thread.is_alive(), "transport server failed to exit"


def _client(port, mode):
    return SenderClient("127.0.0.1", port, CFG, mode=mode, device="cpu")


def _feed_and_close(client, sids, streams, rng, lo=1, hi=49):
    """Deliver each stream in ragged interleaved arrivals, then close all."""
    cursors = {sid: 0 for sid in sids}
    while any(cursors[sid] < len(streams[sid]) for sid in sids):
        for sid in sids:
            if cursors[sid] >= len(streams[sid]):
                continue
            n = int(rng.integers(lo, hi))
            client.send(sid, streams[sid][cursors[sid]: cursors[sid] + n])
            cursors[sid] += n
    return {sid: client.close(sid) for sid in sids}


def _assert_matches_encode(client, sid, ts, seed, res):
    """The session's delta stream against the port's one-shot encode."""
    labels, endpoints = client.delta_concat(sid)
    ts = torch.from_numpy(ts[: res["t_seen"]])
    ref = symed_encode(ts, CFG, prng.key(session_seed(sid, seed)),
                       reconstruct=False, device="cpu")
    n = int(ref["n_pieces"])
    assert res["n_pieces"] == n, sid
    np.testing.assert_array_equal(
        labels, ref["symbols_online"][:n].numpy(),
        err_msg=f"{sid}: delta labels over the wire")
    ev = compress_stream(ts, tol=CFG.tol, len_max=CFG.len_max,
                         alpha=CFG.alpha)
    want_eps = list(ev["endpoint"][ev["emit"]].numpy())
    if bool(ev["tail"].emit):
        want_eps.append(float(ev["tail"].endpoint))
    np.testing.assert_array_equal(
        endpoints, np.asarray(want_eps, np.float32),
        err_msg=f"{sid}: delta endpoints over the wire")


@pytest.mark.parametrize("mode", ["raw", "pieces"])
def test_loopback_bitwise(mode, rng):
    """Interleaved sessions over one socket, both transport modes: the
    returned delta stream is bitwise equal to one-shot symed_encode."""
    seed = 5
    streams = {f"t-{mode}-{i}": make_stream(rng, 128) for i in range(3)}
    sids = list(streams)
    with _Loopback(expect_sessions=len(sids)) as lb:
        client = _client(lb.transport.port, mode)
        for sid in sids:
            client.open(sid, session_seed(sid, seed))
        results = _feed_and_close(client, sids, streams, rng)
        for sid in sids:
            assert results[sid]["t_seen"] == 128
            _assert_matches_encode(client, sid, streams[sid], seed,
                                   results[sid])
        client.shutdown()


def test_loopback_pieces_compresses_wire(rng):
    """Compressed-in mode puts less than 4 B/point on the wire, and the
    server's wire_in accounting sees it."""
    streams = {f"c-{i}": make_stream(rng, 160) for i in range(2)}
    with _Loopback(expect_sessions=2) as lb:
        client = _client(lb.transport.port, "pieces")
        for sid in streams:
            client.open(sid, session_seed(sid, 0))
        results = _feed_and_close(client, list(streams), streams, rng,
                                  lo=20, hi=41)
        client.shutdown()
    points = sum(r["t_seen"] for r in results.values())
    assert client.payload_bytes < 4.0 * points, (
        client.payload_bytes, 4.0 * points)
    rep = lb.stream.report(1.0)
    assert 0 < rep["wire_in_ratio"] < 1.0, rep["wire_in_ratio"]
    # the server books the hello (4 B at open), the client the CLOSE header
    assert abs(rep["wire_in_bytes"] - client.payload_bytes) <= 2 * len(streams)
    summ = lb.transport.summary()
    assert summ["pieces_ratio"] < 1.0
    assert summ["payload_bytes_pieces"] == pytest.approx(client.payload_bytes)


def test_raw_and_pieces_modes_agree(rng):
    """The same stream and seed through either mode yield the identical
    symbol stream."""
    ts = make_stream(rng, 128)
    out = {}
    for mode in ("raw", "pieces"):
        with _Loopback(expect_sessions=1) as lb:
            client = _client(lb.transport.port, mode)
            client.open("same", 1234)
            for c in range(0, 128, 24):
                client.send("same", ts[c: c + 24])
            res = client.close("same")
            out[mode] = (res["n_pieces"], *client.delta_concat("same"))
            client.shutdown()
    assert out["raw"][0] == out["pieces"][0]
    np.testing.assert_array_equal(out["raw"][1], out["pieces"][1])
    np.testing.assert_array_equal(out["raw"][2], out["pieces"][2])


def test_close_unknown_session_keeps_serving(rng):
    """A CLOSE for a session the receiver never saw earns an ERROR frame;
    the connection and the server survive it."""
    ts = make_stream(rng, 96)
    with _Loopback(expect_sessions=1) as lb:
        client = _client(lb.transport.port, "raw")
        client.sock.sendall(encode_close("ghost"))
        with pytest.raises(RuntimeError, match="unknown session"):
            client._drain(block=True)
        client.open("real", session_seed("real", 0))
        client.send("real", ts)
        res = client.close("real")
        _assert_matches_encode(client, "real", ts, 0, res)
        client.shutdown()


def test_duplicate_open_rejected(rng):
    with _Loopback(expect_sessions=1) as lb:
        client = _client(lb.transport.port, "raw")
        client.open("dup", 0)
        client.sock.sendall(encode_open("dup", 0, 0))
        with pytest.raises(RuntimeError, match="already open"):
            client._drain(block=True)
        client.send("dup", make_stream(rng, 96))
        client.close("dup")
        client.shutdown()


def test_eviction_over_transport(rng):
    """LRU eviction reaches the sender as an unsolicited CLOSED(evicted):
    close() returns the parked prefix result, whose delta stream verifies
    bitwise, and the other sessions are unaffected."""
    seed = 3
    streams = {f"e-{i}": make_stream(rng, 96) for i in range(3)}
    sids = list(streams)

    def wait_delta(client, sid):
        # the server has ingested this session's data before the
        # eviction-triggering OPEN arrives
        while not client._sessions[sid].deltas:
            client._drain(block=True)

    with _Loopback(expect_sessions=3, max_sessions=2,
                   evict_idle=True) as lb:
        client = _client(lb.transport.port, "raw")
        client.open(sids[0], session_seed(sids[0], seed))
        client.open(sids[1], session_seed(sids[1], seed))
        client.send(sids[0], streams[sids[0]][:40])
        wait_delta(client, sids[0])
        client.send(sids[1], streams[sids[1]])
        wait_delta(client, sids[1])
        client.open(sids[2], session_seed(sids[2], seed))  # evicts e-0 (LRU)
        client.send(sids[2], streams[sids[2]])
        res0 = client.close(sids[0])   # already settled by the eviction
        assert res0["evicted"] and res0["t_seen"] == 40
        _assert_matches_encode(client, sids[0], streams[sids[0]], seed, res0)
        for sid in sids[1:]:
            res = client.close(sid)
            assert not res["evicted"]
            _assert_matches_encode(client, sid, streams[sid], seed, res)
        client.shutdown()
    assert lb.stream.totals["evicted"] == 1


def test_malformed_payload_drops_conn_not_server(rng):
    """Garbage inside a well-framed body drops that connection only."""
    ts = make_stream(rng, 96)
    with _Loopback(expect_sessions=1) as lb:
        bad = _client(lb.transport.port, "raw")
        sid_b = b"bad"
        body = struct.pack("!BB", OPEN, len(sid_b)) + sid_b + b"\x01"
        bad.sock.sendall(struct.pack("!I", len(body)) + body)
        good = _client(lb.transport.port, "raw")
        good.open("good", session_seed("good", 0))
        good.send("good", ts)
        res = good.close("good")
        _assert_matches_encode(good, "good", ts, 0, res)
        good.shutdown()
        bad.shutdown()


def test_loopback_autoscale_resizes_preserve_deltas(rng):
    """Sessions over the wire force table grows (1 -> 4) and the drain-down
    forces shrinks; every session's delta stream stays bitwise."""
    seed = 9
    streams = {f"a-{i}": make_stream(rng, 96) for i in range(4)}
    sids = list(streams)
    with _Loopback(expect_sessions=4, max_sessions=4, autoscale=True,
                   min_slots=1, shrink_patience=1) as lb:
        client = _client(lb.transport.port, "pieces")
        for sid in sids:
            client.open(sid, session_seed(sid, seed))
        results = _feed_and_close(client, sids, streams, rng, lo=16, hi=33)
        for sid in sids:
            _assert_matches_encode(client, sid, streams[sid], seed,
                                   results[sid])
        client.shutdown()
    assert lb.stream.totals["grows"] >= 2, lb.stream.totals
    assert lb.stream.totals["shrinks"] >= 1, lb.stream.totals
    assert lb.stream.capacity == 1


# --------------------------------------------- cross-talk with the reference


def _cross_talk(reference_server, streams, modes, seed):
    """One sender of one package against the other package's server; every
    session in its mode.  Returns ``{sid: (n_pieces, t_seen, delta frame
    bytes of the whole stream)}`` and the server's summary."""
    sids = list(streams)
    with _Loopback(expect_sessions=len(sids), reference=reference_server,
                   max_sessions=4, autoscale=True, min_slots=2) as lb:
        if reference_server:
            client = SenderClient("127.0.0.1", lb.transport.port, CFG,
                                  device="cpu")
        else:
            client = jt.SenderClient("127.0.0.1", lb.transport.port, JCFG)
        for sid in sids:
            client.open(sid, session_seed(sid, seed), mode=modes[sid])
        for c in range(0, 128, 20):
            for sid in sids:
                client.send(sid, streams[sid][c: c + 20])
        out = {}
        for sid in sids:
            res = client.close(sid)
            labels, endpoints = client.delta_concat(sid)
            out[sid] = (res["n_pieces"], res["t_seen"],
                        pack_delta_frame(labels, endpoints))
        client.shutdown()
    return out, lb.transport.summary()


SUMMARY_KEYS = {"sessions_closed", "frame_bytes", "payload_bytes_raw",
                "payload_bytes_pieces", "raw_equiv_bytes", "pieces_ratio"}


@needs_jax
@pytest.mark.parametrize("reference_server", [True, False],
                         ids=["port sender to reference server",
                              "reference sender to port server"])
def test_cross_talk_with_the_reference(reference_server):
    """One package's sender against the other's server, raw and pieces
    sessions on one socket: each session's delta stream is byte for byte
    the one the reference's ``symed_encode`` and sender give."""
    rng = np.random.default_rng(90)
    streams = {f"x-{i}": make_stream(rng, 128, ("mixed", "walk", "sine")[i % 3])
               for i in range(4)}
    modes = {sid: ("pieces", "raw")[i % 2] for i, sid in enumerate(streams)}
    seed = 4
    got, summary = _cross_talk(reference_server, streams, modes, seed)
    assert set(summary) == SUMMARY_KEYS
    assert summary["sessions_closed"] == len(streams)
    assert 0 < summary["pieces_ratio"] < 1
    for sid, ts in streams.items():
        whole = jax_encode(jnp.asarray(ts), JCFG,
                           jax.random.key(session_seed(sid, seed)),
                           reconstruct=False)
        n = int(whole["n_pieces"])
        ev = jax_compress_stream(jnp.asarray(ts), tol=JCFG.tol,
                                 len_max=JCFG.len_max, alpha=JCFG.alpha)
        eps = list(np.asarray(ev["endpoint"])[np.asarray(ev["emit"])])
        if bool(ev["tail"].emit):
            eps.append(float(ev["tail"].endpoint))
        want = pack_delta_frame(np.asarray(whole["symbols_online"])[:n],
                                np.asarray(eps, np.float32))
        assert got[sid] == (n, 128, want), sid
