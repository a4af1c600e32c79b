"""The port's compressed-in paths and per-stream online receiver.

Against the JAX reference on the same numpy inputs and keys, leaf by leaf
(integers exactly, floats bitwise): ``symed_receive_masked_pieces_table``
and ``symed_receive_masked_pieces`` (states carried across with
``convert``), ``symed_receive_chunk`` / ``symed_step_chunk``, and
``StreamServer.ingest_pieces_many`` frame by frame.  Then the port against
its own one-shot ``symed_encode`` (the torch counterparts of
``tests/test_streaming_receiver.py``), and the pieces and ``min_slots``
cases of ``tests/test_stream_service.py``.  The tests against the
reference skip where JAX is not installed.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import numpy as np
import pytest
import torch

from conftest import make_stream

try:
    import jax
    import jax.numpy as jnp
    from repro.core import symed as js
    from repro.launch.stream import StreamServer as JaxServer
except ImportError:
    js = None
from repro_torch.convert import (
    receiver_state_from_numpy, receiver_state_to_numpy,
)
from repro_torch.core import prng
from repro_torch.core import symed as ts_
from repro_torch.core.compress import (
    compress_stream, compressor_finalize, pieces_on_wire,
)
from repro_torch.launch.stream import StreamServer

PARAMS = dict(tol=0.5, alpha=0.02, scl=1.0, k_min=3, k_max=8, len_max=32,
              n_max=64, lloyd_iters=5)
CFG = ts_.SymEDConfig(**PARAMS)
JCFG = js.SymEDConfig(**PARAMS) if js is not None else None
WINDOW_CAP = 32
needs_jax = pytest.mark.skipif(js is None, reason="needs the JAX reference")


def _np_state(state):
    """A JAX ``ReceiverState`` as the numpy tree ``convert`` reads."""
    return jax.tree.map(np.asarray, state._replace(
        dig=state.dig._replace(key=jax.random.key_data(state.dig.key))))


def _assert_state(ref, port, ctx):
    want = jax.tree.leaves(_np_state(ref))
    got = jax.tree.leaves(receiver_state_to_numpy(port))
    assert len(want) == len(got), ctx
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx}: leaf {i}")


def _assert_info(ref, port, ctx):
    assert set(ref) == set(port), (ctx, set(ref) ^ set(port))
    for name, want in ref.items():
        if isinstance(want, dict):
            _assert_info(want, port[name], f"{ctx} {name}")
        else:
            np.testing.assert_array_equal(
                np.asarray(want), port[name].numpy(), err_msg=f"{ctx} {name}")


def _keys(seed):
    """A JAX key and the same key's words for the port."""
    key = jax.random.key(seed)
    return key, np.asarray(jax.random.key_data(key))


def _piece_frames(ts, splits, cfg=CFG):
    """The pieces a sender's ``symed_encode_chunk`` (on the CPU) puts on
    the wire for each window of ``splits``, then its tail: ``[(endpoints,
    steps, t_seen)]`` as numpy."""
    frames, state, off = [], None, 0
    for n in splits:
        w = ts[off: off + n]
        state, ev = ts_.symed_encode_chunk(w, cfg, state, device="cpu")
        eps, steps = pieces_on_wire(ev, off)
        off += n
        frames.append((eps, steps, off))
    tail = compressor_finalize(state)
    if bool(tail.emit):
        frames.append((np.asarray([float(tail.endpoint)], np.float32),
                       np.asarray([off], np.int32), off))
    return frames


def _splits(rng, t_len, lo=1, hi=49):
    out, pos = [], 0
    while pos < t_len:
        n = int(min(rng.integers(lo, hi), t_len - pos))
        out.append(n)
        pos += n
    return out


def _padded(frames, width):
    """One slot's frame padded to ``width`` tuples."""
    eps, steps, _ = frames
    pe = np.zeros(width, np.float32)
    ps = np.zeros(width, np.int32)
    pe[: len(eps)] = eps
    ps[: len(steps)] = steps
    return pe, ps


# ------------------------------------------------ against the reference


@needs_jax
class TestAgainstReference:
    @pytest.mark.parametrize("cadence", [0, 1, 2])
    def test_pieces_table_from_reference_state(self, cadence):
        """Three slots (one idle, one opening, one mid-stream) carried
        across with ``convert``; each pieces step leaf by leaf."""
        rng = np.random.default_rng(70 + cadence)
        s = 3
        streams = [make_stream(rng, 160, k) for k in ("mixed", "walk", "sine")]
        frames = [_piece_frames(t, _splits(rng, 160)) for t in streams]
        keys = jax.random.split(jax.random.key(11), s)
        ref = jax.vmap(lambda k: js.receiver_init(JCFG, k))(keys)
        port = receiver_state_from_numpy(_np_state(ref), device="cpu")
        cursor = [0, 0, 0]
        for step in range(12):
            width = WINDOW_CAP
            pe = np.zeros((s, width), np.float32)
            ps = np.zeros((s, width), np.int32)
            n_valid = np.zeros(s, np.int32)
            hello = np.zeros(s, np.float32)
            t_seen = np.zeros(s, np.int32)
            for i in range(s):
                if (i == 1 and step < 2) or cursor[i] >= len(frames[i]) \
                        or rng.random() < 0.2:
                    continue  # idle this step
                f = frames[i][cursor[i]]
                cursor[i] += 1
                pe[i], ps[i] = _padded(f, width)
                n_valid[i] = len(f[0])
                hello[i] = streams[i][0]
                t_seen[i] = f[2]
            ref, ri = js.symed_receive_masked_pieces_table(
                jnp.asarray(pe), jnp.asarray(ps), jnp.asarray(n_valid),
                jnp.asarray(hello), jnp.asarray(t_seen), JCFG, ref,
                digitize_every_k=cadence)
            port, pi = ts_.symed_receive_masked_pieces_table(
                torch.from_numpy(pe), torch.from_numpy(ps),
                torch.from_numpy(n_valid), torch.from_numpy(hello),
                torch.from_numpy(t_seen), CFG, port,
                digitize_every_k=cadence)
            _assert_state(ref, port, f"step {step}")
            _assert_info(jax.tree.map(np.asarray, ri), pi, f"step {step}")

    def test_masked_pieces_per_slot(self):
        """One slot through ``symed_receive_masked_pieces``: frames of
        pieces, a frame of none that still advances the clock, the tail,
        and the closing frame."""
        rng = np.random.default_rng(71)
        ts = make_stream(rng, 140, "mixed")
        jkey, tkey = _keys(6)
        ref = js.receiver_init(JCFG, jkey)
        port = ts_.receiver_init(CFG, prng.as_key(tkey))
        frames = _piece_frames(ts, [3, 40, 2, 31, 32, 32])
        frames.insert(2, (np.zeros(0, np.float32), np.zeros(0, np.int32),
                          frames[1][2] + 1))
        for j, f in enumerate(frames):
            pe, ps = _padded(f, WINDOW_CAP)
            ref, ri = js.symed_receive_masked_pieces(
                jnp.asarray(pe), jnp.asarray(ps), len(f[0]), float(ts[0]),
                f[2], JCFG, ref, digitize_every_k=2)
            port, pi = ts_.symed_receive_masked_pieces(
                torch.from_numpy(pe), torch.from_numpy(ps), len(f[0]),
                float(ts[0]), f[2], CFG, port, digitize_every_k=2)
            _assert_state(ref, port, f"frame {j}")
            _assert_info(jax.tree.map(np.asarray, ri), pi, f"frame {j}")
        a = js.symed_receive_finish(ref, JCFG, with_delta=True)
        b = ts_.symed_receive_finish(port, CFG, with_delta=True)
        _assert_info(jax.tree.map(np.asarray, a), b, "finish")

    @pytest.mark.parametrize("splits,cadence", [
        ((1, 40, 17, 32, 48), 1), ((32, 32, 32, 32), 2), ((48, 48, 48), 0)])
    def test_receive_chunk_window_by_window(self, splits, cadence):
        """``symed_receive_chunk`` (``symed_step_chunk`` at cadence 0):
        state and info leaf by leaf after every window, then the finish."""
        ts = make_stream(np.random.default_rng(72 + cadence), sum(splits))
        jkey, tkey = _keys(7)
        ref = port = None
        pos = 0
        for n in splits:
            w = ts[pos: pos + n]
            pos += n
            if cadence == 0:
                ref, ri = js.symed_step_chunk(jnp.asarray(w), JCFG, ref, jkey)
                port, pi = ts_.symed_step_chunk(w, CFG, port, tkey,
                                                device="cpu")
            else:
                ref, ri = js.symed_receive_chunk(
                    jnp.asarray(w), JCFG, ref, jkey, digitize_every_k=cadence)
                port, pi = ts_.symed_receive_chunk(
                    w, CFG, port, tkey, digitize_every_k=cadence,
                    device="cpu")
            _assert_state(ref, port, f"window ending at {pos}")
            _assert_info(jax.tree.map(np.asarray, ri), pi,
                         f"window ending at {pos}")
        a = js.symed_receive_finish(ref, JCFG, jnp.asarray(ts), True,
                                    with_delta=True)
        b = ts_.symed_receive_finish(port, CFG, torch.from_numpy(ts), True,
                                     with_delta=True)
        _assert_info(jax.tree.map(np.asarray, a), b, "finish")


# ----------------------------------- the service, against the reference


def _servers(**kw):
    kw = {"window_cap": WINDOW_CAP, **kw}
    return (JaxServer(JCFG, use_kernel=False, obs=False, **kw),
            StreamServer(CFG, device="cpu", **kw))


def _assert_delta(a, b, ctx):
    np.testing.assert_array_equal(a["labels"], b["labels"],
                                  err_msg=f"{ctx}: labels")
    np.testing.assert_array_equal(a["endpoints"], b["endpoints"],
                                  err_msg=f"{ctx}: endpoints")
    for k in ("n_new", "frames", "bytes"):
        assert a[k] == b[k], (ctx, k, a[k], b[k])


def _assert_closed(a, b, ctx):
    _assert_delta(a["delta"], b["delta"], f"{ctx} closing delta")
    for k in ("symbols", "n_pieces", "t_seen", "symbols_out", "bytes_out"):
        assert a[k] == b[k], (ctx, k)
    assert set(a["out"]) == set(b["out"]), ctx
    for name, want in a["out"].items():
        if name == "symbol_delta":
            for k, v in want.items():
                np.testing.assert_array_equal(np.asarray(v),
                                              b["out"][name][k], err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(want), b["out"][name],
                                          err_msg=f"{ctx}: out[{name}]")


@needs_jax
@pytest.mark.parametrize("seed", [0, 1])
def test_ingest_pieces_many_frame_by_frame(seed):
    """Six interleaved sessions, four compressed-in and two raw-in, in one
    autoscaled table from ``min_slots=2``: every frame, every close and
    every total as the reference's."""
    rng = np.random.default_rng(80 + seed)
    n = 6
    streams = [make_stream(rng, 128, ("mixed", "walk", "sine")[i % 3])
               for i in range(n)]
    pieces = {i: _piece_frames(streams[i], _splits(rng, 128, 10, 60))
              for i in range(4)}
    ref, port = _servers(max_sessions=8, autoscale=True, min_slots=2,
                         shrink_patience=1, digitize_every_k=1 + seed,
                         seed=seed)
    assert ref.capacity == port.capacity == 2
    cursor = [0] * n
    opened = set()
    for rnd in range(40):
        for i in range(n):
            if i < 2 + rnd and f"s{i}" not in opened:
                ref.open(f"s{i}")
                port.open(f"s{i}")
                opened.add(f"s{i}")
        raw, pcs = {}, {}
        for i in range(n):
            sid = f"s{i}"
            if sid not in port or rng.random() < 0.25:
                continue
            if i < 4:
                if cursor[i] >= len(pieces[i]):
                    continue
                take = int(rng.integers(1, 3))  # one or two frames at once
                fr = pieces[i][cursor[i]: cursor[i] + take]
                cursor[i] += take
                pcs[sid] = {"endpoints": np.concatenate([f[0] for f in fr]),
                            "steps": np.concatenate([f[1] for f in fr]),
                            "t_seen": fr[-1][2], "t0": float(streams[i][0])}
            elif cursor[i] < 128:
                m = int(rng.integers(1, 45))
                raw[sid] = streams[i][cursor[i]: cursor[i] + m]
                cursor[i] += m
        if pcs:
            a, b = ref.ingest_pieces_many(pcs), port.ingest_pieces_many(pcs)
            for sid in pcs:
                _assert_delta(a[sid], b[sid], f"round {rnd} {sid} pieces")
        if raw:
            a, b = ref.ingest_many(raw), port.ingest_many(raw)
            for sid in raw:
                _assert_delta(a[sid], b[sid], f"round {rnd} {sid} raw")
        for i in range(n):
            sid = f"s{i}"
            done = (cursor[i] >= len(pieces[i])) if i < 4 else cursor[i] >= 128
            if sid in port and done and rng.random() < 0.5:
                _assert_closed(ref.close(sid), port.close(sid), sid)
        assert ref.capacity == port.capacity, rnd
    for sid in port.session_ids():
        _assert_closed(ref.close(sid), port.close(sid), sid)
    for key in ("opened", "closed", "grows", "shrinks", "symbols_out",
                "frames_out", "points_in", "steps", "bytes_in", "bytes_out"):
        assert ref.totals[key] == port.totals[key], key
    assert port.totals["grows"] >= 1 and port.capacity >= 2


@needs_jax
def test_pieces_arrival_longer_than_window_cap():
    """An arrival of more pieces than ``window_cap`` splits into rounds; an
    arrival of none still advances the clock; ``wire_bytes`` is what the
    books count when given."""
    rng = np.random.default_rng(83)
    ts = make_stream(rng, 400, "walk")
    frames = _piece_frames(ts, [200, 200])
    ref, port = _servers(max_sessions=2, window_cap=8)
    for srv in (ref, port):
        srv.open("s")
    arrivals = [
        {"endpoints": frames[0][0], "steps": frames[0][1],
         "t_seen": frames[0][2], "t0": float(ts[0])},
        {"endpoints": [], "steps": [], "t_seen": frames[0][2] + 5,
         "t0": float(ts[0]), "wire_bytes": 12.0},
        *({"endpoints": f[0], "steps": f[1], "t_seen": f[2],
           "t0": float(ts[0])} for f in frames[1:]),
    ]
    assert len(frames[0][0]) > 8
    for j, arr in enumerate(arrivals):
        a = ref.ingest_pieces_many({"s": arr})["s"]
        b = port.ingest_pieces_many({"s": arr})["s"]
        _assert_delta(a, b, f"arrival {j}")
        assert ref.session_stats("s") == port.session_stats("s")
    _assert_closed(ref.close("s"), port.close("s"), "close")
    for k in ("points_in", "bytes_in", "steps", "symbols_out", "frames_out"):
        assert ref.totals[k] == port.totals[k], k


# ------------------------------------- the port against its own encode


T_LENS = (96, 128, 160)
CHUNKS = (17, 32, 48)


def stream_encode(ts, key, chunk_len, cadence, reconstruct=False):
    """Feed ``ts`` through ``symed_receive_chunk`` in ``chunk_len``
    windows, digitizing every ``cadence`` windows, and close."""
    state = None
    for c in range(0, ts.shape[-1], chunk_len):
        state, _ = ts_.symed_receive_chunk(
            ts[c: c + chunk_len], CFG, state, key, digitize_every_k=cadence,
            device="cpu")
    return ts_.symed_receive_finish(
        state, CFG, torch.from_numpy(ts) if reconstruct else None,
        reconstruct)


def _encode(ts, key, reconstruct=False):
    return ts_.symed_encode(ts, CFG, key, reconstruct=reconstruct,
                            device="cpu")


def assert_outputs_equal(a, b, ctx=""):
    assert set(a) == set(b), (ctx, set(a) ^ set(b))
    for name in a:
        assert torch.equal(a[name], b[name]), f"{ctx}: {name}"


class TestStreamingEquivalence:
    @pytest.mark.parametrize("t_len,chunk_len,cadence,seed", [
        (96, 17, 1, 0), (128, 32, 2, 1), (160, 48, 3, 2), (128, 17, 4, 3),
        (160, 32, 1, 1)])
    def test_bitwise_equals_whole_stream(self, t_len, chunk_len, cadence,
                                         seed):
        rng = np.random.default_rng(1000 + seed)
        ts = make_stream(rng, t_len)
        key = prng.key(seed)
        assert_outputs_equal(
            _encode(ts, key), stream_encode(ts, key, chunk_len, cadence),
            f"T={t_len} C={chunk_len} k={cadence} seed={seed}")

    @pytest.mark.parametrize("chunk_len,seed", [(17, 0), (32, 1), (48, 2)])
    def test_bitwise_equals_symed_finish(self, chunk_len, seed):
        ts = make_stream(np.random.default_rng(2000 + seed), 128)
        key = prng.key(seed)
        state, parts = None, []
        for c in range(0, 128, chunk_len):
            state, ev = ts_.symed_encode_chunk(ts[c: c + chunk_len], CFG,
                                               state, device="cpu")
            parts.append(ev)
        events = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        finish = ts_.symed_finish(events, state, CFG, key, ts,
                                  reconstruct=False, device="cpu")
        assert_outputs_equal(finish, stream_encode(ts, key, chunk_len, 1),
                             f"C={chunk_len} seed={seed}")

    @pytest.mark.parametrize("t_len,chunk_len", [(96, 48), (160, 17)])
    def test_cadence_invariance(self, t_len, chunk_len):
        ts = make_stream(np.random.default_rng(t_len * 31 + chunk_len), t_len)
        key = prng.key(1)
        ref = stream_encode(ts, key, chunk_len, 1)
        for cadence in (2, 3):
            assert_outputs_equal(
                ref, stream_encode(ts, key, chunk_len, cadence),
                f"k={cadence}")
        state = None
        for c in range(0, t_len, chunk_len):
            state, _ = ts_.symed_step_chunk(ts[c: c + chunk_len], CFG, state,
                                            key, device="cpu")
        assert_outputs_equal(ref, ts_.symed_receive_finish(state, CFG),
                             "step_chunk+finish")

    def test_reconstruct_bitwise_equal(self, rng):
        ts = make_stream(rng, 160)
        key = prng.key(5)
        assert_outputs_equal(_encode(ts, key, reconstruct=True),
                             stream_encode(ts, key, 48, 2, reconstruct=True),
                             "reconstruct")

    def test_online_symbols_stream_out_incrementally(self, rng):
        ts = make_stream(rng, 160)
        key = prng.key(9)
        ref_online = _encode(ts, key)["symbols_online"].numpy()
        state, seen = None, 0
        for c in range(0, 160, 32):
            state, info = ts_.symed_receive_chunk(
                ts[c: c + 32], CFG, state, key, digitize_every_k=1,
                device="cpu")
            n_dig = int(info["n_digitized"])
            assert n_dig >= seen, "digitized count must be monotone"
            assert n_dig == int(info["n_pieces"]), "k=1 leaves no backlog"
            np.testing.assert_array_equal(
                info["symbols_online"].numpy()[:n_dig], ref_online[:n_dig],
                err_msg=f"prefix after window ending at {c + 32}")
            seen = n_dig
        out = ts_.symed_receive_finish(state, CFG)
        assert int(out["n_pieces"]) >= seen

    def test_open_stream_requires_key(self):
        with pytest.raises(ValueError, match="requires a PRNG key"):
            ts_.symed_receive_chunk(np.zeros(8), CFG, None, None,
                                    device="cpu")

    def test_negative_cadence_rejected(self):
        with pytest.raises(ValueError, match="digitize_every_k"):
            ts_.symed_receive_chunk(np.zeros(8), CFG, None, prng.key(0),
                                    digitize_every_k=-1, device="cpu")

    def test_reconstruct_requires_stream(self, rng):
        ts = make_stream(rng, 64)
        state, _ = ts_.symed_receive_chunk(ts, CFG, None, prng.key(0),
                                           device="cpu")
        with pytest.raises(ValueError, match="requires the raw stream"):
            ts_.symed_receive_finish(state, CFG, None, reconstruct=True)

    def test_table_streaming_matches_single(self, rng):
        """A slab through the session table (the port's batched receiver)
        ends where each stream's one-shot encode ends."""
        slab = np.stack([make_stream(rng, 128) for _ in range(3)])
        keys = prng.split(prng.key(2), 3)
        table = ts_.receiver_init(CFG, keys)
        for c in range(0, 128, 32):
            table, _ = ts_.symed_receive_masked_chunk_table(
                torch.from_numpy(slab[:, c: c + 32]),
                torch.full((3,), 32, dtype=torch.int32), CFG, table,
                digitize_every_k=2)
        out = ts_.symed_receive_finish(table, CFG)
        for i in range(3):
            single = _encode(slab[i], keys[i])
            for name in ("symbols", "symbols_online", "centers", "n_pieces",
                         "k", "cr"):
                assert torch.equal(out[name][i], single[name]), (i, name)


# ---------------- the pieces and min_slots cases of the service battery


def _wire_endpoints(ts):
    ev = compress_stream(torch.from_numpy(ts), tol=CFG.tol,
                         len_max=CFG.len_max, alpha=CFG.alpha)
    eps = list(ev["endpoint"][ev["emit"]].numpy())
    if bool(ev["tail"].emit):
        eps.append(float(ev["tail"].endpoint))
    return np.asarray(eps, np.float32)


def _matches_encode(res, deltas, ts, key, ctx):
    whole = _encode(ts, key)
    n = int(whole["n_pieces"])
    labels = np.concatenate([d["labels"] for d in deltas]
                            + [res["delta"]["labels"]])
    endpoints = np.concatenate([d["endpoints"] for d in deltas]
                               + [res["delta"]["endpoints"]])
    np.testing.assert_array_equal(labels, whole["symbols_online"][:n].numpy(),
                                  err_msg=f"{ctx}: delta labels")
    np.testing.assert_array_equal(endpoints, _wire_endpoints(ts),
                                  err_msg=f"{ctx}: delta endpoints")
    for name, val in whole.items():
        np.testing.assert_array_equal(res["out"][name], val.numpy(),
                                      err_msg=f"{ctx}: {name}")


class TestServiceBattery:
    def test_autoscale_validation(self):
        for bad in (8, 0):
            with pytest.raises(ValueError, match="min_slots"):
                StreamServer(CFG, max_sessions=4, min_slots=bad, device="cpu")

    def test_autoscale_floor(self):
        """The ladder starts at ``min_slots`` and shrinking stops there."""
        rng = np.random.default_rng(84)
        server = StreamServer(CFG, max_sessions=8, window_cap=WINDOW_CAP,
                              autoscale=True, min_slots=2, shrink_patience=1,
                              device="cpu")
        assert server.capacity == 2 and server._ladder == [2, 4, 8]
        for i in range(5):
            server.open(f"s{i}")
            server.ingest(f"s{i}", make_stream(rng, 16))
        assert server.capacity == 8 and server.totals["grows"] == 2
        for i in range(5):
            server.close(f"s{i}")
        assert server.capacity == 2 and server.totals["shrinks"] == 2

    def test_pieces_ingest_matches_raw_ingest(self, rng):
        """``ingest_pieces_many`` fed the sender's own piece tuples gives
        the raw-in ingest's outputs."""
        ts = make_stream(rng, 128)
        key = prng.key(21)
        raw = StreamServer(CFG, max_sessions=2, window_cap=WINDOW_CAP,
                           device="cpu")
        raw.open("s", key=key)
        deltas_raw, pos = [], 0
        while pos < 128:
            n = int(rng.integers(1, 49))
            deltas_raw.append(raw.ingest("s", ts[pos: pos + n]))
            pos += n
        res_raw = raw.close("s")

        pcs = StreamServer(CFG, max_sessions=2, window_cap=WINDOW_CAP,
                           device="cpu")
        pcs.open("s", key=key)
        deltas, state, off = [], None, 0
        for c in range(0, 128, 32):
            w = ts[c: c + 32]
            state, ev = ts_.symed_encode_chunk(w, CFG, state, device="cpu")
            eps, steps = pieces_on_wire(ev, off)
            off += len(w)
            deltas.append(pcs.ingest_pieces_many({"s": {
                "endpoints": eps, "steps": steps, "t_seen": off,
                "t0": float(ts[0])}})["s"])
        tail = compressor_finalize(state)
        if bool(tail.emit):
            deltas.append(pcs.ingest_pieces_many({"s": {
                "endpoints": [float(tail.endpoint)], "steps": [off],
                "t_seen": off, "t0": float(ts[0])}})["s"])
        res_pcs = pcs.close("s")
        _matches_encode(res_pcs, deltas, ts, key, "pieces-in")
        _matches_encode(res_raw, deltas_raw, ts, key, "raw-in")
        for name in res_raw["out"]:
            if name == "symbol_delta":
                continue  # the tail is digitized at its ingest, not at close
            np.testing.assert_array_equal(res_pcs["out"][name],
                                          res_raw["out"][name], err_msg=name)
        assert pcs.totals["points_in"] == raw.totals["points_in"] == 128
        assert pcs.totals["bytes_in"] < raw.totals["bytes_in"]


@pytest.mark.cuda
def test_pieces_table_kernel_against_plain_on_cuda():
    """On the card, the pieces-in table step with the Lloyd kernel against
    the plain k-means: wire buffers bitwise, at least 99% of symbols."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU")
    from repro_torch.kernels.kmeans import kmeans_lloyd_cuda

    name = torch.cuda.get_device_name()
    cfg = ts_.SymEDConfig(tol=0.5, alpha=0.01, scl=1.0, k_min=3, k_max=100,
                          n_max=512, len_max=512)
    rng = np.random.default_rng(85)
    s, t_len = 16, 1024
    streams = [make_stream(rng, t_len, ("mixed", "walk", "sine")[i % 3])
               for i in range(s)]
    frames = [_piece_frames(t, [64] * (t_len // 64), cfg) for t in streams]
    keys = prng.split(prng.key(3, "cuda"), s)
    tables = {k: ts_.receiver_init(cfg, keys) for k in (True, False)}
    before = kmeans_lloyd_cuda.launches
    for j in range(max(len(f) for f in frames)):
        pe = np.zeros((s, 64), np.float32)
        ps = np.zeros((s, 64), np.int32)
        n_valid = np.zeros(s, np.int32)
        t_seen = np.zeros(s, np.int32)
        for i, fr in enumerate(frames):
            if j < len(fr):
                pe[i], ps[i] = _padded(fr[j], 64)
                n_valid[i], t_seen[i] = len(fr[j][0]), fr[j][2]
        hello = np.asarray([t[0] for t in streams], np.float32)
        args = [torch.from_numpy(a).cuda()
                for a in (pe, ps, n_valid, hello, t_seen)]
        for use_kernel in (True, False):
            tables[use_kernel], _ = ts_.symed_receive_masked_pieces_table(
                *args, cfg, tables[use_kernel], use_kernel=use_kernel)
    assert kmeans_lloyd_cuda.launches > before, name
    a, b = tables[True], tables[False]
    for leaf in ("endpoints", "steps", "n_pieces", "t0", "t_seen", "chunks"):
        assert torch.equal(getattr(a, leaf), getattr(b, leaf)), (name, leaf)
    assert torch.equal(a.dig.n, b.dig.n), name
    live = torch.arange(cfg.n_max, device="cuda")[None] < a.n_pieces[:, None]
    agree = int(((a.symbols_online == b.symbols_online) & live).sum())
    total = int(live.sum())
    assert agree >= 0.99 * total, f"{name}: symbols {agree}/{total}"
