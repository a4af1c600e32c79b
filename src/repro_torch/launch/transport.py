"""Sender->receiver wire transport: the paper's deployment, on real sockets.

Port of ``repro.launch.transport``.  A ``SenderClient`` is the paper's
low-powered sender: in pieces mode it runs the O(1) compressor itself
(``symed_encode_chunk``) and ships only finished piece tuples; in raw mode
it ships the raw windows and the edge runs the compressor.  A
``TransportServer`` is the edge receiver's front door: a ``select`` loop
that decodes the frames of many interleaved sessions, batches each tick's
DATA into one ``StreamServer.ingest_many`` and one ``ingest_pieces_many``
call, and sends the symbol-delta frames back on the same socket.

Wire format (all integers big-endian), byte for byte the reference's:

    frame   := u32 body_len, body
    body    := u8 type, u8 sid_len, sid bytes, payload

    type  payload                                           direction
    ----  ------------------------------------------------  ---------
    OPEN    u8 mode (0 raw / 1 pieces), u32 digitizer seed  sender ->
    DATA    raw:    u32 n, n x f32 raw points               sender ->
            pieces: f32 t0 hello, u32 t_seen, u32 n,
                    n x (f32 endpoint + u32 arrival step)   sender ->
    CLOSE   u32 t_seen, u8 has_tail [, f32 tail endpoint]   sender ->
    DELTA   symbol-delta frame: u32 n, n x (u8 label +
            f32 endpoint)  -- ``receiver.pack_delta_frame``  <- receiver
    CLOSED  u32 n_pieces, u32 t_seen, u8 evicted,
            closing DELTA payload                            <- receiver
    ERROR   utf-8 message                                    <- receiver

The transport records into the wrapped ``StreamServer``'s flight recorder
(``repro_torch.obs``), with the reference's series: frames in by type,
socket bytes in and out, sessions closed, decode and route latency, and
the ``transport.decode`` / ``transport.route`` spans.  The serve thread
records with host-side integer stores and host clock reads, no locks.

Threads and the card: the thread that runs ``TransportServer.serve`` issues
every operation on the slot table; a ``SenderClient`` in the same process
issues only its compressor's.  Both use the default CUDA stream.

CLI (``--serve`` and ``--send`` are the two halves as separate processes;
with neither, an in-process loopback demo; ``--serve`` takes the
recorder's ``--metrics-port``, ``--metrics-linger`` and ``--trace-out``):

    PYTHONPATH=src python -m repro_torch.launch.transport --serve \
        --port 7543 --autoscale --min-slots 2 --max-slots 16 \
        --expect-sessions 8 --pretrace --trace-out serve.json --device cpu
    PYTHONPATH=src python -m repro_torch.launch.transport --send \
        --port 7543 --streams 8 --length 192 --mode pieces --verify \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.transport --device cpu
"""
from __future__ import annotations

import argparse
import select
import socket
import struct
import sys
import time
import zlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core.receiver import (
    PIECE_TUPLE_BYTES, pack_delta_frame, pack_piece_tuples,
    unpack_delta_frame, unpack_piece_tuples,
)

__all__ = [
    "OPEN", "DATA", "CLOSE", "DELTA", "CLOSED", "ERROR",
    "Frame", "FrameDecoder", "SenderClient", "TransportServer",
    "encode_open", "encode_data_raw", "encode_data_pieces", "encode_close",
    "encode_delta", "encode_closed", "encode_error", "session_seed", "main",
]

OPEN, DATA, CLOSE, DELTA, CLOSED, ERROR = 1, 2, 3, 4, 5, 6
MODE_RAW, MODE_PIECES = 0, 1
MAX_FRAME = 1 << 22  # 4 MiB: a decoder guard against garbage length prefixes


class Frame(NamedTuple):
    type: int
    sid: str
    payload: bytes


def _frame(ftype: int, sid: str, payload: bytes = b"") -> bytes:
    sid_b = sid.encode("utf-8")
    if len(sid_b) > 255:
        raise ValueError(f"session id too long ({len(sid_b)} bytes)")
    body = struct.pack("!BB", ftype, len(sid_b)) + sid_b + payload
    return struct.pack("!I", len(body)) + body


def encode_open(sid: str, mode: int, seed: int) -> bytes:
    return _frame(OPEN, sid, struct.pack("!BI", mode, seed & 0xFFFFFFFF))


def encode_data_raw(sid: str, window) -> bytes:
    w = np.asarray(window, np.float32).reshape(-1)
    return _frame(
        DATA, sid, struct.pack("!I", w.shape[0]) + w.astype(">f4").tobytes())


def encode_data_pieces(sid: str, t0: float, t_seen: int, endpoints,
                       steps) -> bytes:
    endpoints = np.asarray(endpoints, np.float32).reshape(-1)
    head = struct.pack("!fII", t0, t_seen, endpoints.shape[0])
    return _frame(DATA, sid, head + pack_piece_tuples(endpoints, steps))


def encode_close(sid: str, t_seen: int = 0,
                 tail_endpoint: Optional[float] = None) -> bytes:
    payload = struct.pack("!IB", t_seen, tail_endpoint is not None)
    if tail_endpoint is not None:
        payload += struct.pack("!f", tail_endpoint)
    return _frame(CLOSE, sid, payload)


def encode_delta(sid: str, labels, endpoints) -> bytes:
    return _frame(DELTA, sid, pack_delta_frame(labels, endpoints))


def encode_closed(sid: str, n_pieces: int, t_seen: int, evicted: bool,
                  labels, endpoints) -> bytes:
    head = struct.pack("!IIB", n_pieces, t_seen, bool(evicted))
    return _frame(CLOSED, sid, head + pack_delta_frame(labels, endpoints))


def encode_error(sid: str, message: str) -> bytes:
    return _frame(ERROR, sid, message.encode("utf-8"))


class FrameDecoder:
    """Incremental frame decoder: feed arbitrary byte slices, get frames.

    A frame may arrive split across any number of ``recv`` calls and one
    ``recv`` may carry many frames; the decoder buffers until a length
    prefix and its body are complete, then yields ``Frame(type, sid,
    payload)``.
    """

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[Frame]:
        self._buf.extend(data)
        frames = []
        while True:
            if len(self._buf) < 4:
                return frames
            (body_len,) = struct.unpack_from("!I", self._buf)
            if body_len < 2 or body_len > MAX_FRAME:
                raise ValueError(f"bad frame length {body_len}")
            if len(self._buf) < 4 + body_len:
                return frames
            body = bytes(self._buf[4: 4 + body_len])
            del self._buf[: 4 + body_len]
            ftype, sid_len = struct.unpack_from("!BB", body)
            if 2 + sid_len > len(body):
                raise ValueError("frame shorter than its session id")
            sid = body[2: 2 + sid_len].decode("utf-8")
            frames.append(Frame(ftype, sid, body[2 + sid_len:]))


def decode_open(payload: bytes) -> Tuple[int, int]:
    mode, seed = struct.unpack_from("!BI", payload)
    return mode, seed


def decode_data_raw(payload: bytes) -> np.ndarray:
    (n,) = struct.unpack_from("!I", payload)
    return np.frombuffer(payload, ">f4", count=n, offset=4).astype(np.float32)


def decode_data_pieces(payload: bytes):
    t0, t_seen, n = struct.unpack_from("!fII", payload)
    endpoints, steps = unpack_piece_tuples(payload[12:], n)
    return t0, t_seen, endpoints, steps


def decode_close(payload: bytes):
    t_seen, has_tail = struct.unpack_from("!IB", payload)
    tail = struct.unpack_from("!f", payload, 5)[0] if has_tail else None
    return t_seen, tail


def decode_closed(payload: bytes):
    n_pieces, t_seen, evicted = struct.unpack_from("!IIB", payload)
    labels, endpoints = unpack_delta_frame(payload[9:])
    return {"n_pieces": n_pieces, "t_seen": t_seen, "evicted": bool(evicted),
            "labels": labels, "endpoints": endpoints}


def session_seed(sid: str, base_seed: int) -> int:
    """Deterministic per-session digitizer seed both halves can derive."""
    return (zlib.crc32(sid.encode("utf-8")) ^ base_seed) & 0xFFFFFFFF


# --------------------------------------------------------------------- sender


class _ClientSession:
    def __init__(self, sid: str, mode: int):
        self.sid = sid
        self.mode = mode
        self.state = None          # pieces mode: the sender's CompressorState
        self.t0 = 0.0
        self.t_seen = 0
        self.payload_bytes = 0.0   # outbound payload bytes (sans framing)
        self.deltas: List[Tuple[np.ndarray, np.ndarray]] = []
        self.result: Optional[dict] = None


class SenderClient:
    """The paper's sender, speaking the transport's wire format.

    ``mode="pieces"`` runs the O(1) compressor locally (``symed_encode_chunk``
    per window, then ``pieces_on_wire``; ``compressor_finalize`` at close)
    and ships only finished piece tuples; ``mode="raw"`` ships the raw f32
    windows.  Several sessions may interleave over the one connection.
    Inbound DELTA frames are collected per session (``delta_concat`` joins
    them); ``close`` blocks until the receiver's CLOSED frame arrives and
    returns its summary.  ``device``: where the compressor runs, ``cuda``
    unless ``"cpu"`` is passed (``repro_torch.resolve_device``).
    """

    def __init__(self, host: str, port: int, cfg, mode: str = "pieces",
                 connect_timeout: float = 60.0, reply_timeout: float = 300.0,
                 device=None):
        from repro_torch import resolve_device

        if mode not in ("raw", "pieces"):
            raise ValueError(f"mode must be 'raw' or 'pieces', got {mode!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mode = MODE_PIECES if mode == "pieces" else MODE_RAW
        self.reply_timeout = float(reply_timeout)
        self._decoder = FrameDecoder()
        self._sessions: Dict[str, _ClientSession] = {}
        self.sock = self._connect(host, port, connect_timeout)

    @staticmethod
    def _connect(host, port, timeout):
        deadline = time.monotonic() + timeout
        while True:
            try:
                sock = socket.create_connection((host, port), timeout=30.0)
                sock.settimeout(None)  # reads go through select
                return sock
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.25)

    def open(self, sid: str, seed: int,
             mode: Optional[str] = None) -> None:
        """Open ``sid``; ``mode`` overrides the client default per session
        (mixed raw/pieces fleets share one socket, keeping frame order)."""
        if sid in self._sessions:
            raise ValueError(f"session {sid!r} is already open")
        if mode is None:
            mode_int = self.mode
        elif mode in ("raw", "pieces"):
            mode_int = MODE_PIECES if mode == "pieces" else MODE_RAW
        else:
            raise ValueError(f"mode must be 'raw' or 'pieces', got {mode!r}")
        self._sessions[sid] = _ClientSession(sid, mode_int)
        self.sock.sendall(encode_open(sid, mode_int, seed))

    def settled(self, sid: str) -> bool:
        """True once the receiver closed ``sid`` (CLOSED arrived -- clean
        or evicted); further sends for it would be dropped server-side."""
        self._drain(block=False)
        sess = self._sessions.get(sid)
        return sess is not None and sess.result is not None

    def send(self, sid: str, window) -> None:
        """Ship one window; pieces mode compresses it locally first."""
        sess = self._sessions[sid]
        window = np.asarray(window, np.float32).reshape(-1)
        if not len(window):
            return
        if sess.mode == MODE_RAW:
            frame = encode_data_raw(sid, window)
            sess.t_seen += len(window)
            sess.payload_bytes += 4 + 4.0 * len(window)
        else:
            from repro_torch.core.compress import pieces_on_wire
            from repro_torch.core.symed import symed_encode_chunk

            if sess.state is None:
                sess.t0 = float(window[0])
            sess.state, events = symed_encode_chunk(
                window, self.cfg, sess.state, device=self.device)
            endpoints, steps = pieces_on_wire(events, sess.t_seen)
            sess.t_seen += len(window)
            frame = encode_data_pieces(
                sid, sess.t0, sess.t_seen, endpoints, steps)
            sess.payload_bytes += 12 + PIECE_TUPLE_BYTES * len(endpoints)
        self.sock.sendall(frame)
        self._drain(block=False)

    def close(self, sid: str) -> dict:
        """Flush (pieces mode ships the sender's tail), await CLOSED.

        If the receiver already settled the session -- LRU eviction delivers
        an unsolicited CLOSED with the evicted flag -- the parked result is
        returned without sending a CLOSE for the dropped session id.
        """
        sess = self._sessions[sid]
        self._drain(block=False)
        if sess.result is not None:
            return sess.result
        tail_endpoint = None
        if sess.mode == MODE_PIECES and sess.state is not None:
            from repro_torch.core.compress import compressor_finalize

            tail = compressor_finalize(sess.state)
            if bool(tail.emit):
                tail_endpoint = float(tail.endpoint)
        self.sock.sendall(encode_close(sid, sess.t_seen, tail_endpoint))
        sess.payload_bytes += 5 + (4 if tail_endpoint is not None else 0)
        while sess.result is None:
            self._drain(block=True)
        return sess.result

    def delta_concat(self, sid: str) -> Tuple[np.ndarray, np.ndarray]:
        """All DELTA frames plus the CLOSED closing frame, concatenated."""
        sess = self._sessions[sid]
        parts = list(sess.deltas)
        if sess.result is not None:
            parts.append((sess.result["labels"], sess.result["endpoints"]))
        if not parts:
            return np.zeros((0,), np.int32), np.zeros((0,), np.float32)
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    @property
    def payload_bytes(self) -> float:
        return sum(s.payload_bytes for s in self._sessions.values())

    def shutdown(self) -> None:
        self.sock.close()

    def _drain(self, block: bool) -> None:
        """Read whatever the receiver sent; ``block`` waits for one read.

        The blocking caller (``close``) re-checks its own condition and
        loops, so one successful read per call is enough.
        """
        while True:
            r, _, _ = select.select(
                [self.sock], [], [], self.reply_timeout if block else 0.0)
            if not r:
                if block:
                    raise TimeoutError(
                        f"no frame from receiver within {self.reply_timeout}s")
                return
            data = self.sock.recv(1 << 16)
            if not data:
                raise ConnectionError("receiver closed the connection")
            for frame in self._decoder.feed(data):
                self._dispatch(frame)
            if block:
                return

    def _dispatch(self, frame: Frame) -> None:
        sess = self._sessions.get(frame.sid)
        if frame.type == ERROR:
            if sess is not None and sess.result is not None:
                return  # stale: the session settled (e.g. evicted) while
                        # our frame for it was in flight
            raise RuntimeError(
                f"receiver error for {frame.sid!r}: "
                f"{frame.payload.decode('utf-8', 'replace')}")
        if sess is None:
            return
        if frame.type == DELTA:
            sess.deltas.append(unpack_delta_frame(frame.payload))
        elif frame.type == CLOSED:
            sess.result = decode_closed(frame.payload)


# --------------------------------------------------------------------- server


class _WireSession:
    def __init__(self, sid: str, mode: int, conn):
        self.sid = sid
        self.mode = mode
        self.conn = conn


class TransportServer:
    """Socket loop in front of the port's ``StreamServer``.

    Single-threaded ``select`` loop: each tick reads every readable
    connection, decodes complete frames, then batches all staged DATA --
    across connections and sessions -- into at most one ``ingest_many`` and
    one ``ingest_pieces_many`` call, routes the resulting DELTA frames back
    to the owning sockets, and finally processes CLOSEs (so a session's
    deltas always precede its CLOSED frame).  Session keys are
    ``prng.key(seed)`` of the OPEN frame's seed, bit for bit the
    reference's ``jax.random.key(seed)``.  Slot-table autoscaling, LRU
    eviction and the digitize cadence are whatever the wrapped
    ``StreamServer`` was built with; an evicted session's connection
    receives CLOSED with the evicted flag set.  A malformed payload drops
    its connection (after an ERROR frame), not the server.
    """

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0):
        self.server = server
        self.listener = socket.create_server((host, port))
        self.host, self.port = self.listener.getsockname()[:2]
        self._conns: Dict[socket.socket, FrameDecoder] = {}
        self._wire: Dict[str, _WireSession] = {}
        self.closed_sessions = 0
        self.frame_bytes = 0.0      # total socket bytes in (incl. framing)
        self.payload_bytes = {MODE_RAW: 0.0, MODE_PIECES: 0.0}
        self.raw_equiv_bytes = {MODE_RAW: 0.0, MODE_PIECES: 0.0}
        self._register_metrics()

    def _register_metrics(self) -> None:
        """Record into the wrapped ``StreamServer``'s flight recorder, so one
        scrape covers the socket tier and the slot table together.

        Socket totals already tracked on ``self`` become scrape-time callback
        series (zero loop cost); per-frame/decode signals are live counters
        and histograms recorded in ``_tick``/``_process``.
        """
        from repro_torch.obs import disabled

        self._obs = getattr(self.server, "obs", None) or disabled()
        self._obs_on = self._obs.enabled
        m = self._obs.metrics
        self._h_decode = m.histogram(
            "transport_decode_seconds",
            "per-recv frame decode latency", unit="ns")
        self._h_route = m.histogram(
            "transport_route_seconds",
            "per-batch frame handling: stage + ingest + reply", unit="ns")
        self._m_frames = {
            ftype: m.counter("transport_frames_in_total", "frames received",
                             labels={"type": name})
            for ftype, name in ((OPEN, "open"), (DATA, "data"),
                                (CLOSE, "close"))
        }
        self._m_frames_other = m.counter(
            "transport_frames_in_total", "frames received",
            labels={"type": "other"})
        self._m_tx = m.counter("transport_tx_bytes_total",
                               "bytes written back to senders")
        self._m_proto_errors = m.counter(
            "transport_protocol_errors_total",
            "malformed frames / payloads rejected")
        self._m_drops = m.counter(
            "transport_conn_drops_total",
            "connections dropped (EOF, errors, protocol violations)")
        if not self._obs_on:
            return
        m.counter_fn("transport_rx_bytes_total",
                     "socket bytes received (incl. framing)",
                     lambda: float(self.frame_bytes))
        m.counter_fn("transport_payload_bytes_total", "payload bytes by mode",
                     lambda: float(self.payload_bytes[MODE_RAW]),
                     labels={"mode": "raw"})
        m.counter_fn("transport_payload_bytes_total", "payload bytes by mode",
                     lambda: float(self.payload_bytes[MODE_PIECES]),
                     labels={"mode": "pieces"})
        m.counter_fn("transport_sessions_closed_total",
                     "sessions closed over the wire",
                     lambda: float(self.closed_sessions))
        m.gauge_fn("transport_open_connections", "live sender sockets",
                   lambda: float(len(self._conns)))

    def serve(self, expect_sessions: Optional[int] = None,
              stop=None, poll: float = 0.05) -> None:
        """Run until ``expect_sessions`` sessions closed (or ``stop`` set)."""
        try:
            while True:
                if stop is not None and stop.is_set():
                    return
                if (expect_sessions is not None
                        and self.closed_sessions >= expect_sessions):
                    return
                self._tick(poll)
        finally:
            if expect_sessions is not None or (
                    stop is not None and stop.is_set()):
                self.shutdown()

    def shutdown(self) -> None:
        for conn in list(self._conns):
            conn.close()
        self._conns.clear()
        self.listener.close()

    # ------------------------------------------------------------ internals

    def _tick(self, poll: float) -> None:
        rlist, _, _ = select.select(
            [self.listener, *self._conns], [], [], poll)
        staged: List[Tuple[socket.socket, Frame]] = []
        for sock_ in rlist:
            if sock_ is self.listener:
                conn, _ = self.listener.accept()
                self._conns[conn] = FrameDecoder()
                continue
            try:
                data = sock_.recv(1 << 16)
            except OSError:
                data = b""
            if not data:
                self._drop_conn(sock_)
                continue
            self.frame_bytes += len(data)
            t_dec = time.perf_counter_ns() if self._obs_on else 0
            try:
                frames = self._conns[sock_].feed(data)
            except ValueError as e:
                self._m_proto_errors.inc()
                try:
                    sock_.sendall(encode_error("", f"protocol error: {e}"))
                except OSError:
                    pass
                self._drop_conn(sock_)
                continue
            if self._obs_on:
                self._h_decode.observe(time.perf_counter_ns() - t_dec)
                self._obs.tracer.add(
                    "transport.decode", t_dec,
                    {"bytes": len(data), "frames": len(frames)})
                for f in frames:
                    (self._m_frames.get(f.type) or self._m_frames_other).inc()
            staged.extend((sock_, f) for f in frames)
        if staged:
            self._process(staged)

    def _drop_conn(self, conn) -> None:
        """A vanished sender abandons its sessions: close them server-side."""
        conn.close()
        if self._conns.pop(conn, None) is not None:
            self._m_drops.inc()
        for sid in [s for s, w in self._wire.items() if w.conn is conn]:
            del self._wire[sid]
            if sid in self.server:
                self.server.close(sid)
                self.closed_sessions += 1

    def _reply(self, conn, data: bytes) -> None:
        try:
            conn.sendall(data)
            self._m_tx.inc(len(data))
        except OSError:
            self._drop_conn(conn)

    def _process(self, staged) -> None:
        t_route = time.perf_counter_ns() if self._obs_on else 0
        raw_batch: Dict[str, list] = {}
        pieces_batch: Dict[str, dict] = {}
        closes: List[str] = []
        for conn, frame in staged:
            try:
                self._handle_frame(conn, frame, raw_batch, pieces_batch,
                                   closes)
            except (struct.error, ValueError, IndexError) as e:
                # a well-framed body with garbage inside must not take the
                # serve loop (and every other tenant) down -- the offending
                # connection is dropped, its sessions closed server-side
                self._m_proto_errors.inc()
                self._reply(conn, encode_error(
                    frame.sid, f"malformed frame payload: {e}"))
                self._drop_conn(conn)
        self._flush(raw_batch, pieces_batch, closes)
        if self._obs_on:
            self._h_route.observe(time.perf_counter_ns() - t_route)
            self._obs.tracer.add("transport.route", t_route,
                                 {"frames": len(staged)})

    def _handle_frame(self, conn, frame: Frame, raw_batch, pieces_batch,
                      closes) -> None:
        from repro_torch.core import prng

        sid = frame.sid
        if frame.type == OPEN:
            mode, seed = decode_open(frame.payload)
            if sid in self._wire or sid in self.server:
                self._reply(conn, encode_error(sid, "already open"))
                return
            before = set(self.server.evicted)
            try:
                self.server.open(sid, key=prng.key(seed))
            except RuntimeError as e:  # table full, eviction disabled
                self._reply(conn, encode_error(sid, str(e)))
                return
            self._wire[sid] = _WireSession(sid, mode, conn)
            self._notify_evicted(before)
        elif frame.type == DATA:
            w = self._wire.get(sid)
            if w is None:
                self._reply(conn, encode_error(sid, "unknown session"))
                return
            if w.mode == MODE_RAW:
                window = decode_data_raw(frame.payload)
                raw_batch.setdefault(sid, []).append(window)
                self.payload_bytes[MODE_RAW] += len(frame.payload)
                self.raw_equiv_bytes[MODE_RAW] += 4.0 * len(window)
            else:
                t0, t_seen, endpoints, steps = decode_data_pieces(
                    frame.payload)
                p = pieces_batch.setdefault(sid, {
                    "endpoints": [], "steps": [], "t_seen": 0,
                    "t0": t0, "wire_bytes": 0.0,
                })
                p["endpoints"].append(endpoints)
                p["steps"].append(steps)
                prev = p["t_seen"]
                p["t_seen"] = max(p["t_seen"], t_seen)
                p["wire_bytes"] += len(frame.payload)
                self.payload_bytes[MODE_PIECES] += len(frame.payload)
                self.raw_equiv_bytes[MODE_PIECES] += 4.0 * max(
                    t_seen - max(prev, self._seen(sid)), 0)
        elif frame.type == CLOSE:
            w = self._wire.get(sid)
            if w is None:
                self._reply(conn, encode_error(sid, "unknown session"))
                return
            t_seen, tail = decode_close(frame.payload)
            self.payload_bytes[w.mode] += len(frame.payload)
            if w.mode == MODE_PIECES and tail is not None:
                p = pieces_batch.setdefault(sid, {
                    "endpoints": [], "steps": [], "t_seen": 0,
                    "t0": 0.0, "wire_bytes": 0.0,
                })
                p["endpoints"].append(np.asarray([tail], np.float32))
                p["steps"].append(np.asarray([t_seen], np.int32))
                p["t_seen"] = max(p["t_seen"], t_seen)
                p["wire_bytes"] += 4.0  # the tail's f32 endpoint
            closes.append(sid)
        else:
            self._reply(conn, encode_error(sid, "unexpected frame type"))

    def _flush(self, raw_batch, pieces_batch, closes) -> None:  # symlint-torch: hot-path
        if raw_batch:
            arrivals = {sid: np.concatenate(ws) for sid, ws in
                        raw_batch.items() if sid in self.server}
            if arrivals:
                self._route_deltas(self.server.ingest_many(arrivals))
        if pieces_batch:
            arrivals = {}
            for sid, p in pieces_batch.items():
                if sid not in self.server:
                    continue
                arrivals[sid] = {
                    "endpoints": (np.concatenate(p["endpoints"])
                                  if p["endpoints"]
                                  else np.zeros((0,), np.float32)),
                    "steps": (np.concatenate(p["steps"]) if p["steps"]
                              else np.zeros((0,), np.int32)),
                    "t_seen": p["t_seen"],
                    "t0": p["t0"],
                    "wire_bytes": p["wire_bytes"],
                }
            if arrivals:
                self._route_deltas(self.server.ingest_pieces_many(arrivals))
        for sid in closes:
            w = self._wire.pop(sid, None)
            if w is None or sid not in self.server:
                continue
            res = self.server.close(sid)
            self.closed_sessions += 1
            d = res["delta"]
            self._reply(w.conn, encode_closed(
                sid, res["n_pieces"], res["t_seen"], False,
                d["labels"], d["endpoints"]))

    def _seen(self, sid: str) -> int:
        return (self.server.session_stats(sid)["t_seen"]
                if sid in self.server else 0)

    def _route_deltas(self, deltas: Dict[str, dict]) -> None:
        for sid, d in deltas.items():
            w = self._wire.get(sid)
            if w is not None and d["frames"]:
                self._reply(w.conn, encode_delta(
                    sid, d["labels"], d["endpoints"]))

    def _notify_evicted(self, before) -> None:
        for sid in set(self.server.evicted) - before:
            w = self._wire.pop(sid, None)
            if w is None:
                continue
            self.closed_sessions += 1
            res = self.server.evicted[sid]
            d = res["delta"]
            self._reply(w.conn, encode_closed(
                sid, res["n_pieces"], res["t_seen"], True,
                d["labels"], d["endpoints"]))

    def summary(self) -> Dict[str, float]:
        """Actual-socket traffic next to the StreamServer's logical totals."""
        raw_pay, pieces_pay = (self.payload_bytes[MODE_RAW],
                               self.payload_bytes[MODE_PIECES])
        raw_eq = self.raw_equiv_bytes[MODE_RAW] + self.raw_equiv_bytes[
            MODE_PIECES]
        return {
            "sessions_closed": float(self.closed_sessions),
            "frame_bytes": self.frame_bytes,
            "payload_bytes_raw": raw_pay,
            "payload_bytes_pieces": pieces_pay,
            "raw_equiv_bytes": raw_eq,
            "pieces_ratio": pieces_pay / max(
                self.raw_equiv_bytes[MODE_PIECES], 1.0),
        }


# ------------------------------------------------------------------- CLI


def _cfg(args):
    from repro_torch.core.symed import SymEDConfig

    return SymEDConfig(tol=args.tol, alpha=args.alpha, n_max=256, k_max=32,
                       len_max=256)


def _serve_main(args) -> int:
    from repro_torch.launch.fleet import fleet_data_mesh
    from repro_torch.launch.mesh import describe_devices
    from repro_torch.launch.stream import StreamServer
    from repro_torch.obs.export import start_exporter

    mesh = (fleet_data_mesh(args.devices, device=args.device)
            if args.devices > 1 else None)
    server = StreamServer(
        _cfg(args), max_sessions=args.max_slots, window_cap=args.window,
        digitize_every_k=args.digitize_every, evict_idle=args.evict,
        autoscale=args.autoscale, min_slots=args.min_slots,
        shrink_patience=args.shrink_patience, pretrace=args.pretrace,
        seed=args.seed, mesh=mesh, device=args.device)
    transport = TransportServer(server, host=args.host, port=args.port)
    exporter = start_exporter(server.obs, args.metrics_port)
    if exporter is not None:
        print(f"metrics exporter        : {exporter.url}/metrics",
              flush=True)
    print(f"listening on {transport.host}:{transport.port} "
          f"(devices={args.devices} slots={args.max_slots}"
          f"{' autoscale' if args.autoscale else ''})", flush=True)
    print(f"shard devices           : "
          f"{describe_devices(server.block_devices)}", flush=True)
    t0 = time.perf_counter()
    transport.serve(expect_sessions=args.expect_sessions)
    rep = server.report(time.perf_counter() - t0)
    summ = transport.summary()
    if args.trace_out:
        server.obs.tracer.write(args.trace_out)
        print(f"trace written           : {args.trace_out}")
    if exporter is not None:
        if args.metrics_linger:
            print(f"metrics exporter        : lingering "
                  f"{args.metrics_linger:.0f}s for scrapes", flush=True)
            time.sleep(args.metrics_linger)
        exporter.close()
    print(f"sessions                : {int(rep['opened'])} opened, "
          f"{int(rep['closed'])} closed, {int(rep['evicted'])} evicted")
    print(f"wire in                 : {int(rep['wire_in_bytes'])} payload "
          f"bytes for {int(rep['points_in'])} points "
          f"({int(rep['raw_bytes'])} raw-equivalent)")
    print(f"wire out                : {int(rep['bytes_out'])} bytes in "
          f"{int(rep['frames_out'])} delta frames")
    print("transport_summary "
          f"sessions={int(summ['sessions_closed'])} "
          f"wire_in_bytes={int(rep['wire_in_bytes'])} "
          f"raw_bytes={int(rep['raw_bytes'])} "
          f"wire_in_ratio={rep['wire_in_ratio']:.4f} "
          f"pieces_ratio={summ['pieces_ratio']:.4f} "
          f"wire_out_bytes={int(rep['bytes_out'])} "
          f"frame_bytes={int(summ['frame_bytes'])} "
          f"capacity={int(rep['capacity'])} "
          f"grows={int(rep['grows'])} shrinks={int(rep['shrinks'])} "
          f"evicted={int(rep['evicted'])}")
    return 0


def check_deltas(sid, labels, endpoints, result, ts, cfg, seed,
                 min_agree=1.0) -> int:
    """Hold a closed session's concatenated deltas against the one-shot
    ``symed_encode`` of its stream ``ts`` (on ``ts``'s device, key
    ``prng.key(seed)``): ``n_pieces`` and the symbol count equal, the
    endpoints bitwise those of ``compress_stream`` and its tail, and at
    least ``min_agree`` of the symbols equal.  Raises ``AssertionError``
    otherwise; returns the count of equal symbols."""
    from repro_torch.core import prng
    from repro_torch.core.compress import compress_stream
    from repro_torch.core.symed import symed_encode

    ref = symed_encode(ts, cfg, prng.key(seed), reconstruct=False,
                       device=ts.device)
    n = int(ref["n_pieces"])
    if (result["n_pieces"], labels.shape[0]) != (n, n):
        raise AssertionError(f"{sid}: n_pieces {result['n_pieces']}, "
                             f"{labels.shape[0]} symbols; symed_encode: {n}")
    ev = compress_stream(ts, tol=cfg.tol, len_max=cfg.len_max,
                         alpha=cfg.alpha)
    want = list(ev["endpoint"][ev["emit"]].cpu().numpy())
    if bool(ev["tail"].emit):
        want.append(float(ev["tail"].endpoint))
    np.testing.assert_array_equal(endpoints, np.asarray(want, np.float32),
                                  err_msg=f"{sid}: delta endpoints")
    agree = int((labels == ref["symbols_online"][:n].cpu().numpy()).sum())
    if agree < min_agree * n:
        raise AssertionError(f"{sid}: delta labels, {agree}/{n} equal to "
                             f"symed_encode's")
    return agree


def _send_main(args) -> int:
    import torch

    from repro_torch.data.synthetic import make_fleet

    cfg = _cfg(args)
    data = make_fleet(args.streams, args.length, seed=args.seed)
    client = SenderClient(args.host, args.port, cfg, mode=args.mode,
                          connect_timeout=args.connect_timeout,
                          device=args.device)
    sids = [f"{args.session_prefix}-{i}" for i in range(args.streams)]
    for sid in sids:
        client.open(sid, session_seed(sid, args.seed))
    # interleaved sessions: round-robin one window per session per pass
    for c in range(0, args.length, args.window):
        for i, sid in enumerate(sids):
            client.send(sid, data[i, c: c + args.window])
    results = {sid: client.close(sid) for sid in sids}
    points = sum(r["t_seen"] for r in results.values())
    symbols = sum(r["n_pieces"] for r in results.values())
    print(f"sent {args.streams} sessions x {args.length} points "
          f"({args.mode} mode): {symbols} symbols back")
    print("sender_summary "
          f"mode={args.mode} sessions={args.streams} points={points} "
          f"payload_bytes={int(client.payload_bytes)} "
          f"raw_bytes={4 * points} "
          f"ratio={client.payload_bytes / max(4.0 * points, 1.0):.4f}")
    if args.verify:
        # the server's Lloyd kernel sums in another order than the plain
        # k-means (C2), so on the card 99% of symbols must agree, not all
        min_agree = 0.99 if client.device.type == "cuda" else 1.0
        agree = 0
        for i, sid in enumerate(sids):
            res = results[sid]
            ts = torch.from_numpy(data[i, : res["t_seen"]]).to(client.device)
            agree += check_deltas(sid, *client.delta_concat(sid), res, ts, cfg,
                                  session_seed(sid, args.seed), min_agree)
        print(f"delta_equivalence=OK sessions={args.streams} "
              f"symbols={agree}/{symbols}")
    client.shutdown()
    return 0


def _demo_main(args) -> int:
    """In-process loopback: server thread + one sender per mode."""
    import threading

    from repro_torch.launch.stream import StreamServer

    server = StreamServer(
        _cfg(args), max_sessions=args.max_slots, window_cap=args.window,
        digitize_every_k=args.digitize_every, autoscale=args.autoscale,
        min_slots=args.min_slots, seed=args.seed, device=args.device)
    transport = TransportServer(server, port=0)
    thread = threading.Thread(
        target=transport.serve, kwargs={"expect_sessions": 2 * args.streams},
        daemon=True)
    thread.start()
    print(f"loopback server on port {transport.port}")
    for mode in ("pieces", "raw"):
        send_args = argparse.Namespace(
            **{**vars(args), "mode": mode, "port": transport.port,
               "host": "127.0.0.1", "session_prefix": f"demo-{mode}",
               "verify": True})
        _send_main(send_args)
    thread.join(timeout=60)
    rep = server.report(1.0)
    summ = transport.summary()
    print(f"wire in  (pieces mode)  : {int(summ['payload_bytes_pieces'])} B "
          f"vs {int(summ['payload_bytes_raw'])} B raw mode "
          f"(pieces ratio {summ['pieces_ratio']:.3f})")
    print(f"wire out                : {int(rep['bytes_out'])} B symbol-delta "
          f"frames")
    return 0


def main(argv=None) -> int:
    from repro_torch.launch.cli import (
        add_devices_arg, add_metrics_args, add_slot_table_args,
        add_symed_args, validate_shared_args)

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    role = ap.add_mutually_exclusive_group()
    role.add_argument("--serve", action="store_true",
                      help="run the receiver socket server")
    role.add_argument("--send", action="store_true",
                      help="run a sender client")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="server port (0: OS-assigned, printed at startup)")
    ap.add_argument("--mode", default="pieces", choices=("raw", "pieces"),
                    help="sender mode: raw windows or locally-compressed "
                         "piece tuples")
    ap.add_argument("--streams", type=int, default=4,
                    help="sessions this sender interleaves")
    ap.add_argument("--length", type=int, default=256)
    ap.add_argument("--window", type=int, default=32)
    ap.add_argument("--session-prefix", default="s",
                    help="session id prefix (make unique per sender process)")
    ap.add_argument("--verify", action="store_true",
                    help="sender: check returned deltas against "
                         "symed_encode (endpoints bitwise; every symbol "
                         "with --device cpu, 99%% with cuda, whose server "
                         "digitizes with the Lloyd kernel)")
    ap.add_argument("--connect-timeout", type=float, default=120.0,
                    help="sender: retry the connect this long")
    ap.add_argument("--expect-sessions", type=int, default=None,
                    help="server: exit after this many sessions closed")
    add_slot_table_args(ap, max_slots=8)
    add_devices_arg(
        ap, help="server: table shards (host shards with --device cpu, "
                 "round-robin over the cards with cuda; >1 shards the "
                 "slot table)")
    add_symed_args(ap)
    add_metrics_args(ap)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the server's table and the sender's "
                         "compressor run")
    args = ap.parse_args(argv)
    # the reference's checks and messages, before any torch work
    validate_shared_args(ap, args)
    if args.serve:
        return _serve_main(args)
    if args.send:
        return _send_main(args)
    return _demo_main(args)


if __name__ == "__main__":
    sys.exit(main())
