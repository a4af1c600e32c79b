"""SymED wire format + receiver-side piece construction (paper Alg. 2).

Port of ``repro.core.receiver``.  The sender transmits one raw float per
finished piece (the segment endpoint) plus a one-off 4-byte "hello" carrying
t0; the receiver rebuilds ``inc_i = e_i - e_{i-1}`` (``e_{-1} = t0``) and
``len_i = step_i - step_{i-1}`` (``step_{-1} = 1``) from arrivals.

Every buffer function is batched over leading dimensions: ``endpoints`` /
``steps`` are ``(..., n_max)`` and the counters ``(...,)``.  The codecs are
host-side numpy and byte-equal to the reference's.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "DELTA_FRAME_HEADER_BYTES", "DELTA_SYMBOL_BYTES", "PIECE_TUPLE_BYTES",
    "append_tail", "compact_chunk", "compact_events", "delta_frame_bytes",
    "pack_delta_frame", "pack_piece_tuples", "pieces_from_wire",
    "unpack_delta_frame", "unpack_piece_tuples",
]

# Symbol-delta frame: a 4-byte count header plus, per newly digitized piece,
# a 1-byte label and the 4-byte raw endpoint.
DELTA_FRAME_HEADER_BYTES = 4.0
DELTA_SYMBOL_BYTES = 5.0  # 1B label + 4B endpoint

# Inbound compressed-piece tuple: 4B endpoint + 4B arrival step.
PIECE_TUPLE_BYTES = 8.0

# numpy record layouts of the two wire payloads (big-endian, packed)
_DELTA_REC = np.dtype([("label", "u1"), ("endpoint", ">f4")])
_PIECE_REC = np.dtype([("endpoint", ">f4"), ("step", ">u4")])


def delta_frame_bytes(n_new: torch.Tensor) -> torch.Tensor:
    """Wire-out bytes of one symbol-delta frame carrying ``n_new`` symbols."""
    n_new = torch.as_tensor(n_new)
    return DELTA_FRAME_HEADER_BYTES + DELTA_SYMBOL_BYTES * n_new.float()


def pack_delta_frame(labels, endpoints) -> bytes:
    """Serialize one symbol-delta frame: ``!I`` count + per-symbol record."""
    labels = np.asarray(labels)
    rec = np.empty(labels.shape[0], _DELTA_REC)
    rec["label"] = labels.astype(np.int64) % 256
    rec["endpoint"] = np.asarray(endpoints, np.float32)
    return struct.pack("!I", labels.shape[0]) + rec.tobytes()


def unpack_delta_frame(buf: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of ``pack_delta_frame``: ``(labels i32, endpoints f32)``."""
    (n,) = struct.unpack_from("!I", buf)
    rec = np.frombuffer(buf, _DELTA_REC, count=n, offset=4)
    return rec["label"].astype(np.int32), rec["endpoint"].astype(np.float32)


def pack_piece_tuples(endpoints, steps) -> bytes:
    """Serialize inbound piece tuples: per piece ``>f4`` endpoint + ``>u4``
    arrival step (no header)."""
    endpoints = np.asarray(endpoints, np.float32)
    rec = np.empty(endpoints.shape[0], _PIECE_REC)
    rec["endpoint"] = endpoints
    rec["step"] = np.asarray(steps, np.int64)
    return rec.tobytes()


def unpack_piece_tuples(buf: bytes, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of ``pack_piece_tuples``: ``(endpoints f32, steps i32)``."""
    rec = np.frombuffer(buf, _PIECE_REC, count=n)
    return rec["endpoint"].astype(np.float32), rec["step"].astype(np.int32)


def _scatter_drop(buf: torch.Tensor, slot: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """``buf.at[slot].set(src, mode="drop")`` along the last axis: slots at
    or past ``n_max`` land in a scratch column that is cut off again."""
    n_max = buf.shape[-1]
    ext = torch.cat([buf, torch.zeros_like(buf[..., :1])], dim=-1)
    ext = ext.scatter(-1, slot.clamp(0, n_max), src.to(buf.dtype))
    return ext[..., :n_max]


def compact_chunk(
    endpoints: torch.Tensor,
    steps: torch.Tensor,
    n_pieces: torch.Tensor,
    emit: torch.Tensor,
    chunk_endpoints: torch.Tensor,
    step_idx: torch.Tensor,
):
    """Scatter one window's emissions into the receiver's padded buffers.

    ``endpoints``/``steps`` are ``(..., n_max)``; ``n_pieces`` ``(...,)``;
    ``emit``/``chunk_endpoints``/``step_idx`` are ``(..., C)``.  Pieces
    beyond the ``n_max`` capacity are dropped.
    """
    n_max = endpoints.shape[-1]
    emit_i = emit.to(torch.int32)
    pos = n_pieces.unsqueeze(-1) + torch.cumsum(emit_i, -1, dtype=torch.int32) - 1
    slot = torch.where(emit, pos, torch.full_like(pos, n_max)).long()
    endpoints = _scatter_drop(endpoints, slot, chunk_endpoints)
    steps = _scatter_drop(steps, slot, step_idx)
    n_new = torch.clamp_max(n_pieces + emit_i.sum(-1, dtype=torch.int32),
                            n_max)
    return endpoints, steps, n_new


def append_tail(endpoints, steps, n_pieces, tail, t_len):
    """Fold the sender's trailing flush (``tail``, a ``PieceEvent``) into the
    wire buffers as a final piece "emitted at step ``t_len``"."""
    n_max = endpoints.shape[-1]
    at = (torch.arange(n_max, device=endpoints.device)
          == n_pieces.unsqueeze(-1))
    emit = tail.emit.unsqueeze(-1)
    endpoints = torch.where(at & emit, tail.endpoint.unsqueeze(-1), endpoints)
    t_len = torch.as_tensor(t_len, dtype=torch.int32, device=steps.device)
    steps = torch.where(at & emit, t_len.expand(n_pieces.shape).unsqueeze(-1),
                        steps)
    n_final = torch.clamp_max(n_pieces + tail.emit.to(torch.int32), n_max)
    return endpoints, steps, n_final


def compact_events(events: dict, *, n_max: int, t0: torch.Tensor) -> dict:
    """Compact per-step emission events (``compress_stream``'s dict, time on
    the last axis) into padded per-piece buffers."""
    emit = events["emit"]
    t_len = emit.shape[-1]
    batch = emit.shape[:-1]
    dev = emit.device
    endpoints, steps, n_emitted = compact_chunk(
        torch.zeros(batch + (n_max,), dtype=torch.float32, device=dev),
        torch.zeros(batch + (n_max,), dtype=torch.int32, device=dev),
        torch.zeros(batch, dtype=torch.int32, device=dev),
        emit, events["endpoint"],
        torch.arange(t_len, dtype=torch.int32, device=dev).expand(emit.shape),
    )
    endpoints, steps, n_pieces = append_tail(
        endpoints, steps, n_emitted, events["tail"], t_len)
    lens, incs = pieces_from_wire(endpoints, steps, n_pieces, t0)
    return {"endpoints": endpoints, "steps": steps, "lengths": lens,
            "incs": incs, "n_pieces": n_pieces, "t0": t0}


def pieces_from_wire(endpoints, steps, n_pieces, t0):
    """Alg. 2 lines 5-7: build (len i32, inc f32) from consecutive arrivals."""
    n_max = endpoints.shape[-1]
    live = (torch.arange(n_max, device=endpoints.device)
            < n_pieces.unsqueeze(-1))
    t0 = torch.as_tensor(t0, dtype=torch.float32, device=endpoints.device)
    prev_e = torch.cat([t0.expand(endpoints.shape[:-1]).unsqueeze(-1),
                        endpoints[..., :-1]], dim=-1)
    prev_s = torch.cat([torch.ones_like(steps[..., :1]), steps[..., :-1]],
                       dim=-1)
    lens = torch.where(live, steps - prev_s, torch.zeros_like(steps))
    incs = torch.where(live, endpoints - prev_e, torch.zeros_like(endpoints))
    return lens.to(torch.int32), incs
