"""Streaming pipeline: raw fleets -> SymED symbols -> packed token batches.

Port of ``repro.data.pipeline``.  ``SymbolPipeline`` runs the port's
batched SymED encoder (``symed_batch``, ``reconstruct=False``) over fleet
slabs on its device, its keys drawn with ``core.prng`` (the reference's
threefry keys, bit for bit), and feeds a background-prefetched
``TokenBatcher`` -- the framework's input path for training sequence
models on symbolized sensor data.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.symed import SymEDConfig, symed_batch
from repro_torch.data.synthetic import make_fleet
from repro_torch.data.tokenizer import SymbolTokenizer

__all__ = ["SymbolPipeline", "TokenBatcher"]


class SymbolPipeline:
    """Symbolize fleet slabs on demand, on ``device`` (``cuda`` unless
    told otherwise)."""

    def __init__(self, cfg: SymEDConfig, tokenizer: SymbolTokenizer,
                 stream_len: int = 1024, slab: int = 64, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.tok = tokenizer
        self.stream_len = stream_len
        self.slab = slab
        self.seed = seed
        self.device = resolve_device(device)

    def slabs(self) -> Iterator[np.ndarray]:
        i = 0
        while True:
            yield make_fleet(self.slab, self.stream_len, seed=self.seed + i)
            i += 1

    def docs(self) -> Iterator[list]:
        key = prng.key(self.seed, self.device)
        for slab in self.slabs():
            key, sub = prng.split(key)
            out = symed_batch(slab, self.cfg, sub, reconstruct=False,
                              device=self.device)
            labels = out["symbols"].cpu().numpy()
            lens = out["pieces_len"].cpu().numpy()
            n_pieces = out["n_pieces"].cpu().numpy()
            for b in range(slab.shape[0]):
                yield self.tok.encode(labels[b], n_pieces[b], lens[b])


class TokenBatcher:
    """Background-prefetched (batch, seq) int32 batches.  ``close`` stops
    the thread and waits for it (at most the slab it is symbolizing), so no
    torch work outlives the batcher."""

    def __init__(self, pipeline: SymbolPipeline, batch: int, seq_len: int,
                 prefetch: int = 4):
        self.pipeline = pipeline
        self.batch = batch
        self.seq_len = seq_len
        self._q: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _worker(self):
        rows = []
        for doc in self.pipeline.docs():
            if self._stop.is_set():
                return
            rows.append(doc)
            packed = self.pipeline.tok.pack(rows, self.seq_len)
            if packed.shape[0] >= self.batch:
                self._q.put(packed[: self.batch])
                rows = []

    def __iter__(self):
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        while True:
            yield self._q.get()

    def close(self):
        self._stop.set()
        while self._thread is not None and self._thread.is_alive():
            try:  # unblock a full queue's put
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
