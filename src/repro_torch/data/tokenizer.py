"""SymED symbol streams as LM token streams.

A copy of ``repro.data.tokenizer`` (numpy only), kept in the port so that
it imports nothing of the JAX package.

The paper's promise is analytics *directly on symbols*; here the analytic is
sequence modeling: each SymED cluster id becomes a token, so the model zoo
trains on symbolized sensor fleets.  Vocab = [PAD, BOS, EOS, sep] + k_max
cluster symbols (+ optional length-bucket tokens to keep duration
information, since cluster ids alone drop the len coordinate at generation
time).
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np

__all__ = ["SymbolTokenizer"]


class SymbolTokenizer:
    PAD, BOS, EOS, SEP = 0, 1, 2, 3
    _SPECIALS = 4

    def __init__(self, k_max: int = 100, len_buckets: Optional[List[int]] = None):
        self.k_max = k_max
        self.len_buckets = len_buckets or []
        self.vocab_size = self._SPECIALS + k_max + len(self.len_buckets)

    def encode(self, labels: np.ndarray, n_pieces: int,
               lengths: Optional[np.ndarray] = None) -> List[int]:
        out = [self.BOS]
        for i in range(int(n_pieces)):
            out.append(self._SPECIALS + int(labels[i]) % self.k_max)
            if self.len_buckets and lengths is not None:
                out.append(self._len_token(int(lengths[i])))
        out.append(self.EOS)
        return out

    def _len_token(self, length: int) -> int:
        idx = int(np.searchsorted(self.len_buckets, length))
        idx = min(idx, len(self.len_buckets) - 1)
        return self._SPECIALS + self.k_max + idx

    def pack(self, docs: Iterable[List[int]], seq_len: int) -> np.ndarray:
        """Pack encoded docs into (n, seq_len) rows (GPT-style contiguous)."""
        flat: List[int] = []
        for d in docs:
            flat.extend(d)
        n = max(len(flat) // seq_len, 1)
        flat = flat[: n * seq_len]
        if len(flat) < n * seq_len:
            flat.extend([self.PAD] * (n * seq_len - len(flat)))
        return np.asarray(flat, np.int32).reshape(n, seq_len)
