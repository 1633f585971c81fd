"""Tokenizer of the serving path: the byte-level ``ByteTokenizer``."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class ByteTokenizer:
    """Byte-level tokenizer: ids 0..3 special, 4..259 bytes."""
    PAD, BOS, EOS, SEP = 0, 1, 2, 3
    OFFSET = 4

    def __init__(self, vocab_size: int = 260):
        assert vocab_size >= 260
        self.vocab_size = vocab_size

    def encode(self, text: str, *, bos: bool = False,
               eos: bool = False) -> List[int]:
        ids = [b + self.OFFSET for b in text.encode("utf-8")]
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        bs = bytes(i - self.OFFSET for i in ids
                   if i >= self.OFFSET and i - self.OFFSET < 256)
        return bs.decode("utf-8", errors="replace")

    def pad_batch(self, rows: List[List[int]], *, seq_len: int,
                  align: str = "right") -> Tuple[np.ndarray, np.ndarray]:
        """Returns (tokens [B, S], lengths [B]); rows are clipped/padded."""
        B = len(rows)
        out = np.full((B, seq_len), self.PAD, np.int32)
        lens = np.zeros((B,), np.int32)
        for i, r in enumerate(rows):
            r = r[:seq_len]
            lens[i] = len(r)
            if align == "right":
                out[i, :len(r)] = r
            else:
                out[i, seq_len - len(r):] = r
        return out, lens
