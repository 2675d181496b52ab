"""Deterministic hash tokenizer (offline stand-in for ALBERT's WordPiece).

Words and word-bigrams are hashed into a fixed vocab; id 0 is padding.
Good enough for the embedder to learn sentence similarity on synthetic
corpora, and fully reproducible without downloaded vocab files.
"""
from __future__ import annotations

import hashlib
import re

import numpy as np

_WORD_RE = re.compile(r"[a-z0-9]+")


def _h(s: str, vocab: int) -> int:
    digest = hashlib.blake2s(s.encode(), digest_size=4).digest()
    return int.from_bytes(digest, "little") % (vocab - 1) + 1  # avoid pad id


class HashTokenizer:
    def __init__(self, vocab_size: int = 30000, max_len: int = 64,
                 bigrams: bool = True):
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.bigrams = bigrams

    def tokenize(self, text: str) -> list[int]:
        words = _WORD_RE.findall(text.lower())
        ids = [_h(w, self.vocab_size) for w in words]
        if self.bigrams:
            ids += [_h(a + "_" + b, self.vocab_size)
                    for a, b in zip(words, words[1:])]
        return ids[: self.max_len]

    def encode_batch(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """Returns (ids (B, max_len) int32, mask (B, max_len) bool)."""
        B = len(texts)
        ids = np.zeros((B, self.max_len), np.int32)
        for i, t in enumerate(texts):
            row = self.tokenize(t)
            ids[i, : len(row)] = row
        return ids, ids > 0
