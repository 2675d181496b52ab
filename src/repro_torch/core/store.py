"""Centroid storage shared by the repository and the semantic cache.

Struct-of-arrays over numpy: vectors, answer vectors, cluster_size (semantic
locality), access_count (short-term popularity). `answer` holds the output
representation — in the synthetic workloads an answer embedding; in text
mode an index into an external answer list can be carried in `answer_id`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class CentroidStore:
    dim: int
    answer_dim: int
    vectors: np.ndarray = None        # (N, dim) float32, L2-normalized
    answers: np.ndarray = None        # (N, answer_dim) float32
    cluster_size: np.ndarray = None   # (N,) float64
    access_count: np.ndarray = None   # (N,) float64 (np.inf for fresh)
    answer_id: np.ndarray = None      # (N,) int64
    ids: np.ndarray = None            # (N,) int64 stable ids
    _next_id: int = 0

    def __post_init__(self):
        if self.vectors is None:
            self.vectors = np.zeros((0, self.dim), np.float32)
            self.answers = np.zeros((0, self.answer_dim), np.float32)
            self.cluster_size = np.zeros((0,), np.float64)
            self.access_count = np.zeros((0,), np.float64)
            self.answer_id = np.zeros((0,), np.int64)
            self.ids = np.zeros((0,), np.int64)

    def __len__(self) -> int:
        return len(self.vectors)

    @property
    def bytes_per_entry(self) -> int:
        return 4 * (self.dim + self.answer_dim) + 8 * 4

    def nbytes(self) -> int:
        return len(self) * self.bytes_per_entry

    def add(self, vectors, answers, cluster_size, access_count=None,
            answer_id=None) -> np.ndarray:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        n = len(vectors)
        answers = np.atleast_2d(np.asarray(answers, np.float32))
        cluster_size = np.broadcast_to(
            np.asarray(cluster_size, np.float64), (n,)).copy()
        access = (np.zeros((n,), np.float64) if access_count is None
                  else np.broadcast_to(np.asarray(access_count, np.float64),
                                       (n,)).copy())
        aid = (np.full((n,), -1, np.int64) if answer_id is None
               else np.broadcast_to(np.asarray(answer_id, np.int64), (n,)).copy())
        new_ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        self._next_id += n
        self.vectors = np.concatenate([self.vectors, vectors])
        self.answers = np.concatenate([self.answers, answers])
        self.cluster_size = np.concatenate([self.cluster_size, cluster_size])
        self.access_count = np.concatenate([self.access_count, access])
        self.answer_id = np.concatenate([self.answer_id, aid])
        self.ids = np.concatenate([self.ids, new_ids])
        return new_ids

    def set_row(self, i: int, vector, answer, answer_id: int = -1,
                cluster_size: float = 1.0, access_count: float = 0.0) -> None:
        """Overwrite row i in place (LRU replacement) with a NEW entry.

        The victim's locality weight and popularity die with it —
        inheriting them would hand the newcomer stale cluster_size /
        access_count and pollute locality-aware replacement. The row also
        gets a fresh stable id: the id names the *entry*, not the slot,
        so generation-stamped lookups and the refresh pipeline's
        id-matched access-count carry can never attribute the newcomer's
        activity to the evicted entry.
        """
        self.vectors[i] = np.asarray(vector, np.float32)
        self.answers[i] = np.asarray(answer, np.float32)
        self.cluster_size[i] = cluster_size
        self.access_count[i] = access_count
        self.answer_id[i] = answer_id
        self.ids[i] = self._next_id
        self._next_id += 1

    def take(self, keep: np.ndarray) -> None:
        """Keep rows selected by index array / bool mask (in-place)."""
        self.vectors = self.vectors[keep]
        self.answers = self.answers[keep]
        self.cluster_size = self.cluster_size[keep]
        self.access_count = self.access_count[keep]
        self.answer_id = self.answer_id[keep]
        self.ids = self.ids[keep]

    def copy(self) -> "CentroidStore":
        out = CentroidStore(self.dim, self.answer_dim)
        out.vectors = self.vectors.copy()
        out.answers = self.answers.copy()
        out.cluster_size = self.cluster_size.copy()
        out.access_count = self.access_count.copy()
        out.answer_id = self.answer_id.copy()
        out.ids = self.ids.copy()
        out._next_id = self._next_id
        return out

    def state_dict(self) -> dict:
        return {"vectors": self.vectors, "answers": self.answers,
                "cluster_size": self.cluster_size,
                "access_count": self.access_count,
                "answer_id": self.answer_id, "ids": self.ids,
                "next_id": np.asarray(self._next_id)}

    @classmethod
    def from_state(cls, state: dict) -> "CentroidStore":
        # np.array (copy), never asarray: a state dict may hold live
        # references into another store (in-process restore) — restoring
        # must not alias buffers the source keeps mutating
        out = cls(state["vectors"].shape[1], state["answers"].shape[1])
        out.vectors = np.array(state["vectors"], np.float32)
        out.answers = np.array(state["answers"], np.float32)
        out.cluster_size = np.array(state["cluster_size"], np.float64)
        out.access_count = np.array(state["access_count"], np.float64)
        out.answer_id = np.array(state["answer_id"], np.int64)
        out.ids = np.array(state["ids"], np.int64)
        out._next_id = int(state["next_id"])
        return out
