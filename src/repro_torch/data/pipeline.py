"""Data pipelines: synthetic token streams, graph-update streams, recsys
batches — deterministic, shardable, prefetching.

Determinism contract: batch ``i`` is a pure function of (seed, i), so a
restarted/elastically-resized job resumes mid-epoch by skipping to the
checkpointed step — no data-order drift (the FT path relies on this), and
straggler rebalancing is a pure re-indexing of host shards.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np


class SyntheticTokens:
    """Deterministic LM batches: batch i == f(seed, i). Zipf-ish unigram."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, i))
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1)) % self.vocab
        toks = z.astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def shard(self, i: int, host: int, n_hosts: int) -> Dict[str, np.ndarray]:
        """Host shard of batch i — contiguous rows, re-indexable on rebalance."""
        b = self[i]
        per = self.batch // n_hosts
        sl = slice(host * per, (host + 1) * per)
        return {k: v[sl] for k, v in b.items()}


class GraphUpdateStream:
    """Deterministic edge-update stream feeding a RapidStore writer."""

    def __init__(self, n_vertices: int, batch: int = 1024, seed: int = 0,
                 delete_frac: float = 0.2):
        self.n, self.batch, self.seed, self.delete_frac = n_vertices, batch, seed, delete_frac

    def __getitem__(self, i: int):
        rng = np.random.default_rng((self.seed, i))
        e = rng.integers(0, self.n, size=(self.batch, 2), dtype=np.int64)
        e = e[e[:, 0] != e[:, 1]]
        k = int(len(e) * self.delete_frac)
        return {"insert": e[k:], "delete": e[:k]}


class RecsysBatches:
    """Deterministic BST batches (history, target, label)."""

    def __init__(self, n_items: int, batch: int, seq: int = 20,
                 n_other: int = 16, seed: int = 0):
        self.n_items, self.batch, self.seq, self.n_other, self.seed = (
            n_items, batch, seq, n_other, seed)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, i))
        return {
            "hist": (rng.zipf(1.2, size=(self.batch, self.seq)) % self.n_items).astype(np.int32),
            "target": (rng.zipf(1.2, size=self.batch) % self.n_items).astype(np.int32),
            "other": rng.normal(size=(self.batch, self.n_other)).astype(np.float32),
            "label": rng.integers(0, 2, self.batch).astype(np.float32),
        }


class Prefetcher:
    """Background-thread prefetch of an indexable source (depth-bounded)."""

    def __init__(self, source, start: int = 0, depth: int = 2):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next = start

        def worker():
            i = start
            while not self._stop.is_set():
                try:
                    self._q.put((i, self.source[i]), timeout=0.2)
                    i += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        i, item = self._q.get()
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
