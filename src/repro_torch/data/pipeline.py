"""Deterministic synthetic-token data pipeline with host prefetch, the
port's own copy of ``repro.data.pipeline`` (pure numpy): ``batch_at(step)``
is the reference's array for array.

Production properties carried into the design:
  * DETERMINISTIC SHARDING: batch(step, host) is a pure function of
    (seed, step) — any host can regenerate any shard, which is what the
    straggler-mitigation re-issue path and elastic restarts rely on
    (no data-loader state in the checkpoint beyond `step`).
  * background prefetch thread with a bounded queue;
  * per-document structure so the LSH near-dup DEDUP (dedup.py) plugs
    in ahead of batching, mirroring a real corpus pipeline.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticTokens:
    """Zipf-ish synthetic LM tokens, deterministic per (seed, step)."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        # zipf-like marginal over the vocab, cheap to sample
        u = rng.random((self.batch, self.seq + 1))
        toks = ((self.vocab - 1) * u**3).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Bounded background prefetch over any step-indexed source."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            b = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self) -> tuple[int, dict[str, np.ndarray]]:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
