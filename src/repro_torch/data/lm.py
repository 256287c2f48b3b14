"""Synthetic LM data pipeline: deterministic, restartable, prefetched.

A copy of the reference's ``src/repro/data/lm.py`` (numpy only; the port
imports nothing of the reference), so the batches are the reference's
bit for bit.  Batches come from a counter-keyed PRNG (step index ->
batch), so a restarted trainer resumes the exact stream from its
checkpoint step, on any mesh.  The arrays stay numpy on the host: the
train step moves them to the card (``device.to_device``).

A background thread keeps ``prefetch`` batches ahead.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["SyntheticLM", "PrefetchIterator"]


class SyntheticLM:
    """Zipf-distributed token stream with next-token labels."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, zipf_a: float = 1.3,
                 enc_dim: int | None = None, enc_len: int | None = None):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.zipf_a = zipf_a
        self.enc_dim = enc_dim
        self.enc_len = enc_len

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        # bounded zipf via inverse-CDF on a truncated harmonic series
        u = rng.random((self.batch, self.seq + 1))
        ranks = np.floor((u ** (-1.0 / (self.zipf_a - 1.0))) - 1.0)
        toks = np.clip(ranks, 0, self.vocab - 1).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.enc_dim:
            batch["enc_embeds"] = rng.standard_normal(
                (self.batch, self.enc_len or self.seq, self.enc_dim)
            ).astype(np.float32)
        return batch


class PrefetchIterator:
    """Runs ``source.batch_at(step)`` in a worker thread, ``prefetch`` deep."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 prefetch: int = 2):
        self.source = source
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        s = self.step
        while not self._stop.is_set():
            try:
                self._q.put(self.source.batch_at(s), timeout=0.1)
                s += 1
            except queue.Full:
                continue

    def __next__(self) -> dict[str, np.ndarray]:
        b = self._q.get()
        self.step += 1
        return b

    def __iter__(self):
        return self

    def close(self) -> None:
        self._stop.set()
