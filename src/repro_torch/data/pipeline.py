"""Deterministic, restartable, sharded data pipeline (numpy only).

The port's copy of ``repro.data.pipeline``; its batches are byte-identical
to ``repro``'s for the same (seed, step, rows).

  * Every batch is a pure function of (seed, step): no iterator state to
    checkpoint, no skew after a restart.
  * Each host materialises only its own rows (global_batch / num_hosts).
  * Backed by a memory-mapped token file or a seeded synthetic stream
    behind one interface.
  * Prefetch: one background thread keeps ``depth`` batches ready.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


class TokenDataset:
    """Memory-mapped flat token file (np.uint16/uint32 raw)."""

    def __init__(self, path: str, dtype=np.uint16, vocab_size: int = 0):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab_size = vocab_size or int(self.tokens.max()) + 1

    def __len__(self) -> int:
        return len(self.tokens)

    def window(self, offset: int, length: int) -> np.ndarray:
        offset = int(offset) % max(len(self.tokens) - length - 1, 1)
        return np.asarray(self.tokens[offset:offset + length + 1],
                          dtype=np.int32)


class SyntheticLM:
    """Seeded synthetic token stream: a Zipf-ish unigram LM with enough
    structure (copy runs) that loss decreases measurably when training."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab_size = vocab_size
        rng = np.random.default_rng(seed)
        z = rng.zipf(1.3, size=vocab_size).astype(np.float64)
        self.probs = z / z.sum()

    def window(self, offset: int, length: int) -> np.ndarray:
        rng = np.random.default_rng(np.uint64(offset) * 2654435761 % 2**63)
        toks = rng.choice(self.vocab_size, size=length + 1, p=self.probs)
        # copy structure: the second half of each 64-run repeats the first
        toks = toks.reshape(-1, 64) if (length + 1) % 64 == 0 else toks
        if toks.ndim == 2:
            toks[:, 32:] = toks[:, :32]
            toks = toks.reshape(-1)
        return toks.astype(np.int32)


@dataclasses.dataclass
class ShardedLoader:
    """Deterministic (seed, step) -> host-local batch."""
    source: object                  # TokenDataset | SyntheticLM
    seq_len: int
    global_batch: int
    host_index: int = 0
    num_hosts: int = 1
    seed: int = 0

    def host_rows(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError(
                f"global_batch={self.global_batch} must divide evenly "
                f"across num_hosts={self.num_hosts}")
        return self.global_batch // self.num_hosts

    def batch_slice(self, step: int, row0: int, rows: int):
        """(tokens, labels) for global rows [row0, row0+rows) of ``step``,
        each (rows, seq_len) int32.  A row is keyed by (seed, step, global
        row) alone, so any host can regenerate any other host's slice."""
        toks = np.empty((rows, self.seq_len + 1), np.int32)
        for r in range(rows):
            g = row0 + r
            offset = (np.uint64(self.seed) * np.uint64(0x9E3779B97F4A7C15)
                      + np.uint64(step) * np.uint64(self.global_batch)
                      + np.uint64(g)) * np.uint64(self.seq_len)
            toks[r] = self.source.window(int(offset % (2**62)), self.seq_len)
        return toks[:, :-1].copy(), toks[:, 1:].copy()

    def batch_at(self, step: int):
        """(tokens, labels) for this host, shape (host_rows, seq_len)."""
        rows = self.host_rows()
        return self.batch_slice(step, self.host_index * rows, rows)

    def prefetch(self, start_step: int, depth: int = 2) -> Iterator:
        """Iterator of (step, tokens, labels) from ``start_step`` on, made
        by a background thread ``depth`` batches ahead.  Closing the
        iterator stops the thread (it waits at most 0.1 s on a full
        queue before it looks again)."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def worker():
            s = start_step
            while not stop.is_set():
                item = (s, *self.batch_at(s))
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        pass
                s += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def make_loader(cfg, seq_len: int, global_batch: int, *, path: str = "",
                seed: int = 0, host_index: int = 0,
                num_hosts: int = 1) -> ShardedLoader:
    src = (TokenDataset(path, vocab_size=cfg.vocab_size) if path
           else SyntheticLM(cfg.vocab_size, seed))
    return ShardedLoader(src, seq_len, global_batch,
                         host_index=host_index, num_hosts=num_hosts,
                         seed=seed)
