"""Synthetic LM token pipeline (a copy of `repro.data.tokens`, numpy only).

Generates Zipf-distributed token streams (real corpora are Zipfian -- the
'heavy hitter' regime of the paper's L3 layer; see DESIGN.md Sec. 3) and
serves fixed-shape, host-sharded batches with a resumable cursor, ahead-of-
step prefetch, and deterministic per-step RNG. The cursor is part of the
checkpoint manifest so restarts resume mid-epoch (fault tolerance).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class TokenPipelineConfig:
    vocab_size: int
    batch_size: int            # global batch (sequences per step)
    seq_len: int
    zipf_a: float = 1.2        # Zipf exponent; 0 => uniform
    seed: int = 0
    prefetch: int = 2


class TokenPipeline:
    """Deterministic, resumable synthetic token batches.

    Batch `i` is a pure function of (seed, i): restart-safe without
    checkpointing buffers -- only the integer cursor is saved.
    """

    def __init__(self, cfg: TokenPipelineConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        self._q: "queue.Queue[Tuple[int, np.ndarray]]" = queue.Queue(
            maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _make_batch(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed << 20) ^ step)
        shape = (self.cfg.batch_size, self.cfg.seq_len)
        if self.cfg.zipf_a > 0:
            # Bounded Zipf via inverse-CDF over the vocab.
            ranks = np.arange(1, self.cfg.vocab_size + 1)
            probs = ranks ** (-self.cfg.zipf_a)
            probs /= probs.sum()
            flat = rng.choice(self.cfg.vocab_size, size=shape[0] * shape[1],
                              p=probs)
            return flat.reshape(shape).astype(np.int32)
        return rng.integers(0, self.cfg.vocab_size, size=shape,
                            dtype=np.int32)

    def _producer(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = self._make_batch(step)
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def next_batch(self) -> Tuple[int, np.ndarray]:
        """(step, (batch, seq) int32 tokens); prefetch hides generation."""
        while True:
            step, batch = self._q.get()
            if step >= self.step:       # drop stale prefetches after resume
                self.step = step + 1
                return step, batch

    def state(self) -> dict:
        return {"cursor": self.step, "seed": self.cfg.seed}

    def close(self) -> None:
        self._stop.set()


def batch_for_step(cfg: TokenPipelineConfig, step: int) -> np.ndarray:
    """Stateless access to the pipeline's batch for `step` (tests, replay)."""
    pipe = TokenPipeline.__new__(TokenPipeline)
    pipe.cfg = cfg
    return TokenPipeline._make_batch(pipe, step)
