"""Synthetic token data pipeline.

Streams batches from the same task-mixture distribution as the serving
workload generator, so training and serving share one data story. Documents
are drawn per task (Zipf-skewed vocab slices) with a learnable structure:
each task has a first-order Markov backbone so a model can actually reduce
loss — "loss goes down" integration tests rely on this.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int = 512
    n_tasks: int = 3
    seq_len: int = 128
    batch: int = 8
    markov_temp: float = 0.5
    seed: int = 0


class TokenStream:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # per-task Markov transition matrices over a vocab slice
        self._starts, self._trans = [], []
        width = max(16, cfg.vocab // 2)
        for t in range(cfg.n_tasks):
            start = (t * (cfg.vocab - width)) // max(1, cfg.n_tasks - 1) \
                if cfg.n_tasks > 1 else 0
            logits = rng.normal(size=(width, width)) / cfg.markov_temp
            p = np.exp(logits - logits.max(axis=1, keepdims=True))
            p /= p.sum(axis=1, keepdims=True)
            self._starts.append(start)
            self._trans.append(p)
        self._width = width

    def sample_doc(self, task: int, n: int, rng) -> np.ndarray:
        p = self._trans[task]
        out = np.empty(n, np.int32)
        s = rng.integers(self._width)
        for i in range(n):
            out[i] = s
            s = rng.choice(self._width, p=p[s])
        return out + self._starts[task]

    def batches(self, n_steps: int, seed: int = 1) -> Iterator[dict]:
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        for _ in range(n_steps):
            toks = np.stack([
                self.sample_doc(int(rng.integers(cfg.n_tasks)),
                                cfg.seq_len, rng)
                for _ in range(cfg.batch)])
            yield {"tokens": toks}
