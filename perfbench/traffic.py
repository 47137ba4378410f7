"""The general traffic generator: one mix's requests from its data file.

A mix (``perfbench/traffic/<name>.json``) gives the client loop, the
prompt and output length distributions and the task mixture. Prompts are
the frozen task-mixture generator's (``frozen/workload.py``): tokens drawn
Zipf-skewed from each task's slice of the vocabulary.

Every seed serves the same sizes. A mix's lengths are the ``stratum``
quantiles of each distribution, at (j + 1/2) / stratum. Each client sends
a fixed sequence of them, every length once in ``stratum`` requests, and
the sequences start spread evenly over the stratum; the seed deals the
sequences out to the clients, whose pool rows are alike, and draws the
tokens.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Iterator, List

import numpy as np

from perfbench.frozen.workload import WorkloadConfig, _task_token_sampler


@dataclass(frozen=True)
class Spec:
    prompt: np.ndarray        # (S,) int32 token ids
    max_new_tokens: int
    task: int


def _quantiles(dist: dict, n: int) -> List[int]:
    lo, hi = int(dist["min"]), int(dist["max"])
    ps = [(j + 0.5) / n for j in range(n)]
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    mu, sd = math.log(dist["median"]), float(dist["sigma"])
    vals = [math.exp(mu + sd * NormalDist().inv_cdf(p)) for p in ps]
    return [min(hi, max(lo, int(round(v)))) for v in vals]


class Traffic:
    """The requests of mix ``mix`` (its parsed file) over a vocabulary of
    ``vocab`` ids."""

    def __init__(self, mix: dict, vocab: int):
        self.mix = mix
        self.clients = int(mix["clients"])
        self.stratum = int(mix["stratum"])
        wc = WorkloadConfig(vocab=vocab, n_tasks=int(mix["n_tasks"]),
                            zipf_a=float(mix["zipf_a"]),
                            task_vocab_frac=float(mix["task_vocab_frac"]))
        self.n_tasks = wc.n_tasks
        self._samplers = [
            _task_token_sampler(wc, t, np.random.default_rng(1000 + t))
            for t in range(wc.n_tasks)]
        self.prompt_lens = _quantiles(mix["prompt_len"], self.stratum)
        self.output_lens = _quantiles(mix["output_len"], self.stratum)

    def prompt(self, length: int, task: int, rng) -> np.ndarray:
        return self._samplers[task](int(length), rng)

    def stream(self, seed: int, client: int) -> Iterator[Spec]:
        """Client ``client``'s endless request stream under ``seed``. Its
        sequence q (dealt by the seed) starts at j = q * stratum //
        clients; its k-th request takes output length j + k and prompt
        length j + 3k of the stratum (mod stratum), and task q + k."""
        n = self.stratum
        if math.gcd(3, n) != 1:
            raise ValueError(f"stratum {n}: a multiple of 3")
        q = int(np.random.default_rng([int(seed), 1])
                .permutation(self.clients)[client])
        rng = np.random.default_rng([int(seed), 1, int(client)])
        j = q * n // self.clients
        for k in itertools.count():
            t = (q + k) % self.n_tasks
            yield Spec(self.prompt(self.prompt_lens[(j + 3 * k) % n], t, rng),
                       self.output_lens[(j + k) % n], t)

    def warm_outputs(self) -> List[int]:
        """Output lengths of the clients' first requests, which finish
        before the window opens: staggered over the shortest output, so
        the clients finish them one after another and the window opens on
        requests at different points of their lives."""
        lo, n = min(self.output_lens), self.clients
        return [max(1, round((c + 1) * lo / n)) for c in range(n)]

    def eamc_prompts(self, seed: int) -> List[np.ndarray]:
        """The EAMC's warm-up set: ``eamc_warmup`` prompts of the mix,
        drawn apart from the served stream."""
        rng = np.random.default_rng([int(seed), 2])
        n = int(self.mix["eamc_warmup"])
        return [self.prompt(self.prompt_lens[j % self.stratum],
                            j % self.n_tasks, rng) for j in range(n)]

    def buckets(self) -> List[int]:
        """The power-of-two prefill buckets (from 8) that the mix's prompt
        lengths fall in."""
        out = []
        for S in sorted(set(self.prompt_lens)):
            b = 8
            while b < S:
                b *= 2
            if b not in out:
                out.append(b)
        return out

    def bucket_prompts(self, seed: int) -> List[np.ndarray]:
        """One prompt filling each bucket, to warm its prefill shapes."""
        rng = np.random.default_rng([int(seed), 3])
        return [self.prompt(b, j % self.n_tasks, rng)
                for j, b in enumerate(self.buckets())]

    def max_len(self) -> int:
        return max(self.prompt_lens) + max(self.output_lens)
