"""Frozen copy of the port's synthetic traffic generator.

Copied from ``src/repro_torch/serving/workload.py`` at commit
594f206bf3e0cabed91f0411f45bb1daddd07a9f: ``WorkloadConfig``,
``_task_token_sampler``, ``poisson_arrivals`` and ``azure_like_arrivals``,
verbatim. Left out: ``make_dataset``, ``attach_arrivals`` and the
multi-tenant mixes, which build the program's ``Request`` objects
(``perfbench/traffic.py`` builds its requests from the sampler here). The
benchmark's yardstick: the program may change its copy, this one stays.

Original docstring: the paper drives its evaluation with FLAN / BIGBench /
MMLU requests arriving per an Azure-trace-shaped process. Offline here, we
synthesize the same *structure*: a mixture of tasks, each with its own
token distribution (so a randomly initialized router produces
task-clustered expert activations), and arrival processes with Azure-like
burstiness.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class WorkloadConfig:
    vocab: int = 512
    n_tasks: int = 3                      # FLAN/BIGBench/MMLU-like mixture
    prompt_len: tuple = (16, 64)          # uniform range
    output_len: tuple = (8, 64)
    zipf_a: float = 1.3                   # within-task token skew
    task_vocab_frac: float = 0.35         # fraction of vocab each task uses


def _task_token_sampler(cfg: WorkloadConfig, task: int,
                        rng: np.random.Generator):
    """Each task draws tokens Zipf-skewed from its own vocab slice."""
    width = max(8, int(cfg.vocab * cfg.task_vocab_frac))
    start = (task * (cfg.vocab - width)) // max(1, cfg.n_tasks - 1) \
        if cfg.n_tasks > 1 else 0
    ranks = np.arange(1, width + 1, dtype=np.float64)
    probs = ranks ** -cfg.zipf_a
    probs /= probs.sum()
    perm = rng.permutation(width)  # fixed per task via rng seeding

    def sample(n: int, r: np.random.Generator) -> np.ndarray:
        local = r.choice(width, size=n, p=probs)
        return (start + perm[local]).astype(np.int32)
    return sample


def poisson_arrivals(n: int, rps: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rps, size=n)
    return np.cumsum(gaps)


def azure_like_arrivals(n: int, rps: float, seed: int = 0,
                        cv: float = 2.5) -> np.ndarray:
    """Bursty arrivals (Gamma renewal with CV>1), the shape of the Azure
    serverless trace used by AlpaServe/Clockwork-style studies."""
    rng = np.random.default_rng(seed)
    shape = 1.0 / (cv * cv)
    scale = 1.0 / (rps * shape)
    gaps = rng.gamma(shape, scale, size=n)
    return np.cumsum(gaps)
