"""Inference request / batch types.

A request's lifecycle under iteration-level scheduling is
``waiting -> prefill -> decode -> done``: it waits until the continuous
scheduler admits it at a token boundary, runs its prefill inside that
iteration (mixed with other requests' decode), then decodes one token per
iteration until ``max_new_tokens``. All engine-side state is keyed by
``rid`` — request identity, not batch slot. Model mode additionally maps a
running request onto a fixed-shape batch slot (``slot``); the rid→slot
binding lives only while the request is in the running set and is the one
piece of model-mode-specific state (DESIGN.md §1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

WAITING, PREFILL, DECODE, DONE = "waiting", "prefill", "decode", "done"


@dataclass
class Request:
    rid: int
    arrival: float                 # seconds
    prompt: np.ndarray             # (S,) int32 token ids
    max_new_tokens: int
    task_id: int = 0               # which synthetic dataset/task produced it
    tenant_id: str = ""            # "" = untenanted (shared namespace)
    sla_class: str = "standard"    # interactive | standard | batch
    # filled by the engine
    state: str = WAITING
    t_sched: float = 0.0           # when the request was admitted to the batch
    t_first: float = 0.0           # first-token time
    t_done: float = 0.0
    n_generated: int = 0
    slot: int = -1                 # model mode: batch slot while running

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def latency(self) -> float:
        """Per-request end-to-end latency (the paper reports per-token
        forward latency; we track both)."""
        return self.t_done - self.arrival

    @property
    def queue_delay(self) -> float:
        """Time spent waiting for admission (the component continuous
        batching removes)."""
        return self.t_sched - self.arrival

    @property
    def per_token_latency(self) -> float:
        n = max(1, self.n_generated)
        return (self.t_done - self.t_sched) / n


@dataclass
class Batch:
    requests: List[Request] = field(default_factory=list)
    t_formed: float = 0.0

    @property
    def size(self) -> int:
        return len(self.requests)
