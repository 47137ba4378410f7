"""Sequence-level expert activation tracing (§4).

Bridges the JAX models and the paper core: the model's forward/serve_step
return per-sequence per-MoE-layer expert token counts (``aux["counts"]``,
shape (n_moe_layers, B, E)); the tracer accumulates them into one EAM per
sequence and builds the offline EAMC from a dataset.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.eam import EAMC


class SequenceTracer:
    """Accumulates an EAM per live sequence, keyed by request id. Sequence
    state follows request lifetime (``start`` on admission, ``finish`` on
    completion), so under continuous batching a request's trace is
    independent of which batch slots it shared iterations with."""

    def __init__(self, n_moe_layers: int, n_experts: int):
        self.L = n_moe_layers
        self.E = n_experts
        self.eams: dict[int, np.ndarray] = {}

    def start(self, rid: int) -> None:
        self.eams[rid] = np.zeros((self.L, self.E), np.float64)

    def record(self, rid: int, counts: np.ndarray) -> None:
        """counts: (n_moe_layers, E) routed by one request this iteration."""
        if rid not in self.eams:
            self.start(rid)
        self.eams[rid] += counts

    def finish(self, rid: int) -> Optional[np.ndarray]:
        return self.eams.pop(rid, None)


def build_eamc(run_fn: Callable[[np.ndarray], np.ndarray],
               dataset: List[np.ndarray], capacity: int,
               seed: int = 0) -> EAMC:
    """Offline EAMC construction (§4.2): run every dataset sequence through
    the model (``run_fn(seq) -> (L, E) EAM``) and cluster.

    The paper uses the validation / fine-tuning split of the serving
    workload's distribution.
    """
    eams = [np.asarray(run_fn(seq), np.float64) for seq in dataset]
    eamc = EAMC(capacity=capacity, seed=seed)
    eamc.construct(eams)
    return eamc
