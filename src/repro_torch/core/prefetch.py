"""Activation-aware expert prefetching — Algorithm 1 (§5).

The prefetcher owns the in-flight sequence context (cur_eam), asks its
``ExpertPredictor`` (DESIGN.md §10 — the EAMC nearest-pattern matcher by
default) for predicted activation ratios, and (re)submits prefetch requests
for experts in layers *after* the currently executing one with priority

    p = (predicted_activation_ratio + ε) · (1 − layer_idx / n_layers)

Continuous refinement (§8.3): the prediction is recomputed at every MoE
layer boundary as cur_eam fills in. Baseline prefetchers from the paper's
micro-benchmarks (TOPK of ZeRO-Infinity, TRACED-TOPK of BrainStorm) share
the same interface so the benchmark harness can swap them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.eam import EAMC, eam_distance
from repro_torch.core.predictor import EAMCPredictor, ExpertPredictor

EPSILON = 1e-4
Key = Tuple[int, int]


@dataclass
class SequenceContext:
    """Per-inference-procedure state: the current EAM (Alg. 1 step 2) plus
    the latest EAMC-predicted activation ratios (for §6.2's cache/prefetch
    priority alignment)."""

    n_layers: int
    n_experts: int
    cur_eam: np.ndarray = field(default=None)
    predicted_ratios: Optional[np.ndarray] = None   # (L, E) row-normalized

    def __post_init__(self):
        if self.cur_eam is None:
            self.cur_eam = np.zeros((self.n_layers, self.n_experts), np.float64)

    def reset(self) -> None:
        self.cur_eam[:] = 0
        self.predicted_ratios = None

    def update(self, layer_idx: int, token_counts: np.ndarray) -> None:
        """Alg. 1 steps 6-7: add routed-token counts for one layer."""
        self.cur_eam[layer_idx] += token_counts


class Prefetcher:
    """Common interface: ``plan(cur_layer)`` → list of (key, priority).

    ``tier_weight`` (optional, set by the offload engine) makes a planner
    tier-aware: a callable ``key -> multiplier`` equal to the expert's
    current-tier demand-miss cost relative to a DRAM resident's, so an
    SSD-resident predicted expert (whose miss pays the NVMe hop *and* the
    PCIe hop) is staged early. DRAM residents weigh 1.0 (GPU residents 0,
    but those are dropped before submission), and everything weighs 1.0
    when the SSD hop is free — two-tier configs are unchanged.
    """

    name = "none"
    tier_weight = None   # Optional[Callable[[Key], float]]

    def _w(self, key: Key) -> float:
        return self.tier_weight(key) if self.tier_weight is not None else 1.0

    def plan(self, ctx: SequenceContext, cur_layer: int):
        return []

    def observe(self, ctx: SequenceContext) -> None:
        """Called at sequence end (for trace-accumulating baselines)."""


class ActivationAwarePrefetcher(Prefetcher):
    """Algorithm 1's PREFETCH (steps 15-27), generic over the prediction
    brain: the predictor supplies per-sequence activation ratios and raw
    Alg-1 priorities; the prefetcher layers the oneshot-vs-refine ablation
    and tier weighting on top. Constructing it from a bare ``EAMC`` wraps
    the collection in an ``EAMCPredictor`` (the classic paper behavior)."""

    name = "moe-infinity"

    def __init__(self, predictor, *, refine: bool = True,
                 include_zero_ratio: bool = False):
        # include_zero_ratio=True enqueues even predicted-inactive experts
        # (pure-epsilon priorities). The paper's Alg. 1 scores them for queue
        # *ordering*, but its measured prefetch-traffic reduction (§8.2:
        # "7 GB out of 13 GB") implies they are not actually transferred;
        # default False keeps the link for predicted-active experts.
        if isinstance(predictor, EAMC):
            predictor = EAMCPredictor(predictor)
        self.predictor: ExpertPredictor = predictor
        self.refine = refine
        self.include_zero_ratio = include_zero_ratio
        self._oneshot_plan: Optional[list] = None
        self.last_distance = float("nan")
        self.last_match_ratios: Optional[np.ndarray] = None

    @property
    def eamc(self) -> Optional[EAMC]:
        """The backing collection when the brain is EAMC-based (benchmark
        and test convenience; None for trace-free predictors)."""
        return getattr(self.predictor, "eamc", None)

    def start_sequence(self) -> None:
        self._oneshot_plan = None
        # a fresh inference procedure must not inherit the previous
        # procedure's predicted ratios into Alg-2 cache scoring
        self.last_match_ratios = None
        self.predictor.start_sequence()

    def plan(self, ctx: SequenceContext, cur_layer: int):
        if not self.refine and self._oneshot_plan is not None:
            # one-shot ablation: keep the first prediction (§8.3)
            return [(k, p) for (k, p, l) in self._oneshot_plan if l > cur_layer]
        probs = self.predictor.predict(ctx)                 # steps 16-21
        self.last_distance = self.predictor.last_distance
        self.last_match_ratios = probs
        if probs is None:
            # no prediction (empty/young EAMC, untrained model): nothing to
            # stage, and last_match_ratios stays cleared so a stale previous
            # match cannot leak into pred_merged / cache scores
            return []
        out = [(key, pr * self._w(key))                     # steps 22-26
               for key, pr in self.predictor.prefetch_priorities(
                   ctx, cur_layer, include_zero=self.include_zero_ratio)]
        if not self.refine and self._oneshot_plan is None:
            self._oneshot_plan = [(k, p, k[0]) for (k, p) in out]
        return out


class TopKPrefetcher(Prefetcher):
    """ZeRO-Infinity style: prefetch the first K expert ids of the next
    layer (no activation awareness; K tuned by the harness)."""

    name = "topk"

    def __init__(self, k: int = 8):
        self.k = k

    def plan(self, ctx: SequenceContext, cur_layer: int):
        nl = cur_layer + 1
        if nl >= ctx.n_layers:
            return []
        return [((nl, e), 1.0 - 1e-3 * e)
                for e in range(min(self.k, ctx.n_experts))]


class TracedTopKPrefetcher(Prefetcher):
    """BrainStorm style: aggregate expert usage frequency across *all*
    sequences (losing per-sequence structure — the paper's point) and
    prefetch the K most popular experts of the next layer."""

    name = "traced-topk"

    def __init__(self, n_layers: int, n_experts: int, k: int = 8):
        self.k = k
        self.freq = np.zeros((n_layers, n_experts), np.float64)

    def observe(self, ctx: SequenceContext) -> None:
        self.freq += ctx.cur_eam

    def plan(self, ctx: SequenceContext, cur_layer: int):
        nl = cur_layer + 1
        if nl >= ctx.n_layers:
            return []
        top = np.argsort(-self.freq[nl], kind="stable")[: self.k]
        return [((nl, int(e)), 1.0 - 1e-3 * i) for i, e in enumerate(top)]


class OraclePrefetcher(Prefetcher):
    """Upper bound: knows the true future activations of this sequence."""

    name = "oracle"

    def __init__(self, true_eam_fn):
        self.true_eam_fn = true_eam_fn  # () -> (L, E) of the current sequence

    def plan(self, ctx: SequenceContext, cur_layer: int):
        eam = self.true_eam_fn()
        L = ctx.n_layers
        out = []
        for fl in range(cur_layer + 1, L):
            n_token = eam[fl].sum()
            if n_token <= 0:
                continue
            for e in np.nonzero(eam[fl])[0]:
                pr = (eam[fl][e] / n_token + EPSILON) * (1.0 - fl / L) \
                    * self._w((fl, int(e)))
                out.append(((fl, int(e)), pr))
        return out


def prediction_accuracy(planned: Sequence[Key], activated: Sequence[Key],
                        budget: int) -> float:
    """Recall of activated experts within the top-``budget`` planned
    prefetches (the paper's prefetch-accuracy metric, §8.3)."""
    if not activated:
        return 1.0
    top = set(list(planned)[:budget])
    hit = sum(1 for k in activated if k in top)
    return hit / len(activated)
