"""ExpertPredictor — the one prediction brain behind cache, prefetch,
admission, and placement (DESIGN.md §10).

MoE-Infinity's core bet is that a single signal — predicted expert
activation — should drive every offloading decision. Before this module
the signal was computed four different ways in four layers, each reaching
into the EAMC directly:

1. ``ActivationAwarePrefetcher`` (Algorithm 1 priorities, core/prefetch.py),
2. ``ActivationAwareCache`` / ``ReuseAwareDRAMCache`` victim scoring
   (Algorithm 2, core/cache.py),
3. the stall-admission cold prior (``StepEngine._predicted_cold_cost``,
   serving/engine.py → serving/scheduler.py),
4. EWMA placement heat (``ExpertPlacement``, core/placement.py).

All four now consume the ``ExpertPredictor`` surface below. The classic
EAMC trace-matching becomes ``EAMCPredictor`` — bit-identical by
construction to the pre-refactor code paths (the float expressions are
kept literally; tests/test_predictor.py pins tokens, counters, and
placement state against pre-refactor goldens) — and ``LearnedPredictor``
(an online per-layer bigram/marginal model in the spirit of MoE-Beyond's
learned activation predictor) plugs into the identical seam, selected by
``OffloadConfig.predictor = "eamc" | "learned" | "hybrid"``.

Lifecycle (driven by the offload engine):

    start_sequence()                  — a fresh inference procedure begins
    predict(ctx)                      — per live sequence, per MoE layer
    prefetch_priorities(ctx, layer)   — Alg-1 priorities from that predict
    observe_iteration(layer, counts, batch_probs)
                                      — once per MoE layer, after the
                                        per-sequence plan loop
    finish_seq(eam)                   — per completed sequence: online
                                        learning + drift telemetry + heat

Prediction surface consumed between lifecycle ticks: ``expert_probs()``,
``victim_score(layer, expert)``, ``batch_probs()`` (Alg-2 cache scoring),
``cold_union()`` (stall admission), ``placement_heat()`` (expert-parallel
rebalancing).
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.eam import EAMC

EPSILON = 1e-4          # Alg-1/Alg-2 score floor (shared with prefetch.py)
Key = Tuple[int, int]


class ExpertPredictor:
    """Base protocol + shared state every predictor carries.

    Subclasses implement ``predict``/``prefetch_priorities``/``finish_seq``;
    the base owns the batch-merged prediction (Alg-2's §6.2 cache/prefetch
    alignment) and the placement heat EWMA, which are model-independent.
    """

    name = "none"
    # EWMA factor of the placement heat — literally ExpertPlacement's old
    # ``decay`` so the heat stream is bit-identical to pre-refactor loads
    heat_decay = 0.8
    # running mean of sequence-final match distances (EAMC predictors
    # override with a property; trace-free models have no match distance)
    mean_match_distance = float("nan")
    # whether an activation-aware prefetcher consumes this predictor's
    # output — gates drift telemetry + reconstruction exactly like the
    # pre-refactor ``isinstance(pf, ActivationAwarePrefetcher)`` check
    track_drift = True

    def __init__(self, n_layers: Optional[int] = None,
                 n_experts: Optional[int] = None):
        self.n_layers = n_layers
        self.n_experts = n_experts
        self.last_probs: Optional[np.ndarray] = None    # (L,E) row-normalized
        self.last_distance = float("nan")
        self._batch_probs: Optional[np.ndarray] = None  # (L,E) batch-merged
        self._heat: Optional[np.ndarray] = None         # (L,E) EWMA heat
        if n_layers is not None and n_experts is not None:
            self._heat = np.zeros((n_layers, n_experts), np.float64)
        self.heat_seqs = 0

    # -- lifecycle -----------------------------------------------------------
    def start_sequence(self) -> None:
        """A fresh inference procedure: per-sequence prediction state must
        not leak across procedure boundaries."""
        self.last_probs = None
        self._batch_probs = None

    def predict(self, ctx) -> Optional[np.ndarray]:
        """Per-sequence prediction from the partial EAM in ``ctx.cur_eam``:
        returns row-normalized (L, E) activation ratios (None = no
        prediction available) and records ``last_probs``/``last_distance``."""
        self.last_probs = None
        return None

    def observe_iteration(self, layer_idx: int, token_counts: np.ndarray,
                          batch_probs: Optional[np.ndarray] = None) -> None:
        """One tick per MoE layer, after the per-sequence plan loop.
        ``token_counts`` (E,) is the batch-combined routing of this layer —
        the online training signal; ``batch_probs`` is the max-merged
        per-sequence prediction that Alg-2 cache scoring consumes."""
        self._batch_probs = batch_probs

    def finish_seq(self, eam: np.ndarray) -> None:
        """A sequence completed with final EAM ``eam`` — the single
        learning stream (the same one the EAMC and placement consumed
        pre-refactor)."""
        self._update_heat(eam)

    # -- prediction surface ---------------------------------------------------
    def expert_probs(self, layer: Optional[int] = None):
        """Latest per-sequence prediction: (L, E) row-normalized ratios, or
        one layer's row."""
        if self.last_probs is None or layer is None:
            return self.last_probs
        return self.last_probs[layer]

    def prefetch_priorities(self, ctx, cur_layer: int, *,
                            include_zero: bool = False):
        """Algorithm-1 priorities ``(ratio + ε) · (1 − l/L)`` for layers
        after ``cur_layer``, from the latest ``predict``. Tier weighting is
        the *prefetcher's* concern (it multiplies on top — left-associative,
        so the split preserves bit-identity with the fused expression)."""
        probs = self.last_probs
        if probs is None:
            return []
        L = ctx.n_layers
        out = []
        for fl in range(cur_layer + 1, L):
            row = probs[fl]
            if row.sum() <= 0:
                continue
            decay = 1.0 - fl / L
            for e in range(ctx.n_experts):
                if row[e] <= 0 and not include_zero:
                    continue
                out.append(((fl, int(e)), (row[e] + EPSILON) * decay))
        return out

    def batch_probs(self) -> Optional[np.ndarray]:
        """Batch-merged predicted ratios for the live iteration (what the
        pre-refactor code kept in ``ctx.predicted_ratios``)."""
        return self._batch_probs

    def victim_score(self, layer: int, expert: int) -> float:
        """Predicted activation ratio feeding Algorithm 2's victim score
        (0.0 when there is no prediction — ``max(p, 0.0) == p`` for the
        non-negative observed ratio, so the fallback is score-neutral)."""
        bp = self._batch_probs
        return float(bp[layer, expert]) if bp is not None else 0.0

    def cold_union(self) -> List[Key]:
        """Expected expert set of a *new* request (no observed EAM yet):
        per layer, the experts covering 80% of predicted activation mass.
        The stall-admission prior; [] = admit unconditionally."""
        return []

    def placement_heat(self) -> Optional[np.ndarray]:
        """(L, E) EWMA of row-normalized finished-sequence EAMs — the
        expert-parallel placement load signal."""
        return self._heat

    @property
    def is_cold(self) -> bool:
        """True while the brain has learned nothing — a cold per-tenant
        predictor may borrow the shared brain's predictions
        (TenantSpec.shared_fallback) until its own has training signal."""
        return False

    def stats(self) -> dict:
        return {}

    # -- shared heat EWMA -----------------------------------------------------
    def _update_heat(self, eam: np.ndarray) -> None:
        # bit-identical to ExpertPlacement.observe pre-refactor: same
        # normalization, same EWMA expression, rebinding (not in-place) so
        # a consumer holding the previous array is never mutated under it
        m = np.asarray(eam, np.float64)
        if self._heat is None:
            self._heat = np.zeros_like(m)
        if m.shape != self._heat.shape:
            return
        s = m.sum(axis=1, keepdims=True)
        m = np.divide(m, np.maximum(s, 1e-12))
        self._heat = self.heat_decay * self._heat + (1.0 - self.heat_decay) * m
        self.heat_seqs += 1


class EAMCPredictor(ExpertPredictor):
    """The classic MoE-Infinity brain: EAMC nearest-entry trace matching
    (Algorithm 1 steps 16-21) + the online insert-or-merge lifecycle and
    EWMA drift-triggered reconstruction (§4.3) that used to live in
    ``OffloadEngine._eamc_lifecycle``, plus the drift telemetry that used
    to live on ``ActivationAwarePrefetcher``. Bit-identical to the
    pre-refactor composition of all three."""

    name = "eamc"

    def __init__(self, eamc: EAMC, *, online: bool = False,
                 drift_threshold: float = 0.6, drift_min_seqs: int = 8,
                 n_layers: Optional[int] = None,
                 n_experts: Optional[int] = None):
        super().__init__(n_layers, n_experts)
        self.eamc = eamc
        self.online = online
        self.drift_threshold = drift_threshold
        self.drift_min_seqs = drift_min_seqs
        self._pred_raw: Optional[np.ndarray] = None   # matched entry (counts)
        self._seqs_since_reconstruct = 0
        # drift telemetry (§4.3): EWMA + running mean over *sequence-final*
        # match distances. The EWMA is the reconstruction trigger;
        # sequence-final distances are used because early-layer lookups
        # carry a constant offset from the still-unobserved layers (see
        # eam_distance) that would swamp it.
        self.ewma_alpha = 0.25
        self.ewma_distance = float("nan")
        self.ewma_n = 0            # samples since the last drift reset
        self.distance_sum = 0.0
        self.distance_n = 0
        # stall-admission prior, cached on (n_entries, version): online
        # merges rewrite entries without changing their count, which a
        # length-only key would treat as unchanged
        self._cold_keys: Optional[List[Key]] = None
        self._cold_keys_v = None

    # -- lifecycle -----------------------------------------------------------
    def start_sequence(self) -> None:
        super().start_sequence()
        self._pred_raw = None

    def predict(self, ctx) -> Optional[np.ndarray]:
        p_eam, d = self.eamc.lookup(ctx.cur_eam)            # steps 16-21
        self.last_distance = d
        if p_eam is None:
            # empty/young EAMC (the online cold-start state): there is no
            # prediction — clearing keeps a stale previous match from
            # leaking into pred_merged / cache scores
            self.last_probs = None
            self._pred_raw = None
            return None
        self._pred_raw = p_eam
        sums = p_eam.sum(axis=1, keepdims=True)
        self.last_probs = np.divide(
            p_eam, sums, out=np.zeros_like(p_eam, dtype=np.float64),
            where=sums > 0)
        return self.last_probs

    def prefetch_priorities(self, ctx, cur_layer: int, *,
                            include_zero: bool = False):
        # computed from the *raw* matched entry, not last_probs, so the
        # per-layer renormalization is literally Alg-1 steps 22-26 —
        # bit-identical to the pre-refactor prefetcher loop
        p_eam = self._pred_raw
        if p_eam is None:
            return []
        L = ctx.n_layers
        out = []
        for fl in range(cur_layer + 1, L):                  # step 22
            n_token = p_eam[fl].sum()                       # step 23
            if n_token <= 0:
                continue
            ratios = p_eam[fl] / n_token                    # step 25
            decay = 1.0 - fl / L                            # step 26
            for e in range(ctx.n_experts):
                if ratios[e] <= 0 and not include_zero:
                    continue
                out.append(((fl, e), (ratios[e] + EPSILON) * decay))
        return out

    def finish_seq(self, eam: np.ndarray) -> None:
        self._update_heat(eam)
        if eam.sum() <= 0:
            return  # a sequence that never routed a token carries no signal
        nearest, dist = None, None
        if self.eamc.entries and (self.track_drift or self.online):
            nearest, dist = self.eamc.lookup(eam)
            if self.track_drift:
                self.note_distance(dist)
        if not self.online:
            return
        verdict = self.eamc.online_update(eam, nearest=nearest, dist=dist)
        self._seqs_since_reconstruct += 1
        if verdict == "insert" and self.track_drift:
            # the collection grew: the novel pattern is now represented, so
            # distances measured before the insert (the cold-start warmup
            # state) must not count as drift evidence
            self.reset_drift_signal()
            return
        if (self.track_drift
                and self._seqs_since_reconstruct >= self.drift_min_seqs
                and self.ewma_n >= self.drift_min_seqs
                and self.ewma_distance > self.drift_threshold):
            self.eamc.reconstruct()
            self._seqs_since_reconstruct = 0
            self.reset_drift_signal()

    # -- drift telemetry ------------------------------------------------------
    def note_distance(self, d: float) -> None:
        """Record one completed sequence's final match distance."""
        if not np.isfinite(d):
            return
        self.distance_sum += d
        self.distance_n += 1
        self.ewma_n += 1
        a = self.ewma_alpha
        self.ewma_distance = (d if np.isnan(self.ewma_distance)
                              else (1 - a) * self.ewma_distance + a * d)

    def reset_drift_signal(self) -> None:
        """Called when the collection changes shape (an online insert or a
        reconstruction): distances measured against the previous collection
        no longer describe the current one, so match quality is re-measured
        fresh instead of averaging across the boundary."""
        self.ewma_distance = float("nan")
        self.ewma_n = 0

    @property
    def mean_match_distance(self) -> float:
        return (self.distance_sum / self.distance_n if self.distance_n
                else float("nan"))

    # -- admission prior ------------------------------------------------------
    def cold_union(self) -> List[Key]:
        eamc = self.eamc
        entries = eamc.entries
        ver = (len(entries), getattr(eamc, "version", 0))
        if self._cold_keys is not None and self._cold_keys_v == ver:
            return self._cold_keys
        keys: List[Key] = []
        if entries:
            agg = np.zeros_like(np.asarray(entries[0], np.float64))
            for e in entries:
                e = np.asarray(e, np.float64)
                agg += e / max(e.sum(), 1.0)
            for li in range(agg.shape[0]):
                row = agg[li]
                tot = row.sum()
                if tot <= 0:
                    continue
                order = np.argsort(row)[::-1]
                cum = np.cumsum(row[order]) / tot
                take = int(np.searchsorted(cum, 0.8)) + 1
                keys.extend((li, int(e)) for e in order[:take])
        self._cold_keys = keys
        self._cold_keys_v = ver
        return keys

    @property
    def is_cold(self) -> bool:
        return not self.eamc.entries

    def stats(self) -> dict:
        return {"predictor_seqs_trained": len(self.eamc.entries)}

    # -- persistence (per-tenant namespaces persist their own EAMC) ----------
    def save(self, path) -> Path:
        return Path(str(self.eamc.save(path)))

    def load_state(self, path) -> None:
        """In-place warm restart: replace the collection's entries with the
        persisted ones (the cache/prefetcher already hold references to
        ``self.eamc``, so the object identity must survive the load)."""
        other = EAMC.load(path)
        eamc = self.eamc
        eamc.entries = other.entries
        eamc.capacity = max(eamc.capacity, other.capacity)
        eamc.version += 1
        self._cold_keys = None
        self.reset_drift_signal()


class LearnedPredictor(ExpertPredictor):
    """Online learned activation predictor (the MoE-Beyond direction):
    a per-layer bigram transition model + EWMA marginal prior over the
    recent activation history, trained from the same ``finish_seq`` stream
    the EAMC consumes — no trace database, so it keeps adapting where a
    frozen EAMC degrades under workload drift.

    Model state (all float64, ``.npz``-persistable like the EAMC):

    - ``prior``  (L, E): EWMA of row-normalized finished-sequence EAMs —
      "which experts does this layer use lately".
    - ``trans``  (L-1, E, E): EWMA of consecutive-layer activation outer
      products — "given layer l's expert mix, what does layer l+1 use".

    ``predict`` runs a forward pass over the partial EAM: observed layers
    report their true ratios; each unobserved layer is the previous
    layer's distribution pushed through the row-normalized transition,
    blended with the marginal prior (``blend``); leading unobserved layers
    fall back to the prior alone. Ratios below ``min_ratio`` are dropped
    from prefetch priorities so the dense model doesn't flood the upload
    queue with epsilon-probability experts (the EAMC's sparsity came for
    free from its sparse entries)."""

    name = "learned"

    def __init__(self, n_layers: int, n_experts: int, *, decay: float = 0.8,
                 blend: float = 0.7, min_ratio: float = 0.01):
        super().__init__(n_layers, n_experts)
        self.decay = decay
        self.blend = blend
        self.min_ratio = min_ratio
        self.prior = np.zeros((n_layers, n_experts), np.float64)
        self.trans = np.zeros((max(n_layers - 1, 0), n_experts, n_experts),
                              np.float64)
        self.n_trained = 0
        self.version = 0
        self._tn_cache: Optional[np.ndarray] = None
        self._tn_v = -1
        self._prior_n_cache: Optional[np.ndarray] = None
        self._prior_n_v = -1
        self._cold_keys: Optional[List[Key]] = None
        self._cold_keys_v = -1

    # -- normalized views (cached per model version) --------------------------
    def _tn(self) -> np.ndarray:
        """Row-stochastic transitions: trans[l] normalized over the target
        axis."""
        if self._tn_v != self.version:
            t = self.trans
            s = t.sum(axis=2, keepdims=True)
            self._tn_cache = np.divide(t, s, out=np.zeros_like(t),
                                       where=s > 0)
            self._tn_v = self.version
        return self._tn_cache

    def _prior_n(self) -> np.ndarray:
        if self._prior_n_v != self.version:
            s = self.prior.sum(axis=1, keepdims=True)
            self._prior_n_cache = np.divide(self.prior, s,
                                            out=np.zeros_like(self.prior),
                                            where=s > 0)
            self._prior_n_v = self.version
        return self._prior_n_cache

    # -- lifecycle -----------------------------------------------------------
    def predict(self, ctx) -> Optional[np.ndarray]:
        self.last_distance = float("nan")
        if self.n_trained == 0:
            self.last_probs = None
            return None
        cur = np.asarray(ctx.cur_eam, np.float64)
        L, E = self.n_layers, self.n_experts
        if cur.shape != (L, E):
            self.last_probs = None
            return None
        row_tok = cur.sum(axis=1)
        prior = self._prior_n()
        tn = self._tn()
        probs = np.zeros((L, E), np.float64)
        q = None
        for l in range(L):
            if row_tok[l] > 0:
                probs[l] = cur[l] / row_tok[l]      # observed: ground truth
            elif q is not None:
                chain = q @ tn[l - 1]
                cs = chain.sum()
                if cs > 0:
                    chain = chain / cs
                    probs[l] = (self.blend * chain
                                + (1.0 - self.blend) * prior[l])
                else:
                    probs[l] = prior[l]
            else:
                probs[l] = prior[l]                 # leading unobserved
            q = probs[l]
        self.last_probs = probs
        return probs

    def prefetch_priorities(self, ctx, cur_layer: int, *,
                            include_zero: bool = False):
        probs = self.last_probs
        if probs is None:
            return []
        L = ctx.n_layers
        out = []
        for fl in range(cur_layer + 1, L):
            row = probs[fl]
            if row.sum() <= 0:
                continue
            decay = 1.0 - fl / L
            if include_zero:
                idx = range(ctx.n_experts)
            else:
                idx = np.nonzero(row >= self.min_ratio)[0]
            for e in idx:
                out.append(((fl, int(e)), (row[e] + EPSILON) * decay))
        return out

    def finish_seq(self, eam: np.ndarray) -> None:
        self._update_heat(eam)
        m = np.asarray(eam, np.float64)
        if m.shape != (self.n_layers, self.n_experts) or m.sum() <= 0:
            return
        s = m.sum(axis=1, keepdims=True)
        r = np.divide(m, s, out=np.zeros_like(m), where=s > 0)
        d = self.decay
        self.prior = d * self.prior + (1.0 - d) * r
        if len(self.trans):
            self.trans = d * self.trans + (1.0 - d) * np.einsum(
                "le,lf->lef", r[:-1], r[1:])
        self.n_trained += 1
        self.version += 1

    # -- admission prior ------------------------------------------------------
    def cold_union(self) -> List[Key]:
        if self._cold_keys is not None and self._cold_keys_v == self.version:
            return self._cold_keys
        keys: List[Key] = []
        if self.n_trained:
            prior = self.prior
            for li in range(prior.shape[0]):
                row = prior[li]
                tot = row.sum()
                if tot <= 0:
                    continue
                order = np.argsort(row)[::-1]
                cum = np.cumsum(row[order]) / tot
                take = int(np.searchsorted(cum, 0.8)) + 1
                keys.extend((li, int(e)) for e in order[:take])
        self._cold_keys = keys
        self._cold_keys_v = self.version
        return keys

    @property
    def is_cold(self) -> bool:
        return self.n_trained == 0

    def stats(self) -> dict:
        return {"predictor_seqs_trained": self.n_trained}

    # -- persistence (mirrors EAMC.save/load: exact float64 round-trip) ------
    @staticmethod
    def _resolve_path(path) -> Path:
        p = Path(path)
        if p.suffix != ".npz":
            p = p.with_suffix(p.suffix + ".npz")
        return p

    def save(self, path) -> Path:
        p = self._resolve_path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        heat = (self._heat if self._heat is not None
                else np.zeros((self.n_layers, self.n_experts), np.float64))
        np.savez_compressed(
            p, prior=self.prior, trans=self.trans, heat=heat,
            meta=np.array([self.n_layers, self.n_experts, self.n_trained,
                           self.heat_seqs], np.int64),
            knobs=np.array([self.decay, self.blend, self.min_ratio],
                           np.float64))
        return p

    @classmethod
    def load(cls, path) -> "LearnedPredictor":
        p = cls._resolve_path(path)
        with np.load(p) as z:
            meta = z["meta"]
            knobs = z["knobs"]
            lp = cls(int(meta[0]), int(meta[1]), decay=float(knobs[0]),
                     blend=float(knobs[1]), min_ratio=float(knobs[2]))
            lp.prior = z["prior"].astype(np.float64, copy=True)
            lp.trans = z["trans"].astype(np.float64, copy=True)
            lp._heat = z["heat"].astype(np.float64, copy=True)
            lp.n_trained = int(meta[2])
            lp.heat_seqs = int(meta[3])
        lp.version = 1  # invalidate any (impossible) stale caches
        return lp

    def load_state(self, path) -> None:
        """In-place warm restart (the serve launcher's pattern: the engine
        already constructed the predictor; state streams in from disk)."""
        other = type(self).load(path)
        if (other.n_layers, other.n_experts) != (self.n_layers,
                                                 self.n_experts):
            raise ValueError(
                f"predictor shape mismatch: saved ({other.n_layers}, "
                f"{other.n_experts}) vs engine ({self.n_layers}, "
                f"{self.n_experts})")
        self.prior = other.prior
        self.trans = other.trans
        self._heat = other._heat
        self.n_trained = other.n_trained
        self.heat_seqs = other.heat_seqs
        self.decay, self.blend = other.decay, other.blend
        self.min_ratio = other.min_ratio
        self.version += 1


class HybridPredictor(ExpertPredictor):
    """EAMC trace-matching while the match is good, learned model when it
    isn't: per-sequence, if the EAMC's nearest entry is within
    ``switch_distance`` its prediction wins (bit-identical Alg-1 behavior
    on in-distribution traffic); otherwise the learned model predicts.
    Both sub-models train from every finished sequence, so the learned
    side is warm by the time drift makes the EAMC miss."""

    name = "hybrid"

    def __init__(self, eamc_pred: EAMCPredictor, learned: LearnedPredictor,
                 *, switch_distance: float = 0.35):
        super().__init__(learned.n_layers, learned.n_experts)
        self.eamc_pred = eamc_pred
        self.learned = learned
        self.switch_distance = switch_distance
        self.active = "eamc"
        self.n_eamc_predictions = 0
        self.n_learned_predictions = 0

    # track_drift gates the EAMC side's telemetry — forward it
    @property
    def track_drift(self):
        return self.eamc_pred.track_drift

    @track_drift.setter
    def track_drift(self, v):
        self.eamc_pred.track_drift = v

    @property
    def eamc(self):
        return self.eamc_pred.eamc

    @property
    def mean_match_distance(self) -> float:
        return self.eamc_pred.mean_match_distance

    def start_sequence(self) -> None:
        super().start_sequence()
        self.eamc_pred.start_sequence()
        self.learned.start_sequence()

    def predict(self, ctx) -> Optional[np.ndarray]:
        p = self.eamc_pred.predict(ctx)
        d = self.eamc_pred.last_distance
        if p is not None and np.isfinite(d) and d <= self.switch_distance:
            self.active = "eamc"
            self.n_eamc_predictions += 1
            self.last_probs, self.last_distance = p, d
            return p
        lp = self.learned.predict(ctx)
        if lp is None:
            # learned side still cold: fall back to whatever the EAMC had
            self.active = "eamc"
            self.last_probs, self.last_distance = p, d
            return p
        self.active = "learned"
        self.n_learned_predictions += 1
        self.last_probs = lp
        self.last_distance = self.learned.last_distance
        return lp

    def prefetch_priorities(self, ctx, cur_layer: int, *,
                            include_zero: bool = False):
        src = self.eamc_pred if self.active == "eamc" else self.learned
        return src.prefetch_priorities(ctx, cur_layer,
                                       include_zero=include_zero)

    def finish_seq(self, eam: np.ndarray) -> None:
        self.eamc_pred.finish_seq(eam)
        self.learned.finish_seq(eam)

    def cold_union(self) -> List[Key]:
        keys = self.eamc_pred.cold_union()
        return keys if keys else self.learned.cold_union()

    @property
    def is_cold(self) -> bool:
        return self.eamc_pred.is_cold and self.learned.is_cold

    def placement_heat(self) -> Optional[np.ndarray]:
        return self.eamc_pred.placement_heat()

    def stats(self) -> dict:
        return {"predictor_seqs_trained": self.learned.n_trained,
                "predictor_eamc_predictions": self.n_eamc_predictions,
                "predictor_learned_predictions": self.n_learned_predictions}

    def save(self, path) -> Path:
        return self.learned.save(path)

    def load_state(self, path) -> None:
        self.learned.load_state(path)


def make_predictor(kind: str, eamc: EAMC, *, n_layers: int, n_experts: int,
                   online: bool = False, drift_threshold: float = 0.6,
                   drift_min_seqs: int = 8) -> ExpertPredictor:
    """Predictor factory keyed by ``OffloadConfig.predictor``."""
    if kind == "eamc":
        return EAMCPredictor(eamc, online=online,
                             drift_threshold=drift_threshold,
                             drift_min_seqs=drift_min_seqs,
                             n_layers=n_layers, n_experts=n_experts)
    if kind == "learned":
        return LearnedPredictor(n_layers, n_experts)
    if kind == "hybrid":
        return HybridPredictor(
            EAMCPredictor(eamc, online=online,
                          drift_threshold=drift_threshold,
                          drift_min_seqs=drift_min_seqs,
                          n_layers=n_layers, n_experts=n_experts),
            LearnedPredictor(n_layers, n_experts))
    raise ValueError(f"unknown predictor kind: {kind!r}")
