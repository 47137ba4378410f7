"""Expert cache policies — Algorithm 2 and the paper's baselines (§6, §8.4).

A cache holds expert keys ``(layer, expert)`` with a fixed slot capacity.
``victim()`` picks the replacement victim. The activation-aware policy scores
cached experts by the *current* sequence's EAM (cur_eam): activation ratio
within the expert's layer × linear layer decay favouring early layers —
exactly Algorithm 2.
"""
from __future__ import annotations

from typing import Dict, Hashable, List, Optional

import numpy as np

Key = Hashable
EPSILON = 1e-4
MAX_PRIORITY = float("inf")


class CachePolicy:
    name = "base"

    def on_access(self, key: Key, now: float) -> None:  # hit
        pass

    def on_insert(self, key: Key, now: float) -> None:
        pass

    def on_evict(self, key: Key) -> None:
        pass

    def victim(self, cached: List[Key], protected=frozenset()) -> Key:
        """Pick the replacement victim; ``None`` when ``cached`` is empty
        (a zero-capacity tier has nothing to evict)."""
        raise NotImplementedError


class ActivationAwareCache(CachePolicy):
    """Algorithm 2: evict argmin over cached experts of
    ``(cur_eam[l][e]/Σ_e cur_eam[l] + ε) · (1 − l/L)``.

    Per §6.2 ("closely aligning the caching strategy with the prefetching
    priorities") the activation ratio also sees the *predicted* ratios of
    the ongoing inference — the ``ExpertPredictor``'s batch-merged
    prediction (DESIGN.md §10), the same signal the prefetcher ranks by:
    an expert the prefetcher expects to need soon scores as if already
    observed, so early-iteration arrivals cannot evict the sequence's
    soon-to-run experts (the refetch ping-pong otherwise costs ~40% extra
    demand fetches in our replay)."""

    name = "moe-infinity"

    def __init__(self, ctx, predictor=None):
        self.ctx = ctx  # SequenceContext: .cur_eam (L,E)
        # the prediction brain; standalone constructions (tests, ablations)
        # fall back to ctx.predicted_ratios for the predicted term
        self.predictor = predictor

    def _pred(self) -> Optional[np.ndarray]:
        if self.predictor is not None:
            return self.predictor.batch_probs()
        return getattr(self.ctx, "predicted_ratios", None)

    def scores(self, cached: List[Key]) -> np.ndarray:
        eam = self.ctx.cur_eam
        pred = self._pred()
        n_layers = eam.shape[0]
        layer_tokens = eam.sum(axis=1)                     # (L,)
        out = np.empty(len(cached))
        for i, (l, e) in enumerate(cached):
            n_token = layer_tokens[l]
            p = (eam[l, e] / n_token) if n_token > 0 else 0.0
            if pred is not None:
                p = max(p, pred[l, e])
            out[i] = (p + EPSILON) * (1.0 - l / n_layers)
        return out

    def victim(self, cached: List[Key], protected=frozenset()) -> Key:
        if not cached:
            return None
        s = self.scores(cached)
        order = np.argsort(s, kind="stable")
        for i in order:
            if cached[i] not in protected:
                return cached[i]
        return cached[int(order[0])]


class LRUCache(CachePolicy):
    """CUDA-Unified-Memory-style least-recently-used."""

    name = "lru"

    def __init__(self):
        self.last: Dict[Key, float] = {}
        self._tick = 0.0

    def _now(self, now):
        self._tick += 1.0
        return self._tick

    def on_access(self, key, now):
        self.last[key] = self._now(now)

    def on_insert(self, key, now):
        self.last[key] = self._now(now)

    def on_evict(self, key):
        self.last.pop(key, None)

    def victim(self, cached, protected=frozenset()):
        if not cached:
            return None
        best = None
        for k in cached:
            if k in protected:
                continue
            if best is None or self.last.get(k, 0) < self.last.get(best, 0):
                best = k
        return best if best is not None else cached[0]


class LFUCache(CachePolicy):
    """BrainStorm-style least-frequently-used. Counter resets on eviction
    (the behaviour the paper calls out in §8.4)."""

    name = "lfu"

    def __init__(self):
        self.freq: Dict[Key, int] = {}

    def on_access(self, key, now):
        self.freq[key] = self.freq.get(key, 0) + 1

    def on_insert(self, key, now):
        self.freq[key] = self.freq.get(key, 0) + 1

    def on_evict(self, key):
        self.freq.pop(key, None)  # counter reset

    def victim(self, cached, protected=frozenset()):
        if not cached:
            return None
        best = None
        for k in cached:
            if k in protected:
                continue
            if best is None or self.freq.get(k, 0) < self.freq.get(best, 0):
                best = k
        return best if best is not None else cached[0]


class ReuseAwareDRAMCache(LRUCache):
    """DRAM-tier policy for the three-tier SSD→DRAM→GPU pipeline.

    Algorithm 2 scores by the *current* procedure's EAM, which is the
    right horizon for the GPU cache but nearly blind for the DRAM tier:
    between procedures the EAM resets, every expert floors to ε·decay and
    DRAM victims degrade to layer order — so cross-request reuse (the
    signal eMoE exploits at the SSD boundary) is thrown away, and an LRU
    DRAM tier beats Algorithm 2 there by a wide margin in our replay.

    Victim = least-recently-used among the *activation-cold* experts
    (no observed tokens and no EAMC-predicted ratio in the live batch);
    while any cold expert exists, hot/predicted experts are shielded.
    Only when everything is hot does Algorithm 2 pick the victim. The
    GPU tier is untouched."""

    name = "reuse-dram"

    def __init__(self, ctx, predictor=None):
        super().__init__()
        self.aa = ActivationAwareCache(ctx, predictor)

    def victim(self, cached, protected=frozenset()):
        eam = self.aa.ctx.cur_eam
        pred = self.aa._pred()
        cold = [k for k in cached if k not in protected
                and eam[k[0], k[1]] == 0
                and (pred is None or pred[k[0], k[1]] <= 0)]
        if cold:
            return min(cold, key=lambda k: self.last.get(k, 0))
        return self.aa.victim(cached, protected)


class NeighborAwareCache(LRUCache):
    """ZeRO-Infinity-style: LRU over *layer groups* — neighbours (same-layer
    experts) are kept/evicted together, approximated by using the layer's
    last access time for every member expert."""

    name = "neighbor"

    def __init__(self):
        super().__init__()
        self.layer_last: Dict[Hashable, float] = {}

    def _touch(self, key, now):
        t = self._now(now)
        self.last[key] = t
        self.layer_last[key[0]] = t

    def on_access(self, key, now):
        self._touch(key, now)

    def on_insert(self, key, now):
        # an insert is a use of the layer group too — without this, experts
        # that only ever arrive via prefetch never refresh their layer's
        # timestamp and the group is evicted as if idle
        self._touch(key, now)

    def victim(self, cached, protected=frozenset()):
        if not cached:
            return None
        layer_last = self.layer_last
        best, best_t = None, None
        for k in cached:
            if k in protected:
                continue
            t = max(self.last.get(k, 0), layer_last.get(k[0], 0))
            if best is None or t < best_t:
                best, best_t = k, t
        return best if best is not None else cached[0]


class OracleCache(CachePolicy):
    """Belady's MIN: evict the expert whose next use is furthest in the
    future. Needs the full future access trace (benchmark harness only)."""

    name = "oracle"

    def __init__(self, future: List[Key]):
        # future[i] = key accessed at step i; consumed via .advance_to(i)
        self.future = future
        self.cursor = 0
        self._next_use: Dict[Key, List[int]] = {}
        for i, k in enumerate(future):
            self._next_use.setdefault(k, []).append(i)

    def advance_to(self, i: int) -> None:
        self.cursor = i

    def _next(self, key: Key) -> int:
        uses = self._next_use.get(key, ())
        for u in uses:
            if u >= self.cursor:
                return u
        return 1 << 60

    def victim(self, cached, protected=frozenset()):
        if not cached:
            return None
        best, best_u = None, -1
        for k in cached:
            if k in protected:
                continue
            u = self._next(k)
            if u > best_u:
                best, best_u = k, u
        return best if best is not None else cached[0]


class ExpertCache:
    """A fixed-capacity expert cache driven by a pluggable policy."""

    def __init__(self, capacity: int, policy: CachePolicy):
        self.capacity = capacity
        self.policy = policy
        self.resident: List[Key] = []
        self._set = set()
        self.hits = 0
        self.misses = 0
        # tenant slot accounting (DESIGN.md §11): which tenant's traffic
        # pulled a key in. Drives per-tenant occupancy stats and the
        # optional GPU-slot quota; empty for untenanted engines.
        self.owner: Dict[Key, str] = {}
        self._owned: Dict[str, int] = {}

    def __contains__(self, key: Key) -> bool:
        return key in self._set

    # -- tenant slot ownership ------------------------------------------------
    def set_owner(self, key: Key, tenant: str) -> None:
        if key not in self._set:
            return
        prev = self.owner.get(key)
        if prev == tenant:
            return
        if prev is not None:
            self._owned[prev] = self._owned.get(prev, 1) - 1
        self.owner[key] = tenant
        self._owned[tenant] = self._owned.get(tenant, 0) + 1

    def owned_count(self, tenant: str) -> int:
        return self._owned.get(tenant, 0)

    def owned_keys(self, tenant: str) -> List[Key]:
        return [k for k in self.resident if self.owner.get(k) == tenant]

    def _drop_owner(self, key: Key) -> None:
        prev = self.owner.pop(key, None)
        if prev is not None:
            self._owned[prev] = self._owned.get(prev, 1) - 1

    def access(self, key: Key, now: float = 0.0) -> bool:
        if key in self._set:
            self.hits += 1
            self.policy.on_access(key, now)
            return True
        self.misses += 1
        return False

    def insert(self, key: Key, now: float = 0.0,
               protected=frozenset()) -> Optional[Key]:
        """Insert ``key``; returns the evicted victim (if any). A
        zero-capacity cache (ablated tier) rejects the insert outright."""
        if self.capacity <= 0 or key in self._set:
            return None
        evicted = None
        if len(self.resident) >= self.capacity:
            evicted = self.policy.victim(self.resident, protected)
            self.remove(evicted)
        self.resident.append(key)
        self._set.add(key)
        self.policy.on_insert(key, now)
        return evicted

    def remove(self, key: Key) -> None:
        """Evict a specific resident key (caller already chose the victim)."""
        self.resident.remove(key)
        self._set.discard(key)
        self._drop_owner(key)
        self.policy.on_evict(key)

    @property
    def hit_ratio(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0
