"""OffloadEngine — ties tracing, prefetching, caching and the memory
simulator into the per-layer serving loop (the runtime of Figure 2).

The serving engine calls, for every forward iteration (one generated token)
and every MoE layer in execution order:

    stall = engine.on_layer(layer_idx, expert_token_counts, compute_time)

which (1) updates cur_eam, (2) refreshes prefetch priorities (Alg. 1 step 8),
(3) demand-fetches missing activated experts (steps 9-12, MAX_PRIORITY
queue-jump), (4) applies cache replacement on every arrival (Alg. 2), and
(5) advances the virtual clock by the layer's compute time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cache import (ActivationAwareCache, CachePolicy, ExpertCache,
                              LFUCache, LRUCache, NeighborAwareCache,
                              OracleCache, ReuseAwareDRAMCache)
from repro_torch.core.eam import EAMC
from repro_torch.core.memsim import DRAM, GPU, HWConfig, MemSim, PAPER_8GPU, SSD
from repro_torch.core.predictor import ExpertPredictor, make_predictor
from repro_torch.core.prefetch import (ActivationAwarePrefetcher, Prefetcher,
                                 SequenceContext)

Key = Tuple[int, int]


@dataclass
class OffloadConfig:
    n_moe_layers: int
    n_experts: int
    expert_bytes: int
    gpu_cache_experts: int          # slots in device HBM
    dram_cache_experts: int         # slots in host memory
    hw: HWConfig = field(default_factory=lambda: PAPER_8GPU)
    cache_policy: str = "moe-infinity"   # | lru | lfu | neighbor | oracle
    prefetch: str = "moe-infinity"       # | none | topk | traced-topk | oracle
    # repro-lint: disable=config-drift -- ablation-only knob set directly by simulator benchmarks (bench_cluster); the paper default 0 (all later layers) is what serving uses, so no serve.py flag
    prefetch_lookahead: int = 0          # 0 = all later layers (paper default)
    demand_overhead_s: float = 0.0       # per-demand fault overhead (UM)
    n_gpu_links: int = 1                 # parallel DRAM→device links (§7)
    # expert-parallel degree (DESIGN.md §8): >1 shards experts across D
    # devices with one host↔device link each (n_gpu_links is raised to D),
    # EAMC-guided placement deciding each expert's home shard, and a
    # compute-skew model for the all-to-all straggler term. 1 = the
    # single-device engine, bit-identical to pre-sharding behavior.
    n_devices: int = 1
    # quantized expert wire (DESIGN.md §7): the dtype experts ship in.
    # ``wire_expert_bytes`` is the per-expert transfer size the simulator
    # charges — None derives it analytically from the dtype (incl. int8
    # scale rows) via `quant.wire_itemsize`; model mode overrides it with
    # the host store's measured wire image size so sim bytes == real bytes.
    transfer_dtype: str = "fp32"
    wire_expert_bytes: Optional[int] = None
    # three-tier pipeline: weight prefetch priorities by the miss cost of
    # the expert's current tier (SSD residents stage SSD→DRAM early). A
    # no-op when the SSD hop is free, so False only exists for the
    # bit-invariance tests and ablations.
    tier_aware: bool = True
    # online EAMC lifecycle (§4.3 / DESIGN.md §4): learn every completed
    # sequence's EAM into the collection (capacity-bounded insert-or-merge)
    # and rebuild it in the background when the drift EWMA over match
    # distances degrades past the threshold. With good match distances the
    # trigger never fires, so an armed trigger is bit-identical to a
    # disarmed one on a stable workload.
    eamc_online: bool = False
    eamc_drift_threshold: float = 0.6    # EWMA Eq.(1) distance ⇒ drift
    eamc_drift_min_seqs: int = 8         # warmup + min gap between rebuilds
    # the prediction brain behind cache scoring, prefetch priorities, stall
    # admission, and placement heat (DESIGN.md §10): "eamc" is the paper's
    # trace matcher (bit-identical to the pre-refactor code paths),
    # "learned" the online bigram/marginal model, "hybrid" trace-matches
    # while the match distance is good and falls back to the learned model
    predictor: str = "eamc"              # | learned | hybrid
    # multi-tenant namespaces (DESIGN.md §11): a tuple of TenantSpec-shaped
    # objects (duck-typed — this module must not import the serving spec
    # layer). A tenant with its own PredictorSpec gets a private prediction
    # brain + prefetcher whose drift/reconstruction lifecycle never touches
    # any other tenant's; gpu_slot_quota bounds its GPU cache footprint.
    # () = untenanted, every new code path dormant (bit-identical engine).
    tenants: tuple = ()


class OffloadEngine:
    def __init__(self, cfg: OffloadConfig, *,
                 eamc: Optional[EAMC] = None,
                 prefetcher: Optional[Prefetcher] = None,
                 cache_policy: Optional[CachePolicy] = None,
                 oracle_future: Optional[List[Key]] = None,
                 predictor: Optional[ExpertPredictor] = None):
        self.cfg = cfg
        self.ctx = SequenceContext(cfg.n_moe_layers, cfg.n_experts)
        # rid-keyed per-request contexts; ``self.ctx`` is the incrementally
        # maintained batch-combined EAM of the *live* requests only
        self.seq_ctxs: Dict[Hashable, SequenceContext] = {}
        self.eamc = eamc if eamc is not None else EAMC(capacity=128)

        # the one prediction brain (DESIGN.md §10): cache scoring, prefetch
        # priorities, stall admission, and placement heat all consume it.
        # A caller-supplied instance wins (warm restarts, tests).
        if predictor is None:
            predictor = make_predictor(
                cfg.predictor, self.eamc,
                n_layers=cfg.n_moe_layers, n_experts=cfg.n_experts,
                online=cfg.eamc_online,
                drift_threshold=cfg.eamc_drift_threshold,
                drift_min_seqs=cfg.eamc_drift_min_seqs)
        self.predictor = predictor

        if prefetcher is not None:
            self.prefetcher = prefetcher
        elif cfg.prefetch == "moe-infinity":
            self.prefetcher = ActivationAwarePrefetcher(self.predictor)
        else:
            self.prefetcher = Prefetcher()  # on-demand only
        # drift telemetry + reconstruction only make sense when an
        # activation-aware prefetcher actually consumes the predictions
        # (matches the pre-refactor ``isinstance`` gating in
        # ``_eamc_lifecycle``)
        self.predictor.track_drift = isinstance(self.prefetcher,
                                                ActivationAwarePrefetcher)

        if cache_policy is not None:
            gpu_policy: CachePolicy = cache_policy
        elif cfg.cache_policy == "moe-infinity":
            gpu_policy = ActivationAwareCache(self.ctx, self.predictor)
        elif cfg.cache_policy == "lru":
            gpu_policy = LRUCache()
        elif cfg.cache_policy == "lfu":
            gpu_policy = LFUCache()
        elif cfg.cache_policy == "neighbor":
            gpu_policy = NeighborAwareCache()
        elif cfg.cache_policy == "oracle":
            gpu_policy = OracleCache(oracle_future or [])
        else:
            raise ValueError(cfg.cache_policy)
        self.gpu_cache = ExpertCache(cfg.gpu_cache_experts, gpu_policy)
        # host-memory tier: recency with activation-aware shielding
        # (Algorithm 2's horizon is one procedure — too short for the
        # DRAM tier's cross-request reuse; see ReuseAwareDRAMCache);
        # plain LRU for baselines
        self.dram_cache = ExpertCache(
            cfg.dram_cache_experts,
            ReuseAwareDRAMCache(self.ctx, self.predictor)
            if cfg.cache_policy == "moe-infinity" else LRUCache())

        from repro_torch.core import quant
        wire_bytes = cfg.wire_expert_bytes
        if wire_bytes is None:
            # expert_bytes is the master image; scale it by the wire
            # itemsize ratio (scale-row overhead needs the arch — callers
            # that know it pass wire_expert_bytes explicitly)
            wire_bytes = int(cfg.expert_bytes
                             * quant.wire_itemsize(cfg.transfer_dtype) / 4)
        # expert-parallel placement (DESIGN.md §8): only instantiated at
        # D>1 so the single-device hot path stays byte-for-byte untouched
        self.placement = None
        link_of = None
        n_links = cfg.n_gpu_links
        if cfg.n_devices > 1:
            from repro_torch.core.placement import ExpertPlacement
            self.placement = ExpertPlacement(
                cfg.n_moe_layers, cfg.n_experts, cfg.n_devices)
            n_links = max(cfg.n_gpu_links, cfg.n_devices)
            link_of = lambda key: self.placement.device_of(*key)  # noqa: E731
        self.sim = MemSim(
            cfg.hw,
            expert_bytes=wire_bytes,
            on_arrive=self._on_arrive, admit=self._admit,
            demand_overhead=cfg.demand_overhead_s,
            n_gpu_links=n_links, link_of=link_of)
        self.prefetcher.tier_weight = (self.sim.tier_weight
                                       if cfg.tier_aware else None)
        self._protected: frozenset = frozenset()

        # -- tenant namespaces (DESIGN.md §11) ----------------------------
        self.tenant_predictors: Dict[str, ExpertPredictor] = {}
        self.tenant_prefetchers: Dict[str, Prefetcher] = {}
        self.tenant_fallback: Dict[str, bool] = {}
        self.tenant_quota: Dict[str, int] = {}
        self.tenant_paths: Dict[str, str] = {}
        self.tenant_predictor_source: Dict[str, str] = {}
        self.seq_tenant: Dict[Hashable, str] = {}
        self.tenant_access: Dict[str, Dict[str, int]] = {}
        # in-flight prefetch attribution: key -> the ONE tenant whose plan
        # proposed it (quota enforcement on arrival); multi-tenant and
        # untenanted proposals stay unattributed
        self._prefetch_tenant: Dict[Key, str] = {}
        self._tenant_ids: List[str] = []
        for t in cfg.tenants:
            self._register_tenant(t)

        self.warm_start()

        # stats
        self.layer_stalls: List[float] = []
        self.access_log: List[Key] = []   # expert access order (for Belady)
        self.ondemand_bytes = 0.0
        self.prefetch_bytes = 0.0

    # -- initial placement (§6.1: topological fill) -------------------------
    def warm_start(self) -> None:
        keys = [(l, e) for l in range(self.cfg.n_moe_layers)
                for e in range(self.cfg.n_experts)]
        for k in keys[: self.cfg.gpu_cache_experts]:
            self.gpu_cache.insert(k)
            self.sim.on_gpu.add(k)
        rest = keys[self.cfg.gpu_cache_experts:]
        for k in rest[: self.cfg.dram_cache_experts]:
            self.dram_cache.insert(k)
            self.sim.in_dram.add(k)

    # -- tenant namespaces (DESIGN.md §11) -----------------------------------
    def _register_tenant(self, t) -> None:
        """``t`` is TenantSpec-shaped (duck-typed): ``tenant_id``,
        ``predictor`` (PredictorSpec-shaped or None = share the engine
        brain), ``gpu_slot_quota``, ``shared_fallback``."""
        tid = str(t.tenant_id)
        self._tenant_ids.append(tid)
        quota = getattr(t, "gpu_slot_quota", None)
        if quota:
            self.tenant_quota[tid] = int(quota)
        ps = getattr(t, "predictor", None)
        if ps is None:
            return                      # shared-namespace tenant
        cfg = self.cfg
        t_eamc = EAMC(capacity=int(getattr(ps, "capacity", 32) or 32))
        kind = getattr(ps, "kind", None) or cfg.predictor
        pred = make_predictor(
            kind, t_eamc,
            n_layers=cfg.n_moe_layers, n_experts=cfg.n_experts,
            online=bool(getattr(ps, "online", False)) or cfg.eamc_online,
            drift_threshold=cfg.eamc_drift_threshold,
            drift_min_seqs=cfg.eamc_drift_min_seqs)
        pred.track_drift = isinstance(self.prefetcher,
                                      ActivationAwarePrefetcher)
        source = "cold"
        path = getattr(ps, "path", None)
        if path:
            self.tenant_paths[tid] = str(path)
            from pathlib import Path
            p = Path(path)
            if p.suffix != ".npz":
                p = p.with_suffix(p.suffix + ".npz")
            if p.exists():
                pred.load_state(str(p))
                source = "load"
        if isinstance(self.prefetcher, ActivationAwarePrefetcher):
            pf: Prefetcher = ActivationAwarePrefetcher(pred)
        else:
            pf = Prefetcher()
        pf.tier_weight = self.prefetcher.tier_weight
        self.tenant_predictors[tid] = pred
        self.tenant_prefetchers[tid] = pf
        self.tenant_fallback[tid] = bool(getattr(t, "shared_fallback", True))
        self.tenant_predictor_source[tid] = source

    def predictor_for(self, tenant: Optional[str]) -> ExpertPredictor:
        """The brain serving this tenant's predictions right now: its own,
        unless it has none — or it is cold and shared_fallback is on."""
        pred = self.tenant_predictors.get(tenant or "")
        if pred is None:
            return self.predictor
        if self.tenant_fallback.get(tenant, True) and pred.is_cold:
            return self.predictor
        return pred

    def prefetcher_for(self, tenant: Optional[str]) -> Prefetcher:
        pf = self.tenant_prefetchers.get(tenant or "")
        if pf is None:
            return self.prefetcher
        pred = self.tenant_predictors[tenant]
        if self.tenant_fallback.get(tenant, True) and pred.is_cold:
            return self.prefetcher
        return pf

    def save_tenant_state(self) -> Dict[str, str]:
        """Persist every path-configured tenant brain; returns
        tenant_id -> written path."""
        out: Dict[str, str] = {}
        for tid, path in self.tenant_paths.items():
            pred = self.tenant_predictors.get(tid)
            save = getattr(pred, "save", None)
            if save is None:
                continue
            out[tid] = str(save(path))
        return out

    def _enforce_quota(self, tenant: str, key: Key) -> None:
        """About to demand-fetch ``key`` for ``tenant`` at its GPU-slot
        quota: evict one of the tenant's *own* residents first so the
        arrival reuses its slot instead of displacing another tenant's."""
        q = self.tenant_quota.get(tenant)
        if q is None or self.gpu_cache.owned_count(tenant) < q:
            return
        owned = [k for k in self.gpu_cache.owned_keys(tenant)
                 if k not in self._protected]
        if not owned:
            return
        victim = self.gpu_cache.policy.victim(owned, self._protected)
        if victim is None:
            victim = owned[0]
        self.gpu_cache.remove(victim)
        self.sim.evict(victim, GPU)
        self._demote(victim, self.sim.clock)

    def _account_owner(self, key: Key, tenants) -> None:
        """Slot-ownership accounting after an access resolved: only
        single-tenant activations claim slots, and never past quota."""
        if len(tenants) != 1 or key not in self.gpu_cache:
            return
        tenant = next(iter(tenants))
        q = self.tenant_quota.get(tenant)
        if (q is not None and self.gpu_cache.owner.get(key) != tenant
                and self.gpu_cache.owned_count(tenant) >= q):
            return
        self.gpu_cache.set_owner(key, tenant)

    # -- zero-capacity DRAM tier (GPU↔SSD ablation) ---------------------------
    # With ``dram_cache_experts=0`` the DRAM level still exists in the
    # simulator as the staging hop of the SSD→DRAM→GPU pipeline, but
    # nothing may *live* there: any path that would normally hand a key to
    # the DRAM cache must instead release the transient staging image as
    # soon as its GPU leg completes (or is vetoed), or ``sim.in_dram``
    # residency leaks and misses stop paying the NVMe hop. Every such path
    # funnels through these two helpers — keep it that way.
    def _dram_is_staging_only(self) -> bool:
        return self.dram_cache.capacity <= 0

    def _release_staging(self, key: Key) -> None:
        self.sim.evict(key, DRAM)

    # -- prefetch admission (§6.2: replacement decided before the copy) ------
    def _admit(self, key: Key, tier: str, priority: float) -> bool:
        cache = self.gpu_cache if tier == GPU else self.dram_cache
        if cache.capacity <= 0:
            # ablated tier: veto the copy; if the expert was staged through
            # the transient DRAM buffer for this hop, release that image
            if tier == GPU and self._dram_is_staging_only():
                self._release_staging(key)
            return False
        if len(cache.resident) < cache.capacity or key in cache._set:
            return True
        victim = cache.policy.victim(cache.resident, self._protected)
        if isinstance(cache.policy, ActivationAwareCache):
            vscore = cache.policy.scores([victim])[0]
        else:
            # no comparable score: baseline policies (their systems copy
            # unconditionally, which is part of why they lose) and — by
            # design — the reuse-aware DRAM tier, which admits stagings
            # unconditionally like the LRU family it extends (its victim
            # is the least-recently-used activation-cold expert)
            return True
        ok = priority > vscore
        if not ok and tier == GPU and self._dram_is_staging_only():
            # vetoed GPU copy with no DRAM tier: the staging image that
            # carried it across the SSD hop has no cache to live in
            self._release_staging(key)
        return ok

    # -- cache replacement on arrival (Alg. 2 trigger) -----------------------
    def _on_arrive(self, key: Key, tier: str, now: float) -> None:
        if tier == GPU:
            if self._dram_is_staging_only():
                # the DRAM image was only the pipeline staging buffer —
                # release it on GPU arrival
                self._release_staging(key)
            # quota enforcement covers prefetch arrivals too: an at-quota
            # tenant's upload recycles one of its own slots instead of
            # displacing a neighbour's resident (interference containment,
            # DESIGN.md §11)
            tenant = self._prefetch_tenant.pop(key, None)
            if tenant is not None and self.tenant_quota.get(tenant):
                self._enforce_quota(tenant, key)
            evicted = self.gpu_cache.insert(key, now, self._protected)
            if evicted is not None:
                self.sim.evict(evicted, GPU)
                self._demote(evicted, now)
            if tenant is not None:
                self._account_owner(key, (tenant,))
        else:
            if self._dram_is_staging_only():
                # keep the staging image only while a GPU leg is still
                # pending on it
                if key not in self.sim._gpu_pending_priority:
                    self._release_staging(key)
                return
            evicted = self.dram_cache.insert(key, now, self._protected)
            if evicted is not None:
                self.sim.evict(evicted, DRAM)

    def _dram_access(self, key: Key) -> None:
        """Post-demand-fetch DRAM-tier recency touch (no-op when ablated)."""
        if not self._dram_is_staging_only():
            self.dram_cache.access(key, self.sim.clock)

    def _demote(self, key: Key, now: float) -> None:
        """A GPU-evicted expert falls back to the DRAM tier (no copy is
        simulated: the DRAM image is still valid — weights are read-only —
        so demotion is a residency-set update). An Alg-2-scored DRAM tier
        only takes the demoted expert when its score beats the would-be
        victim's; the default reuse-aware DRAM tier and the baselines
        demote unconditionally (LRU semantics: the GPU-evicted expert was
        recently used on-device, so it displaces the LRU cold resident)."""
        if self._dram_is_staging_only():
            return  # no DRAM tier: the evicted expert is SSD-resident again
        if key in self.dram_cache:
            self.sim.in_dram.add(key)
            return
        if len(self.dram_cache.resident) >= self.dram_cache.capacity and \
                isinstance(self.dram_cache.policy, ActivationAwareCache):
            victim = self.dram_cache.policy.victim(
                self.dram_cache.resident, self._protected)
            vscore, kscore = self.dram_cache.policy.scores([victim, key])
            if kscore <= vscore:
                return           # demoted expert is colder than everything
            # evict the victim we already chose (avoids a second scan
            # inside insert — this runs on the per-arrival hot path)
            self.dram_cache.remove(victim)
            self.sim.evict(victim, DRAM)
        dram_victim = self.dram_cache.insert(key, now, self._protected)
        if dram_victim is not None:
            self.sim.evict(dram_victim, DRAM)
        self.sim.in_dram.add(key)

    # -- sequence lifecycle ----------------------------------------------------
    # The paper traces *per sequence* (§4: separate EAMs; aggregation across
    # sequences destroys the signal). Sequence state follows *request*
    # lifetime, not batch lifetime: the serving engine registers a context
    # when a request is admitted (at any token boundary, under continuous
    # batching) and finishes it when the request completes. Prefetch plans
    # are computed per live sequence and merged by max-priority; ``self.ctx``
    # holds the batch-combined EAM used by Algorithm 2's cache scoring ("the
    # ongoing generative inference") and is maintained incrementally as
    # sequences join and leave.
    def register_seq(self, rid: Hashable,
                     tenant: Optional[str] = None) -> SequenceContext:
        """A request joins the running set; its per-sequence EAM starts.
        ``tenant`` routes the sequence's predictions and training to that
        tenant's namespace (None/"" = the shared namespace)."""
        if tenant:
            self.seq_tenant[rid] = str(tenant)
        if rid in self.seq_ctxs:
            return self.seq_ctxs[rid]
        if not self.seq_ctxs:
            # fresh inference procedure: reset per-procedure prediction
            # state (the prefetcher cascades into its predictor; with a
            # prediction-free prefetcher the predictor is reset directly)
            if isinstance(self.prefetcher, ActivationAwarePrefetcher):
                self.prefetcher.start_sequence()
            else:
                self.predictor.start_sequence()
            for tid, pf in self.tenant_prefetchers.items():
                if isinstance(pf, ActivationAwarePrefetcher):
                    pf.start_sequence()
                else:
                    self.tenant_predictors[tid].start_sequence()
        ctx = SequenceContext(self.cfg.n_moe_layers, self.cfg.n_experts)
        self.seq_ctxs[rid] = ctx
        return ctx

    def finish_seq(self, rid: Hashable, *,
                   record_drift: bool = False) -> Optional[np.ndarray]:
        """A request completed: free its context and remove its counts from
        the batch-combined EAM so it stops influencing Alg. 2 cache scores
        and prefetch merging. Returns the sequence's final EAM."""
        ctx = self.seq_ctxs.pop(rid, None)
        tenant = self.seq_tenant.pop(rid, "")
        if ctx is None:
            return None
        eam = ctx.cur_eam.copy()
        np.subtract(self.ctx.cur_eam, eam, out=self.ctx.cur_eam)
        np.maximum(self.ctx.cur_eam, 0.0, out=self.ctx.cur_eam)
        self.prefetcher.observe(ctx)
        if record_drift:
            self.eamc.record_for_reconstruction(eam)
        # the predictor's per-completed-sequence learning step (DESIGN.md
        # §10): for the EAMC brain this is the §4.3 online lifecycle —
        # drift telemetry, insert-or-merge, bounded reconstruction — and
        # for every brain it also folds the EAM into the shared placement
        # heat EWMA. Runs at the sequence boundary — nothing here touches
        # the per-layer hot path.
        t_pred = self.tenant_predictors.get(tenant)
        if t_pred is not None:
            # strict namespace isolation: a tenant-owned sequence trains
            # ONLY its own brain — its drift can never merge into, insert
            # into, or reconstruct the shared (or any other tenant's)
            # collection. The shared placement-heat stream still sees every
            # sequence so expert-parallel rebalancing keeps full load info.
            t_pred.finish_seq(eam)
            self.predictor._update_heat(eam)
        else:
            self.predictor.finish_seq(eam)
        if self.placement is not None:
            # placement learns from the same finish_seq stream as the
            # predictor: adopt its fresh heat EWMA as the load estimate,
            # re-home by LPT, then top up hot-expert replicas
            self.placement.set_load(self.predictor.placement_heat())
            self.placement.rebalance()
            self.placement.replicate()
        if not self.seq_ctxs:
            # engine idle: the inference procedure is over — drop its
            # prefetch queue (Algorithm 1's ``q`` is procedure-scoped),
            # clear residual float fuzz in the combined EAM, and reset the
            # predictor's per-procedure state (batch-merged prediction)
            self.ctx.reset()
            self.predictor.start_sequence()
            for p in self.tenant_predictors.values():
                p.start_sequence()
            self.sim.clear_queues()
        return eam

    # -- the per-layer hot path (Algorithm 1) -----------------------------------
    def on_layer(self, layer_idx: int, token_counts: np.ndarray,
                 compute_time: float,
                 rids: Optional[Sequence[Hashable]] = None) -> float:
        """``token_counts``: (B, E) or (E,) tokens routed to each expert of
        this layer this iteration (per live sequence when 2-D); ``rids``
        names the request behind each row (defaults to registration order,
        auto-registering slot-keyed sequences for direct/legacy callers).
        Returns stall seconds spent waiting for experts."""
        token_counts = np.asarray(token_counts)
        if token_counts.ndim == 1:
            token_counts = token_counts[None]
        if rids is None:
            if len(self.seq_ctxs) == token_counts.shape[0]:
                rids = list(self.seq_ctxs)
            else:
                rids = [("_slot", b) for b in range(token_counts.shape[0])]
        combined = token_counts.sum(axis=0)
        self.ctx.update(layer_idx, combined)                # steps 6-7

        # step 8: per-sequence predictions, merged by max priority. Each
        # tenant-owned sequence plans through its tenant's prefetcher/brain
        # (shared-fallback while cold); the untenanted engine takes the
        # identical pre-tenant path.
        tenanted = bool(self._tenant_ids)
        merged: Dict[Key, float] = {}
        plan_tenants: Dict[Key, set] = {}
        pred_merged = None
        for b, rid in enumerate(rids):
            c = self.seq_ctxs.get(rid)
            if c is None:
                c = self.register_seq(rid)
            if token_counts[b].sum() == 0 and c.cur_eam.sum() == 0:
                continue  # no activity yet
            c.update(layer_idx, token_counts[b])
            tid = self.seq_tenant.get(rid) if tenanted else None
            pf = (self.prefetcher_for(tid) if tenanted else self.prefetcher)
            for key, pr in pf.plan(c, layer_idx):
                if self.cfg.prefetch_lookahead and \
                        key[0] > layer_idx + self.cfg.prefetch_lookahead:
                    continue
                if pr > merged.get(key, -1.0):
                    merged[key] = pr
                if self.tenant_quota:
                    plan_tenants.setdefault(key, set()).add(tid or "")
            ratios = getattr(pf, "last_match_ratios", None)
            if ratios is not None:
                pred_merged = (ratios if pred_merged is None
                               else np.maximum(pred_merged, ratios))
        if self.tenant_quota:
            # refresh in-flight attribution: a key is tenant-owned only
            # while exactly one tenant's plan wants it
            for key in merged:
                ts = plan_tenants.get(key) or ()
                if len(ts) == 1 and "" not in ts:
                    self._prefetch_tenant[key] = next(iter(ts))
                else:
                    self._prefetch_tenant.pop(key, None)
        # §6.2 alignment: one predictor lifecycle tick per MoE layer — the
        # batch-merged prediction feeds Alg-2 cache scoring (victim_score /
        # batch_probs) and the combined routing is the online training
        # signal for learned brains
        self.predictor.observe_iteration(layer_idx, combined, pred_merged)
        for key, pr in merged.items():
            self.sim.submit_prefetch(key, pr)

        # steps 9-12: activated experts must be on device. Enqueue all
        # missing ones at MAX_PRIORITY first, then wait (minimizes
        # head-of-line blocking behind an in-flight prefetch).
        activated = [(layer_idx, int(e)) for e in np.nonzero(combined)[0]]
        self.access_log.extend(activated)
        self._protected = frozenset(activated)
        # interference accounting: which tenants' tokens activated each
        # expert this iteration (drives per-tenant hit/miss counters,
        # demand-stall attribution, and slot ownership)
        key_tenants: Dict[Key, set] = {}
        if tenanted:
            for b, rid in enumerate(rids):
                tid = self.seq_tenant.get(rid)
                if not tid:
                    continue
                for e in np.nonzero(token_counts[b])[0]:
                    key_tenants.setdefault((layer_idx, int(e)),
                                           set()).add(tid)
        stall = 0.0
        missing = []
        for key in activated:
            hit = self.gpu_cache.access(key, self.sim.clock)
            if tenanted:
                for tid in key_tenants.get(key, ()):
                    ta = self.tenant_access.setdefault(
                        tid, {"hits": 0, "misses": 0})
                    ta["hits" if hit else "misses"] += 1
            if hit:
                if key not in self.sim.on_gpu:
                    self.sim.on_gpu.add(key)
                if tenanted:
                    self._account_owner(key, key_tenants.get(key, ()))
            else:
                missing.append(key)
                self.sim.submit_prefetch(key, 1e30)
        for key in missing:
            if tenanted:
                tset = key_tenants.get(key, ())
                if len(tset) == 1:
                    self._enforce_quota(next(iter(tset)), key)
                stall += self.sim.demand_fetch(
                    key, tenants=tuple(sorted(tset)) or None)
                self._account_owner(key, tset)
            else:
                stall += self.sim.demand_fetch(key)
            self._dram_access(key)
        self._protected = frozenset()

        # step 13: experts execute. With expert parallelism the layer's
        # wall time is the straggler shard's share of the grouped GEMM
        # (comp × max token share; replicas split hot experts' tokens) —
        # max_share is 1.0 at D=1 so the single-device model is unchanged.
        if self.placement is not None:
            compute_time = compute_time * self.placement.max_share(
                layer_idx, combined)
        self.sim.advance(compute_time)
        self.layer_stalls.append(stall)
        return stall

    # -- metrics ------------------------------------------------------------------
    def stats(self) -> dict:
        sim = self.sim
        # drift telemetry lives on the predictor now; trace-free brains
        # (and prediction-free prefetchers, which never feed the EWMA)
        # report nan exactly like the pre-refactor non-aware path
        mean_dist = float(self.predictor.mean_match_distance)
        tenants = {}
        if self._tenant_ids:
            sim_t = sim.tenant_stats()
            for tid in self._tenant_ids:
                ta = self.tenant_access.get(tid, {})
                h, m = ta.get("hits", 0), ta.get("misses", 0)
                sd = sim_t.get(tid, {})
                pred = self.tenant_predictors.get(tid)
                tenants[tid] = {
                    "gpu_hits": h,
                    "gpu_misses": m,
                    "gpu_hit_ratio": h / (h + m) if h + m else 0.0,
                    "demand_fetches": sd.get("demand_fetches", 0.0),
                    "demand_stall_s": sd.get("stall_s", 0.0),
                    "demand_bytes": sd.get("bytes", 0.0),
                    "gpu_slots_owned": self.gpu_cache.owned_count(tid),
                    "gpu_slot_quota": self.tenant_quota.get(tid),
                    "predictor_kind": (pred.name if pred is not None
                                       else "shared"),
                    "predictor_source": self.tenant_predictor_source.get(
                        tid, "shared"),
                    "predictor_seqs": (pred.stats().get(
                        "predictor_seqs_trained", 0)
                        if pred is not None else 0),
                }
        return {
            **({"tenants": tenants} if tenants else {}),
            "predictor": self.predictor.name,
            **self.predictor.stats(),
            "eamc_entries": len(self.eamc.entries),
            "eamc_online_inserts": self.eamc.n_online_inserts,
            "eamc_online_merges": self.eamc.n_online_merges,
            "eamc_reconstructions": self.eamc.n_reconstructions,
            "eamc_mean_match_distance": mean_dist,
            "gpu_hit_ratio": self.gpu_cache.hit_ratio,
            "dram_hit_ratio": self.dram_cache.hit_ratio,
            "demand_fetches": sim.demand_fetches,
            "demand_from_dram": sim.demand_from[DRAM],
            "demand_from_ssd": sim.demand_from[SSD],
            "staged_prefetches": sim.staged_prefetches,
            "prefetch_hits": sim.prefetch_hits,
            "stall_time": sim.stall_time,
            "pcie_bytes": sim.gpu_bytes_moved,
            "pcie_demand_bytes": sum(l.demand_bytes for l in sim.gpu_links),
            "pcie_prefetch_bytes": sum(l.prefetch_bytes
                                       for l in sim.gpu_links),
            "ssd_bytes": sim.ssd_link.bytes_moved,
            "ssd_demand_bytes": sim.ssd_link.demand_bytes,
            "ssd_prefetch_bytes": sim.ssd_link.prefetch_bytes,
            "clock": sim.clock,
            "n_gpu_links": len(sim.gpu_links),
            "gpu_link_stats": sim.link_stats(),
            **(self.placement.stats() if self.placement is not None else {}),
        }
