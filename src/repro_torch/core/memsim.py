"""Multi-tier memory & link event simulator.

Models the paper's serving server: experts live on SSD; DRAM and device HBM
hold caches; one I/O worker per link moves one expert at a time (the paper's
"dedicated I/O thread per PCIe link", §5.3). The simulator keeps a virtual
clock in seconds; the serving engine advances it with compute time and the
links drain their queues in the background.

This is the one deliberately-simulated layer (no PCIe exists on this host) —
see DESIGN.md §3. Every *policy* decision (what to fetch, what to evict, in
which order) is executed exactly, not approximated.

Hardware constants default to the paper's 8-GPU server testbed
(PCIe 4.0 x16 ≈ 25 GB/s effective, NVMe RAID0 ≈ 6 GB/s) with a TPU v5e
flavour available for the TPU-adapted deployment story.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, Hashable, Optional, Set, Tuple

Key = Hashable  # expert key: (layer_idx, expert_idx)

GPU, DRAM, SSD = "gpu", "dram", "ssd"
MAX_PRIORITY = float("inf")


@dataclass(frozen=True)
class HWConfig:
    dram_to_dev_gbps: float = 25.0     # PCIe 4.0 x16 effective
    ssd_to_dram_gbps: float = 6.0      # NVMe RAID0
    # NVMe submission/seek cost: each SSD read pays 1/ssd_iops seconds on
    # top of the bandwidth term. 0 = ideal drive (keeps pre-three-tier
    # configs bit-identical); a consumer NVMe is ~500k–1M read IOPS.
    ssd_iops: float = 0.0
    # compute model (per device)
    # repro-lint: disable=config-drift -- hardware compute-model constant selected via presets (PAPER_8GPU/TPU_V5E), not a per-run CLI knob
    peak_flops: float = 27.8e12        # A5000 fp32 (the paper's testbed)
    # repro-lint: disable=config-drift -- hardware compute-model constant selected via presets (PAPER_8GPU/TPU_V5E), not a per-run CLI knob
    hbm_gbps: float = 768.0            # GDDR6

    @property
    def ssd_op_latency_s(self) -> float:
        return 1.0 / self.ssd_iops if self.ssd_iops > 0 else 0.0


PAPER_8GPU = HWConfig()
TPU_V5E = HWConfig(dram_to_dev_gbps=32.0, ssd_to_dram_gbps=6.0,
                   peak_flops=197e12, hbm_gbps=819.0)


# prefetch priorities live in (0, ~1] (activation ratio × layer decay,
# possibly × a tier miss-cost weight); anything at or above this threshold
# is a demand fetch jumping the queue (MAX_PRIORITY or the engine's 1e30)
DEMAND_CLASS = 1e29


class Link:
    """One transfer queue with a single worker (one expert in flight).

    ``op_latency`` is a fixed per-transfer setup cost (NVMe submission /
    seek for the SSD link; 0 for PCIe copies).
    """

    def __init__(self, gbps: float, op_latency: float = 0.0):
        self.gbps = gbps
        self.op_latency = op_latency
        self._heap: list = []
        self._counter = itertools.count()
        self._entries: Dict[Key, list] = {}
        self.busy_until = 0.0
        self.inflight: Optional[Tuple[Key, float, float, float]] = None
        # (key, start, end, priority)
        self.bytes_moved = 0.0
        self.n_transfers = 0
        # demand/prefetch split of the traffic (per-tier accounting)
        self.demand_bytes = 0.0
        self.prefetch_bytes = 0.0
        # accumulated seconds this link spent transferring (utilization =
        # busy_s / wall clock); aborted transfers are unwound
        self.busy_s = 0.0

    # -- queue management (paper §5.3: re-enqueue replaces priority) ---------
    def submit(self, key: Key, priority: float, size: int,
               now: float = 0.0) -> None:
        if key in self._entries:
            self._entries[key][-1] = None          # invalidate old entry
        entry = [-priority, next(self._counter), key, size, now, key]
        self._entries[key] = entry
        heapq.heappush(self._heap, entry)

    def cancel(self, key: Key) -> None:
        if key in self._entries:
            self._entries[key][-1] = None
            del self._entries[key]

    def _pop(self) -> Optional[Tuple[Key, int, float, float]]:
        """-> (key, size, priority, available_at)"""
        while self._heap:
            neg_p, _, key, size, avail, live = heapq.heappop(self._heap)
            if live is not None:
                del self._entries[key]
                return key, size, -neg_p, avail
        return None

    def _requeue(self, key: Key, size: int, priority: float,
                 avail: float) -> None:
        entry = [-priority, next(self._counter), key, size, avail, key]
        self._entries[key] = entry
        heapq.heappush(self._heap, entry)

    def queued(self, key: Key) -> bool:
        return key in self._entries

    def queue_len(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        """Drop all queued (not in-flight) requests — the prefetch queue is
        scoped to one inference procedure (Algorithm 1's ``q``)."""
        for e in self._entries.values():
            e[-1] = None
        self._entries.clear()


class MemSim:
    """Event-driven multi-tier memory simulator for one device.

    ``on_arrive(key, tier, now)`` callback lets the offload engine apply its
    cache-replacement policy when a transfer lands.
    """

    def __init__(self, hw: HWConfig = PAPER_8GPU, *,
                 expert_bytes: int, on_arrive=None, admit=None,
                 demand_overhead: float = 0.0, n_gpu_links: int = 1,
                 link_of=None):
        self.hw = hw
        self.expert_bytes = expert_bytes
        # per-demand-fetch fixed overhead (CUDA-UM baselines pay page-fault
        # handling per migration batch; 0 for explicit-copy systems)
        self.demand_overhead = demand_overhead
        self.clock = 0.0
        # beyond-paper generalization of §7's per-GPU prefetch threads:
        # experts stripe deterministically across n parallel DRAM→device
        # links (a multi-GPU server, or a v5e host's multiple PCIe roots)
        self.gpu_links = [Link(hw.dram_to_dev_gbps)
                          for _ in range(max(1, n_gpu_links))]
        # expert→link routing: default deterministic hash striping; an
        # expert-parallel engine passes a placement-aware ``link_of(key)``
        # so each expert rides its home device's host↔device link
        self.link_of = link_of
        self.ssd_link = Link(hw.ssd_to_dram_gbps, hw.ssd_op_latency_s)
        self.on_gpu: Set[Key] = set()
        self.in_dram: Set[Key] = set()
        self.on_arrive = on_arrive or (lambda key, tier, now: None)
        # §6.2: cache replacement is applied BEFORE initiating the copy —
        # admit(key, tier, priority) may veto a prefetch whose priority does
        # not beat the would-be victim. Demand fetches are never vetoed.
        self.admit = admit or (lambda key, tier, priority: True)
        self._gpu_pending_priority: Dict[Key, float] = {}
        self.stall_time = 0.0
        self.demand_fetches = 0
        self.prefetch_hits = 0
        # three-tier accounting: where did each demand fetch find the
        # expert (DRAM = the prefetcher staged or warm-start placed it one
        # hop away; SSD = it pays both hops), and how many SSD→DRAM
        # stagings the prefetcher completed
        self.demand_from: Dict[str, int] = {DRAM: 0, SSD: 0}
        self.staged_prefetches = 0
        # per-tenant demand attribution (DESIGN.md §11): a demand fetch
        # triggered by several tenants' tokens in one iteration splits
        # evenly across them — the interference-accounting signal behind
        # the per-tenant stall/bytes columns in stats(). Empty (and the
        # demand_fetch fast path untouched) for untenanted engines.
        self.tenant_demand: Dict[str, Dict[str, float]] = {}

    def _note_tenant_demand(self, tenants, stall: float) -> None:
        if not tenants:
            return
        share = 1.0 / len(tenants)
        for t in tenants:
            d = self.tenant_demand.setdefault(
                t, {"demand_fetches": 0.0, "stall_s": 0.0, "bytes": 0.0})
            d["demand_fetches"] += share
            d["stall_s"] += stall * share
            d["bytes"] += self.expert_bytes * share

    def tenant_stats(self) -> Dict[str, Dict[str, float]]:
        return {t: dict(v) for t, v in self.tenant_demand.items()}

    # -- transfer mechanics ----------------------------------------------------
    @property
    def gpu_link(self) -> Link:
        return self.gpu_links[0]

    def _gpu_for(self, key: Key) -> Link:
        if self.link_of is not None:
            return self.gpu_links[self.link_of(key) % len(self.gpu_links)]
        return self.gpu_links[hash(key) % len(self.gpu_links)]

    def _gpu_inflight(self, key: Key) -> Optional[tuple]:
        link = self._gpu_for(key)
        if link.inflight and link.inflight[0] == key:
            return link.inflight
        return None

    @property
    def gpu_bytes_moved(self) -> float:
        return sum(l.bytes_moved for l in self.gpu_links)

    def link_stats(self) -> list:
        """Per DRAM→device-link counters (the D-device crosswalk
        needs per-link utilization, not just the aggregate)."""
        return [
            {
                "bytes_moved": l.bytes_moved,
                "demand_bytes": l.demand_bytes,
                "prefetch_bytes": l.prefetch_bytes,
                "n_transfers": l.n_transfers,
                "busy_s": l.busy_s,
                "utilization": (l.busy_s / self.clock) if self.clock > 0
                else 0.0,
            }
            for l in self.gpu_links
        ]

    def _xfer_time(self, link: Link) -> float:
        return self.expert_bytes / (link.gbps * 1e9) + link.op_latency

    # -- tier model (three-tier SSD→DRAM→GPU pipeline) ----------------------
    def tier_of(self, key: Key) -> str:
        if key in self.on_gpu:
            return GPU
        if key in self.in_dram:
            return DRAM
        return SSD

    def miss_cost(self, tier: str) -> float:
        """Seconds an unstaged demand fetch pays when the expert currently
        lives in ``tier`` (hop times are sequential for one expert; the
        pipeline only overlaps hops of *different* experts)."""
        if tier == GPU:
            return 0.0
        dram_hop = self._xfer_time(self.gpu_link)
        if tier == DRAM:
            return dram_hop
        return self._xfer_time(self.ssd_link) + dram_hop

    def tier_weight(self, key: Key) -> float:
        """Miss cost of the expert's current tier relative to a DRAM
        resident's — the tier-aware prefetch priority multiplier. 1.0 for
        DRAM residents, 0.0 for GPU residents (nothing left to fetch;
        ``submit_prefetch`` drops them before the weight matters), and
        1.0 for everything whenever the SSD hop is free (∞ bandwidth,
        0 op latency), so two-tier configs are bit-identical."""
        dram_hop = self._xfer_time(self.gpu_link)
        if dram_hop <= 0.0:
            return 1.0
        return self.miss_cost(self.tier_of(key)) / dram_hop

    def _run_links(self, until: float) -> None:
        """Drain link work up to virtual time ``until``."""
        progressed = True
        while progressed:
            progressed = False
            for link, tier in [(self.ssd_link, DRAM)] + \
                    [(l, GPU) for l in self.gpu_links]:
                # complete inflight
                if link.inflight and link.busy_until <= until:
                    key, _s, _e, pr = link.inflight
                    link.inflight = None
                    self._arrive(key, tier, link.busy_until, pr)
                    progressed = True
                # start next queued transfer(s)
                while link.inflight is None and link._heap:
                    nxt = link._pop()
                    if nxt is None:
                        break
                    key, size, pr, avail = nxt
                    if self._skip(key, tier):
                        progressed = True
                        continue
                    start = max(link.busy_until, avail)
                    if start > until:
                        link._requeue(key, size, pr, avail)
                        break
                    if pr < DEMAND_CLASS and not self.admit(key, tier, pr):
                        # NOTE: do NOT touch _gpu_pending_priority — it
                        # belongs to the SSD→DRAM pipeline stage (a demand
                        # fetch may have raised it).
                        progressed = True
                        continue
                    if tier == GPU and key not in self.in_dram:
                        # source evicted from DRAM while queued: reroute
                        # through the SSD tier
                        self.ssd_link.submit(key, pr, size, now=start)
                        self._gpu_pending_priority[key] = max(
                            pr, self._gpu_pending_priority.get(key, 0))
                        progressed = True
                        continue
                    dur = self._xfer_time(link)
                    link.inflight = (key, start, start + dur, pr)
                    link.busy_until = start + dur
                    link.busy_s += dur
                    link.bytes_moved += size
                    if pr >= DEMAND_CLASS:
                        link.demand_bytes += size
                    else:
                        link.prefetch_bytes += size
                    link.n_transfers += 1
                    progressed = True

    def _skip(self, key: Key, tier: str) -> bool:
        """Avoid useless copies (§5.3: check allocation before memcpy)."""
        if tier == GPU:
            return key in self.on_gpu
        return key in self.in_dram or key in self.on_gpu

    def _arrive(self, key: Key, tier: str, t: float, priority: float) -> None:
        if tier == DRAM:
            self.in_dram.add(key)
            if priority < DEMAND_CLASS:
                self.staged_prefetches += 1
            self.on_arrive(key, DRAM, t)
            # multi-tier pipelining (§5.3): re-enqueue for DRAM→GPU with the
            # original priority if it was headed to the device
            if key in self._gpu_pending_priority:
                pr = self._gpu_pending_priority.pop(key)
                self._gpu_for(key).submit(key, pr, self.expert_bytes, now=t)
        else:
            self.on_gpu.add(key)
            self.on_arrive(key, GPU, t)

    # -- public API --------------------------------------------------------------
    def advance(self, dt: float) -> None:
        """GPU computes for ``dt`` seconds; background transfers proceed."""
        target = self.clock + dt
        self._run_links(target)
        self.clock = target
        self._run_links(target)

    def submit_prefetch(self, key: Key, priority: float) -> None:
        """Route a prefetch to the right link for the expert's current tier."""
        if key in self.on_gpu or self._gpu_inflight(key):
            return
        if key in self.in_dram:
            self._gpu_for(key).submit(key, priority, self.expert_bytes,
                                      now=self.clock)
        else:
            if self.ssd_link.inflight and self.ssd_link.inflight[0] == key:
                self._gpu_pending_priority[key] = priority
                return
            self.ssd_link.submit(key, priority, self.expert_bytes,
                                 now=self.clock)
            self._gpu_pending_priority[key] = priority

    def demand_fetch(self, key: Key, tenants=None) -> float:
        """Expert needed NOW (Alg. 1 steps 9-12). Returns stall seconds.
        ``tenants``: tenant ids whose tokens activated the expert this
        iteration — the fetch's cost is attributed evenly across them."""
        self._run_links(self.clock)
        if key in self.on_gpu:
            self.prefetch_hits += 1
            return 0.0
        self.demand_fetches += 1
        # tier accounting: a DRAM resident (or an expert already riding the
        # DRAM→GPU link) pays one hop; an SSD resident pays both
        in_dram_level = (key in self.in_dram or self._gpu_inflight(key)
                         is not None)
        self.demand_from[DRAM if in_dram_level else SSD] += 1
        t0 = self.clock
        if self.demand_overhead:
            # fault-handling time passes; background transfers continue
            self._finish_until(self.clock + self.demand_overhead)
            self.clock = t0 + self.demand_overhead
        # if currently in flight to GPU, wait for it
        infl = self._gpu_inflight(key)
        if infl:
            done = infl[2]
            self._finish_until(done)
            stall = max(0.0, done - t0)
            self._note_tenant_demand(tenants, stall)
            return stall
        # jump the queue with MAX_PRIORITY
        if key in self.in_dram:
            self._gpu_for(key).submit(key, MAX_PRIORITY, self.expert_bytes,
                                      now=self.clock)
        else:
            if not (self.ssd_link.inflight and self.ssd_link.inflight[0] == key):
                self._preempt_ssd_prefetch(key)
                self.ssd_link.submit(key, MAX_PRIORITY, self.expert_bytes,
                                     now=self.clock)
            self._gpu_pending_priority[key] = MAX_PRIORITY
        guard = 0
        while key not in self.on_gpu:
            # self-heal: if the request fell out of every queue (e.g. a veto
            # race), resubmit on the right link at demand priority
            tracked = (
                key in self._gpu_pending_priority
                or self._gpu_for(key).queued(key) or self.ssd_link.queued(key)
                or bool(self._gpu_inflight(key))
                or (self.ssd_link.inflight and self.ssd_link.inflight[0] == key))
            if not tracked:
                if key in self.in_dram:
                    self._gpu_for(key).submit(key, MAX_PRIORITY,
                                              self.expert_bytes,
                                              now=self.clock)
                else:
                    self.ssd_link.submit(key, MAX_PRIORITY,
                                         self.expert_bytes, now=self.clock)
                    self._gpu_pending_priority[key] = MAX_PRIORITY
            self._step_time()
            guard += 1
            if guard > 100000:
                raise RuntimeError(f"demand fetch of {key} never completed")
        stall = self.clock - t0
        self.stall_time += stall
        self._note_tenant_demand(tenants, stall)
        return stall

    def _preempt_ssd_prefetch(self, key: Key) -> None:
        """NVMe urgent-class demand read: abort an in-flight *background*
        staging on the SSD link (requeued, restarted from scratch) so the
        demand read starts immediately instead of waiting out a ~ms-scale
        speculative transfer. Demands never abort each other, and the PCIe
        link is untouched (its transfers are sub-ms; aborting a DMA
        mid-flight buys nothing and would break two-tier bit-invariance)."""
        infl = self.ssd_link.inflight
        if infl is None:
            return
        ikey, istart, iend, pr = infl
        if ikey == key or pr >= DEMAND_CLASS:
            return
        # a sibling expert demanded this layer escalates via
        # _gpu_pending_priority while its staging is already in flight at
        # the old priority — it is a demand too, don't restart it
        if self._gpu_pending_priority.get(ikey, 0.0) >= DEMAND_CLASS:
            return
        link = self.ssd_link
        link.inflight = None
        link.busy_until = self.clock
        # the aborted read never completed: unwind its start-time accounting
        link.bytes_moved -= self.expert_bytes
        link.prefetch_bytes -= self.expert_bytes
        link.n_transfers -= 1
        link.busy_s -= iend - istart
        link.submit(ikey, pr, self.expert_bytes, now=self.clock)

    def _finish_until(self, t: float) -> None:
        self._run_links(t)
        self.clock = max(self.clock, t)

    def _step_time(self) -> None:
        """Advance to the next link completion event."""
        all_links = [self.ssd_link] + self.gpu_links
        times = []
        for link in all_links:
            if link.inflight:
                times.append(link.inflight[2])
        if not times:
            # nothing in flight: force links to start queued work now
            self._run_links(self.clock + 1e-9)
            self.clock += 1e-9
            for link in all_links:
                if link.inflight:
                    times.append(link.inflight[2])
            if not times:
                raise RuntimeError("deadlock: nothing queued or in flight")
        t = min(times)
        self._run_links(t)
        self.clock = max(self.clock, t)

    def clear_queues(self) -> None:
        for l in self.gpu_links:
            l.clear()
        self.ssd_link.clear()
        self._gpu_pending_priority.clear()

    # -- residency management (evictions decided by the cache policy) -----------
    def evict(self, key: Key, tier: str) -> None:
        if tier == GPU:
            self.on_gpu.discard(key)
        else:
            self.in_dram.discard(key)
