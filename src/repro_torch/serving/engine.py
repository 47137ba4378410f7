"""Serving on the port: the trace-mode engine and the slot-pool step loop
over a PyTorch model.

``RoutingOracle``, ``EngineConfig``, ``StepEngine`` and ``ServingEngine``
are verbatim copies of the reference (``repro.serving.engine``): the
iteration-level step loop, admission, offload-engine bookkeeping and the
virtual clock are shared numpy policy, and trace mode (``ServingEngine``
over a ``RoutingOracle``'s synthetic per-task routing) runs no model.
``TorchModelServer`` is the port of ``JaxModelServer``: a fixed pool of
decode slots, each joining request prefilled at B=1 into a power-of-two
bucket and written into a free slot, and one pooled decode step per
iteration with greedy argmax; either the fused ``serve_step`` (every expert
resident) or, with device weight slots, the layered walk of
``serving.slot_runtime`` that streams experts through the slot cache. Latency accounting (compute + expert stalls) is the shared
``MemSim`` virtual clock, not a measurement of the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ArchConfig
from repro_torch.core.eam import EAMC
from repro_torch.core import quant
from repro_torch.core.memsim import DRAM, HWConfig, PAPER_8GPU, SSD
from repro_torch.core.offload import OffloadConfig, OffloadEngine
from repro_torch.core.tracer import SequenceTracer
from repro_torch.serving.perf_model import (expert_bytes, layer_cost,
                                            layer_time_mixed)
from repro_torch.serving.request import DECODE, DONE, PREFILL, Request
from repro_torch.serving.scheduler import (ContinuousScheduler,
                                           SchedulerConfig, make_scheduler)


# ---------------------------------------------------------------------------
# Synthetic routing oracle (trace mode)
# ---------------------------------------------------------------------------


class RoutingOracle:
    """Task-conditioned expert routing with temporal locality.

    Each (task, layer) has a Dirichlet-concentrated distribution over
    experts; all tokens of a sequence route from that distribution, so a
    sequence reuses few experts (sparse activation + temporal locality),
    while different tasks use different experts — the structure EAMC mines.
    """

    def __init__(self, n_layers: int, n_experts: int, n_tasks: int,
                 top_k: int = 1, concentration: float = 0.05, seed: int = 7):
        rng = np.random.default_rng(seed)
        self.top_k = top_k
        self.n_layers, self.n_experts = n_layers, n_experts
        self.dist = rng.dirichlet(np.full(n_experts, concentration),
                                  size=(n_tasks, n_layers))

    def route_tokens(self, task: int, n_tokens: int, rng) -> np.ndarray:
        """-> (L, E) token counts for one iteration of one sequence."""
        out = np.zeros((self.n_layers, self.n_experts), np.int64)
        for l in range(self.n_layers):
            for _ in range(self.top_k):
                out[l] += rng.multinomial(n_tokens, self.dist[task, l])
        return out


@dataclass
class EngineConfig:
    arch: ArchConfig
    gpu_cache_experts: int
    dram_cache_experts: int
    hw: HWConfig = field(default_factory=lambda: PAPER_8GPU)
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    cache_policy: str = "moe-infinity"
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    prefetch: str = "moe-infinity"
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    scheduling: str = "continuous"   # | "static" (seed batch-to-completion)
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    bytes_per_param: int = 2
    record_drift: bool = False
    # retain each finished request's EAM in ``engine.request_eams`` (needed
    # by drift analysis and the batch-invariance tests; turn off for very
    # long replays where thousands of (L, E) arrays would accumulate)
    keep_request_eams: bool = True
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    demand_overhead_s: float = 0.0   # UM-style per-fault handling overhead
    n_gpu_links: int = 1             # parallel DRAM→device links
    # expert-parallel degree (DESIGN.md §8): shard experts over D devices —
    # per-device slot caches + upload links, all-to-all token dispatch in
    # model mode, EAMC-guided placement. 1 = single-device (unchanged).
    n_devices: int = 1
    # expert wire dtype (DESIGN.md §7): fp32 | fp16 | int8. One value
    # drives BOTH the simulator's per-transfer byte model (analytic, incl.
    # int8 scale rows) and — in model mode — the real slot-cache wire
    # (quantized host store, narrow device buffers, in-kernel dequant), so
    # the two byte accountings can never disagree.
    transfer_dtype: str = "fp32"
    # True restores the fenced upload schedule in slot mode: every prefetch
    # upload issued at the iteration boundary and every demand miss blocked
    # through an explicit wall-clock fence (the double-buffered default
    # stages uploads while the previous layer's post computes and lets the
    # consuming kernel's data dependence do the blocking)
    fenced_uploads: bool = False
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    tier_aware: bool = True          # SSD-tier-aware prefetch priorities
    # online EAMC lifecycle: learn completed sequences' EAMs into the
    # collection and reconstruct on drift (DESIGN.md §4)
    eamc_online: bool = False
    eamc_drift_threshold: float = 0.6
    eamc_drift_min_seqs: int = 8
    # prediction brain (DESIGN.md §10): "eamc" (the paper's trace matcher,
    # bit-identical to pre-refactor behavior) | "learned" (online bigram/
    # marginal model, keeps adapting under drift) | "hybrid" (trace-match
    # while the match distance is good, learned model otherwise)
    predictor: str = "eamc"
    # device-resident expert slot cache (model mode, DESIGN.md §6):
    # fraction of the L×E expert set held in fixed device weight slots.
    # 1.0 = everything resident (the fused single-jit step); < 1.0 streams
    # real expert weights through the layered runtime, with the offload
    # engine's verdicts driving actual device uploads. ``n_weight_slots``
    # pins the slot count explicitly (overrides the fraction). In slot mode
    # the simulator's GPU cache capacity is forced equal to the slot count —
    # they are the same physical resource.
    resident_fraction: float = 1.0
    n_weight_slots: Optional[int] = None
    # multi-tenant serving (DESIGN.md §11): TenantSpec tuple forwarded to
    # the offload engine (per-tenant predictor namespaces, GPU-slot quotas)
    # and consulted here for per-tenant stall budgets. () = untenanted.
    tenants: tuple = ()


class StepEngine:
    """Shared iteration-level step loop for trace mode and model mode.

    Subclasses provide ``_route_iteration(reqs, tokens) -> (n_moe, B, E)``
    routed-token counts; everything else — admission, per-request sequence
    lifecycle in the offload engine and tracer, mixed prefill/decode compute
    accounting, completion bookkeeping — lives here.
    """

    def __init__(self, cfg: EngineConfig, *, eamc: Optional[EAMC] = None,
                 prefetcher=None, cache_policy=None):
        self.cfg = cfg
        arch = cfg.arch
        self.moe_layers = [i for i in range(arch.n_layers)
                           if arch.is_moe_layer(i)]
        self.n_moe = len(self.moe_layers)
        ocfg = OffloadConfig(
            n_moe_layers=self.n_moe,
            n_experts=arch.moe.n_experts,
            expert_bytes=expert_bytes(arch, cfg.bytes_per_param),
            gpu_cache_experts=cfg.gpu_cache_experts,
            dram_cache_experts=cfg.dram_cache_experts,
            hw=cfg.hw,
            cache_policy=cfg.cache_policy,
            prefetch=cfg.prefetch,
            demand_overhead_s=cfg.demand_overhead_s,
            n_gpu_links=cfg.n_gpu_links,
            n_devices=cfg.n_devices,
            transfer_dtype=cfg.transfer_dtype,
            wire_expert_bytes=quant.sim_wire_expert_bytes(
                arch, cfg.bytes_per_param, cfg.transfer_dtype),
            tier_aware=cfg.tier_aware,
            eamc_online=cfg.eamc_online,
            eamc_drift_threshold=cfg.eamc_drift_threshold,
            eamc_drift_min_seqs=cfg.eamc_drift_min_seqs,
            predictor=cfg.predictor,
            tenants=cfg.tenants,
        )
        self.offload = OffloadEngine(ocfg, eamc=eamc, prefetcher=prefetcher,
                                     cache_policy=cache_policy)
        self.tracer = SequenceTracer(self.n_moe, arch.moe.n_experts)
        self._costs = {i: layer_cost(arch, i, cfg.bytes_per_param)
                       for i in range(arch.n_layers)}
        self._running: List[Request] = []
        self.request_eams: Dict[int, np.ndarray] = {}
        self.token_latencies: List[float] = []
        self.iter_log: List[dict] = []
        self.prefill_tokens = 0
        self.decode_tokens = 0

    # -- routing (subclass responsibility) -----------------------------------
    def _route_iteration(self, reqs: List[Request], tokens: List[int]
                         ) -> np.ndarray:
        """-> (n_moe, len(reqs), E) routed-token counts for one iteration."""
        raise NotImplementedError

    # -- the step loop --------------------------------------------------------
    def run_loop(self, scheduler, *, max_iters: int = 10_000) -> None:
        it = 0
        while self.step(scheduler):
            it += 1
            if it > max_iters:
                raise RuntimeError("runaway generation")

    def step(self, scheduler) -> bool:
        """One forward iteration: admit at the token boundary, route,
        execute, retire completions. Returns False when all work is done."""
        sim = self.offload.sim
        if not self._running:
            if scheduler.done():
                return False
            # idle: jump virtual time to the next admissible arrival
            t = scheduler.next_event(sim.clock)
            if t is not None and t > sim.clock:
                sim.advance(t - sim.clock)
        for r in scheduler.admit(sim.clock):
            r.t_sched = sim.clock
            r.state = PREFILL
            self.offload.register_seq(
                r.rid, tenant=getattr(r, "tenant_id", "") or None)
            self.tracer.start(r.rid)
            self._running.append(r)
        if not self._running:
            return not scheduler.done()

        reqs = list(self._running)     # admission order = batch columns
        tokens, ctxs = [], []
        for r in reqs:
            if r.state == PREFILL:
                tokens.append(r.prompt_len)
                ctxs.append(r.prompt_len)
            else:
                tokens.append(1)
                ctxs.append(r.prompt_len + r.n_generated)
        counts = self._route_iteration(reqs, tokens)
        self._execute_iteration(reqs, counts, tokens, ctxs)

        now = sim.clock
        for b, r in enumerate(reqs):
            self.tracer.record(r.rid, counts[:, b, :])
            if r.state == PREFILL:
                r.t_first = now            # prefill emitted the first token
                r.state = DECODE
            r.n_generated += 1
            if r.n_generated >= r.max_new_tokens:
                r.t_done = now
                r.state = DONE
                self._retire(r)
                scheduler.on_finish(r.rid)
        self._running = [r for r in self._running if r.state != DONE]
        return True

    def _retire(self, r: Request) -> None:
        self.offload.finish_seq(r.rid)
        eam = self.tracer.finish(r.rid)
        if eam is not None:
            if self.cfg.keep_request_eams:
                self.request_eams[r.rid] = eam
            if self.cfg.record_drift:
                self.eamc_record(eam)

    def eamc_record(self, eam: np.ndarray) -> None:
        self.offload.eamc.record_for_reconstruction(eam)

    # -- one forward pass -----------------------------------------------------
    def _execute_iteration(self, reqs: List[Request], counts: np.ndarray,
                           tokens: List[int], ctxs: List[int]) -> None:
        """Walk layers in order, offload-aware. Prefill and decode tokens
        are accounted separately: each request contributes its own (tokens,
        context) pair to the roofline instead of the batch being lumped
        under the maximum context."""
        sim = self.offload.sim
        t0 = sim.clock
        token_ctx = list(zip(tokens, ctxs))
        rids = [r.rid for r in reqs]
        # dense layers run between MoE layers; amortize their compute evenly
        # across MoE layer boundaries to keep the event loop per-MoE-layer
        dense_t = sum(
            layer_time_mixed(c, self.cfg.hw, token_ctx)
            for i, c in self._costs.items()
            if not self.cfg.arch.is_moe_layer(i))
        slices = max(1, self.n_moe)
        for li, layer_idx in enumerate(self.moe_layers):
            sim.advance(dense_t / slices)
            comp = layer_time_mixed(self._costs[layer_idx], self.cfg.hw,
                                    token_ctx, float(counts[li].sum()))
            self.offload.on_layer(li, counts[li], comp, rids=rids)
        if not self.n_moe:
            sim.advance(dense_t)
        lat = sim.clock - t0
        n_prefill = sum(n for n, r in zip(tokens, reqs) if r.state == PREFILL)
        n_decode = sum(n for n, r in zip(tokens, reqs) if r.state != PREFILL)
        self.prefill_tokens += n_prefill
        self.decode_tokens += n_decode
        self.token_latencies.append(lat)
        self.iter_log.append({"t": sim.clock, "n_tokens": sum(tokens),
                              "n_prefill": n_prefill, "n_decode": n_decode,
                              "batch": len(reqs), "lat": lat})

    # -- batch run (offline replay) --------------------------------------------
    def _scheduler_cfg(self) -> SchedulerConfig:
        """Scheduler config for engine-built schedulers (model mode clamps
        ``max_batch`` to the slot-pool capacity)."""
        return self.cfg.scheduler

    def _stall_budget(self) -> int:
        scfg = self.cfg.scheduler
        return scfg.stall_budget or max(1, self.cfg.gpu_cache_experts // 5)

    def _tenant_stall_budgets(self) -> Optional[Dict[str, int]]:
        """Per-tenant admission-budget overrides (TenantSpec.stall_budget);
        None when no tenant sets one — the scheduler then runs the exact
        single-budget legacy path."""
        out = {str(t.tenant_id): int(t.stall_budget)
               for t in self.cfg.tenants
               if getattr(t, "stall_budget", None)}
        return out or None

    def run(self, requests: List[Request], *,
            max_iters: Optional[int] = None,
            scheduling: Optional[str] = None) -> List[Request]:
        """Replay a fixed request list to completion (offline loop shared
        by trace mode and model mode; online front-ends use the model-mode
        ``submit()/step()/drain()`` loop instead)."""
        sched = make_scheduler(scheduling or self.cfg.scheduling,
                               self._scheduler_cfg(), requests,
                               cold_cost_fn=self._predicted_cold_cost,
                               stall_budget=self._stall_budget(),
                               stall_budgets=self._tenant_stall_budgets())
        if max_iters is None:
            # every iteration with live requests generates one token per
            # running request, so the workload bounds its own iteration
            # count; anything beyond this is a scheduler bug, not load
            max_iters = sum(r.max_new_tokens for r in requests) \
                + len(requests) + 16
        self.run_loop(sched, max_iters=max_iters)
        return requests

    # -- stall-aware admission (scheduler ``policy="stall"``) -----------------
    def _predicted_cold_cost(self, r: Request) -> int:
        """Predicted cold-expert union a joining request adds: the
        predictor's expected expert set (``cold_union`` — per layer, the
        experts covering 80% of predicted activation mass) minus the
        experts currently GPU-resident. At admission time the request has
        no observed EAM yet, so the prediction is the brain-wide prior —
        the same signal Algorithm 1 predicts from, one step earlier
        (DESIGN.md §10). Tenant-owned requests consult their tenant's
        brain (falling through to the shared one while cold/absent)."""
        keys = self.offload.predictor_for(
            getattr(r, "tenant_id", "") or None).cold_union()
        gpu = self.offload.gpu_cache
        return sum(1 for k in keys if k not in gpu)

    # -- metrics --------------------------------------------------------------
    def stats(self) -> dict:
        s = self.offload.stats()
        sim = self.offload.sim
        # the simulator's own hop model, not perf_model's analytic mirror
        # (they can differ by expert-size truncation)
        s.update(prefill_tokens=self.prefill_tokens,
                 decode_tokens=self.decode_tokens,
                 miss_cost_dram=sim.miss_cost(DRAM),
                 miss_cost_ssd=sim.miss_cost(SSD))
        lat = np.array(self.token_latencies)
        if len(lat):
            s.update(mean_token_latency=float(lat.mean()),
                     p50=float(np.percentile(lat, 50)),
                     p99=float(np.percentile(lat, 99)))
        return s


class ServingEngine(StepEngine):
    """Trace-mode serving: oracle-routed requests over the step loop."""

    def __init__(self, cfg: EngineConfig, *, eamc: Optional[EAMC] = None,
                 oracle: Optional[RoutingOracle] = None,
                 model=None, params=None, seed: int = 0,
                 prefetcher=None, cache_policy=None):
        super().__init__(cfg, eamc=eamc, prefetcher=prefetcher,
                         cache_policy=cache_policy)
        self.oracle = oracle
        self.model = model
        self.params = params
        self.seed = seed
        # routing randomness is keyed by request id, not by draw order, so a
        # request's expert trace is identical whether it runs alone or joins
        # a continuous batch mid-decode (sequence-lifetime determinism)
        self._req_rngs: Dict[int, np.random.Generator] = {}

    def _rng_for(self, rid: int) -> np.random.Generator:
        rng = self._req_rngs.get(rid)
        if rng is None:
            rng = np.random.default_rng([self.seed, rid])
            self._req_rngs[rid] = rng
        return rng

    def _route_iteration(self, reqs: List[Request], tokens: List[int]
                         ) -> np.ndarray:
        E = self.cfg.arch.moe.n_experts
        out = np.zeros((self.n_moe, len(reqs), E), np.int64)
        for b, (r, n) in enumerate(zip(reqs, tokens)):
            if n <= 0:
                continue
            out[:, b, :] = self.oracle.route_tokens(r.task_id, n,
                                                    self._rng_for(r.rid))
        return out

    def _retire(self, r: Request) -> None:
        super()._retire(r)
        self._req_rngs.pop(r.rid, None)


# ---------------------------------------------------------------------------
# Real-model serving (model mode): persistent slot-pool decode engine
# ---------------------------------------------------------------------------


def _pow2_bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class TorchModelServer(StepEngine):
    """Persistent slot-pool serving of a ``repro_torch`` model over the
    shared step loop (the port of ``JaxModelServer``'s fused path).

    ``n_slots`` fixed batch slots share one pooled decode cache (per-slot
    positions, per-slot attention lengths, ``active`` gating so idle slots
    never advance). A joining request's prompt is right-padded to a
    power-of-two bucket, prefilled as a B=1 call and copied into a free
    slot; one ``serve_step`` over the whole pool then decodes every running
    request. A request's tokens and EAM do not depend on its slot
    neighbours: every per-row computation of the decode step is independent
    of the other rows under the default dropless decode capacity.

    Padded prefill is exact for attention-only stacks; recurrent (mamba,
    rwkv) prefill state is not pad-corrected, so a stack with a recurrent
    layer prefills each prompt at its exact length, as the reference does.

    With ``resident_fraction < 1`` or ``n_weight_slots`` the experts live
    in a host store and stream through ``n_weight_slots`` device slots
    (``slot_runtime``): constructing the server then moves ``model``'s
    experts to the host. ``n_devices > 1`` serves expert-parallel
    (``ShardedSlotRuntime``) over ``mesh`` (default ``make_expert_mesh(
    n_devices, device)``: distinct cards, or logical shards of the CPU),
    each expert streamed through the slot cache of the shard the
    placement policy homes it on. Eager PyTorch traces nothing, so
    ``compile_counts`` stays empty. On CUDA, ``decode_ms`` records each
    pooled decode step's time between CUDA events; when streaming,
    ``decode_uploads`` records the slot uploads (demand and planned) each
    step issued.
    """

    def __init__(self, cfg: EngineConfig, model, *,
                 eamc: Optional[EAMC] = None,
                 n_slots: Optional[int] = None,
                 cache_len: Optional[int] = None, device="cuda",
                 mesh=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, server on "
                             f"{self.device}")
        if mesh is not None and mesh.shape["expert"] != cfg.n_devices:
            raise ValueError(f"mesh {mesh} has {mesh.shape['expert']} "
                             f"shards, n_devices is {cfg.n_devices}")
        cfg, n_weight_slots = self._resolve_weight_slots(cfg)
        super().__init__(cfg, eamc=eamc)
        self.model = model
        self.n_slots = n_slots or cfg.scheduler.max_batch
        self.cache_len = cache_len
        self._pad = all(d.kind == "attn" for d in model.descs)
        self.compile_counts: Dict = {}
        self.generated: Dict[int, list] = {}   # rid -> token list (pop it)
        self.n_prefills = 0
        self.n_decode_steps = 0
        self.decode_ms: List[float] = []
        self.decode_uploads: List[int] = []
        self._cache = None                     # the slot-pool decode cache
        self._tok: Optional[np.ndarray] = None
        self._free: List[int] = []
        self._slot_of: Dict[int, int] = {}
        self._rid_counter = 0
        self._outstanding_iters = 0
        self._sched = ContinuousScheduler(
            self._scheduler_cfg(),
            cold_cost_fn=self._predicted_cold_cost,
            stall_budget=self._stall_budget(),
            stall_budgets=self._tenant_stall_budgets())
        # device expert slot cache: real weight streaming through the
        # layered runtime; None = the all-resident fused step
        self.slot_runtime = None
        if n_weight_slots is not None:
            kw = dict(n_pool_slots=self.n_slots,
                      n_weight_slots=n_weight_slots,
                      victim_fn=self.offload.gpu_cache.policy.victim,
                      transfer_dtype=cfg.transfer_dtype,
                      fenced=cfg.fenced_uploads)
            if cfg.n_devices > 1:
                # expert parallelism: per-device slot caches and the
                # sharded expert FFN over the ("expert",) mesh, homes
                # decided by the offload engine's placement policy
                from repro_torch.launch.mesh import make_expert_mesh
                from repro_torch.serving.slot_runtime import \
                    ShardedSlotRuntime
                self.slot_runtime = ShardedSlotRuntime(
                    model, mesh=mesh or make_expert_mesh(cfg.n_devices,
                                                         self.device),
                    placement=self.offload.placement, **kw)
            else:
                from repro_torch.serving.slot_runtime import \
                    SlotStreamRuntime
                self.slot_runtime = SlotStreamRuntime(model, **kw)
            # sim<->real crosswalk: the simulator charges exactly the bytes
            # the host store ships per expert
            self.offload.sim.expert_bytes = \
                self.slot_runtime.store.wire_expert_bytes

    @staticmethod
    def _resolve_weight_slots(cfg: EngineConfig):
        """Resolve ``resident_fraction``/``n_weight_slots`` into a concrete
        slot count (or None = all-resident) and force the simulator's GPU
        cache to the same capacity: device slots and the simulated GPU
        cache are one physical resource. Floor: one layer's worst-case
        routed set (E experts), the minimum the layered walk needs resident
        at use time."""
        arch = cfg.arch
        if arch.moe is None:
            return cfg, None
        n_moe = sum(arch.is_moe_layer(i) for i in range(arch.n_layers))
        total = n_moe * arch.moe.n_experts
        from dataclasses import replace
        if cfg.n_weight_slots is None and cfg.resident_fraction >= 1.0:
            if cfg.n_devices <= 1:
                return cfg, None
            # expert parallelism always runs the sharded layered walk:
            # all-resident just means every expert has a home slot
            return (replace(cfg, n_weight_slots=total,
                            gpu_cache_experts=total), total)
        n = (cfg.n_weight_slots if cfg.n_weight_slots is not None
             else int(round(cfg.resident_fraction * total)))
        n = min(total, max(n, min(total, arch.moe.n_experts)))
        return replace(cfg, n_weight_slots=n, gpu_cache_experts=n), n

    def _scheduler_cfg(self) -> SchedulerConfig:
        from dataclasses import replace
        scfg = self.cfg.scheduler
        if scfg.max_batch > self.n_slots:
            scfg = replace(scfg, max_batch=self.n_slots)
        return scfg

    def _ensure_pool(self, need_len: int) -> None:
        if self._cache is not None and need_len <= self.cache_len:
            return
        if self._slot_of:
            raise RuntimeError(
                f"request needs cache_len {need_len} > pool {self.cache_len} "
                "while requests are running; construct TorchModelServer "
                "with cache_len sized for the workload")
        if self._cache is not None or self.cache_len is None \
                or need_len > self.cache_len:
            self.cache_len = _pow2_bucket(max(need_len, self.cache_len or 0),
                                          lo=32)
        if self.slot_runtime is not None:
            # the layered runtime owns its own pooled decode cache
            self.slot_runtime.build_pool(self.cache_len)
            self._cache = "slot-runtime-pool"
        else:
            self._cache = self.model.init_cache(self.n_slots, self.cache_len)
        self._tok = np.zeros(self.n_slots, np.int32)
        self._free = list(range(self.n_slots))

    def _bucket(self, S: int) -> int:
        if not self._pad:
            return S
        return min(_pow2_bucket(S), self.cache_len)

    # -- device work ----------------------------------------------------------
    @torch.inference_mode()
    def _prefill(self, padded: np.ndarray, S: int, slot: int):
        """B=1 padded prefill written into pool row ``slot``.
        -> (first token, (n_moe, E) counts)."""
        self.n_prefills += 1
        if self.slot_runtime is not None:
            return self.slot_runtime.prefill(padded, S, slot)
        dev = self.device
        one = self.model.init_cache(1, self.cache_len)
        toks = torch.from_numpy(padded[None]).to(dev, torch.long)
        true_len = torch.tensor([S], dtype=torch.int32, device=dev)
        logits, one, aux = self.model.prefill({"tokens": toks}, one,
                                              true_len=true_len)
        self.model.write_slot(self._cache, one, slot)
        return (int(torch.argmax(logits[0])),
                aux["counts"][:, 0, :].cpu().numpy())

    @torch.inference_mode()
    def _decode(self, active: np.ndarray):
        """One pooled decode step. -> (tokens (n_slots,), counts
        (n_moe, n_slots, E))."""
        dev = self.device
        timed = dev.type == "cuda"
        if timed:
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
        if self.slot_runtime is not None:
            n0 = self._uploads()
            tok_new, counts = self.slot_runtime.decode(self._tok, active)
            self.decode_uploads.append(self._uploads() - n0)
        else:
            tok = torch.from_numpy(self._tok).to(dev, torch.long)
            act = torch.from_numpy(active).to(dev)
            logits, self._cache, aux = self.model.serve_step(
                self._cache, tok, active=act)
            tok_new = torch.argmax(logits, dim=-1).cpu().numpy()
            counts = aux["counts"].cpu().numpy()
        if timed:
            t1.record()
            t1.synchronize()
            self.decode_ms.append(t0.elapsed_time(t1))
        self.n_decode_steps += 1
        return tok_new, counts

    def _uploads(self) -> int:
        """Slot uploads issued so far (demand and prefetch, every shard)."""
        st = self.slot_runtime.slot_cache.stats()
        return st["demand_uploads"] + st["prefetch_uploads"]

    # -- routing: prefill joiners into free slots, one pool decode step -------
    def _route_iteration(self, reqs: List[Request], tokens: List[int]
                         ) -> np.ndarray:
        if self.slot_runtime is not None:
            # iteration boundary: the offload engine's admit/evict/prefetch
            # verdicts of the previous iteration become real async uploads
            self.slot_runtime.sync_residency(
                set(self.offload.gpu_cache.resident))
        cols: Dict[int, np.ndarray] = {}
        for r in reqs:
            if r.state != PREFILL:
                continue
            if not self._free:
                raise RuntimeError("scheduler admitted beyond slot capacity")
            self._free.sort()
            slot = self._free.pop(0)
            self._slot_of[r.rid] = slot
            r.slot = slot
            S = r.prompt_len
            padded = np.zeros(self._bucket(S), np.int32)
            padded[:S] = np.asarray(r.prompt, np.int32)
            tok0, cnts = self._prefill(padded, S, slot)
            self._tok[slot] = tok0
            self.generated[r.rid] = [tok0]
            cols[r.rid] = cnts

        deciders = [r for r in reqs if r.state == DECODE]
        if deciders:
            active = np.zeros(self.n_slots, bool)
            for r in deciders:
                active[self._slot_of[r.rid]] = True
            tok_new, cnts = self._decode(active)
            for r in deciders:
                s = self._slot_of[r.rid]
                self._tok[s] = tok_new[s]
                self.generated[r.rid].append(int(tok_new[s]))
                cols[r.rid] = cnts[:, s, :]
        return np.stack([cols[r.rid] for r in reqs], axis=1)

    def _retire(self, r: Request) -> None:
        super()._retire(r)
        slot = self._slot_of.pop(r.rid, None)
        if slot is not None:
            self._free.append(slot)
        r.slot = -1

    # -- metrics --------------------------------------------------------------
    def stats(self) -> dict:
        """Adds the measured slot-cache counters (expert-granularity hits
        and misses, real upload traffic, wall-clock demand stall) next to
        the simulator's modeled ones; expert-parallel, summed over the
        shards, with ``n_devices`` and each shard's own under
        ``per_device``."""
        s = super().stats()
        if self.slot_runtime is not None:
            rs = self.slot_runtime.slot_cache.stats()
            s.update(rs)
            s["sim_expert_bytes"] = self.offload.sim.expert_bytes
            tot = rs["slot_hits"] + rs["slot_misses"]
            s["slot_hit_ratio"] = rs["slot_hits"] / tot if tot else 1.0
            toks = max(1, self.prefill_tokens + self.decode_tokens)
            s["demand_uploads_per_token"] = rs["demand_uploads"] / toks
            s["demand_stall_per_token_s"] = rs["demand_stall_s"] / toks
        return s

    # -- request-loop API -----------------------------------------------------
    def submit(self, request: Request) -> None:
        """Enqueue a request (``arrival`` in virtual-clock seconds); the
        continuous scheduler admits it at the first token boundary where
        its arrival has passed and a slot is free."""
        self._ensure_pool(request.prompt_len + request.max_new_tokens)
        self._sched.add(request)
        self._outstanding_iters += request.max_new_tokens + 2

    def step(self, scheduler=None) -> bool:
        """One engine iteration against the server's own scheduler (or an
        explicit one, for the shared offline ``run`` loop)."""
        return super().step(self._sched if scheduler is None else scheduler)

    def drain(self, *, max_iters: Optional[int] = None) -> None:
        """Run until every submitted request has completed."""
        if max_iters is None:
            max_iters = self._outstanding_iters + 16
        self.run_loop(self._sched, max_iters=max_iters)
        self._outstanding_iters = 0

    def run(self, requests: List[Request], **kw) -> List[Request]:
        for r in requests:
            self._ensure_pool(r.prompt_len + r.max_new_tokens)
        return super().run(requests, **kw)

    def generate(self, prompts: np.ndarray, max_new_tokens: int):
        """prompts: (B, S) int32. Returns (generated (B, max_new), stats):
        submits B requests arriving now and drains the pool."""
        B, S = prompts.shape
        now = float(self.offload.sim.clock)
        reqs = [Request(rid=self._rid_counter + b, arrival=now,
                        prompt=np.asarray(prompts[b]),
                        max_new_tokens=max_new_tokens) for b in range(B)]
        self._rid_counter += B
        for r in reqs:
            self.submit(r)
        self.drain()
        out = np.stack([np.asarray(self.generated.pop(r.rid), np.int64)
                        for r in reqs])
        eams = [self.request_eams.pop(r.rid, None) for r in reqs]
        stats = dict(self.stats(),
                     mean_token_latency=float(np.mean(self.token_latencies)))
        return out, {"eams": eams, **stats}
