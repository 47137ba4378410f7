"""Shared benchmark scaffolding: workload + engine builders.

All benchmarks run the trace-mode serving engine (real policy code, real
event simulator, synthetic task-conditioned routing — DESIGN.md §3) and
print ``name,value,unit,derived`` CSV rows. With JSON capture enabled
(``--json`` on the bench front-ends) the same rows are also collected into
a machine-checkable document — the CI BENCH tier asserts it parses, so
benches can no longer bitrot silently between PRs.
"""
from __future__ import annotations

import json
import warnings

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.eam import EAMC
from repro_torch.core.memsim import HWConfig
from repro_torch.serving import EngineConfig, SchedulerConfig, ServingEngine
from repro_torch.serving.engine import RoutingOracle
from repro_torch.serving.spec import PredictorSpec, ServeSpec
from repro_torch.serving.workload import (WorkloadConfig, attach_arrivals,
                                    azure_like_arrivals, make_dataset)

N_TASKS = 3


def n_moe_layers(arch):
    return sum(arch.is_moe_layer(i) for i in range(arch.n_layers))


def build_oracle(arch, n_tasks=N_TASKS, seed=7, concentration=0.05):
    return RoutingOracle(n_layers=n_moe_layers(arch),
                         n_experts=arch.moe.n_experts,
                         n_tasks=n_tasks, top_k=arch.moe.top_k, seed=seed,
                         concentration=concentration)


def build_eamc(arch, oracle, capacity=32, n_seqs=60, seed=1,
               prompt_tokens=16, iters=24, tasks=None):
    """Offline EAMC construction by peeking at the routing oracle before
    serving. This is the *optimistic* baseline the online lifecycle removes:
    a deployed system cannot run its serving distribution through the model
    ahead of time. ``tasks`` restricts the peek to a task subset (the
    drift scenario builds "yesterday's" collection this way)."""
    rng = np.random.default_rng(seed)
    L, E = oracle.n_layers, oracle.n_experts
    eams = []
    for i in range(n_seqs):
        task = tasks[i % len(tasks)] if tasks else i % oracle.dist.shape[0]
        eam = np.zeros((L, E))
        for it in range(iters):
            eam += oracle.route_tokens(task, prompt_tokens if it == 0 else 1,
                                       rng)
        eams.append(eam)
    c = EAMC(capacity=capacity)
    c.construct(eams)
    return c


SYSTEMS = {
    # label -> (cache_policy, prefetch, gpu_frac_scale)
    "moe-infinity": ("moe-infinity", "moe-infinity"),
    "cache-only": ("moe-infinity", "none"),
    "pytorch-um": ("lru", "none"),          # demand paging + LRU
    "zero-style": ("lru", "topk"),          # prefetch-all-next-layer + LRU
    "lfu": ("lfu", "none"),
}


_warned_legacy_kwargs = False


def build_engine(spec="switch-base-128", system="moe-infinity", *,
                 gpu_slots=None, dram_slots=None, eamc=None, oracle=None,
                 hw=None, max_batch=16, seed=0, topk_all=True,
                 scheduling="continuous", policy="prefill",
                 keep_request_eams=False, ssd_gbps=None, ssd_iops=None,
                 tier_aware=True, eamc_mode="offline", eamc_path=None,
                 eamc_capacity=32, eamc_tasks=None, resident_fraction=None,
                 transfer_dtype="fp32", n_devices=1, predictor="eamc",
                 tenants=()):
    """Build a trace-mode serving engine from a :class:`ServeSpec`
    (``build_engine(spec)``) — the structured configuration surface of
    DESIGN.md §11 — or from the legacy loose kwargs, kept as a thin
    deprecated shim that constructs the equivalent spec (bit-identical:
    the shim maps ``eamc_mode``/``eamc_path``/``predictor``/
    ``eamc_capacity`` onto one :class:`PredictorSpec` and the builder
    derives the mode straight back).

    ``eamc_mode`` (legacy) / ``PredictorSpec`` (spec) select the EAMC
    lifecycle (DESIGN.md §4):

    * ``"offline"`` (``online=False, path=None``) — oracle-peek
      construction before serving (the seed-era default; quietly
      optimistic, kept as the upper-bound baseline).
    * ``"online"``  (``online=True, path=None``) — cold start: the
      collection begins empty and learns from the engine's own completed
      sequences (insert-or-merge + drift reconstruction).
    * ``"path"``    (``path=...``) — warm restart from a ``.npz``
      persisted by a previous run; online learning stays on.

    Runtime objects stay builder arguments: an explicitly passed ``eamc``
    wins over mode-driven construction but still honours the online flag;
    ``oracle``/``hw`` override the defaults.
    """
    if isinstance(spec, ServeSpec):
        return _build_engine_from_spec(spec, eamc=eamc, oracle=oracle,
                                       hw=hw)
    global _warned_legacy_kwargs
    if not _warned_legacy_kwargs:
        _warned_legacy_kwargs = True
        warnings.warn(
            "build_engine(arch_id, system, **kwargs) is deprecated; pass a "
            "ServeSpec: build_engine(ServeSpec(arch=..., ...))",
            DeprecationWarning, stacklevel=2)
    built = ServeSpec(
        arch=spec, system=system,
        gpu_slots=gpu_slots, dram_slots=dram_slots,
        resident_fraction=resident_fraction,
        max_batch=max_batch, scheduling=scheduling, policy=policy,
        predictor=PredictorSpec(kind=predictor,
                                path=(eamc_path if eamc_mode == "path"
                                      else None),
                                capacity=eamc_capacity,
                                online=eamc_mode in ("online", "path")),
        tenants=tuple(tenants),
        eamc_tasks=(tuple(eamc_tasks) if eamc_tasks is not None else None),
        ssd_gbps=ssd_gbps, ssd_iops=ssd_iops, tier_aware=tier_aware,
        transfer_dtype=transfer_dtype, n_devices=n_devices,
        topk_all=topk_all, keep_request_eams=keep_request_eams, seed=seed)
    if eamc_mode not in ("offline", "online", "path"):
        raise ValueError(f"unknown eamc_mode {eamc_mode!r}")
    return _build_engine_from_spec(built, eamc=eamc, oracle=oracle, hw=hw)


def _build_engine_from_spec(s: ServeSpec, *, eamc=None, oracle=None,
                            hw=None):
    arch = get_config(s.arch)
    oracle = oracle or build_oracle(arch)
    ps = s.predictor
    # the spec encodes the legacy eamc_mode as (online, path) — derive it
    # back so both entry paths run literally the same construction
    eamc_mode = "path" if ps.path else ("online" if ps.online else "offline")
    if eamc is None:
        if eamc_mode == "offline":
            eamc = build_eamc(arch, oracle, capacity=ps.capacity,
                              tasks=(list(s.eamc_tasks)
                                     if s.eamc_tasks is not None else None))
        elif eamc_mode == "online":
            eamc = EAMC(capacity=ps.capacity)
        else:
            eamc = EAMC.load(ps.path)
    E, L = arch.moe.n_experts, n_moe_layers(arch)
    total = E * L
    gpu_slots, dram_slots = s.gpu_slots, s.dram_slots
    if s.resident_fraction is not None:
        # trace-mode mirror of the model-mode slot cache: the GPU cache
        # capacity is the device expert-slot count, rf × L·E (floor: one
        # layer's worst-case routed set, like JaxModelServer)
        gpu_slots = min(total, max(int(round(s.resident_fraction * total)),
                                   min(total, E)))
    gpu_slots = gpu_slots if gpu_slots is not None else total // 5
    dram_slots = dram_slots if dram_slots is not None else (2 * total) // 3
    hw = hw or HWConfig()
    if s.ssd_gbps is not None or s.ssd_iops is not None:
        from dataclasses import replace
        hw = replace(hw,
                     ssd_to_dram_gbps=(hw.ssd_to_dram_gbps if s.ssd_gbps
                                       is None else s.ssd_gbps),
                     ssd_iops=(hw.ssd_iops if s.ssd_iops is None
                               else s.ssd_iops))
    cache_policy, prefetch = SYSTEMS[s.system]
    # CUDA-UM baseline: page-fault handling per on-demand migration —
    # ~25 us per 2 MiB fault batch (driver fault storm; the paper observes
    # <10% GPU utilization for PYTORCH-UM under load, §8.2)
    from repro_torch.serving.perf_model import expert_bytes as _ebytes
    demand_overhead = 0.0
    if s.system == "pytorch-um":
        demand_overhead = 25e-6 * (_ebytes(arch, 4) / 2e6)
    # long replays: finished requests' (L, E) EAMs are not retained unless a
    # caller needs them (drift analysis / invariance tests opt back in)
    cfg = EngineConfig(arch=arch, gpu_cache_experts=gpu_slots,
                       dram_cache_experts=dram_slots,
                       cache_policy=cache_policy,
                       prefetch=prefetch, bytes_per_param=4,
                       hw=hw,
                       scheduler=SchedulerConfig(max_batch=s.max_batch,
                                                 policy=s.policy),
                       scheduling=s.scheduling,
                       keep_request_eams=s.keep_request_eams,
                       demand_overhead_s=demand_overhead,
                       tier_aware=s.tier_aware,
                       transfer_dtype=s.transfer_dtype,
                       n_devices=s.n_devices,
                       predictor=ps.kind,
                       tenants=tuple(s.tenants),
                       eamc_online=eamc_mode in ("online", "path"))
    prefetcher = None
    if prefetch == "topk":
        from repro_torch.core.prefetch import TopKPrefetcher
        prefetcher = TopKPrefetcher(k=E if s.topk_all else 8)
    return ServingEngine(cfg, eamc=eamc, oracle=oracle, seed=s.seed,
                         prefetcher=prefetcher)


def run_workload(engine, n_requests=40, rps=2.0, seed=3,
                 prompt_len=(24, 64), output_len=(8, 32)):
    reqs = make_dataset(WorkloadConfig(prompt_len=prompt_len,
                                       output_len=output_len),
                        n_requests, seed=seed)
    attach_arrivals(reqs, azure_like_arrivals(n_requests, rps=rps,
                                              seed=seed + 1))
    engine.run(reqs)
    return reqs


def run_phased_workload(engine, phase_tasks, *, n_per_phase=20, rps=2.0,
                        seed=3, prompt_len=(24, 64), output_len=(8, 24)):
    """Replay one request wave per entry of ``phase_tasks`` (each a list of
    task ids) back-to-back on ONE engine, so cache/EAMC state carries across
    the phase boundary — the cold-start and drift scenarios. Arrivals of
    each phase are offset to the engine's current virtual clock to keep the
    offered load at ``rps`` throughout. Returns one dict per phase with the
    phase-local GPU hit ratio, per-token latency array, demand-fetch count,
    and the EAMC lifecycle counters at phase end."""
    n_tasks = max(t for tasks in phase_tasks for t in tasks) + 1
    out = []
    for pi, tasks in enumerate(phase_tasks):
        reqs = make_dataset(WorkloadConfig(prompt_len=prompt_len,
                                           output_len=output_len,
                                           n_tasks=n_tasks),
                            n_per_phase, seed=seed + pi, tasks=list(tasks))
        for j, r in enumerate(reqs):       # unique rids across phases
            r.rid = pi * n_per_phase + j
        arr = azure_like_arrivals(n_per_phase, rps=rps, seed=seed + 10 + pi)
        attach_arrivals(reqs, arr + engine.offload.sim.clock)
        gpu = engine.offload.gpu_cache
        h0, m0 = gpu.hits, gpu.misses
        d0 = engine.offload.sim.demand_fetches
        n0 = len(engine.token_latencies)
        engine.run(reqs)
        dh, dm = gpu.hits - h0, gpu.misses - m0
        stats = engine.stats()
        out.append({
            "hit": dh / max(1, dh + dm),
            "lat": np.array(engine.token_latencies[n0:]),
            "demand": engine.offload.sim.demand_fetches - d0,
            "eamc_entries": stats["eamc_entries"],
            "eamc_reconstructions": stats["eamc_reconstructions"],
        })
    return out


# the lifecycle comparison variants of the cold-start/drift scenarios:
# offline-oracle (the optimistic pre-serving peek), online (cold start +
# learning), and no-EAMC (same activation-aware cache, no prediction)
LIFECYCLE_VARIANTS = ("offline-oracle", "online", "no-eamc")


def build_scenario_engine(variant, arch_id="switch-base-128", *,
                          oracle, known_tasks=None, eamc_capacity=24, **kw):
    """Engine for one lifecycle variant. ``known_tasks`` restricts the
    offline-oracle peek to the pre-drift task subset (what "yesterday's"
    traces could have contained)."""
    if variant == "offline-oracle":
        return build_engine(arch_id, "moe-infinity", oracle=oracle,
                            eamc_capacity=eamc_capacity,
                            eamc_tasks=known_tasks, **kw)
    if variant == "online":
        return build_engine(arch_id, "moe-infinity", oracle=oracle,
                            eamc_mode="online",
                            eamc_capacity=eamc_capacity, **kw)
    if variant == "no-eamc":
        return build_engine(arch_id, "cache-only", oracle=oracle,
                            eamc=EAMC(capacity=1), **kw)
    raise ValueError(variant)


def scenario_phases(scenario, n_tasks=6):
    """Task mixes per phase: cold start repeats one mix, drift shifts to a
    disjoint mix mid-replay."""
    old = list(range(n_tasks // 2))
    new = list(range(n_tasks // 2, n_tasks))
    return [old, old] if scenario == "coldstart" else [old, new]


def run_lifecycle_scenario(scenario, *, arch_id="switch-base-128",
                           n_per_phase=16, rps=1.0, dram_slots=150,
                           ssd_gbps=3.5, **engine_kw):
    """Run the coldstart/drift replay for every lifecycle variant and
    return ``{variant: [phase dicts]}`` (see ``run_phased_workload``).
    Defaults to the experts-≫-DRAM regime (NVMe 3.5 GB/s, DRAM 150 slots)
    where prediction quality moves per-token latency, not just hit ratio;
    both benchmark front-ends emit from this one implementation."""
    phases = scenario_phases(scenario)
    results = {}
    for variant in LIFECYCLE_VARIANTS:
        oracle = build_oracle(get_config(arch_id), n_tasks=6)
        eng = build_scenario_engine(variant, arch_id, oracle=oracle,
                                    known_tasks=phases[0],
                                    dram_slots=dram_slots,
                                    ssd_gbps=ssd_gbps, **engine_kw)
        results[variant] = run_phased_workload(eng, phases,
                                               n_per_phase=n_per_phase,
                                               rps=rps)
    return results


def mean_e2e(reqs):
    """Mean end-to-end latency (arrival -> last token), the metric that
    exposes batching/queueing delay."""
    return float(np.mean([r.latency for r in reqs]))


# -- emit + optional JSON capture (CI BENCH tier) ---------------------------
_JSON_ROWS = None


def start_json_capture() -> None:
    """Collect every subsequent `emit` row for `dump_json`."""
    global _JSON_ROWS
    _JSON_ROWS = []


def emit(name, value, unit="", derived=""):
    if _JSON_ROWS is not None:
        _JSON_ROWS.append({"name": name, "value": value, "unit": unit,
                           "derived": derived})
    print(f"{name},{value},{unit},{derived}")


def dump_json(path=None) -> None:
    """Write captured rows as a JSON document (``None``/``"-"`` = stdout)."""
    doc = json.dumps({"rows": _JSON_ROWS or []}, indent=1)
    if path in (None, "-"):
        print(doc)
    else:
        with open(path, "w") as f:
            f.write(doc + "\n")
