"""Serving launcher of the port: the same flags and report lines as
``repro.launch.serve``, plus ``--device``.

Wires a ``repro_torch`` model (weights drawn from a seed on the device) and
the shared offload engine into an open-loop request loop: requests arrive
per a Poisson process with ragged prompt lengths and token budgets, the
continuous scheduler admits them into the ``TorchModelServer`` slot pool at
token boundaries, and slots recycle on completion. The EAMC is built from a
warm-up pass over ``Model.forward`` (default), learned online
(``--eamc-online``) or loaded (``--eamc-path``).

The ``e2e=``/``tok-lat=`` figures are the ``MemSim`` virtual clock under the
``PAPER_8GPU`` hardware preset (the paper's testbed), not measurements of
the device this runs on. ``--resident-fraction < 1`` moves the experts to
a host store after the EAMC warm-up and streams them through device weight
slots (``--transfer-dtype``, ``--fenced-uploads``). ``--devices D`` serves
expert-parallel over D shards, each with its own slot cache: D cards under
``--device cuda`` (fewer cards raise), D logical shards of the CPU under
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --requests 4 --prompt-len 32 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --resident-fraction 0.5 --transfer-dtype int8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
        --resident-fraction 0.5 --devices 4
"""
from __future__ import annotations

import argparse
import os
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.eam import EAMC
from repro_torch.core.memsim import PAPER_8GPU
from repro_torch.core.predictor import LearnedPredictor
from repro_torch.core.tracer import build_eamc
from repro_torch.models import Model
from repro_torch.serving import EngineConfig, SchedulerConfig, TenantSpec
from repro_torch.serving.engine import TorchModelServer
from repro_torch.serving.guard import recompile_guard
from repro_torch.serving.request import Request
from repro_torch.serving.spec import SLA_CLASSES, load_tenants
from repro_torch.serving.workload import poisson_arrivals
from repro_torch.train.data import DataConfig, TokenStream

DATA_VOCAB = 4096


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-235b-a22b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--rps", type=float, default=2.0,
                    help="open-loop Poisson arrival rate (virtual-clock)")
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="max prompt length; requests draw ragged lengths "
                         "from [max(4, len//2), len]")
    ap.add_argument("--max-new", type=int, default=8,
                    help="max token budget; per-request budgets are ragged")
    ap.add_argument("--slots", type=int, default=4,
                    help="slot-pool capacity (fixed decode batch shape)")
    ap.add_argument("--policy", default="prefill",
                    choices=["prefill", "decode", "stall"],
                    help="continuous-admission policy")
    ap.add_argument("--gpu-cache", type=int, default=4)
    ap.add_argument("--dram-cache", type=int, default=8,
                    help="host-DRAM cache slots; experts beyond it are "
                         "SSD-resident and pay the NVMe hop on a miss")
    ap.add_argument("--resident-fraction", type=float, default=1.0,
                    help="fraction of the L×E expert set held in device "
                         "weight slots; < 1.0 keeps the experts in a host "
                         "store and streams them through the slot cache "
                         "(1.0: every expert resident, fused step)")
    ap.add_argument("--weight-slots", type=int, default=None,
                    help="explicit device expert-slot count (overrides "
                         "--resident-fraction)")
    ap.add_argument("--transfer-dtype", default="fp32",
                    choices=["fp32", "fp16", "int8"],
                    help="expert wire dtype: what the slot cache ships and "
                         "the simulator charges per transfer (int8 adds "
                         "per-output-channel fp32 scales; dequant happens "
                         "on device in the consuming kernel)")
    ap.add_argument("--fenced-uploads", action="store_true",
                    help="restore the fenced slot-cache schedule: all "
                         "prefetch uploads at the iteration boundary and a "
                         "wall-clock fence on every demand miss (default "
                         "is the double-buffered overlap schedule)")
    ap.add_argument("--ssd-gbps", type=float, default=None,
                    help="SSD→DRAM bandwidth in GB/s (e.g. 3.5 for a "
                         "consumer NVMe; 'inf' disables the SSD tier)")
    ap.add_argument("--ssd-iops", type=float, default=0.0,
                    help="NVMe read IOPS: each SSD read pays 1/iops s "
                         "setup on top of the bandwidth term (0 = ideal)")
    ap.add_argument("--dram-gbps", type=float, default=None,
                    help="DRAM→device link bandwidth in GB/s (the paper's "
                         "PCIe sweep, Figure 10; default: the PAPER_8GPU "
                         "preset)")
    ap.add_argument("--gpu-links", type=int, default=1,
                    help="parallel DRAM→device upload links the simulator "
                         "charges transfers against (§7)")
    ap.add_argument("--record-drift", action="store_true",
                    help="record per-iteration router drift stats (adds "
                         "host-side bookkeeping; off on the measured path)")
    ap.add_argument("--eamc-capacity", type=int, default=8)
    ap.add_argument("--eamc-online", action="store_true",
                    help="learn the EAMC from served traffic instead of the "
                         "offline warmup pass; without --eamc-path the "
                         "collection starts empty (cold start)")
    ap.add_argument("--eamc-drift-threshold", type=float, default=0.6,
                    help="EWMA match-distance threshold that declares "
                         "workload drift and triggers an online EAMC "
                         "rebuild (only with --eamc-online)")
    ap.add_argument("--eamc-drift-min-seqs", type=int, default=8,
                    help="completed sequences required before (and "
                         "between) drift-triggered EAMC rebuilds")
    ap.add_argument("--eamc-path", default=None,
                    help="persisted EAMC (.npz): loaded at startup when the "
                         "file exists (warm restart) and rewritten at exit")
    ap.add_argument("--predictor", default="eamc",
                    choices=["eamc", "learned", "hybrid"],
                    help="prediction brain behind cache scoring, prefetch "
                         "priorities, stall admission, and placement "
                         "(DESIGN.md §10): the EAMC trace matcher "
                         "(default, the paper's behavior), the online "
                         "learned bigram/marginal model, or the hybrid "
                         "that trace-matches while the match is good")
    ap.add_argument("--predictor-path", default=None,
                    help="persisted learned-predictor state (.npz, "
                         "learned/hybrid only): loaded at startup when the "
                         "file exists (warm restart) and rewritten at exit "
                         "— the learned-brain counterpart of --eamc-path")
    ap.add_argument("--devices", type=int, default=1,
                    help="expert-parallel degree (DESIGN.md §8): D "
                         "shards, each with its own slot cache and upload "
                         "stream; D cards under --device cuda, D logical "
                         "shards under --device cpu")
    ap.add_argument("--tenants", default=None,
                    help="multi-tenant spec JSON (a TenantSpec list or a "
                         "full ServeSpec document, DESIGN.md §11): "
                         "per-tenant predictor namespaces with their own "
                         ".npz persistence, SLA classes, stall budgets, "
                         "and GPU-slot quotas")
    ap.add_argument("--sla-class", default=None, choices=list(SLA_CLASSES),
                    help="override: tag every request (and every tenant "
                         "from --tenants) with this SLA class; the stall "
                         "policy admits interactive < standard < batch, "
                         "with aging so batch never starves")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on; 'cpu' runs the kernels' "
                         "plain PyTorch versions (no GPU needed)")
    return ap.parse_args(argv)


def _tenants(args):
    # TenantSpec rebuilt field by field so the --sla-class override applies
    # uniformly
    if not args.tenants:
        return ()
    return tuple(
        TenantSpec(tenant_id=t.tenant_id,
                   sla_class=args.sla_class or t.sla_class,
                   predictor=t.predictor,
                   stall_budget=t.stall_budget,
                   gpu_slot_quota=t.gpu_slot_quota,
                   shared_fallback=t.shared_fallback,
                   tasks=t.tasks,
                   rps=t.rps)
        for t in load_tenants(args.tenants))


def request_shapes(args):
    """-> [(prompt length, token budget)] per request, drawn from
    ``args.seed``: lengths in [max(4, prompt_len // 2), prompt_len],
    budgets in [max(2, max_new // 2), max_new]."""
    rng = np.random.default_rng(args.seed)
    return [(int(rng.integers(max(4, args.prompt_len // 2),
                              args.prompt_len + 1)),
             int(rng.integers(max(2, args.max_new // 2), args.max_new + 1)))
            for _ in range(args.requests)]


def serve(args, cfg, model: Optional[Model] = None, mesh=None) -> dict:
    """Serve ``args.requests`` open-loop requests of ``cfg`` and print the
    report. ``model``: weights to serve (default: ``Model(cfg).init(0)`` on
    ``args.device``; with device weight slots the server moves its experts
    to the host store). ``mesh``: the ``ExpertMesh`` of ``--devices`` > 1
    (default ``make_expert_mesh(args.devices, args.device)``). Returns
    {"server", "requests", "tokens" (rid -> generated tokens), "n_warmup"
    (model.forward calls of the EAMC pass)}.
    """
    tenants = _tenants(args)
    if cfg.moe is None:
        raise SystemExit(f"{cfg.name} has no routed MoE; expert offloading "
                         "degenerates to layer streaming (see DESIGN.md §5). "
                         "Pick an MoE arch for this launcher.")
    if not any(cfg.is_moe_layer(i) for i in range(cfg.n_layers)):
        m = cfg.moe
        raise SystemExit(
            f"{cfg.name} at {cfg.n_layers} layers has no MoE layer (MoE "
            f"every {m.moe_layer_period} layers from layer "
            f"{m.moe_layer_offset}), so there is no expert to offload. "
            "Serve more layers, or pick an arch whose cut keeps a MoE "
            "layer.")
    if model is None:
        model = Model(cfg, device=args.device).init(0)
    dev = model.device

    # the synthetic Markov data's transition tables are quadratic in the
    # vocabulary (a full 151936-id vocab would need ~46 GB of host memory
    # per task), so prompts draw from the first DATA_VOCAB ids at most
    data = TokenStream(DataConfig(vocab=min(cfg.vocab, DATA_VOCAB),
                                  seq_len=args.prompt_len + 4, batch=1))

    @torch.inference_mode()
    def run_fn(seq):
        toks = torch.as_tensor(np.asarray(seq)[None], device=dev,
                               dtype=torch.long)
        return model.forward({"tokens": toks})[1]["counts"][:, 0, :] \
            .cpu().numpy()

    dataset = [b["tokens"][0] for b in data.batches(max(10, args.requests))]
    eamc_source = "offline"
    n_warmup = 0
    if args.eamc_path and os.path.exists(EAMC._resolve_path(args.eamc_path)):
        eamc = EAMC.load(args.eamc_path)
        eamc.capacity = max(eamc.capacity, args.eamc_capacity)
        eamc_source = "load"
    elif args.eamc_online:
        # cold start: the engine learns the collection from its own traffic
        eamc = EAMC(capacity=args.eamc_capacity)
        eamc_source = "cold"
    else:
        eamc = build_eamc(run_fn, dataset, capacity=args.eamc_capacity)
        n_warmup = len(dataset)

    hw = PAPER_8GPU
    if args.ssd_gbps is not None or args.ssd_iops:
        hw = replace(hw,
                     ssd_to_dram_gbps=(args.ssd_gbps if args.ssd_gbps
                                       is not None else hw.ssd_to_dram_gbps),
                     ssd_iops=args.ssd_iops)
    if args.dram_gbps is not None:
        hw = replace(hw, dram_to_dev_gbps=args.dram_gbps)
    srv = TorchModelServer(
        EngineConfig(arch=cfg, gpu_cache_experts=args.gpu_cache,
                     dram_cache_experts=args.dram_cache, hw=hw,
                     scheduler=SchedulerConfig(max_batch=args.slots,
                                               policy=args.policy),
                     keep_request_eams=False,
                     record_drift=args.record_drift,
                     n_gpu_links=args.gpu_links,
                     eamc_online=args.eamc_online,
                     eamc_drift_threshold=args.eamc_drift_threshold,
                     eamc_drift_min_seqs=args.eamc_drift_min_seqs,
                     resident_fraction=args.resident_fraction,
                     n_weight_slots=args.weight_slots,
                     transfer_dtype=args.transfer_dtype,
                     fenced_uploads=args.fenced_uploads,
                     n_devices=args.devices,
                     predictor=args.predictor,
                     tenants=tenants),
        model, eamc=eamc, cache_len=args.prompt_len + args.max_new,
        device=dev, mesh=mesh)

    # eamc brains inherit the collection's provenance; learned state is
    # cold unless --predictor-path warm-restarts it
    predictor_source = eamc_source if args.predictor == "eamc" else "cold"
    if args.predictor_path and args.predictor in ("learned", "hybrid"):
        lp_path = LearnedPredictor._resolve_path(args.predictor_path)
        if os.path.exists(lp_path):
            srv.offload.predictor.load_state(args.predictor_path)
            predictor_source = "load"

    # open loop: every request is submitted up front with its Poisson
    # arrival timestamp; the engine's virtual clock drives admission
    arrivals = poisson_arrivals(args.requests, rps=args.rps, seed=args.seed)
    # tenant assignment draws from a separate stream so prompts/budgets are
    # identical with and without --tenants
    trng = np.random.default_rng(args.seed + 1)
    weights = None
    if tenants:
        weights = np.array([max(float(t.rps), 0.0) for t in tenants])
        if weights.sum() <= 0:
            weights = np.ones(len(tenants))
        weights = weights / weights.sum()
    reqs = []
    for i, (plen, budget) in enumerate(request_shapes(args)):
        prompt = np.asarray(dataset[i % len(dataset)][:plen], np.int32)
        r = Request(rid=i, arrival=float(arrivals[i]), prompt=prompt,
                    max_new_tokens=budget)
        if tenants:
            t = tenants[int(trng.choice(len(tenants), p=weights))]
            r.tenant_id = t.tenant_id
            r.sla_class = t.sla_class
        elif args.sla_class:
            r.sla_class = args.sla_class
        reqs.append(r)
        srv.submit(r)
    with recompile_guard(srv, max_traces_per_key=1):
        srv.drain()
    print(f"guard: zero-recompile ok (keys={len(srv.compile_counts)})")

    stats = srv.stats()
    tokens = {}
    for r in reqs:
        toks = tokens[r.rid] = srv.generated.pop(r.rid)
        print(f"req {r.rid}: prompt={r.prompt_len} new={len(toks)} "
              f"slotwait={r.queue_delay*1e3:.1f}ms "
              f"e2e={r.latency*1e3:.1f}ms "
              f"tok-lat={r.per_token_latency*1e3:.2f}ms "
              f"toks={','.join(str(t) for t in toks)}")
    e2e = np.mean([r.latency for r in reqs])
    print(f"total: {args.requests} requests, policy={args.policy}, "
          f"hit={stats['gpu_hit_ratio']:.3f}, "
          f"mean-tok-lat={stats['mean_token_latency']*1e3:.2f}ms, "
          f"mean-e2e={e2e*1e3:.1f}ms, "
          f"compiles={dict(srv.compile_counts)}")
    print(f"tiers: demand dram={stats['demand_from_dram']} "
          f"ssd={stats['demand_from_ssd']} "
          f"staged={stats['staged_prefetches']}, "
          f"pcie={stats['pcie_bytes']/1e6:.1f}MB "
          f"(demand {stats['pcie_demand_bytes']/1e6:.1f}), "
          f"ssd={stats['ssd_bytes']/1e6:.1f}MB "
          f"(demand {stats['ssd_demand_bytes']/1e6:.1f}), "
          f"miss-cost dram={stats['miss_cost_dram']*1e3:.2f}ms "
          f"ssd={stats['miss_cost_ssd']*1e3:.2f}ms")
    if srv.slot_runtime is not None:
        n_moe = len(model.moe_layers)
        total = n_moe * cfg.moe.n_experts
        print(f"slots: resident={stats['weight_slots']}/{total} "
              f"hit-ratio={stats['slot_hit_ratio']:.3f} "
              f"hits={stats['slot_hits']} misses={stats['slot_misses']} "
              f"demand-uploads={stats['demand_uploads']} "
              f"prefetch-uploads={stats['prefetch_uploads']} "
              f"evictions={stats['slot_evictions']} "
              f"uploaded={stats['upload_bytes']/1e6:.1f}MB "
              f"demand-stall={stats['demand_stall_s']*1e3:.1f}ms "
              f"({stats['demand_stall_per_token_s']*1e3:.2f}ms/token) "
              f"wire={stats['transfer_dtype']} "
              f"({stats['wire_expert_bytes']}B/expert, "
              f"sim={stats['sim_expert_bytes']}B) "
              f"schedule={'fenced' if args.fenced_uploads else 'overlap'}")
    else:
        print("slots: all-resident (resident-fraction 1.0)")
    if args.devices > 1:
        links = stats["gpu_link_stats"]
        util = " ".join(f"{l['utilization']:.3f}" for l in links)
        busy = " ".join(f"{l['busy_s']*1e3:.1f}" for l in links)
        print(f"devices: D={args.devices} links={stats['n_gpu_links']} "
              f"link-util=[{util}] link-busy-ms=[{busy}] "
              f"rebalances={stats['placement_rebalances']} "
              f"migrations={stats['placement_migrations']} "
              f"replicated={stats['replicated_experts']}")
    learned = stats["eamc_online_inserts"] + stats["eamc_online_merges"]
    print(f"eamc: source={eamc_source} entries={stats['eamc_entries']} "
          f"learned={learned} "
          f"(insert={stats['eamc_online_inserts']} "
          f"merge={stats['eamc_online_merges']}) "
          f"recon={stats['eamc_reconstructions']} "
          f"mean-dist={stats['eamc_mean_match_distance']:.3f}")
    print(f"predictor: kind={stats['predictor']} source={predictor_source} "
          f"seqs={stats.get('predictor_seqs_trained', 0)}")
    if tenants:
        tstats = stats.get("tenants", {})
        by_tenant = {}
        for r in reqs:
            by_tenant.setdefault(r.tenant_id, []).append(r)
        defs = getattr(srv._sched, "deferrals_by_tenant", {})
        for t in tenants:
            ts = tstats.get(t.tenant_id, {})
            rs = by_tenant.get(t.tenant_id, [])
            p99 = (float(np.percentile([r.latency for r in rs], 99))
                   if rs else 0.0)
            print(f"tenant {t.tenant_id}: sla={t.sla_class} n={len(rs)} "
                  f"hit={ts.get('gpu_hit_ratio', 0.0):.3f} "
                  f"p99={p99*1e3:.1f}ms "
                  f"deferrals={defs.get(t.tenant_id, 0)} "
                  f"slots={ts.get('gpu_slots_owned', 0)}"
                  f"{'/' + str(t.gpu_slot_quota) if t.gpu_slot_quota else ''} "
                  f"stall={ts.get('demand_stall_s', 0.0)*1e3:.1f}ms "
                  f"pred={ts.get('predictor_kind', 'shared')} "
                  f"src={ts.get('predictor_source', '-')} "
                  f"seqs={ts.get('predictor_seqs', 0)}")
        for tid, saved in srv.offload.save_tenant_state().items():
            print(f"tenant {tid}: saved predictor -> {saved}")
    if args.eamc_path:
        saved = eamc.save(args.eamc_path)
        print(f"eamc: saved {stats['eamc_entries']} entries -> {saved}")
    if args.predictor_path and args.predictor in ("learned", "hybrid"):
        saved = srv.offload.predictor.save(args.predictor_path)
        print(f"predictor: saved seqs="
              f"{stats.get('predictor_seqs_trained', 0)} -> {saved}")
    return {"server": srv, "requests": reqs, "tokens": tokens,
            "n_warmup": n_warmup}


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    return serve(args, cfg)


if __name__ == "__main__":
    main()
