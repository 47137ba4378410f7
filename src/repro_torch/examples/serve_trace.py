"""End-to-end serving driver in trace mode (the paper's main experiment
shape, Fig 4): replay an Azure-like bursty request trace against
Switch-Transformer-style MoEs under several offloading systems and report
latency/SLO statistics.

Trace mode runs no model and touches no device: routing comes from the
synthetic task-conditioned ``RoutingOracle`` and every latency is the
``MemSim`` virtual clock, so this takes no ``--device`` and needs no GPU.
Its table equals ``examples/serve_trace.py``'s line for line for the same
flags.

    PYTHONPATH=src python -m repro_torch.examples.serve_trace \
        [--model switch-base-128] [--rps 2.0] [--requests 60] \
        [--system all|moe-infinity|pytorch-um|...]
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.serving.harness import (SYSTEMS, build_eamc, build_engine,
                                         build_oracle)
from repro_torch.serving.workload import (WorkloadConfig, attach_arrivals,
                                          azure_like_arrivals, make_dataset)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="switch-base-128")
    ap.add_argument("--rps", type=float, default=2.0)
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--system", default="all")
    args = ap.parse_args(argv)

    arch = get_config(args.model)
    oracle = build_oracle(arch)
    eamc = build_eamc(arch, oracle)
    systems = list(SYSTEMS) if args.system == "all" else [args.system]

    print(f"{'system':14s} {'tok-lat':>9s} {'p99':>9s} {'e2e':>8s} "
          f"{'hit':>6s} {'demand':>7s} {'pcie':>8s}  SLO(1s)")
    for system in systems:
        eng = build_engine(args.model, system, eamc=eamc, oracle=oracle)
        reqs = make_dataset(WorkloadConfig(prompt_len=(24, 96),
                                           output_len=(8, 48)),
                            args.requests, seed=2)
        attach_arrivals(reqs, azure_like_arrivals(args.requests,
                                                  rps=args.rps, seed=3))
        eng.run(reqs)
        s = eng.stats()
        e2e = np.mean([r.latency for r in reqs])
        slo = np.mean([r.per_token_latency <= 1.0 for r in reqs])
        print(f"{system:14s} {s['mean_token_latency']*1e3:8.2f}ms "
              f"{s['p99']*1e3:8.2f}ms {e2e:7.2f}s {s['gpu_hit_ratio']:6.3f} "
              f"{s['demand_fetches']:7d} {s['pcie_bytes']/1e9:7.2f}GB "
              f"{slo*100:5.1f}%")


if __name__ == "__main__":
    main()
