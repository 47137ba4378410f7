#!/usr/bin/env python3
"""Run one benchmark cell once on the GPU and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is ``perfbench/cells/<cell>.json``
and must be one of ``BENCHMARK.json``'s workloads. With ``--trace 0`` the
result holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, each computed by ``perfbench/metrics/<name>.py``. The
last line of standard output is one JSON object; the numbers the check
compared, each beside its limit, are the last lines of standard error
and the last key of that object.

Measures only on a CUDA device with as many cards as the cell asks for:
without one it exits with code 2 and prints no result. It exits with
code 3, and no result, if the process has loaded JAX or the reference
package by the time the window closes.
"""
from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The process's start on the ``time.time()`` clock (Linux), else
    now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# caches of anything the run builds stay at fixed paths in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
os.environ["USE_FLAX"] = "0"
# one process with one thread of CPU math: no pool spinning beside the
# host's issue of the steps
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list:
    """Top-level names among ``names`` (module names) that are JAX's or
    the reference package's, compared whole (``repro_torch`` is not
    ``repro``)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def reader(name: str, root: str = ROOT):
    """The ``read`` function of ``<root>/perfbench/metrics/<name>.py``."""
    path = os.path.join(root, "perfbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: str, trace: bool, rec: dict,
               root: str = ROOT) -> dict:
    """The cell's metrics that its readers find: per-layer with a trace,
    end-to-end without, each as {"value", "unit"}."""
    out = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if cell not in m.get("workloads", [cell]):
            continue
        v = reader(m["name"], root)(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result(bench: dict, cell: str, trace: bool, rec: dict, kind: str,
           count: int) -> dict:
    dev = {"platform": "gpu", "kind": kind, "count": count,
           "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": rec["check"]["correct"],
           "attempted": len({rid for rid, _, _ in rec["tokens"]}),
           "failed": 0,
           "metrics": metrics_of(bench, cell, trace, rec),
           "device": dev}
    t = rec["trace"]
    if trace and t:
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = t["breakdown"]
    out["check"] = {k: {"value": v, "limit": lim}
                    for k, (v, lim) in rec["check"]["numbers"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])

    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{found}: not measuring", file=sys.stderr)
        return 2
    from perfbench import harness, window
    spec = harness.load_cell(args.workload)
    for key in ("config", "traffic"):
        if spec["cell"][key] != cells[args.workload][key]:
            print(f"{args.workload}: the cell's {key} is "
                  f"{spec['cell'][key]!r}, BENCHMARK.json's "
                  f"{cells[args.workload][key]!r}", file=sys.stderr)
            return 2
    t_start = time.perf_counter() - (time.time() - T_START)
    rec = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start=t_start)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"the run loaded {bad}: refusing to report", file=sys.stderr)
        return 3
    out = result(bench, args.workload, bool(args.trace), rec,
                 torch.cuda.get_device_name(0), chips)
    gaps, firsts = window.token_gaps(rec), window.ttfts(rec)
    print(f"window: {len(rec['tokens'])} tokens, {len(gaps)} gaps (ms at "
          "p50 / p95 / p98: " + " / ".join(
              f"{1e3 * window.percentile(gaps, q):.1f}" if gaps else "-"
              for q in (50, 95, 98))
          + f"), {len(firsts)} first tokens (ms: "
          + ", ".join(f"{1e3 * x:.1f}" for x in sorted(firsts)) + ")",
          file=sys.stderr)
    print("set-up and check seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in rec["phases"].items()), file=sys.stderr)
    if rec["trace"]:
        t = rec["trace"]
        print(f"traced slice: {t['window_s']:.3f} s, iterations "
              f"{t['iter_mean_s'] * 1e3:.3f} ms on average against the "
              f"window's {rec['iter_mean_s'] * 1e3:.3f} ms", file=sys.stderr)
    for name, c in out["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']} "
              f"({rec['check']['requests']} requests, "
              f"{rec['check']['tokens']} served tokens)", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
