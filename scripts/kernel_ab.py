#!/usr/bin/env python3
"""Time the port's B2, B4 and B1 kernels of two trees of this repo on one
GPU, in turns: the other tree, this one, this one, the other.

    python3 scripts/kernel_ab.py --parent DIR [--paths]

DIR is another checkout of the repo (for example ``git archive`` of the
parent commit unpacked into a git-ignored directory). Each run is its own
process with that tree's ``src`` first on the path, so its kernels are
built from its own sources; all runs take the same seeded inputs:

  - B2 ``moe_ffn_quant`` over 256 int8 and fp16 slots (E = 128, C = 8,
    d = 4096, f = 1536, swiglu, x bf16, out fp32), with every expert filled
    and at the decode occupancy of ``chip_smoke.route_decode``;
  - B4 ``wkv6`` at decode (BH = 256, T = 1) and at each of phase 6's prompt
    lengths (BH = 64), r/k/v bf16, w fp32;
  - B1 ``moe_ffn``, which shares B2's GEMM header, at the same shape with
    dense weights: bf16 every expert and at decode occupancy, fp32 every
    expert.

Each result is held against the plain version first. With ``--paths`` each
run also drives that tree's own ``chip_smoke.py`` phase 4b (streaming,
int8) and phase 6 (RWKV6), which print their step medians and prefill
times. Kernel times are ``chip_smoke.time_ms`` of this tree (device time,
the host's enqueue ahead of the card). Prints each run's JSON line (``AB
{...}``) and a table; needs one CUDA GPU.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B4_SHAPES = [(256, 1)] + [(64, T) for T in (16, 100, 256, 512)]


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(tree: Path, paths: bool) -> dict:
    """One run: B2, B1 and B4 of ``tree`` on this process's card."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    import repro_torch
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.moe_ffn import moe_ffn, moe_ffn_quant
    from repro_torch.kernels.wkv6 import wkv6
    if not Path(repro_torch.__file__).resolve().is_relative_to(
            tree.resolve()):
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: CUDA is not available")
    cs = _module(ROOT / "chip_smoke.py", "chip_smoke_here")
    build.build(["moe_ffn", "moe_ffn_quant", "wkv6"])
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": str(tree), "b2": {}, "b4": {}, "b1": {}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    E, C, d, f = (cs.MAIN[k] for k in "ECdf")
    f32 = torch.float32
    for kind in ("int8", "fp16"):
        args = cs.quant_inputs(gen, E, C, d, f, 2 * E, "swiglu", kind,
                               torch.bfloat16)
        for what in ("every", "occupancy"):
            if what == "occupancy":
                cs.route_decode(args[0])
            got = moe_ffn_quant(*args, act="swiglu", out_dtype=f32)
            cs.compare(f"B2 {kind} {what}", got, ref.moe_ffn_quant_ref(
                *args, act="swiglu", out_dtype=f32))
            out["b2"][f"{kind}_{what}"] = cs.time_quant(
                args, "swiglu", f32, plain=False)["ms"]
        del args, got
        torch.cuda.empty_cache()
    for dt in (torch.bfloat16, torch.float32):
        xg = torch.randn((E, C, d), generator=gen, device="cuda").to(dt)
        wg, wu = (torch.randn((E, d, f), generator=gen, device="cuda")
                  .mul(d ** -0.5).to(dt) for _ in "gu")
        wd = torch.randn((E, f, d), generator=gen, device="cuda") \
            .mul(f ** -0.5).to(dt)
        for what in ("every", "occupancy") if dt == torch.bfloat16 \
                else ("every",):
            if what == "occupancy":
                cs.route_decode(xg)
            cs.compare(f"B1 {dt} {what}", moe_ffn(xg, wg, wu, wd),
                       ref.moe_ffn_ref(xg, wg, wu, wd))
            out["b1"][f"{str(dt)[6:]}_{what}"] = cs.time_ms(
                lambda: moe_ffn(xg, wg, wu, wd), 10)
        del xg, wg, wu, wd
        torch.cuda.empty_cache()
    for BH, T in B4_SHAPES:
        r, k, v = (torch.randn((BH, T, 64), generator=gen, device="cuda")
                   .mul(0.5).to(torch.bfloat16) for _ in range(3))
        w = torch.sigmoid(torch.randn((BH, T, 64), generator=gen,
                                      device="cuda"))
        u = torch.randn((BH, 64), generator=gen, device="cuda") * 0.1
        s0 = torch.randn((BH, 64, 64), generator=gen, device="cuda") * 0.1
        args = (r, k, v, w, u, s0)
        o, sN = wkv6(*args)
        o_ref, sN_ref = ref.wkv6_ref(*args)
        cs.compare(f"B4 BH={BH} T={T} o", o, o_ref, cs.WKV_TOL)
        cs.compare(f"B4 BH={BH} T={T} sN", sN, sN_ref, cs.WKV_TOL)
        out["b4"][f"BH={BH} T={T}"] = cs.time_wkv6(args, o, sN,
                                                   plain=False)["ms"]
    if paths:
        own = _module(tree / "chip_smoke.py", "chip_smoke_tree")
        card = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0]
        own.streaming_path(card)
        own.rwkv_path(card)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the other tree")
    ap.add_argument("--paths", action="store_true",
                    help="also run each tree's phases 4b and 6")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        print("AB " + json.dumps(measure(args.measure, args.paths)),
              flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for label, tree in (("parent", args.parent), ("change", ROOT),
                        ("change", ROOT), ("parent", args.parent)):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--measure",
               str(tree.resolve())] + (["--paths"] if args.paths else [])
        print(f"== {label}: {tree}", flush=True)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        print(proc.stdout + proc.stderr[-4000:], flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"{label} run failed ({proc.returncode})")
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        runs.append((label, json.loads(line[-1][3:])))
    print(f"ms per launch, runs in order [{card.splitlines()[0]}]")
    keys = [(part, k) for part in ("b2", "b4", "b1")
            for k in runs[0][1][part]]
    print("kernel, shape | " + " | ".join(label for label, _ in runs))
    for part, key in keys:
        print(f"{part.upper()} {key} | "
              + " | ".join(f"{run[part][key]:.4f}" for _, run in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
