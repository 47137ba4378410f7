#!/usr/bin/env python3
"""Time the port's B2, B4, B1, B5, B3, B3-qk and B3-pv kernels and the
B4/B5 backward kernels of two trees of this repo on one GPU, in turns: the
other tree, this one, this one, the other.

    python3 scripts/kernel_ab.py --parent DIR [--paths] [--train]
    python3 scripts/kernel_ab.py --parent DIR --steps
    python3 scripts/kernel_ab.py --lanes
    python3 scripts/kernel_ab.py --b3-q

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
    expert;
  - B5 ``selective_scan`` at Jamba's decode shape (B = 4, T = 1, d_in
    16384, N 16) and at B = 1 over 1, 17, 36, 256 and 2048 steps, x/B/C
    bf16;
  - B3 ``flash_decode`` in bf16 at ``chip_smoke.py`` phase 3b's served
    shapes (qwen3 decode, S 64; the 32768-position cache; Jamba's 64/8
    heads) and at its family shapes (``B3_FAMILY_SHAPES``: Whisper's
    cross-attention, Qwen2-VL, and Gemma-2's hd 256 with softcap 50 where
    the tree's kernel takes them).

  - B3-qk ``decode_scores`` and B3-pv ``decode_values`` (B3's halves
    over a head_dim-sharded cache) at ``chip_smoke.py`` phase 18a's shape:
    the 32768-position cache (B = 4, H = 64, Hkv = 4, hd 128, lengths
    32768 / 16384 / 8192 / 1), bf16, one of 2, 4 and 16 head_dim slices
    (one rank's launch), L2-warm and L2-cold (``chip_smoke.time_ms`` with
    ``flush``: the working set fits the 50 MB L2), B3-pv on the scores of
    the tree's own B3-qk.

  - B4-bwd ``wkv6_backward`` at the training shape (BH = 256, T = 128, hd
    64, r/k/v bf16, w fp32) and at T = 512, and B5-bwd
    ``selective_scan_backward`` at Jamba's (B = 4, T = 128, d_in 16384, N
    16, x/B/C bf16) and at T = 512, each gradient held against the plain
    backward (``chip_smoke.compare_grad``: normwise per row) first.

B3's hd 64/128 outputs without a softcap and every B4 and B5 output are
hashed, and every run's hashes must be equal: the other tree's kernel
and this one's give the same bits there. B3-qk and B3-pv are held only
against their tree's plain version, not hashed: a redesign that sums on
the tensor cores adds the products in another order, so its bits may
differ from the other tree's within the tolerance.

Each result is held against the plain version first. With ``--paths`` each
run also drives that tree's own ``chip_smoke.py`` phase 4b (streaming,
int8) and phase 6 (RWKV6), which print their step medians and prefill
times. With ``--train`` each run also trains ``chip_smoke.RECURRENT_LEGS``
(phase 14's full-width rwkv6-7b and jamba cuts) through that tree's
launcher for ``RECURRENT_STEPS`` steps; their losses and gradient norms are
printed side by side, step 0's loss must be bit-equal across the runs (the
forward is the same) and its gradient norm within 1e-3 relative. Kernel times are ``chip_smoke.time_ms`` of this tree (device time,
the host's enqueue ahead of the card). Prints each run's JSON line (``AB
{...}``) and a table; needs one CUDA GPU.

``--steps`` times, instead of the kernels, each tree's unplaced serving
steps (``Model.prefill`` and ``Model.serve_step``) at ``chip_smoke.py``
phase 17's legs: the decode step's wall and host enqueue ms, its
top-level aten ops and device kernels, the same but the wall for one
more prefill, and the greedy tokens, which must be equal in every run
(``serve_steps``).

``--lanes`` times this tree's B5 alone at the same shapes for each lane
group size G (lanes a channel's states are split over) and ring-stage
depth (steps a stage holds), each built as its own library from the same
source with ``-DSCAN_LANES=G -DSCAN_TILE=steps`` and held against the
plain version first: the measurement behind the kernel's defaults.

``--b3-q`` times this tree's B3 alone, bf16, at the B3 shapes above for
where q lives: built with ``-DFLASH_Q_SMEM_HD=`` 64 (q in shared memory
at every hd), 256 (the served build: from hd 256) and 512 (q's fragments
in registers at every hd, as before hd 256 was taken), each its own
library, held against the plain version first, with each build's
registers and spills of the bf16 hd-256 kernels.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import time
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B4_SHAPES = [(256, 1)] + [(64, T) for T in (16, 100, 256, 512)]
B5_SHAPES = [(4, 1)] + [(1, T) for T in (1, 17, 36, 256, 2048)]   # (B, T)
B5_D, B5_N = 16384, 16                                # Jamba's d_in, d_state
B5_LANES = (1, 2, 4, 8, 16)
B5_TILES = (32, 64)
BWD_SEQS = (128, 512)              # the training length, and 4x it
B4_BWD = (256, 64)                 # BH (4 rows x 64 heads), hd
B5_BWD = (4, 16384, 16)            # B, d_in, N
TRAIN_GNORM_RTOL = 1e-3


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(tree: Path, paths: bool, train: bool = False,
            steps: bool = False) -> dict:
    """One run: B2, B1, B4, B5, B3, B3-qk, B3-pv and the backward kernels
    of ``tree`` on this process's card; with ``steps``, only its unplaced
    serving steps (``serve_steps``)."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    import repro_torch
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.moe_ffn import moe_ffn, moe_ffn_quant
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.kernels.wkv6 import wkv6
    if not Path(repro_torch.__file__).resolve().is_relative_to(
            tree.resolve()):
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: CUDA is not available")
    cs = _module(ROOT / "chip_smoke.py", "chip_smoke_here")
    if steps:
        return {"tree": str(tree), "steps": serve_steps(cs)}
    build.build(["moe_ffn", "moe_ffn_quant", "wkv6", "selective_scan",
                 "flash_decode", "wkv6_bwd", "selective_scan_bwd",
                 "decode_scores", "decode_values"])
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": str(tree), "b2": {}, "b4": {}, "b1": {}, "b5": {},
           "b3": {}, "b3_qk": {}, "b3_pv": {}, "b4_bwd": {}, "b5_bwd": {},
           "bits": {}}
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
        out["bits"][f"B4 BH={BH} T={T}"] = _sha(o, sN)
    for B, T in B5_SHAPES:
        args = cs.scan_inputs(gen, B, T, B5_D, B5_N, torch.bfloat16)
        y, hT = selective_scan(*args)
        y_ref, hT_ref = ref.selective_scan_ref(*args)
        cs.compare(f"B5 B={B} T={T} y", y, y_ref, cs.SCAN_TOL)
        cs.compare(f"B5 B={B} T={T} h_T", hT, hT_ref, cs.SCAN_TOL)
        out["b5"][f"B={B} T={T}"] = cs.time_ms(
            lambda: selective_scan(*args), 200 if T < 1024 else 20)
        out["bits"][f"B5 B={B} T={T}"] = _sha(y, hT)
    measure_b3(cs, out)
    measure_split(cs, out)
    measure_bwd(cs, out)
    if train:
        out["train"] = train_legs(cs)
    if paths:
        own = _module(tree / "chip_smoke.py", "chip_smoke_tree")
        card = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0]
        own.streaming_path(card)
        own.rwkv_path(card)
    return out


STEP_AB_STEPS = 24     # greedy decode steps a leg; the first is not timed


def serve_steps(cs) -> dict:
    """The unplaced ``Model.prefill`` / ``Model.serve_step`` of the tree on
    the path, at ``chip_smoke.py`` phase 17's legs (full-width qwen3-moe 4
    layers, rwkv6-7b 4, Jamba 5; B = 4 prompts of 32, seed-0 weights), each
    with ``STEP_AB_STEPS`` greedy steps: the decode step's synchronised
    wall ms and its host enqueue ms (``perf_counter`` around the call, no
    sync inside), medians of steps 2 on, and one more step under
    ``torch.profiler`` (``chip_smoke.profile_step``: top-level aten ops,
    device kernels and copies, busy ms); then one more prefill of the same
    prompts into a new cache: its host enqueue ms, and profiled, its aten
    ops and device kernels. -> {leg: {...}, with the greedy tokens}."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import DATA_VOCAB
    from repro_torch.models import Model
    out = {}
    for leg, arch, depth, _ in cs.SERVE_MESH_LEGS:
        cfg = cs._full_cfg(f"kernel_ab --steps {leg}: unplaced prefill + "
                           f"{STEP_AB_STEPS} decode steps", arch, depth)
        model = Model(cfg, device="cuda").init(0)
        g = torch.Generator(device="cuda").manual_seed(17)
        B, S = cs.SERVE_MESH_B, cs.SERVE_MESH_PROMPT
        prompts = torch.randint(0, min(cfg.vocab, DATA_VOCAB), (B, S),
                                generator=g, device="cuda")
        cache = model.init_cache(B, S + STEP_AB_STEPS + 1)
        wall, enqueue, toks = [], [], []
        with torch.no_grad():
            lg, cache, _ = model.prefill({"tokens": prompts}, cache)
            for _ in range(STEP_AB_STEPS):
                tok = lg.argmax(-1)
                toks.append(tok)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, cache, _ = model.serve_step(cache, tok)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
                enqueue.append((t1 - t0) * 1e3)
            busy, kernels, ops, _, _ = cs.profile_step(
                lambda: model.serve_step(cache, lg.argmax(-1)))
            # one more prefill of the same prompts: its host enqueue (no
            # sync inside), then its aten ops under the profiler
            fresh = model.init_cache(B, S + STEP_AB_STEPS + 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill({"tokens": prompts}, fresh)
            pre_enqueue = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            _, pre_kernels, pre_ops, _, _ = cs.profile_step(
                lambda: model.prefill({"tokens": prompts}, fresh))
        out[leg] = {"step_ms": float(np.median(wall[1:])),
                    "enqueue_ms": float(np.median(enqueue[1:])),
                    "aten_ops": ops, "kernels": kernels, "busy_ms": busy,
                    "prefill_enqueue_ms": pre_enqueue,
                    "prefill_aten_ops": pre_ops,
                    "prefill_kernels": pre_kernels,
                    "tokens": torch.stack(toks, 1).tolist()}
        del model, cache, lg, fresh
        torch.cuda.empty_cache()
    return out


def compare_steps(runs) -> None:
    """The serving steps' table, runs side by side; every run's greedy
    tokens must be equal."""
    print("unplaced decode step, runs in order: step ms (synchronised "
          "wall) | host enqueue ms | top-level aten ops | device kernels "
          "and copies | busy ms; then one more prefill's host enqueue ms, "
          "top-level aten ops and device kernels and copies")
    for leg in runs[0][1]["steps"]:
        rs = [run["steps"][leg] for _, run in runs]
        for key in ("step_ms", "enqueue_ms", "aten_ops", "kernels",
                    "busy_ms", "prefill_enqueue_ms", "prefill_aten_ops",
                    "prefill_kernels"):
            print(f"{leg} {key} | " + " | ".join(
                f"{r[key]:.3f}" if isinstance(r[key], float)
                else str(r[key]) for r in rs))
        if any(r["tokens"] != rs[0]["tokens"] for r in rs):
            raise SystemExit(f"{leg}: the runs' greedy tokens differ")
    print("greedy tokens equal in every run")


# B3's phase-3b shapes: (what, B, H, Hkv, hd, S, per-row lengths, softcap)
B3_SHAPES = [("qwen3 S=64", 4, 64, 4, 128, 64, [1, 17, 40, 64], 0.0),
             ("long cache", 4, 64, 4, 128, 32768, [32768, 16384, 8192, 1],
              0.0),
             ("jamba heads", 4, 64, 8, 128, 48, [1, 17, 40, 48], 0.0)]
B3_Q_SMEM_HD = (64, 256, 512)     # the served build keeps q in smem from 256


def _sha(*ts) -> str:
    """The sha256 of the tensors' bytes, in order."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def measure_b3(cs, out) -> None:
    """B3 of the tree on the path at ``B3_SHAPES`` and this tree's
    ``chip_smoke.B3_FAMILY_SHAPES`` (a softcap only where the tree's
    wrapper takes hd 256): held against the tree's plain version, timed,
    and the uncapped outputs' bits hashed, into ``out``."""
    import torch
    from repro_torch.kernels import flash_decode as fd_mod
    from repro_torch.kernels import ref
    for i, (what, B, H, Hkv, hd, S, lens, cap) in enumerate(
            B3_SHAPES + cs.B3_FAMILY_SHAPES):
        if hd not in fd_mod.HEAD_DIMS:
            continue
        # seeded per shape: a tree that skips a shape draws the same
        # inputs for the others
        gen = torch.Generator(device="cuda").manual_seed(3 + i)
        q = torch.randn((B, H, hd), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        k, v = (torch.randn((B, S, Hkv, hd), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in "kv")
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        args = (q, k, v, cl) + ((cap,) if cap else ())
        y = fd_mod.flash_decode(*args)
        cs.compare(f"B3 {what}", y, ref.flash_decode_ref(*args))
        out["b3"][what] = cs.time_ms(lambda: fd_mod.flash_decode(*args),
                                     100)
        if not cap:
            out["bits"][f"B3 {what}"] = _sha(y)
        del q, k, v, y
    torch.cuda.empty_cache()


def measure_split(cs, out) -> None:
    """B3-qk and B3-pv of the tree on the path at phase 18a's timed cache
    (``chip_smoke.split_cache_inputs``, bf16) over one of each of
    ``chip_smoke.HD_SPLITS`` head_dim slices: each held against the tree's
    plain version, then timed L2-warm and L2-cold, into ``out`` (no
    hashes: see the module's docstring)."""
    import torch
    from repro_torch.kernels import decode_split as ds_mod
    from repro_torch.kernels import ref
    q, k, v, cl = cs.split_cache_inputs(
        torch.Generator(device="cuda").manual_seed(18))
    hd = q.shape[-1]
    for n in cs.HD_SPLITS:
        w = hd // n
        qs, ks, vs = (t[..., :w].contiguous() for t in (q, k, v))
        sc = ds_mod.decode_scores(qs, ks, cl, hd ** -0.5)
        cs.compare(f"B3-qk 1/{n}", sc,
                   ref.decode_scores_ref(qs, ks, cl, hd ** -0.5))
        cs.compare(f"B3-pv 1/{n}", ds_mod.decode_values(sc, vs, cl),
                   ref.decode_values_ref(sc, vs, cl))
        for part, fn in (
                ("b3_qk", lambda: ds_mod.decode_scores(qs, ks, cl,
                                                       hd ** -0.5)),
                ("b3_pv", lambda: ds_mod.decode_values(sc, vs, cl))):
            out[part][f"1/{n} warm"] = cs.time_ms(fn, 100)
            out[part][f"1/{n} L2-cold"] = cs.time_ms(
                fn, cs.SPLIT_COLD_ITERS, flush=True)
        del sc
    del q, k, v
    torch.cuda.empty_cache()


def _wkv_bwd_inputs(gen, BH, T, hd):
    """B4's inputs as phase 3f draws them (r/k/v bf16, w = exp(-exp(N))
    fp32), its checkpoints, and the upstream gradients."""
    import torch
    from repro_torch.kernels import wkv6 as wkv_mod

    def rnd(shape, std, dt=torch.float32):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dt)
    r, k, v = (rnd((BH, T, hd), 0.5, torch.bfloat16) for _ in range(3))
    w = torch.exp(-torch.exp(rnd((BH, T, hd), 1.0) - 0.5))
    args = (r, k, v, w, rnd((BH, hd), 0.1), rnd((BH, hd, hd), 0.1))
    do, dsN = rnd((BH, T, hd), 1.0, torch.bfloat16), rnd((BH, hd, hd), 0.1)
    _, _, ck = wkv_mod.wkv6(*args, checkpoints=True)
    return args, ck, do, dsN


def _scan_bwd_inputs(cs, gen, B, T, D, N):
    """B5's inputs as phase 3g draws them (x/B/C bf16), its checkpoints,
    and the upstream gradients."""
    import torch
    from repro_torch.kernels import selective_scan as scan_mod
    args = cs.scan_inputs(gen, B, T, D, N, torch.bfloat16)
    dy = torch.randn((B, T, D), generator=gen, device="cuda")
    dhT = torch.randn((B, D, N), generator=gen, device="cuda") * 0.1
    _, _, ck = scan_mod.selective_scan(*args, checkpoints=True)
    return args, ck, dy, dhT


def _grads_close(cs, tag, got, want, names):
    for n, g, w in zip(names, got, want):
        cs.compare_grad(f"{tag} d{n}", g, w)


def measure_bwd(cs, out) -> None:
    """B4-bwd and B5-bwd of the tree on the path at ``B4_BWD`` / ``B5_BWD``
    and each of ``BWD_SEQS``: every gradient held against the tree's plain
    backward, then timed, into ``out``."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as scan_mod
    from repro_torch.kernels import wkv6 as wkv_mod
    BH, hd = B4_BWD
    B, D, N = B5_BWD
    for T in BWD_SEQS:
        gen = torch.Generator(device="cuda").manual_seed(11 + T)
        args, ck, do, dsN = _wkv_bwd_inputs(gen, BH, T, hd)
        _grads_close(cs, f"B4-bwd T={T}",
                     wkv_mod.wkv6_backward(*args[:5], ck, do, dsN),
                     ref.wkv6_bwd_ref(*args, do, dsN), "rkvwus")
        out["b4_bwd"][f"BH={BH} T={T}"] = cs.time_ms(
            lambda: wkv_mod.wkv6_backward(*args[:5], ck, do, dsN), 20)
        del args, ck, do, dsN
        args, ck, dy, dhT = _scan_bwd_inputs(cs, gen, B, T, D, N)
        _grads_close(cs, f"B5-bwd T={T}",
                     scan_mod.selective_scan_backward(*args[:5], ck, dy, dhT),
                     ref.selective_scan_bwd_ref(*args, dy, dhT),
                     ("x", "t", "A", "B", "C", "h0"))
        out["b5_bwd"][f"B={B} T={T}"] = cs.time_ms(
            lambda: scan_mod.selective_scan_backward(*args[:5], ck, dy, dhT),
            20)
        del args, ck, dy, dhT
        torch.cuda.empty_cache()


def train_legs(cs) -> dict:
    """``cs.RECURRENT_LEGS`` trained through the tree's own launcher
    (phase 14's cuts, bf16, seed 0) for ``cs.RECURRENT_STEPS`` steps.
    -> {leg: {"losses": [...], "gnorms": [...]}}."""
    import gc

    import torch
    from repro_torch.launch import train as train_mod
    from repro_torch.models import Model
    res = {}
    for leg, arch, depth in cs.RECURRENT_LEGS:
        args = train_mod.parse_args(["--arch", arch, "--layers", str(depth),
                                     "--steps", str(cs.RECURRENT_STEPS)])
        cfg = train_mod.config(args)
        model = Model(cfg, device="cuda").init(0)
        got = train_mod.train(args, cfg, model)
        res[leg] = {"losses": [float(x) for x in got["losses"]],
                    "gnorms": [float(x) for x in got["gnorms"]]}
        del model, got
        gc.collect()
        torch.cuda.empty_cache()
    return res


def compare_train(runs) -> None:
    """The runs' phase-14 legs side by side; step 0's loss bit-equal in
    every run and its gradient norm within TRAIN_GNORM_RTOL."""
    legs = [run["train"] for _, run in runs]
    for leg in legs[0]:
        print(f"phase 14 {leg} leg, {len(legs[0][leg]['losses'])} steps "
              "(losses | gnorms), runs in order:")
        for (label, _), got in zip(runs, legs):
            print(f"  {label}: " + ", ".join(f"{x:.6f}" for x in
                                             got[leg]["losses"])
                  + " | " + ", ".join(f"{x:.6f}" for x in got[leg]["gnorms"]))
        l0 = {got[leg]["losses"][0] for got in legs}
        g0 = [got[leg]["gnorms"][0] for got in legs]
        spread = (max(g0) - min(g0)) / max(g0)
        print(f"  step 0: loss {'bit-equal' if len(l0) == 1 else 'DIFFERS'}"
              f" in every run; gnorm spread {spread:.2e} (limit "
              f"{TRAIN_GNORM_RTOL:g})")
        if len(l0) != 1 or spread > TRAIN_GNORM_RTOL:
            raise SystemExit(f"phase 14 {leg}: step 0 differs between runs")


def _variant_libs(build, name, variants) -> tuple:
    """Kernel ``name`` built once per variant (key -> its ``-D`` flags),
    one ``nvcc`` each, all started together, into the build directory
    beside (not over) the served library; each name carries the served
    library's source hash. -> (key -> launch function, key -> nvcc log,
    empty for a library built before)."""
    import ctypes
    stem = build.library_path(name).stem
    src = build.CSRC / f"{name}.cu"
    jobs, logs = {}, {}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def path(flags):
        return build.BUILD_DIR / (stem + "".join(
            "-" + f[2:].replace("=", "") for f in flags) + ".so")
    for key, flags in variants.items():
        out = path(flags)
        if not out.exists():
            tmp = out.with_suffix(".tmp")
            jobs[key] = (out, tmp, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(tmp),
                 str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for key, (out, tmp, proc) in jobs.items():
        logs[key], _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"kernel_ab: nvcc failed for {out.name}:\n"
                             f"{logs[key]}")
        tmp.replace(out)
    fn_name, argtypes = build._SIGNATURES[name]
    fns = {}
    for key, flags in variants.items():
        fn = getattr(ctypes.CDLL(str(path(flags))), fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[key] = fn
    return fns, logs


def lanes(card: str) -> None:
    """B5 of this tree per lane group size and ring-stage depth."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import build, ref
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: CUDA is not available")
    cs = _module(ROOT / "chip_smoke.py", "chip_smoke_here")
    variants = [(g, tile) for g in B5_LANES for tile in B5_TILES]
    fns, _ = _variant_libs(build, "selective_scan", {
        (g, tile): [f"-DSCAN_LANES={g}", f"-DSCAN_TILE={tile}"]
        for g, tile in variants})
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"B5 ms per launch by lanes G x stage steps, d_in {B5_D}, N {B5_N}"
          f", x/B/C bf16 [{card}]")
    print("B, T | bound ms | " + " | ".join(f"G={g} tile={tile}"
                                             for g, tile in variants))
    for B, T in B5_SHAPES:
        args = cs.scan_inputs(gen, B, T, B5_D, B5_N, torch.bfloat16)
        y_ref, hT_ref = ref.selective_scan_ref(*args)
        times = []
        for g, tile in variants:
            def run(fn=fns[g, tile]):
                y = torch.empty((B, T, B5_D), device="cuda")
                hT = torch.empty_like(args[5])
                stream = torch.cuda.current_stream().cuda_stream
                build.check("selective_scan", fn(
                    *(t.data_ptr() for t in args), y.data_ptr(),
                    hT.data_ptr(), None, B, T, B5_D, B5_N,
                    build.DTYPES[torch.bfloat16], stream))
                return y, hT
            y, hT = run()
            cs.compare(f"B5 G={g} tile={tile} B={B} T={T} y", y, y_ref,
                       cs.SCAN_TOL)
            cs.compare(f"B5 G={g} tile={tile} B={B} T={T} h_T", hT,
                       hT_ref, cs.SCAN_TOL)
            times.append(cs.time_ms(run, 200 if T < 1024 else 20))
        print(f"B={B} T={T} | {cs.scan_bound(args)[0]:.6f} | "
              + " | ".join(f"{ms:.4f}" for ms in times), flush=True)



def b3_q(card: str) -> None:
    """B3 of this tree, bf16, per ``-DFLASH_Q_SMEM_HD`` build."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_decode as fd_mod
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: CUDA is not available")
    cs = _module(ROOT / "chip_smoke.py", "chip_smoke_here")
    fns, logs = _variant_libs(build, "flash_decode", {
        v: [f"-DFLASH_Q_SMEM_HD={v}"] for v in B3_Q_SMEM_HD})
    for v, log in logs.items():
        lines = log.splitlines()
        for i, line in enumerate(lines):
            # the bf16 hd 256 kernels' <kCap, kLse> flags, serving (no lse)
            flags = re.search(r"flash_decode_kernelI13__nv_bfloat16Li256E"
                              r"Lb(\d)ELb0E", line)
            if flags:
                print(f"FLASH_Q_SMEM_HD={v} bf16 hd 256 "
                      f"{'capped' if flags[1] == '1' else 'uncapped'}: "
                      + "; ".join(x.strip() for x in lines[i + 1:i + 3]))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"B3 ms per launch, bf16, by FLASH_Q_SMEM_HD (q in shared memory "
          f"from that hd) [{card}]")
    print("shape | bound ms | " + " | ".join(
        f"q smem from hd {v}" for v in B3_Q_SMEM_HD))
    for i, (what, B, H, Hkv, hd, S, lens, cap) in enumerate(
            B3_SHAPES + cs.B3_FAMILY_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(3 + i)
        q = torch.randn((B, H, hd), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        k, v = (torch.randn((B, S, Hkv, hd), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in "kv")
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        want = ref.flash_decode_ref(q, k, v, cl, cap)
        n_split, split_len = fd_mod.splits(B, Hkv, H // Hkv, S, n_sm)
        part = torch.empty((B * H * n_split * (hd + 2),), device="cuda")
        times = []
        for var in B3_Q_SMEM_HD:
            def run(fn=fns[var]):
                out = torch.empty_like(q)
                build.check("flash_decode", fn(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), cl.data_ptr(),
                    out.data_ptr(), part.data_ptr() if n_split > 1 else None,
                    None, B, S, Hkv, H // Hkv, hd, n_split, split_len,
                    hd ** -0.5, cap, build.DTYPES[torch.bfloat16],
                    torch.cuda.current_stream().cuda_stream))
                return out
            cs.compare(f"B3 FLASH_Q_SMEM_HD={var} {what}", run(), want)
            times.append(cs.time_ms(run, 100))
        bound_ms = cs.bounds.flash_decode(
            B, H, Hkv, hd, sum(min(n, S) for n in lens), 2,
            torch.bfloat16)[0]
        print(f"{what} (hd {hd}) | {bound_ms:.6f} | "
              + " | ".join(f"{ms:.4f}" for ms in times), flush=True)
        del q, k, v, want, part
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the other tree")
    ap.add_argument("--paths", action="store_true",
                    help="also run each tree's phases 4b and 6")
    ap.add_argument("--lanes", action="store_true",
                    help="time this tree's B5 per lane group and stage "
                         "depth instead")
    ap.add_argument("--b3-q", action="store_true",
                    help="time this tree's B3 per FLASH_Q_SMEM_HD build "
                         "instead")
    ap.add_argument("--train", action="store_true",
                    help="also train each tree's phase-14 legs and compare "
                         "their losses and gradient norms")
    ap.add_argument("--steps", action="store_true",
                    help="time only each tree's unplaced serving steps at "
                         "chip_smoke.py phase 17's legs")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        print("AB " + json.dumps(measure(args.measure, args.paths,
                                         args.train, args.steps)),
              flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    if args.lanes:
        lanes(card.splitlines()[0])
        return 0
    if args.b3_q:
        b3_q(card.splitlines()[0])
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    runs = []
    for label, tree in (("parent", args.parent), ("change", ROOT),
                        ("change", ROOT), ("parent", args.parent)):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--measure",
               str(tree.resolve())] + (["--paths"] if args.paths else []) \
            + (["--train"] if args.train else []) \
            + (["--steps"] if args.steps else [])
        print(f"== {label}: {tree}", flush=True)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        print(proc.stdout + proc.stderr[-4000:], flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"{label} run failed ({proc.returncode})")
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        runs.append((label, json.loads(line[-1][3:])))
    if args.steps:
        print(f"[{card.splitlines()[0]}]")
        compare_steps(runs)
        return 0
    print(f"ms per launch, runs in order [{card.splitlines()[0]}]")
    keys = [(part, k) for part in ("b2", "b4", "b1", "b5", "b3", "b3_qk",
                                   "b3_pv", "b4_bwd", "b5_bwd")
            for k in dict.fromkeys(key for _, run in runs
                                   for key in run.get(part, {}))]
    print("kernel, shape | " + " | ".join(label for label, _ in runs))
    for part, key in keys:
        print(f"{part.upper()} {key} | " + " | ".join(
            f"{run[part][key]:.4f}" if key in run.get(part, {}) else "-"
            for _, run in runs))
    bits = [run.get("bits", {}) for _, run in runs]
    shared = sorted(set.intersection(*(set(b) for b in bits)))
    same = [k for k in shared if len({b[k] for b in bits}) == 1]
    print(f"B3 (without a softcap), B4 and B5 outputs bit-equal in every "
          f"run: {len(same)} of {len(shared)} shapes ({', '.join(shared)})")
    if len(same) != len(shared):
        raise SystemExit("kernel outputs differ between runs: "
                         + ", ".join(k for k in shared if k not in same))
    if args.train:
        compare_train(runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
