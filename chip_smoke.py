#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. the card's name and power limit, torch and CUDA versions;
  2. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc;
  3. hold each kernel against its plain PyTorch version on the card at the
     served shapes, in bf16 and fp32, plus ragged shapes; time the kernel,
     the plain version, a library call (a yardstick only) and the bound:
     3a moe_ffn (B1, also through a permuted slot table, and at decode
     occupancy: 4 tokens x top-8, the other rows and experts zero; at
     DeepSeek-V2's decode occupancy: 160 experts, C = 6, 4 tokens x top-6;
     and at Jamba's: 16 experts of d 8192 x f 24576, C = 4, 4 tokens x
     top-2; under a gradient, its autograd Function at the training shape,
     E 128, C 41, d 4096, f 1536 bf16, every row filled and routed over 512
     tokens, and at ragged fp32 shapes: output bit-equal to the plain
     launch, output and all four gradients against autograd through the
     plain version, forward and backward timed), 3b flash_decode (B3,
     also over a 32768-position cache split across blocks, at Jamba's
     64/8 heads, and at the family shapes of phases 9-9c: Gemma-2's hd
     256 with softcap 50 over a full and a ragged 4096-position ring,
     Whisper's cross-attention over 1500 encoder positions, Qwen2-VL's
     64/8 heads), 3c moe_ffn_quant (B2, int8
     and fp16 slot buffers, every expert filled and at B1's decode
     occupancy; at DeepSeek-V2's over 240 slots), 3d wkv6 (B4, the RWKV6
     recurrence at decode, at each of phase 6's prompt lengths and at
     ragged shapes), 3e selective_scan (B5, the Mamba scan at Jamba's
     decode shape, also timed with a cold L2, at B = 1 for each of phase
     8's prompt lengths and its warm-up length and over 256 and 2048
     steps, and at ragged shapes, bf16 and fp32 inputs; beside its bound,
     the time its exps alone take on the special-function units);
  4. serve full-width qwen3-moe-235b-a22b, cut to 4 layers, through the
     launcher's own code (4 requests, prompts <= 32, <= 16 new tokens, 4
     slots), every expert resident, and check every request's budget and
     the kernels' launch counts; time each pooled decode step with CUDA
     events, and the host's enqueue and the device's busy time of one more
     step (torch.profiler); finite full-width logits; then one more warmed
     server decode step, and ``Model.serve_step`` alone, under
     ``torch.cuda.set_sync_debug_mode("warn")``: every sync the card
     reports is attributed to its source line (the innermost frame under
     ``src/repro_torch``) and must lie in a function the port's linter
     declares a fence, or on a line it reports as suppressed;
     ``serve_step`` alone must sync only where the linter predicts
     (nowhere);
  4b the same through the streaming path (--resident-fraction 0.5
     --transfer-dtype int8): experts in page-locked host memory, 256
     device slots, real uploads; check budgets, slot counters, upload
     bytes, B2's launch count and the memory the card no longer holds;
     time decode steps, the demand stall and one expert's upload; one more
     warmed decode step under the sync debug mode, held as in phase 4;
  5. the whole port stack on the card against the same weights on the CPU
     (reduced config, fp32);
  5b the streaming server on the card (reduced, fp32): a slot for every
     expert gives the fused server's tokens; rf 0.5 over each wire, overlap
     and fenced, gives the CPU port's tokens;
  6. rwkv6-7b at full width and all 32 layers (bf16) through the model's
     serving entry points: 4 prompts of 16-512 tokens prefilled at B=1 and
     written into a pool of 4, then pooled decode steps under an ``active``
     mask that retires rows at different budgets; check finite logits,
     frozen inactive rows and B4's launch count; time each prefill and
     decode step with CUDA events and the host's enqueue time of each step, and
     profile one more step (device busy time, kernels, aten ops);
  6b the same port on the card against the CPU (reduced rwkv6-7b, fp32):
     equal greedy tokens, logits within fp32 limits;
  7. phase 4 for deepseek-v2-236b at full width (MLA, 160 experts top-6
     plus 2 shared experts, a dense first layer), cut to 4 layers: B1 on
     every MoE layer, B3 never (MLA decode is tensor ops over the latent
     cache); plus the step's weight-read floor;
  7b phase 4b for the same model (240 slots for 480 experts), with the
     host's resident memory;
  7c the launcher on the card against the CPU, same weights, fp32, every
     report line equal but the wall-clock ones: reduced qwen3-moe and a
     reduced DeepSeek-V2 of 1 dense + 2 MoE layers x 8 experts (forward
     and 6 pooled decode steps first), all-resident and at rf 0.5 over each
     wire;
  8. jamba-1.5-large-398b at full width (Mamba d_in 16384, attention 64/8
     heads x 128, 16 experts top-2 of d_expert 24576 on odd layers, dense
     d_ff 24576 on even ones, vocab 65536), cut to 5 layers: (mamba,
     dense), (mamba, MoE), (mamba, dense), (mamba, MoE), (attn, dense);
     phase 4 for it all-resident: B5 in every Mamba layer at prefill and
     decode, B1 on both MoE layers, B3 on the attention layer, B2 never;
     inactive pool rows' conv/ssm bit-frozen; the step's weight-read floor;
  8b phase 4b for the same model at rf 0.5 over the master-dtype (bf16)
     wire: 16 slots for 32 experts of 1.208 GB, B1 through the slot table,
     ~38.7 GB of page-locked host masters, no wire images;
  8c the launcher on the card against the CPU, same weights, fp32, every
     report line equal but the wall-clock ones, for a reduced Jamba whose
     Mamba layers carry 8 experts ((mamba, dense), (mamba, MoE), (attn,
     dense), (mamba, MoE)), all-resident and at rf 0.5 over each wire;
  9. gemma2-2b at full width and all 26 layers (8/4 heads x 256, window
     4096 on the 13 local layers, softcaps 50/30, GeGLU 9216, vocab
     256000) through the model's serving entry points: prompts of 16,
     512, 2048 and 4080 tokens prefilled at B=1 into a pool of 4 (cache_len
     4112), 32 decode steps under an ``active`` mask, the 4080 row past
     position 4096 where the local rings wrap; finite logits, inactive
     rows bit-frozen, B3 26 launches a step and no other kernel; prefill
     and step times, host enqueue, one more step profiled;
  9b the same for qwen2-vl-72b at full width (64/8 heads x 128, QKV bias,
     M-RoPE (16, 24, 24), SwiGLU 29568, vocab 152064, head not tied), cut
     to 4 layers: prompts of seeded patch embeddings over a stub grid
     with (3, B, S) positions, then text; B3 4 launches a step;
  9c the same for whisper-small at full width and depth (12 + 12 layers,
     12 heads x 64, learned positions, LayerNorm, GELU): seeded stub
     frames (1500 x 768) through the encoder, decoder prompts of 4-16
     tokens, 16 steps; B3 24 launches a step (12 self, 12 cross);
  9d each of the three reduced configs in fp32 on the card against the
     CPU: equal greedy tokens, logits within fp32 limits, Gemma's reduced
     window of 128 crossed;
 10. train qwen3-moe-235b-a22b at every published width, cut to 1 layer
     (3.733e9 parameters: bf16 weights and gradients and fp32 AdamW
     moments fill ~45 GB), after freeing every earlier model: 8 steps of
     batch 4 x seq 128 through ``make_train_step`` (remat on, AdamW, lr
     1e-3, 2 warm-up steps); finite losses and gradient norms, after step 1
     a finite gradient for every parameter, non-zero expert gradients and
     every parameter changed; B1 launches (1 a step at 1 layer: a prefix
     layer is not rematerialized) and no other kernel; step times, the
     host's enqueue, peak memory, then 3 more steps timed part by part
     (forward + backward, AdamW) beside their bytes floors; then the same
     model cut to 2 layers (two scan groups) takes one remat forward +
     backward: B1 2 launches a MoE layer, the forward and its recompute;
 10b reduced qwen3-moe (its MoE layers rematerialized: B1 2 launches a
     layer and step) and reduced DeepSeek-V2 in fp32, 5 steps on the card
     against the same weights on the CPU: losses, gradient norms and
     parameters within fp32 limits; a checkpoint round trip on the card;
 11. phase 10's model and batches under ``moe_dispatch="grouped"``
     (per-sequence GShard dispatch, capacity C_g per expert and sequence):
     5 steps through ``make_train_step``, B1 once a step over the (E,
     B·C_g, d) blocks of every sequence, then 3 timed part by part; finite
     loss and gradients, non-zero expert gradients; step, forward +
     backward and AdamW ms and peak memory beside phase 10's; B1 at the
     grouped shape (E 128, 4 x 11 rows, d 4096, f 1536 bf16) against its
     plain version, timed beside its bound and 3x ``torch.bmm``; the
     step's ``model_flops_for`` as an MFU; the dry run's traced FLOPs of
     the same step against ``torch.utils.flop_counter`` on the card (plus
     B1's forward products, a launch it cannot see), and its roofline
     against the measured step;
 11b gemma2-2b at full width and all 26 layers prefilled at 4080 and 8192
     tokens with ``attn_impl="blocked"`` and ``"naive"`` on the same
     weights: last-token logits within bf16 limits, prefill ms and peak
     memory of each, no kernel launched; then reduced gemma2-2b in fp32
     with blocked attention over 1100 tokens (several query and KV blocks,
     past its 128 window) on the card against the CPU;
 11c ``python -m repro_torch.launch.dryrun --all`` in a subprocess (meta
     tensors, no card): seconds, records by status (an error fails), and
     qwen3-moe's decode_32k and train_4k rooflines;
 12. expert parallelism over D shards of this one card (``ExpertMesh``
     of cuda:0 repeated; the shards share its SMs and its host link, so
     this measures what sharding costs, not a speed-up): at one MoE
     layer's decode shape ``moe_ffn_sharded`` (B1) and
     ``moe_ffn_sharded_slots`` (B1 over bf16 slots, B2 over int8 and
     fp16) at D = 2 and 4 bit-equal to the unsharded launch, each shard
     against its plain version and timed beside its bytes bound, and the
     exchange's copies a layer; then phase 4's model and requests through
     the launcher with ``--devices D``: (a) rf 0.5 int8 at D = 2 and (b)
     at D = 4 (256 slots split over the shards; phase 4b's tokens), (c)
     all-resident at D = 2 (512 bf16 home slots, B1 through each shard's
     slot table; phase 4's tokens); the slot kernel D times a MoE layer
     and step, the shards' counters summing to ``stats()``, rebalances
     > 0, the ``devices:`` line, no card memory beyond the slots and the
     pool cache; step medians, host and device busy time beside phase
     4b's D = 1, per-shard uploads and GB/s on each copy stream;
 13. the port's linter (``python -m repro_torch.analysis.lint``, standard
     library only) over ``src/repro_torch`` in a subprocess: exit 0 and no
     new finding; files, rule ids, suppressed findings by rule, declared
     fences and step entries; the capture map (step entries, what they
     reach, kernel launch sites) written to ``experiments/lint_torch/``;
 14. one JSON line of per-kernel numbers, then the result line.

Exits non-zero without a result when CUDA is unavailable.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12                                  # H100 SXM
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
MAIN = dict(E=128, C=8, d=4096, f=1536)       # expert FFN at decode
DEEPSEEK = dict(E=160, C=6, d=5120, f=1536)   # DeepSeek-V2's, top-6
DEEPSEEK_SLOTS = 240                          # rf 0.5 of 3 x 160 experts
JAMBA_MOE = dict(E=16, C=4, d=8192, f=24576)  # Jamba's, top-2, C = 4 at cf 8
LONG_CACHE = (4, 64, 4, 128, 32768)           # B3: B, H, Hkv, hd, S (> L2)
SLEEP_CYCLES = 50_000_000                     # ~25 ms at the H100's clocks

# tolerances (allclose: |kernel - plain| <= atol + rtol * |plain|):
#  fp32 -- both sides accumulate in fp32, in different orders over
#          K <= 4096 terms: a few 1e-6 absolute at O(1) outputs; the CPU
#          tests' fp32 limits hold with margin;
#  bf16 -- inputs are identical, but the hidden activation / output are
#          rounded to bf16 (ulp 2^-8 relative), so an fp32-order difference
#          can flip one rounding step; 5e-2 as in the CPU kernel tests.
TOL = {"torch.float32": (2e-5, 1e-4), "torch.bfloat16": (5e-2, 5e-2)}
# B4's fp32 limit: tests/test_kernels.py's wkv6 test (sums over K = hd
# terms in another order, carried through T steps of the state)
WKV_TOL = {"torch.float32": (1e-4, 1e-4), "torch.bfloat16": (5e-2, 5e-2)}
# B5: y and h_T are fp32 on both sides, computed in fp32 from the same
# inputs (bf16 x/B/C are widened exactly), so bf16 inputs take the fp32
# limit too: sums over N in another order, exp to an ulp, carried through
# T steps of a decaying state
SCAN_TOL = {"torch.float32": (1e-4, 1e-4)}


def sh(cmd):
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def time_ms(fn, iters, ahead=True):
    """Mean ms per call between CUDA events, after two warm-up calls.

    ahead=True (kernels and library calls): a device sleep queued first lets
    the host enqueue every timed call before the card reaches them, so a
    kernel shorter than its wrapper's host cost is timed on the device, not
    at the host's issue rate. The host's enqueue time is held against the
    sleep's device time; when it outlasts the sleep the card may have waited
    on the host, so the sleep is lengthened and the timing repeated, and
    after three tries it raises. ahead=False (the plain versions: chains of
    many small launches that would fill the launch queue): back-to-back
    calls, the host's issue included."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    sleep0, start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(3))
    if not ahead:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    cycles = SLEEP_CYCLES
    for _ in range(3):
        t0 = time.perf_counter()
        sleep0.record()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        sleep_ms = sleep0.elapsed_time(start)
        if enqueue_ms < sleep_ms:
            return start.elapsed_time(end) / iters
        cycles = int(cycles * 2 * enqueue_ms / sleep_ms)
    raise SystemExit(f"time_ms: the host's enqueue ({enqueue_ms:.1f} ms) "
                     f"outlasts the device sleep ({sleep_ms:.1f} ms)")


def compare(name, got, want, tol=TOL):
    import torch
    atol, rtol = tol[str(want.dtype)]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(torch.all(err <= atol + rtol * w.abs())) and \
        bool(torch.isfinite(g).all())
    worst = float(err.max())
    print(f"  {name}: max_abs_err={worst:.3e} (atol {atol:g}, rtol {rtol:g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return worst


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_ffn(xg, wg, wu, wd):
    """The swiglu expert FFN as one library call per product: 3
    ``torch.bmm`` and a silu (a yardstick for B1, used nowhere in the
    port)."""
    import torch
    h = torch.nn.functional.silu(torch.bmm(xg, wg)) * torch.bmm(xg, wu)
    return torch.bmm(h, wd)


def check_moe_ffn(gen, card):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_ffn import moe_ffn

    def make(E, C, d, f, act, dtype):
        def rnd(shape, std):
            return (torch.randn(shape, generator=gen, device="cuda")
                    * std).to(dtype)
        wg = rnd((E, d, f), d ** -0.5) if act in ("swiglu", "geglu") else None
        return (rnd((E, C, d), 1.0), wg, rnd((E, d, f), d ** -0.5),
                rnd((E, f, d), f ** -0.5))

    print("phase 3a: moe_ffn kernel vs plain (moe_ffn_ref)")
    row = None
    for dtype in (torch.bfloat16, torch.float32):
        for E, C, d, f, act in [(128, 8, 4096, 1536, "swiglu"),
                                (3, 13, 520, 700, "swiglu"),
                                (3, 13, 520, 700, "geglu"),
                                (3, 13, 520, 700, "relu2"),
                                (3, 13, 520, 700, "gelu")]:
            xg, wg, wu, wd = make(E, C, d, f, act, dtype)
            got = moe_ffn(xg, wg, wu, wd, act=act)
            want = ref.moe_ffn_ref(xg, wg, wu, wd, act=act)
            torch.cuda.synchronize()
            err = compare(f"E={E} C={C} d={d} f={f} {act} {dtype}", got, want)
            if (E, C, d, f) != (128, 8, 4096, 1536):
                continue
            ms = time_ms(lambda: moe_ffn(xg, wg, wu, wd, act=act), 10)
            plain_ms = time_ms(
                lambda: ref.moe_ffn_ref(xg, wg, wu, wd, act=act), 5,
                ahead=False)

            lib_ms = time_ms(lambda: library_ffn(xg, wg, wu, wd), 10)
            esz = xg.element_size()
            nbytes = esz * (2 * xg.numel() + wg.numel() + wu.numel()
                            + wd.numel())
            bound_ms, by = bound(nbytes, 2 * E * C * d * f * 3, dtype)
            print(f"  time {dtype}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, library (3x torch.bmm + silu) {lib_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({by}) [{card}]")
            if dtype == torch.bfloat16:
                row = dict(name="moe_ffn", route="cuda",
                           source="src/repro_torch/kernels/csrc/moe_ffn.cu",
                           replaces="src/repro/kernels/moe_ffn.py:80",
                           max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)
            # the same weights as slot buffers read through a permuted
            # slot table (the streaming path's fp32 wire)
            perm = torch.randperm(E, generator=gen, device="cuda")
            got = moe_ffn(xg, wg, wu, wd, act=act,
                          slot_ids=perm.to(torch.int32))
            want = ref.moe_ffn_ref(xg, wg[perm], wu[perm], wd[perm], act=act)
            torch.cuda.synchronize()
            compare(f"E={E} C={C} d={d} f={f} {act} {dtype} permuted "
                    "slot_ids", got, want)
            del xg, wg, wu, wd, got, want
            torch.cuda.empty_cache()
    row.update(check_moe_ffn_occupancy(gen, card, make))
    row.update(check_moe_ffn_occupancy(
        gen, card, make, DEEPSEEK, DEEPSEEK_TOP_K, (torch.bfloat16,),
        "deepseek_"))
    row.update(check_moe_ffn_occupancy(
        gen, card, make, JAMBA_MOE, JAMBA_TOP_K, (torch.bfloat16,), "jamba_"))
    row.update(check_moe_ffn_train(gen, card, make))
    return row


TOKENS, TOP_K = 4, 8          # the decode pool and the routing width
DEEPSEEK_TOP_K = 6
JAMBA_TOP_K = 2


def route_decode(xg, seed=1, top_k=TOP_K):
    """Fill xg (E, C, d) in place as the dispatch fills it for a pool of
    TOKENS tokens, each routed to ``top_k`` distinct experts (a seeded
    draw) at its expert's first free row: the tokens are xg[0, :TOKENS] as
    made; every other row, and every expert no token chose, is exactly
    zero. -> ((E, C) bool mask of the routed rows, number of routed
    experts)."""
    import torch
    E = xg.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = xg[0, :TOKENS].clone()               # the pool's hidden rows
    xg.zero_()
    fill = [0] * E
    for t in range(TOKENS):
        for e in torch.randperm(E, generator=gen,
                                device="cuda")[:top_k].tolist():
            xg[e, fill[e]] = x[t]
            fill[e] += 1
    routed = (xg != 0).any(-1)
    return routed, int(routed.any(-1).sum())


def check_zero_rows(y, routed):
    """Every row of y without a token is +0.0 in every bit."""
    import torch
    ints = torch.int16 if y.element_size() == 2 else torch.int32
    if not bool((y[~routed].view(ints) == 0).all()):
        raise SystemExit("decode occupancy: a zero row of xg gave a "
                         "non-zero (or -0.0) row of y")
    print(f"  rows without a token: all {int((~routed).sum())} are +0.0 in "
          f"every bit")


def check_moe_ffn_occupancy(gen, card, make, shape=MAIN, top_k=TOP_K,
                            dtypes=None, prefix=""):
    """B1 at decode occupancy: xg (``shape``) filled as the dispatch fills
    it for a pool of 4 tokens, each routed to ``top_k`` distinct experts at
    its expert's first free row; every other row (and every expert no token
    chose) is exactly zero. -> the ``<prefix>occupancy_*`` keys of B1's row
    (bf16)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_ffn import moe_ffn

    E, C, d, f = shape["E"], shape["C"], shape["d"], shape["f"]
    nums = {}
    for dtype in dtypes or (torch.bfloat16, torch.float32):
        xg, wg, wu, wd = make(E, C, d, f, "swiglu", dtype)
        routed, n_experts = route_decode(xg, top_k=top_k)
        got = moe_ffn(xg, wg, wu, wd, act="swiglu")
        want = ref.moe_ffn_ref(xg, wg, wu, wd, act="swiglu")
        torch.cuda.synchronize()
        at = f" E={E} C={C} d={d} f={f}" if prefix else ""
        err = compare(f"decode occupancy{at}: {TOKENS} tokens x top-{top_k}"
                      f", {n_experts} of {E} experts non-empty, {dtype}",
                      got, want)
        check_zero_rows(got, routed)
        if dtype != torch.bfloat16:
            continue
        ms = time_ms(lambda: moe_ffn(xg, wg, wu, wd, act="swiglu"), 20)
        plain_ms = time_ms(
            lambda: ref.moe_ffn_ref(xg, wg, wu, wd, act="swiglu"), 5,
            ahead=False)

        def library():
            h = torch.nn.functional.silu(torch.bmm(xg, wg)) \
                * torch.bmm(xg, wu)
            return torch.bmm(h, wd)
        lib_ms = time_ms(library, 10)
        esz = xg.element_size()
        # what these inputs need: xg and y once, and the weights of the
        # experts with a routed row; flops of the routed rows
        nbytes = esz * (2 * xg.numel() + n_experts * 3 * d * f)
        bound_ms, by = bound(nbytes, 2 * int(routed.sum()) * d * f * 3,
                             dtype)
        print(f"  time decode occupancy{at} {dtype}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library (3x torch.bmm + silu over "
              f"all {E} experts) {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({by}: {n_experts} experts' weights), kernel/library "
              f"{ms / lib_ms:.3f}, roofline {bound_ms / ms:.1%} [{card}]")
        nums = {prefix + "occupancy_" + k: v for k, v in dict(
            experts=n_experts, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=by, library_ms=lib_ms).items()}
        if prefix:
            nums[prefix + "occupancy_shape"] = (
                f"E={E} C={C} d={d} f={f} swiglu bf16, {TOKENS} tokens x "
                f"top-{top_k}")
        del xg, wg, wu, wd, got, want
        torch.cuda.empty_cache()
    return nums


def quant_inputs(gen, E, C, d, f, n, act, kind, xdt):
    """B2's operands: xg (E, C, d) in xdt, fp16 or int8 slot buffers (n
    slots; int8 with (n, out) fp32 scales) and an (E,) slot table: E
    distinct slots of n, or [3, 0, 0] at E = 3.
    -> (xg, w_gate, w_up, w_down, s_gate, s_up, s_down, slot_ids)."""
    import torch

    def wire(shape):
        std = shape[0] ** -0.5
        if kind == "fp16":
            w = torch.randn((n,) + shape, generator=gen, device="cuda") * std
            return w.half(), None
        q = torch.randint(-127, 128, (n,) + shape, generator=gen,
                          device="cuda", dtype=torch.int8)
        s = (torch.rand((n, shape[-1]), generator=gen, device="cuda") + 0.5) \
            * (2 * std / 127)
        return q, s
    xg = torch.randn((E, C, d), generator=gen, device="cuda").to(xdt)
    wg, sg = wire((d, f)) if act == "swiglu" else (None, None)
    wu, su = wire((d, f))
    wd, sd = wire((f, d))
    if E == 3:
        slots = torch.tensor([3, 0, 0], device="cuda")
    else:             # E distinct slots of n, as at rf 0.5
        slots = torch.randperm(n, generator=gen, device="cuda")[:E]
    return xg, wg, wu, wd, sg, su, sd, slots.to(torch.int32)


def quant_bound(args, routed, out_dtype):
    """B2's bound from these inputs: xg, y and the slot table once, and the
    weights (and int8 scales) of the slots that experts with a routed row
    read; the routed rows' fp32 flops. -> (bound ms, by)."""
    import torch
    xg, wg, wu, wd, sg, su, sd, slots = args
    E, C, d = xg.shape
    f = wu.shape[-1]
    busy = routed.any(-1)
    n_read = len(set(slots[busy].tolist()))
    n_proj = 3 if wg is not None else 2
    wbytes = n_proj * d * f * wu.element_size()
    sbytes = 4 * ((n_proj - 1) * f + d) if su is not None else 0
    nbytes = (xg.numel() * xg.element_size() + n_read * (wbytes + sbytes)
              + 4 * E + E * C * d * torch.finfo(out_dtype).bits // 8)
    return bound(nbytes, 2 * int(routed.sum()) * d * f * n_proj,
                 torch.float32)


def time_quant(args, act, out, plain=True):
    """B2's kernel, plain and library times on these inputs.
    -> dict(ms, plain_ms, library_ms)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_ffn import moe_ffn_quant
    xg, wg, wu, wd, sg, su, sd, slots = args
    ms = time_ms(lambda: moe_ffn_quant(*args, act=act, out_dtype=out), 10)
    if not plain:
        return dict(ms=ms)
    plain_ms = time_ms(lambda: ref.moe_ffn_quant_ref(
        *args, act=act, out_dtype=out), 3, ahead=False)
    idx = slots.long()

    def deq(w, s):
        w = w[idx].to(torch.bfloat16)
        return w if s is None else w * s[idx][:, None, :].to(torch.bfloat16)

    def library():
        x = xg.to(torch.bfloat16)
        h = torch.nn.functional.silu(torch.bmm(x, deq(wg, sg))) \
            * torch.bmm(x, deq(wu, su))
        return torch.bmm(h, deq(wd, sd))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=time_ms(library, 10))


def quant_occupancy(args, act, out, top_k, what, card):
    """B2 at decode occupancy: ``args``' xg refilled by ``route_decode``
    (top-``top_k``), held against the plain version with every unrouted row
    +0.0, then timed. -> the values of the row's ``occupancy_*`` keys."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_ffn import moe_ffn_quant
    E = args[0].shape[0]
    routed, n_experts = route_decode(args[0], top_k=top_k)
    got = moe_ffn_quant(*args, act=act, out_dtype=out)
    want = ref.moe_ffn_quant_ref(*args, act=act, out_dtype=out)
    torch.cuda.synchronize()
    err = compare(f"decode occupancy: {TOKENS} tokens x top-{top_k}, "
                  f"{n_experts} of {E} experts non-empty, {what}", got, want)
    check_zero_rows(got, routed)
    del got, want
    nums = time_quant(args, act, out)
    bound_ms, by = quant_bound(args, routed, out)
    print(f"  time {what}, decode occupancy: kernel {nums['ms']:.4f} ms, "
          f"plain {nums['plain_ms']:.4f} ms, library (dequantize to bf16 + "
          f"3x torch.bmm + silu over all {E} experts) "
          f"{nums['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({by}: "
          f"{n_experts} experts' weights and scales), roofline "
          f"{bound_ms / nums['ms']:.1%} [{card}]")
    return dict(experts=n_experts, max_abs_err=err, bound_ms=bound_ms,
                bound_by=by, **nums)


def check_moe_ffn_quant(gen, card):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_ffn import moe_ffn_quant

    print("phase 3c: moe_ffn_quant kernel vs plain (moe_ffn_quant_ref)")
    E, C, d, f = MAIN["E"], MAIN["C"], MAIN["d"], MAIN["f"]
    row = {}
    cases = [(E, C, d, f, 2 * E, "swiglu", torch.float32)]
    cases += [(3, 13, 520, 700, 4, act, out) for act in ("swiglu", "gelu")
              for out in (torch.float32, torch.bfloat16)]
    for kind in ("int8", "fp16"):
        for xdt in (torch.bfloat16, torch.float32):
            for E_, C_, d_, f_, n, act, out in cases:
                args = quant_inputs(gen, E_, C_, d_, f_, n, act, kind, xdt)
                got = moe_ffn_quant(*args, act=act, out_dtype=out)
                want = ref.moe_ffn_quant_ref(*args, act=act, out_dtype=out)
                torch.cuda.synchronize()
                err = compare(f"E={E_} C={C_} d={d_} f={f_} n_slots={n} {act} "
                              f"{kind} x {xdt} out {out}", got, want)
                if E_ == 3 or xdt != torch.bfloat16:
                    continue
                # every row of every expert filled
                nums = time_quant(args, act, out)
                bound_ms, by = quant_bound(
                    args, torch.ones((E, C), dtype=torch.bool,
                                     device="cuda"), out)
                print(f"  time {kind} x {xdt}, every expert: kernel "
                      f"{nums['ms']:.4f} ms, plain {nums['plain_ms']:.4f} ms, "
                      f"library (dequantize to bf16 + 3x torch.bmm + silu) "
                      f"{nums['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                      f"({by}), roofline {bound_ms / nums['ms']:.1%} [{card}]")
                pre = "" if kind == "int8" else "fp16_"
                row.update({pre + k: v for k, v in dict(
                    max_abs_err=err, bound_ms=bound_ms, bound_by=by,
                    **nums).items()})
                # decode occupancy: the routing draw of B1's row
                del got, want
                row.update({pre + "occupancy_" + k: v for k, v in
                            quant_occupancy(args, act, out, TOP_K,
                                            f"{kind} x {xdt} out {out}",
                                            card).items()})
                del args
                torch.cuda.empty_cache()
    # DeepSeek-V2's decode occupancy over the streaming path's 240 slots
    dE, dC, dd, df = (DEEPSEEK[k] for k in "ECdf")
    for kind in ("int8", "fp16"):
        args = quant_inputs(gen, dE, dC, dd, df, DEEPSEEK_SLOTS, "swiglu",
                            kind, torch.bfloat16)
        nums = quant_occupancy(
            args, "swiglu", torch.float32, DEEPSEEK_TOP_K,
            f"E={dE} C={dC} d={dd} f={df} n_slots={DEEPSEEK_SLOTS} {kind} x "
            f"bf16 out fp32", card)
        nums["shape"] = (f"E={dE} C={dC} d={dd} f={df} swiglu, "
                         f"{DEEPSEEK_SLOTS} slots, x bf16, out fp32, "
                         f"{TOKENS} tokens x top-{DEEPSEEK_TOP_K}")
        pre = "deepseek_" if kind == "int8" else "deepseek_fp16_"
        row.update({pre + "occupancy_" + k: v for k, v in nums.items()})
        del args
        torch.cuda.empty_cache()
    return dict(name="moe_ffn_quant", route="cuda",
                source="src/repro_torch/kernels/csrc/moe_ffn_quant.cu",
                replaces="src/repro/kernels/moe_ffn.py:177",
                shape=f"E={E} C={C} d={d} f={f} swiglu, {2 * E} slots, x "
                      "bf16, out fp32; int8 unless fp16_", **row)


def check_flash_decode(gen, card):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode

    print("phase 3b: flash_decode kernel vs plain (flash_decode_ref)")
    row, long = None, {}
    for dtype in (torch.bfloat16, torch.float32):
        for B, H, Hkv, hd, S, lens in [(4, 64, 4, 128, 64, [1, 17, 40, 64]),
                                       (2, 8, 2, 64, 300, [300, 7]),
                                       (3, 16, 1, 128, 1000, [1000, 513, 1]),
                                       # Jamba's heads, phase 8's cache
                                       (4, 64, 8, 128, 48, [1, 17, 40, 48]),
                                       (*LONG_CACHE, [32768, 16384, 8192, 1])
                                       ]:
            q = torch.randn((B, H, hd), generator=gen, device="cuda").to(dtype)
            k = torch.randn((B, S, Hkv, hd), generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn((B, S, Hkv, hd), generator=gen,
                            device="cuda").to(dtype)
            cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = flash_decode(q, k, v, cl)
            want = ref.flash_decode_ref(q, k, v, cl)
            torch.cuda.synchronize()
            err = compare(f"B={B} H={H} Hkv={Hkv} hd={hd} S={S} lens={lens} "
                          f"{dtype}", got, want)
            if (B, H, Hkv, hd, S) == LONG_CACHE and dtype == torch.bfloat16:
                long = time_long_cache(q, k, v, cl, err, card)
            if S != 64:
                continue
            ms = time_ms(lambda: flash_decode(q, k, v, cl), 200)
            plain_ms = time_ms(lambda: ref.flash_decode_ref(q, k, v, cl), 50,
                               ahead=False)
            rep = H // Hkv
            kk = k.transpose(1, 2).repeat_interleave(rep, dim=1)
            vv = v.transpose(1, 2).repeat_interleave(rep, dim=1)
            mask = (torch.arange(S, device="cuda")[None, :] < cl[:, None]
                    )[:, None, None, :]
            qq = q[:, :, None, :]
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask), 50)
            n_valid = sum(min(n, S) for n in lens)
            esz = q.element_size()
            nbytes = esz * (2 * q.numel() + 2 * n_valid * Hkv * hd)
            bound_ms, by = bound(nbytes, 4 * H * hd * n_valid, dtype)
            print(f"  time {dtype}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, library (F.scaled_dot_product_attention) "
                  f"{lib_ms:.4f} ms, bound {bound_ms:.6f} ms ({by}) "
                  f"(L2-warm, back-to-back launches) [{card}]")
            if dtype == torch.bfloat16:
                row = dict(name="flash_decode", route="cuda",
                           source="src/repro_torch/kernels/csrc/"
                                  "flash_decode.cu",
                           replaces="src/repro/kernels/flash_decode.py:83",
                           max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)
    row.update(long)
    row["family_shapes"] = check_flash_decode_families(gen, card)
    return row


# B3 at the decode shapes of phases 9-9c: (what, B, H, Hkv, hd, S, per-row
# lengths, softcap). Gemma-2's local layers hold a ring of 4096 positions
# (full once a row passes the window); Whisper's cross-attention reads its
# 1500 encoder positions in every row; Qwen2-VL's rows at phase 9b's
# prompt lengths.
B3_FAMILY_SHAPES = [
    ("gemma2 ring-full", 4, 8, 4, 256, 4096, [4096] * 4, 50.0),
    ("gemma2 ragged", 4, 8, 4, 256, 4096, [4096, 1, 2500, 17], 50.0),
    ("whisper cross", 4, 12, 12, 64, 1500, [1500] * 4, 0.0),
    ("qwen2-vl", 4, 64, 8, 128, 2112, [160, 512, 1024, 2048], 0.0),
]


def check_flash_decode_families(gen, card):
    """Phase 3b at the family shapes, bf16 and fp32 against the plain
    version; bf16 timed. q is scaled so that Gemma's scores reach the
    softcap's bend. -> one dict per shape for B3's row."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode

    out = []
    for what, B, H, Hkv, hd, S, lens, cap in B3_FAMILY_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q = (torch.randn((B, H, hd), generator=gen, device="cuda")
                 * (8.0 if cap else 1.0)).to(dtype)
            k, v = (torch.randn((B, S, Hkv, hd), generator=gen,
                                device="cuda").to(dtype) for _ in "kv")
            cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = flash_decode(q, k, v, cl, cap)
            want = ref.flash_decode_ref(q, k, v, cl, cap)
            torch.cuda.synchronize()
            err = compare(f"{what}: B={B} H={H} Hkv={Hkv} hd={hd} S={S} "
                          f"lens={lens} softcap={cap:g} {dtype}", got, want)
            if dtype == torch.bfloat16:
                t = _time_b3(q, k, v, cl, cap)
                print(f"  time {what} {dtype}: {_b3_line(t)} [{card}]")
                out.append(dict(shape=f"{what}: B={B} H={H} Hkv={Hkv} "
                                      f"hd={hd} S={S} lens={lens} softcap="
                                      f"{cap:g} bf16", max_abs_err=err,
                                **{key: t[key] for key in (
                                    "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}))
            del q, k, v, got, want
    torch.cuda.empty_cache()
    return out


def _time_b3(q, k, v, cl, cap=0.0):
    """B3's time, its plain version's, the library call's (SDPA over the
    same length mask; None under a softcap, which SDPA has not) and the
    bound from the valid K/V prefix. -> dict."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd_mod
    from repro_torch.kernels import ref

    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n_split, split_len = fd_mod.splits(B, Hkv, H // Hkv, S, n_sm)
    ms = time_ms(lambda: fd_mod.flash_decode(q, k, v, cl, cap), 100)
    plain_ms = time_ms(lambda: ref.flash_decode_ref(q, k, v, cl, cap), 3,
                       ahead=False)
    lib_ms = None
    if not cap:
        mask = (torch.arange(S, device="cuda")[None, :] < cl[:, None]
                )[:, None, None, :]
        qq, kk, vv = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask, enable_gqa=True), 10)
    n_valid = sum(min(int(n), S) for n in cl.tolist())
    esz = q.element_size()
    kv_bytes = 2 * n_valid * Hkv * hd * esz
    bound_ms, by = bound(esz * 2 * q.numel() + kv_bytes,
                         4 * H * hd * n_valid, q.dtype)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by, splits=n_split,
                split_len=split_len, kv_bytes=kv_bytes)


def _b3_line(t):
    lib = ("none (softcap: F.scaled_dot_product_attention has none)"
           if t["library_ms"] is None else
           f"{t['library_ms']:.4f} ms (F.scaled_dot_product_attention, "
           "enable_gqa)")
    return (f"{t['splits']} splits of {t['split_len']} positions, "
            f"{t['kv_bytes']} B of valid K/V: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library {lib}, bound "
            f"{t['bound_ms']:.6f} ms ({t['bound_by']}), roofline "
            f"{t['bound_ms'] / t['ms']:.1%}")


def time_long_cache(q, k, v, cl, err, card):
    """B3 over a cache larger than L2, split across blocks. -> the
    ``long_*`` keys of B3's row."""
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    t = _time_b3(q, k, v, cl)
    print(f"  time long cache {q.dtype}: {_b3_line(t)} [{card}]")
    return dict(long_shape=f"B={B} H={H} Hkv={Hkv} hd={hd} S={S} lens="
                           f"{cl.tolist()} bf16", long_max_abs_err=err,
                long_ms=t["ms"], long_plain_ms=t["plain_ms"],
                long_bound_ms=t["bound_ms"], long_bound_by=t["bound_by"],
                long_library_ms=t["library_ms"])


def check_wkv6(gen, card):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv6 import wkv6

    print("phase 3d: wkv6 kernel vs plain (wkv6_ref)")
    f32, bf16 = torch.float32, torch.bfloat16
    row, prefill = None, {}
    for BH, T, hd, dtype, w_dtype, what in [
            (256, 1, 64, bf16, f32, "decode"),        # 4 rows x 64 heads
            # one prompt of each of phase 6's lengths, 512 last (the row's
            # prefill_* keys)
            *((64, T, 64, bf16, f32, "prefill") for T in RWKV_PROMPTS),
            (256, 1, 64, f32, f32, ""), (64, 512, 64, f32, f32, ""),
            (3, 37, 32, f32, f32, ""), (3, 37, 32, bf16, f32, ""),
            (3, 37, 32, bf16, bf16, "")]:
        def rnd(shape, std, dt=f32):
            return (torch.randn(shape, generator=gen, device="cuda")
                    * std).to(dt)
        r, k, v = (rnd((BH, T, hd), 0.5, dtype) for _ in range(3))
        w = torch.sigmoid(rnd((BH, T, hd), 1.0)).to(w_dtype)
        u, s0 = rnd((BH, hd), 0.1), rnd((BH, hd, hd), 0.1)
        args = (r, k, v, w, u, s0)
        o, sN = wkv6(*args)
        o_ref, sN_ref = ref.wkv6_ref(*args)
        torch.cuda.synchronize()
        name = f"BH={BH} T={T} hd={hd} r/k/v {dtype} w {w_dtype}"
        err = compare(f"{name} o", o, o_ref, WKV_TOL)
        compare(f"{name} sN", sN, sN_ref, WKV_TOL)
        if not what:
            continue
        nums = dict(max_abs_err=err, **time_wkv6(args, o, sN))
        print(f"  time {what} BH={BH} T={T}: kernel {nums['ms']:.4f} ms, "
              f"plain {nums['plain_ms']:.4f} ms, library none (no single "
              f"PyTorch call computes the recurrence), bound "
              f"{nums['bound_ms']:.6f} ms ({nums['bound_by']}), roofline "
              f"{nums['bound_ms'] / nums['ms']:.1%} (L2-warm, back-to-back "
              f"launches) [{card}]")
        if what == "decode":
            row = dict(name="wkv6", route="cuda",
                       source="src/repro_torch/kernels/csrc/wkv6.cu",
                       replaces="src/repro/kernels/wkv6.py:63", **nums,
                       shape=f"BH={BH} T={T} hd={hd} r/k/v bf16 w fp32",
                       library_note="no single PyTorch call computes the "
                                    "recurrence")
        else:
            prefill[T] = {key: val for key, val in nums.items()
                          if key in ("ms", "plain_ms", "bound_ms",
                                     "bound_by")}
    row.update({f"prefill_{key}": val for key, val in prefill[512].items()})
    row["prefill_by_T"] = prefill
    return row


def time_wkv6(args, o, sN, plain=True):
    """B4's kernel and plain times and its bound on these inputs.
    -> dict(ms, plain_ms, bound_ms, bound_by, library_ms=None)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv6 import wkv6
    BH, T, hd = args[0].shape
    nums = dict(ms=time_ms(lambda: wkv6(*args), 200 if T == 1 else 20))
    if plain:
        nums["plain_ms"] = time_ms(lambda: ref.wkv6_ref(*args),
                                   50 if T == 1 else 3, ahead=False)
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + o.numel() * o.element_size() + sN.numel() * 4)
    # per step and row: hd*hd state elements, each k*v (1), w*S + a (2) and
    # its share of r^T S (2); the bonus (r*u*k)^T v is O(hd)
    nums["bound_ms"], nums["bound_by"] = bound(
        nbytes, 5 * BH * T * hd * (hd + 1), "torch.float32")
    nums["library_ms"] = None
    return nums


# phases 4, 4b, 7, 7b, 8 and 8b serve this request mix through the launcher
SERVE_FLAGS = ["--device", "cuda", "--requests", "4", "--prompt-len", "32",
               "--max-new", "16", "--slots", "4"]


def served_scan_lengths():
    """The B = 1 scan lengths phase 8 runs: the launcher's prompt lengths
    for SERVE_FLAGS and its EAMC warm-up sequences (prompt-len + 4)."""
    from repro_torch.launch import serve as serve_mod
    args = serve_mod.parse_args(SERVE_FLAGS)
    return sorted({n for n, _ in serve_mod.request_shapes(args)}
                  | {args.prompt_len + 4})


def scan_inputs(gen, B, T, D, N, dtype):
    """B5's operands as a Mamba layer makes them: x/B/C N(0, 1) in
    ``dtype``, dt = softplus(N(0, 1)) fp32, A = -(1..N) per channel fp32,
    h0 N(0, 0.5^2) fp32."""
    import torch
    f32 = torch.float32

    def rnd(shape, std=1.0, dt=f32):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).to(dt)
    dt = torch.nn.functional.softplus(rnd((B, T, D)))
    A = -torch.arange(1, N + 1, dtype=f32,
                      device="cuda").expand(D, N).contiguous()
    return (rnd((B, T, D), dt=dtype), dt, A, rnd((B, T, N), dt=dtype),
            rnd((B, T, N), dt=dtype), rnd((B, D, N), 0.5))


# B5's decode timing with a cold L2: distinct input sets rotated so that
# each launch finds its set evicted (> the H100's 50 MB of L2)
SCAN_COLD_SETS = 16


def check_selective_scan(gen, card):
    """Phase 3e: B5 against ``selective_scan_ref`` at Jamba's decode shape
    (a pool of 4, d_in 16384, N 16), at B = 1 for each of phase 8's prompt
    lengths and its warm-up length, at B = 1 over 256 (the reference's
    chunk) and 2048 steps, and at ragged shapes; bf16 and fp32 inputs.
    -> B5's row (decode; ``prefill_*`` at the longest served prompt)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.selective_scan import selective_scan

    print("phase 3e: selective_scan kernel vs plain (selective_scan_ref)")
    f32, bf16 = torch.float32, torch.bfloat16
    d_in, N = 2 * 8192, 16
    cases = [(4, 1, d_in, N, bf16, "decode")]
    cases += [(1, T, d_in, N, bf16, "prefill")
              for T in served_scan_lengths()]
    cases += [(1, T, d_in, N, bf16, "long") for T in (256, 2048)]
    cases += [(4, 1, d_in, N, f32, ""), (1, 32, d_in, N, f32, ""),
              (3, 7, 1000, 16, bf16, ""), (3, 7, 1000, 16, f32, ""),
              (1, 300, 1000, 16, bf16, ""), (1, 300, 1000, 16, f32, ""),
              (2, 1, 100, 8, f32, ""), (1, 33, 70, 16, bf16, "")]
    exp_rate, exp_note = sfu_exp_rate()
    row, by_T = None, {"prefill": {}, "long": {}}
    for B, T, D, N_, dtype, what in cases:
        args = scan_inputs(gen, B, T, D, N_, dtype)
        y, hT = selective_scan(*args)
        y_ref, hT_ref = ref.selective_scan_ref(*args)
        torch.cuda.synchronize()
        name = f"B={B} T={T} d_in={D} N={N_} x/B/C {dtype}"
        err = compare(f"{name} y", y, y_ref, SCAN_TOL)
        err = max(err, compare(f"{name} h_T", hT, hT_ref, SCAN_TOL))
        del y, hT, y_ref, hT_ref
        if not what:
            continue
        nums = dict(max_abs_err=err, **time_scan(args))
        exp_ms = B * T * D * N_ / exp_rate * 1e3   # printed, not in the row
        print(f"  time {what} B={B} T={T}: kernel {nums['ms']:.4f} ms, "
              f"plain {nums['plain_ms']:.4f} ms, library none (no single "
              f"PyTorch call computes the scan), bound "
              f"{nums['bound_ms']:.6f} ms ({nums['bound_by']}), roofline "
              f"{nums['bound_ms'] / nums['ms']:.1%} (L2-warm, back-to-back "
              f"launches); exps alone on the SFUs {exp_ms:.6f} ms "
              f"({B * T * D * N_} {exp_note}) [{card}]")
        if what == "decode":
            nums["ms_l2_cold"] = time_scan_cold(gen, B, T, D, N_, dtype)
            print(f"  time decode B={B} T={T} with a cold L2: kernel "
                  f"{nums['ms_l2_cold']:.4f} ms against {nums['ms']:.4f} ms "
                  f"L2-warm; roofline {nums['bound_ms'] / nums['ms_l2_cold']:.1%}"
                  f" ({SCAN_COLD_SETS} input sets in turn) [{card}]")
            row = dict(name="selective_scan", route="cuda",
                       source="src/repro_torch/kernels/csrc/"
                              "selective_scan.cu",
                       replaces="src/repro/models/mamba.py:65", **nums,
                       replaces_note="no Pallas kernel: the reference's "
                                     "lax.scan _scan_chunk (:65-75) over "
                                     "_ssm_params (:52-62), and mamba_decode's"
                                     " step (:112-127)",
                       shape=f"B={B} T={T} d_in={D} N={N_} x/B/C bf16, "
                             "dt/A/h fp32",
                       library_note="no single PyTorch call computes the "
                                    "scan")
        else:
            by_T[what][T] = {key: val for key, val in nums.items()
                             if key in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")}
    prefill = by_T["prefill"]
    longest = max(prefill)
    row.update({f"prefill_{key}": val
                for key, val in prefill[longest].items()})
    row["prefill_T"] = longest
    row["prefill_by_T"] = prefill
    row["long_by_T"] = by_T["long"]
    return row


def sfu_exp_rate():
    """fp32 exps a second on the special-function units: 16 a clock on
    each SM at the card's maximum SM clock (nvidia-smi's clocks.max.sm).
    -> (rate, how it was made)."""
    import torch
    mhz = float(sh(["nvidia-smi", "--query-gpu=clocks.max.sm",
                    "--format=csv,noheader,nounits"]).splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (16 * sms * mhz * 1e6,
            f"exps at 16/clock x {sms} SMs x {mhz:.0f} MHz; not in the bound")


def time_scan(args):
    """B5's kernel and plain times and its bound on these inputs.
    -> dict(ms, plain_ms, bound_ms, bound_by, library_ms=None)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.selective_scan import selective_scan
    T = args[0].shape[1]
    nums = dict(ms=time_ms(lambda: selective_scan(*args),
                           200 if T < 1024 else 20),
                plain_ms=time_ms(lambda: ref.selective_scan_ref(*args),
                                 20 if T == 1 else 5 if T < 1024 else 1,
                                 ahead=False))
    nums["bound_ms"], nums["bound_by"] = scan_bound(args)
    nums["library_ms"] = None
    return nums


def scan_bound(args):
    """B5's bound on these inputs: inputs read once (x, B, C in their
    dtype; dt, A, h0 fp32), y and h_T written once (fp32); per state
    element and step 7 fp32 operations (dt*A, exp, dA*h, + dBx, dx*B, h*C,
    + y) and dt*x per channel. -> (ms, by)."""
    x, h0, N = args[0], args[5], args[2].shape[-1]
    B, T, D = x.shape
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + 4 * B * T * D + 4 * h0.numel())
    return bound(nbytes, B * T * D * (7 * N + 1), "torch.float32")


def time_scan_cold(gen, B, T, D, N, dtype):
    """B5's ms per launch over ``SCAN_COLD_SETS`` distinct input sets taken
    in turn, so each launch finds its state, A and rows out of L2, as a
    served step does (a layer's state is touched once a step, with the
    other layers' weights read in between)."""
    import itertools
    from repro_torch.kernels.selective_scan import selective_scan
    sets = [scan_inputs(gen, B, T, D, N, dtype)
            for _ in range(SCAN_COLD_SETS)]
    nbytes = sum(t.numel() * t.element_size() for s in sets for t in s)
    if nbytes <= 50e6:
        raise SystemExit(f"time_scan_cold: {nbytes} B of inputs fit in L2")
    turn = itertools.cycle(sets)
    return time_ms(lambda: selective_scan(*next(turn)), 10 * len(sets))


def _check_budgets(out, cfg):
    for r in out["requests"]:
        got = len(out["tokens"][r.rid])
        if got != r.max_new_tokens:
            raise SystemExit(f"request {r.rid}: {got} tokens, budget "
                             f"{r.max_new_tokens}")
        if not all(0 <= t < cfg.vocab for t in out["tokens"][r.rid]):
            raise SystemExit(f"request {r.rid}: token out of vocabulary")


def _steps(srv, what, card):
    import numpy as np
    steps = np.asarray(srv.decode_ms)
    print(f"  decode step {what} (pool of {srv.n_slots}, CUDA events): mean "
          f"{steps.mean():.3f} ms, median {np.median(steps):.3f} ms, min "
          f"{steps.min():.3f} ms over {len(steps)} steps [{card}]")
    return steps


QWEN3, DEEPSEEK_V2 = "qwen3-moe-235b-a22b", "deepseek-v2-236b"
JAMBA = "jamba-1.5-large-398b"
# the smallest cut of Jamba that holds every block kind: (mamba, dense),
# (mamba, MoE), (mamba, dense), (mamba, MoE), (attn, dense)
DEPTH = {QWEN3: 4, DEEPSEEK_V2: 4, JAMBA: 5}


def _full_cfg(what, arch=QWEN3, depth=None):
    """``arch`` at every published width, its depth cut to ``depth``
    (default ``DEPTH``)."""
    from repro_torch.configs import get_config
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=depth or DEPTH[arch])
    m, mla = cfg.moe, cfg.attn.mla
    attn = (f"heads {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim_}"
            if mla is None else
            f"{cfg.n_heads} heads, MLA q_lora {mla.q_lora_rank} kv_lora "
            f"{mla.kv_lora_rank} qk {mla.qk_nope_head_dim} + "
            f"{mla.qk_rope_head_dim} v {mla.v_head_dim}")
    extra = ""
    if m.n_shared_experts:
        extra += (f" + {m.n_shared_experts} shared x "
                  f"{m.d_shared or m.d_expert}")
    if m.first_dense_layers:
        extra += (f", first {m.first_dense_layers} layer(s) dense d_ff "
                  f"{cfg.d_ff}")
    if cfg.mamba is not None:
        mb = cfg.mamba
        extra += (f", mamba d_state {mb.d_state} d_conv {mb.d_conv} expand "
                  f"{mb.expand} (d_in {mb.expand * cfg.d_model}, dt_rank "
                  f"{mb.dt_rank or -(-cfg.d_model // 16)}), attention every "
                  f"{cfg.attn_layer_period} at offset {cfg.attn_layer_offset}"
                  f", MoE every {m.moe_layer_period}, dense d_ff {cfg.d_ff}")
    print(f"{what}, {cfg.name} at full width (d_model {cfg.d_model}, {attn}, "
          f"{m.n_experts} experts top-{m.top_k}, d_expert {m.d_expert}"
          f"{extra}, vocab {cfg.vocab}"
          f"{'' if cfg.tie_embeddings else ' (head not tied)'}, "
          f"{cfg.dtype}); depth cut {full.n_layers} -> {cfg.n_layers} layers"
          f": {_layer_kinds(cfg)}")
    return cfg


def _layer_kinds(cfg):
    return ", ".join(f"({cfg.block_kind(i)}, "
                     f"{'MoE' if cfg.is_moe_layer(i) else 'dense'})"
                     for i in range(cfg.n_layers))


def _reset_counts():
    from repro_torch.kernels import flash_decode as fd_mod
    from repro_torch.kernels import moe_ffn as moe_mod
    from repro_torch.kernels import selective_scan as scan_mod
    from repro_torch.kernels import wkv6 as wkv_mod
    moe_mod.launches = moe_mod.quant_launches = fd_mod.launches = 0
    wkv_mod.launches = scan_mod.launches = 0


def _counts():
    from repro_torch.kernels import flash_decode as fd_mod
    from repro_torch.kernels import moe_ffn as moe_mod
    from repro_torch.kernels import selective_scan as scan_mod
    from repro_torch.kernels import wkv6 as wkv_mod
    return {"moe_ffn": moe_mod.launches,
            "moe_ffn_quant": moe_mod.quant_launches,
            "flash_decode": fd_mod.launches,
            "wkv6": wkv_mod.launches,
            "selective_scan": scan_mod.launches}


def _b3_per_step(cfg):
    """B3 launches a decode step makes: one per GQA attention layer (two in
    an encoder-decoder: self and cross), none for MLA (its decode is tensor
    ops over the latent cache) or for Mamba layers."""
    from repro_torch.config import BLOCK_ATTN
    if cfg.attn.mla is not None:
        return 0
    n = sum(cfg.block_kind(i) == BLOCK_ATTN for i in range(cfg.n_layers))
    return 2 * n if cfg.is_encoder_decoder else n


def _n_mamba(cfg):
    from repro_torch.config import BLOCK_MAMBA
    return sum(cfg.block_kind(i) == BLOCK_MAMBA for i in range(cfg.n_layers))


def frozen_rows_step(step, caches, pos, n_slots):
    """Run ``step(active)`` (one more pooled decode step) with every other
    row inactive and check that the inactive rows of every layer cache
    (K/V or latents, mamba conv/ssm) and their positions stay bit-frozen.
    ``caches``/``pos``: callables returning the live per-layer cache dicts
    and the (n_slots,) positions. -> a line for the log."""
    import numpy as np
    import torch
    active = torch.tensor([i % 2 == 0 for i in range(n_slots)],
                          device="cuda")
    idle = ~active
    before = [{k: v[idle].clone() for k, v in layer.items()}
              for layer in caches()]
    pos0 = np.asarray(pos()).copy()
    step(active)
    torch.cuda.synchronize()
    for layer, old in zip(caches(), before):
        for key, val in old.items():
            if not torch.equal(layer[key][idle], val):
                raise SystemExit(f"an inactive row's {key} changed")
    rows = idle.cpu().numpy()
    if not np.array_equal(np.asarray(pos())[rows], pos0[rows]):
        raise SystemExit("an inactive row's position moved")
    keys = sorted({k for layer in before for k in layer})
    return (f"inactive rows {np.flatnonzero(rows).tolist()}: {', '.join(keys)}"
            " and positions bit-frozen")


def weight_floor(model, counts):
    """The least HBM bytes a pooled decode step reads: every weight but the
    embedding table (a step reads its B rows) and the routed experts, plus
    the step's distinct routed experts (from its (n_moe, B, E) counts).
    -> (bytes, the non-expert bytes, distinct experts, one expert's
    bytes)."""
    names = {f"layers.{i}.moe.{k}" for i in model.moe_layers
             for k in ("w_gate", "w_up", "w_down")}
    params = dict(model.named_parameters())
    dense = sum(p.numel() * p.element_size() for n, p in params.items()
                if n != "embed" and n not in names)
    moe = model.layers[model.moe_layers[0]].moe
    one = sum(getattr(moe, k)[0].numel() * getattr(moe, k).element_size()
              for k in ("w_gate", "w_up", "w_down") if hasattr(moe, k))
    distinct = int((counts.sum(dim=1) > 0).sum())
    return dense + distinct * one, dense, distinct, one


# -- the linter's host-sync verdicts held against the card (4, 4b, 13) ------

_LINT = {}


def lint_verdicts():
    """The port's linter over ``src/repro_torch``, run once in this process
    (it imports only the standard library and reads only the AST). ->
    {"graph": its device-boundary graph, "suppressed": {(path, line):
    rule} of the host-sync and capture-hazard findings that ``torch-lint``
    directives suppress, "predicted": {(path, line)} of the syncs it finds
    inside ``Model.serve_step``'s capture}."""
    if not _LINT:
        from repro_torch.analysis.lint import run_lint
        # a path relative to the root: the linter skips any file with a
        # hidden directory among its path's parts, the root's own included
        with contextlib.chdir(ROOT):
            res = run_lint([Path("src/repro_torch")], root=ROOT)
        if res.n_files == 0:
            raise SystemExit("the port's linter found no file to lint")
        if res.new_findings:
            raise SystemExit("the port's linter has new findings:\n" +
                             "\n".join(f.format() for f in res.new_findings))
        sup = [f for f in res.suppressed
               if f["rule"] in ("host-sync", "capture-hazard")]
        _LINT.update(
            graph=res.graph,
            suppressed={(f["path"], f["line"]): f["rule"] for f in sup},
            predicted={(f["path"], f["line"]) for f in sup
                       if f["rule"] == "capture-hazard"
                       and "Model.serve_step" in f["message"]
                       and "closure variable" not in f["message"]})
    return _LINT


@contextlib.contextmanager
def synced_sites():
    """Run the body under ``torch.cuda.set_sync_debug_mode("warn")`` and
    yield the list it fills with (path, line, function) of every sync the
    card reports: the innermost frame under ``src/repro_torch`` of the
    stack that raised the warning (the warning's own location can be
    inside torch). The mode is set back to 0 on the way out, and an error
    in the body propagates."""
    import traceback
    import warnings

    import torch
    port = (ROOT / "src" / "repro_torch").resolve()
    sites = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            shown(message, category, filename, lineno, file, line)
            return
        for frame in reversed(traceback.extract_stack()[:-1]):
            path = Path(frame.filename).resolve()
            if path.is_relative_to(port):
                sites.append((path.relative_to(ROOT.resolve()).as_posix(),
                              frame.lineno, frame.name))
                return
        sites.append((filename, lineno, "<outside src/repro_torch>"))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning
        warnings.showwarning = hook
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode(0)


def held_syncs(what, sites):
    """Print the syncs of one step by site, each with the linter's verdict,
    and fail unless every one lies in a declared fence or on a suppressed
    line."""
    from repro_torch.analysis.rules.host_sync import site_verdict
    lint = lint_verdicts()
    parts, bad = [], []
    for (path, line, name), n in sorted(collections.Counter(sites).items()):
        verdict = site_verdict(lint["graph"], path, line)
        if verdict is not None:
            verdict = verdict.split(":")[0]
        elif (path, line) in lint["suppressed"]:
            verdict = f"suppressed {lint['suppressed'][(path, line)]}"
        else:
            bad.append(f"{path}:{line} ({name})")
        parts.append(f"{path.removeprefix('src/repro_torch/')}:{line} "
                     f"{name} x{n} [{verdict or 'NOT A FENCE'}]")
    print(f"  {what}: {len(sites)} syncs at {len(parts)} sites"
          + (": " + "; ".join(parts) if parts else ""))
    if bad:
        raise SystemExit(f"{what}: syncs outside every declared fence and "
                         f"suppressed line: {', '.join(bad)}")


def sync_check(srv, what, serve_step=None):
    """One more warmed decode step of the server, every row active, under
    the sync debug mode, held against the linter's fences; with
    ``serve_step`` (a no-argument callable running ``Model.serve_step``
    over the server's pool) also that step alone, which must sync only
    where the linter predicts."""
    import numpy as np
    import torch
    lint = lint_verdicts()
    with torch.inference_mode(), synced_sites() as sites:
        srv._decode(np.ones(srv.n_slots, bool))
    held_syncs(f"{what}: one more server decode step under "
               "set_sync_debug_mode('warn')", sites)
    if serve_step is None:
        return
    with torch.inference_mode(), synced_sites() as alone:
        serve_step()
    held_syncs("Model.serve_step alone under the same mode", alone)
    predicted = sorted(lint["predicted"])
    stray = sorted({(p, ln) for p, ln, _ in alone} - lint["predicted"])
    print(f"  the linter predicts {len(predicted)} sync sites inside "
          f"Model.serve_step's capture"
          + (f" ({', '.join(f'{p}:{ln}' for p, ln in predicted)})"
             if predicted else "") + f"; the card reports {len(alone)}")
    if stray:
        raise SystemExit("Model.serve_step synced where the linter predicts "
                         "no sync: " + ", ".join(f"{p}:{ln}"
                                                 for p, ln in stray))


def lint_phase():
    """Phase 13: the port's linter as CI runs it, in a subprocess on the
    card's host."""
    out = ROOT / "experiments" / "lint_torch"
    out.mkdir(parents=True, exist_ok=True)
    report, cmap = out / "report.json", out / "capture_map.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", "--json",
         str(report), "--capture-map", str(cmap), "src/repro_torch"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"phase 13: the linter exited {proc.returncode}:\n"
                         f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    doc = json.loads(report.read_text())
    s, graph = doc["summary"], json.loads(cmap.read_text())
    if s["files"] == 0 or s["new"] != 0 or s["baselined"] != 0:
        raise SystemExit(f"phase 13: {s['files']} files, {s['new']} new, "
                         f"{s['baselined']} baselined findings")
    by_rule = collections.Counter(f["rule"] for f in doc["suppressed"])
    print(f"phase 13: python -m repro_torch.analysis.lint over "
          f"src/repro_torch in a subprocess: exit 0 in {secs:.1f} s; "
          f"{s['files']} files; rules {', '.join(sorted(doc['rules']))}; "
          f"{s['new']} new, {s['baselined']} baselined, {s['suppressed']} "
          f"suppressed by torch-lint directives ("
          + ", ".join(f"{r} {n}" for r, n in sorted(by_rule.items()))
          + f"); {s['declared_fences']} declared fences; "
          f"{s['step_entries']} step entries reaching "
          f"{len(graph['step_reachable'])} functions; "
          f"{len(graph['kernel_launch_sites'])} kernel launch sites; capture "
          f"map in experiments/lint_torch/capture_map.json")


def main_path(card, arch=QWEN3,
              what="phase 4: main path, every expert resident",
              check_syncs=False):
    import numpy as np
    import torch
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import Model

    cfg = _full_cfg(what, arch)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  init: {n_params / 1e9:.2f}e9 params, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card, "
          f"{time.perf_counter() - t0:.1f} s")
    args = serve_mod.parse_args(SERVE_FLAGS)
    _reset_counts()
    t0 = time.perf_counter()
    out = serve_mod.serve(args, cfg, model)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    srv = out["server"]
    n_moe, n_b3 = len(model.moe_layers), _b3_per_step(cfg)
    n_mamba = _n_mamba(cfg)
    _check_budgets(out, cfg)
    calls = out["n_warmup"] + srv.n_prefills + srv.n_decode_steps
    want = {"moe_ffn": n_moe * calls, "moe_ffn_quant": 0,
            "flash_decode": n_b3 * srv.n_decode_steps, "wkv6": 0,
            "selective_scan": n_mamba * calls}
    print(f"  launches: moe_ffn {launches['moe_ffn']} (expected {n_moe} MoE "
          f"layers x ({out['n_warmup']} warm-up forwards + {srv.n_prefills} "
          f"prefills + {srv.n_decode_steps} decode steps) = "
          f"{want['moe_ffn']}); flash_decode {launches['flash_decode']} "
          f"(expected {n_b3} attention layers x {srv.n_decode_steps} decode "
          f"steps = {want['flash_decode']}); selective_scan "
          f"{launches['selective_scan']} (expected {n_mamba} mamba layers x "
          f"{calls} = {want['selective_scan']}); moe_ffn_quant "
          f"{launches['moe_ffn_quant']} (expected 0); serve wall "
          f"{wall:.1f} s")
    if launches != want:
        raise SystemExit("launch counts differ from the main path's calls")
    steps = _steps(srv, "all-resident", card)
    # one more pooled step over the server's cache (every row active): the
    # host's enqueue of it (no sync inside) and what the device does in it
    with torch.inference_mode():
        tok = torch.zeros(srv.n_slots, dtype=torch.long, device="cuda")
        act = torch.ones(srv.n_slots, dtype=torch.bool, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, aux = model.serve_step(srv._cache, tok, active=act)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        busy_ms, n_kernels, n_ops, top, _ = profile_step(
            lambda: model.serve_step(srv._cache, tok, active=act))
    print(f"  one more decode step: host enqueue {enqueue_ms:.3f} ms; "
          f"torch.profiler: {n_ops} top-level aten ops, {n_kernels} device "
          f"kernels/copies, device busy {busy_ms:.3f} ms = "
          f"{busy_ms / float(np.median(steps)):.1%} of the median step "
          f"[{card}]")
    print("  host time by top-level op (profiled, nested ops included): "
          + ", ".join(f"{name} {ms:.3f} ms in {n}" for name, n, ms in top))
    nbytes, dense, distinct, one = weight_floor(model, aux["counts"])
    floor_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  that step's weight-read floor: {floor_ms:.3f} ms ({dense} B "
          f"of weights but the embedding table and the routed experts + "
          f"{distinct} distinct routed experts x {one} B, over 3.35 TB/s) "
          f"[{card}]")
    with torch.inference_mode():
        print("  one more step, every other row active: " + frozen_rows_step(
            lambda act: model.serve_step(srv._cache, tok, active=act),
            lambda: srv._cache["layers"],
            lambda: srv._cache["pos"].cpu().numpy(), srv.n_slots))
    with torch.inference_mode():
        toks = torch.as_tensor(out["requests"][0].prompt[None],
                               dtype=torch.long, device="cuda")
        logits, aux = model.forward({"tokens": toks})
    if logits.shape != (1, toks.shape[1], cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise SystemExit("full-width forward logits are not finite")
    print(f"  full-width forward logits {tuple(logits.shape)} finite")
    if check_syncs:
        sync_check(srv, what.split(":")[0], lambda: model.serve_step(
            srv._cache, tok, active=act))
    tokens = out["tokens"]
    del model, srv, out, logits
    gc.collect()          # the server holds reference cycles
    torch.cuda.empty_cache()
    return launches, tokens


def upload_gbps(stream, expert, reps=10):
    """GB/s of one expert's page-locked host -> device upload (every weight
    of the expert), timed with CUDA events on ``stream``."""
    import torch
    nbytes = sum(t.numel() * t.element_size() for t in expert.values())
    dst = {k: torch.empty(t.shape, dtype=t.dtype, device="cuda")
           for k, t in expert.items()}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.cuda.stream(stream):
        for k, t in expert.items():
            dst[k].copy_(t, non_blocking=True)
        start.record(stream)
        for _ in range(reps):
            for k, t in expert.items():
                dst[k].copy_(t, non_blocking=True)
        end.record(stream)
    end.synchronize()
    if not all(t.is_pinned() for t in expert.values()):
        raise SystemExit("the host store is not page-locked")
    return nbytes * reps / (start.elapsed_time(end) * 1e-3) / 1e9, nbytes


def host_rss():
    """This process's resident host memory in bytes (page-locked included)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise SystemExit("no VmRSS in /proc/self/status")


def tensor_bytes():
    """The bytes the card's live tensors asked for. Not
    ``memory_allocated``, which counts the caching allocator's blocks: it
    may hand a request a cached block up to 1 MiB larger, depending on
    what earlier phases freed. Read as PyTorch's own leak check reads
    memory: Python garbage collected first (a reference cycle keeps a dead
    tensor until the collector runs) and cuBLAS's workspaces dropped (a
    handle takes 32 MiB the first time a thread uses it on a stream, and
    keeps it)."""
    import torch
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def streaming_path(card, arch=QWEN3,
                   what="phase 4b: main path, streaming experts at rf 0.5 "
                        "over the int8 wire", wire="int8", check_syncs=False):
    """The launcher at rf 0.5 over ``wire``: int8 and fp16 take B2, the
    master dtype ("fp32": no wire image, bf16 slot buffers) takes B1
    through the slot table."""
    import numpy as np
    import torch
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import Model

    cfg = _full_cfg(what, arch)
    rss0 = host_rss()
    model = Model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    resident_bytes = tensor_bytes()
    args = serve_mod.parse_args(SERVE_FLAGS + [
        "--resident-fraction", "0.5", "--transfer-dtype", wire])
    _reset_counts()
    t0 = time.perf_counter()
    out = serve_mod.serve(args, cfg, model)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    srv = out["server"]
    st = srv.stats()
    store = srv.slot_runtime.store
    n_moe, n_mamba = len(model.moe_layers), _n_mamba(cfg)
    _check_budgets(out, cfg)
    served = srv.n_prefills + srv.n_decode_steps
    slot_kernel = "moe_ffn" if wire == "fp32" else "moe_ffn_quant"
    want = {"moe_ffn": n_moe * out["n_warmup"], "moe_ffn_quant": 0,
            "flash_decode": _b3_per_step(cfg) * srv.n_decode_steps,
            "wkv6": 0,
            "selective_scan": n_mamba * (out["n_warmup"] + served)}
    want[slot_kernel] += n_moe * served
    print(f"  launches: {slot_kernel} {launches[slot_kernel]} (expected "
          f"{n_moe} MoE layers x ({srv.n_prefills} prefills + "
          f"{srv.n_decode_steps} decode steps through the slot table"
          + (f" + {out['n_warmup']} all-resident EAMC warm-up forwards"
             if wire == "fp32" else "")
          + f") = {want[slot_kernel]})"
          + ("" if wire == "fp32" else
             f"; moe_ffn {launches['moe_ffn']} (expected {n_moe} x "
             f"{out['n_warmup']} all-resident EAMC warm-up forwards = "
             f"{want['moe_ffn']})")
          + f"; flash_decode {launches['flash_decode']} (expected "
          f"{want['flash_decode']}); selective_scan "
          f"{launches['selective_scan']} (expected {want['selective_scan']})"
          f"; moe_ffn_quant {launches['moe_ffn_quant']} (expected "
          f"{want['moe_ffn_quant']}); serve wall {wall:.1f} s")
    if launches != want:
        raise SystemExit("launch counts differ from the streaming path's "
                         "calls")
    n_up = st["demand_uploads"] + st["prefetch_uploads"]
    print(f"  slots: {st['weight_slots']} of {n_moe * cfg.moe.n_experts}, "
          f"hits {st['slot_hits']}, misses {st['slot_misses']}, demand "
          f"uploads {st['demand_uploads']}, prefetch uploads "
          f"{st['prefetch_uploads']}, evictions {st['slot_evictions']}, "
          f"uploaded {st['upload_bytes']} B = {n_up} x "
          f"{st['wire_expert_bytes']} B")
    if st["demand_uploads"] <= 0 or st["slot_hits"] <= 0:
        raise SystemExit("the streaming path moved no expert on demand")
    if st["upload_bytes"] != n_up * st["wire_expert_bytes"]:
        raise SystemExit("upload bytes disagree with the upload count")
    # land any staged rows and release staging memory before measuring
    srv.slot_runtime.slot_cache.commit()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    expert_total = n_moe * cfg.moe.n_experts * store.expert_bytes

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    slot_bytes = nbytes(srv.slot_runtime.slot_cache.bufs.values())
    kv_bytes = nbytes(t for bc in srv.slot_runtime.layer_caches
                      for t in bc.values())
    stream_bytes = tensor_bytes()
    print(f"  card memory: {resident_bytes} B all-resident after init, "
          f"{stream_bytes} B streaming after serving; experts "
          f"{expert_total} B, slot buffers {slot_bytes} B, pooled decode "
          f"cache {kv_bytes} B")
    n_total = n_moe * cfg.moe.n_experts
    images = ("no wire images (the wire is the master dtype)"
              if wire == "fp32" else
              f"{n_total} {wire} wire images "
              f"{n_total * store.wire_expert_bytes} B "
              f"({int(store._have.sum())} quantized so far)")
    print(f"  host memory: resident {host_rss()} B after serving ({rss0} B "
          f"before init); page-locked: {n_total} {cfg.dtype} masters "
          f"{expert_total} B, {images}")
    if resident_bytes + kv_bytes - stream_bytes < expert_total - slot_bytes:
        raise SystemExit("the card still holds experts beyond its slots")
    steps = _steps(srv, f"streaming rf 0.5 {wire}", card)
    ups = np.asarray(srv.decode_uploads, dtype=float)
    print("  uploads issued inside each decode step (demand + planned) : "
          "its ms: " + ", ".join(f"{int(n)}: {ms:.1f}"
                                 for n, ms in zip(ups, steps)))
    if ups.std() > 0:
        slope, icpt = np.polyfit(ups, steps, 1)
        print(f"  least squares over {len(steps)} steps: step ms = "
              f"{icpt:.2f} + {slope:.2f} x uploads (r = "
              f"{np.corrcoef(ups, steps)[0, 1]:.4f}) [{card}]")
    toks = srv.prefill_tokens + srv.decode_tokens
    cost = "issue" if wire == "fp32" else f"issue + first-use {wire} " \
        "quantization"
    print(f"  demand stall: {st['demand_stall_s'] * 1e3:.3f} ms over {toks} "
          f"tokens = {st['demand_stall_per_token_s'] * 1e3:.4f} ms/token "
          f"(host time of the misses: {cost}; the overlap schedule waits "
          f"for the copies on the device, inside the step) [{card}]")
    if wire != "fp32":
        from repro_torch.core.slot_cache import quantize_weight
        t0 = time.perf_counter()
        for _ in range(3):
            for w in store.expert(0, 0).values():
                quantize_weight(w, wire)
        print(f"  host {wire} quantization of one expert (first use, torch "
              f"on {torch.get_num_threads()} CPU threads): "
              f"{(time.perf_counter() - t0) / 3 * 1e3:.1f} ms")
    stream = srv.slot_runtime.slot_cache._copy_stream
    uploads = [(f"{cfg.dtype} master", store.expert(0, 0))]
    if wire != "fp32":
        uploads.append((f"{wire} wire", store.wire_expert(0, 0)))
    for name, expert in uploads:
        gbps, size = upload_gbps(stream, expert)
        print(f"  upload of one expert ({name}, {size} B, page-locked, "
              f"copy stream, CUDA events): {gbps:.2f} GB/s = "
              f"{size / gbps / 1e6:.3f} ms [{card}]")
    rt = srv.slot_runtime
    tok = srv._tok.copy()
    readings = stream_step_readings(srv, steps, "D = 1", card)
    print("  one more streaming step, every other row active: "
          + frozen_rows_step(
              lambda act: rt.decode(tok, act.cpu().numpy()),
              lambda: rt.layer_caches, lambda: rt.pos, srv.n_slots))
    if check_syncs:
        sync_check(srv, what.split(":")[0])
    tokens = out["tokens"]
    del model, srv, out, store, stream, rt
    gc.collect()          # frees the card and unlocks the host store
    torch.cuda.empty_cache()
    return launches, tokens, readings


def stream_step_readings(srv, steps, what, card):
    """Three more steps of the streaming runtime, every row active: one to
    upload what the new routes miss, one for the host's time (the runtime
    waits on the device once a MoE layer to read the routing, so this is
    its wall time), one for the device's busy time (torch.profiler).
    -> {"median_ms", "host_ms", "busy_ms"}, the first the served steps'
    median."""
    import numpy as np
    import torch
    rt = srv.slot_runtime
    tok = srv._tok.copy()
    active = np.ones(srv.n_slots, bool)
    rt.decode(tok, active)
    n0 = srv._uploads()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt.decode(tok, active)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    n1 = srv._uploads()
    busy_ms, n_kernels, n_ops, _, copy_ms = profile_step(
        lambda: rt.decode(tok, active))
    median = float(np.median(steps))
    print(f"  {what}: decode step median {median:.3f} ms over {len(steps)} "
          f"served steps; after one step to upload what new routes miss, "
          f"one more: host {host_ms:.3f} ms with {n1 - n0} uploads (it "
          f"waits on the routing once a MoE layer), then torch.profiler: "
          f"{n_ops} top-level aten ops, {n_kernels} device kernels/copies, "
          f"device busy {busy_ms:.3f} ms ({copy_ms:.3f} of it copies, "
          f"{srv._uploads() - n1} uploads among them) [{card}]")
    return {"median_ms": median, "host_ms": host_ms, "busy_ms": busy_ms,
            "copy_ms": copy_ms}


def port_vs_cpu(cfg=None, phase="5"):
    """The whole port on the card (kernels) against the same weights on
    the CPU (plain versions): a reduced config (default: qwen3-moe's),
    fp32; forward logits and counts, then 6 decode steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = cfg or get_config(QWEN3).reduced()
    print(f"phase {phase}: port on the card vs the same weights on the CPU "
          f"({cfg.name}, {cfg.n_layers} layers, fp32)")
    gpu = Model(cfg, device="cuda").init(1)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        lg, ag = gpu.forward({"tokens": toks.cuda()})
        lc, ac = cpu.forward({"tokens": toks})
        err = float((lg.cpu() - lc).abs().max())
        same = bool(torch.equal(ag["counts"].cpu(), ac["counts"]))
        print(f"  forward logits max_abs_err={err:.3e} (limit 1e-3: fp32 "
              f"sums in other orders through {cfg.n_layers} layers), counts "
              f"equal: {same}")
        if err > 1e-3 or not same:
            raise SystemExit("port on the card disagrees with the CPU")
        caches = [m.init_cache(2, 32) for m in (gpu, cpu)]
        outs = [m.prefill({"tokens": toks.to(m.device)}, c)
                for m, c in zip((gpu, cpu), caches)]
        tok = [o[0].argmax(-1) for o in outs]
        for step in range(6):
            outs = [m.serve_step(c, t.to(m.device))
                    for m, c, t in zip((gpu, cpu), caches, tok)]
            tok = [o[0].argmax(-1) for o in outs]
            err = float((outs[0][0].cpu() - outs[1][0]).abs().max())
            if err > 1e-3 or not torch.equal(tok[0].cpu(), tok[1]):
                raise SystemExit(f"decode step {step}: card and CPU differ "
                                 f"(max_abs_err {err:.3e})")
        print(f"  6 decode steps: greedy tokens equal, last max_abs_err="
              f"{err:.3e}")


def streaming_vs_cpu():
    """The streaming server on the card (B1/B2 over slot buffers, uploads
    on the copy stream) against the fused server on the card and against
    the streaming server on the CPU: reduced config, fp32."""
    import copy
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, TorchModelServer

    print("phase 5b: streaming server on the card vs fused on the card and "
          "vs the CPU (qwen3-moe-235b-a22b reduced, fp32)")
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    gpu = Model(cfg, device="cuda").init(2)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab, (3, 9)).astype(np.int32)
    total = len(gpu.moe_layers) * cfg.moe.n_experts

    def serve(model, device, **kw):
        srv = TorchModelServer(
            EngineConfig(arch=cfg, gpu_cache_experts=3, dram_cache_experts=6,
                         **kw), copy.deepcopy(model), cache_len=32,
            device=device)
        return srv.generate(prompts, 6)
    fused, _ = serve(gpu, "cuda")
    every, st = serve(gpu, "cuda", n_weight_slots=total)
    print(f"  {total} slots for {total} experts: tokens equal to the fused "
          f"server: {np.array_equal(every, fused)}, demand uploads "
          f"{st['demand_uploads']}")
    if not np.array_equal(every, fused) or st["demand_uploads"]:
        raise SystemExit("slot path with every expert resident differs "
                         "from the fused path")
    for wire in ("fp32", "fp16", "int8"):
        for fenced in (False, True):
            kw = dict(resident_fraction=0.5, transfer_dtype=wire,
                      fenced_uploads=fenced)
            g_out, g_st = serve(gpu, "cuda", **kw)
            c_out, c_st = serve(cpu, "cpu", **kw)
            same = (np.array_equal(g_out, c_out)
                    and g_st["demand_uploads"] == c_st["demand_uploads"]
                    and g_st["upload_bytes"] == c_st["upload_bytes"])
            print(f"  rf 0.5 {wire} {'fenced' if fenced else 'overlap'}: "
                  f"tokens and uploads equal to the CPU: {same} (demand "
                  f"uploads {g_st['demand_uploads']})")
            if not same or g_st["demand_uploads"] <= 0:
                raise SystemExit("streaming server on the card disagrees "
                                 "with the CPU")


REPORT_LINES = ("req ", "total:", "tiers:", "slots:", "eamc:", "predictor:")


def launcher_report(model, cfg, device, flags):
    """The launcher's report lines for ``model`` (a copy is served: the
    streaming server moves the experts of the model it is given), without
    the ``compiles=`` tail and the wall-clock ``demand-stall=``."""
    import contextlib
    import copy
    import io
    import re
    from repro_torch.launch import serve as serve_mod
    args = serve_mod.parse_args(["--requests", "4", "--seed", "3",
                                 "--device", device, *flags])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_mod.serve(args, cfg, copy.deepcopy(model))
    lines = []
    for line in buf.getvalue().splitlines():
        if line.startswith(REPORT_LINES):
            line = re.sub(r", compiles=.*$", "", line)
            lines.append(re.sub(r"demand-stall=\S+ \(\S+\) ", "", line))
    return lines


def launcher_vs_cpu(cfg, seed):
    """The launcher on the card against the same weights on the CPU,
    all-resident and at rf 0.5 over each wire: every report line equal."""
    from repro_torch.models import Model
    gpu = Model(cfg, device="cuda").init(seed)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    for wire in (None, "fp32", "fp16", "int8"):
        flags = [] if wire is None else ["--resident-fraction", "0.5",
                                         "--transfer-dtype", wire]
        got = launcher_report(gpu, cfg, "cuda", flags)
        want = launcher_report(cpu, cfg, "cpu", flags)
        what = "all-resident" if wire is None else f"rf 0.5 {wire}"
        slots = [ln for ln in got if ln.startswith("slots:")]
        print(f"  launcher {cfg.name} {what}: {len(got)} report lines, equal "
              f"to the CPU's: {got == want}; {slots[0] if slots else ''}")
        if got != want or len(got) != 4 + 5:
            for g, c in zip(got, want):
                if g != c:
                    print(f"    card: {g}\n    cpu:  {c}")
            raise SystemExit(f"launcher {cfg.name} {what}: the card's report "
                             "differs from the CPU's")
        if wire is not None and " demand-uploads=0 " in slots[0]:
            raise SystemExit(f"launcher {cfg.name} {what}: nothing streamed")


def deepseek_vs_cpu():
    """Phase 7c: a reduced DeepSeek-V2 of 1 dense + 2 MoE layers x 8
    experts (enough experts that rf 0.5 streams) and reduced qwen3-moe,
    on the card against the same weights on the CPU, fp32."""
    from repro_torch.configs import get_config
    cfg = get_config(DEEPSEEK_V2).reduced()
    cfg = dataclasses.replace(
        cfg, n_layers=3, moe=dataclasses.replace(cfg.moe, n_experts=8))
    port_vs_cpu(cfg, "7c")
    print("  the launcher (4 requests, seed 3) on the card vs the CPU, "
          "report lines without compiles= and demand-stall=")
    launcher_vs_cpu(cfg, 7)
    launcher_vs_cpu(get_config(QWEN3).reduced(), 8)


def jamba_vs_cpu():
    """Phase 8c: a reduced Jamba whose Mamba layers carry 8 experts
    ((mamba, dense), (mamba, MoE), (attn, dense), (mamba, MoE): the plain
    ``.reduced()`` has no (mamba, MoE) block, and at rf 0.5 its one MoE
    layer of 4 experts stays resident) on the card against the same
    weights on the CPU, fp32: the model, then the launcher all-resident
    and at rf 0.5 over each wire."""
    from repro_torch.configs import get_config
    cfg = get_config(JAMBA).reduced(n_layers=4)
    cfg = dataclasses.replace(
        cfg, attn_layer_period=4, attn_layer_offset=2,
        moe=dataclasses.replace(cfg.moe, n_experts=8))
    port_vs_cpu(cfg, "8c")
    print(f"  layers: {_layer_kinds(cfg)}; the launcher (4 requests, seed "
          "3) on the card vs the CPU, report lines without compiles= and "
          "demand-stall=")
    launcher_vs_cpu(cfg, 9)


def profile_step(fn):
    """Run ``fn`` once under torch.profiler. -> (device busy ms: the summed
    durations of its kernels and copies, their count, the number of
    top-level aten ops dispatched, [(op name, calls, host ms)] of the five
    top-level op names with the most host time, nested ops included, the
    copies' ms within the busy ms). Zeros if the profiler sees no
    device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.name.startswith("aten::") and e.cpu_parent is None]
    by_name = {}
    for e in ops:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    copies = sum(e.time_range.elapsed_us() for e in dev
                 if e.name.startswith("Memcpy"))
    return (sum(e.time_range.elapsed_us() for e in dev) / 1e3, len(dev),
            len(ops), [(name, n, us / 1e3) for name, (n, us) in top],
            copies / 1e3)


RWKV_PROMPTS = (16, 100, 256, 512)     # 512 takes the two-chunk length rule
RWKV_BUDGETS = (16, 9, 12, 4)          # decode steps each pool row is active


def rwkv_path(card):
    """Phase 6: full-width, full-depth rwkv6-7b through prefill, write_slot
    and pooled serve_step, every recurrence in B4."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config("rwkv6-7b")
    print(f"phase 6: {cfg.name} at full width and depth (d_model "
          f"{cfg.d_model}, {cfg.d_model // cfg.rwkv.head_dim} heads x "
          f"{cfg.rwkv.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.n_layers} layers, {cfg.dtype})")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  init: {n_params / 1e9:.3f}e9 params, "
          f"{torch.cuda.memory_allocated()} B on the card, "
          f"{time.perf_counter() - t0:.1f} s")
    B = len(RWKV_PROMPTS)
    rng = np.random.default_rng(6)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    _reset_counts()
    with torch.inference_mode():
        pool = model.init_cache(B, 8)
        tok = torch.zeros(B, dtype=torch.long, device="cuda")
        prefill_ms = []
        for slot, S in enumerate(RWKV_PROMPTS):
            prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S))) \
                .cuda()
            start.record()
            logits, one, _ = model.prefill({"tokens": prompt},
                                           model.init_cache(1, 8))
            end.record()
            end.synchronize()
            prefill_ms.append(start.elapsed_time(end))
            if logits.shape != (1, cfg.vocab) or \
                    not bool(torch.isfinite(logits).all()):
                raise SystemExit(f"prefill of {S} tokens: logits not finite")
            model.write_slot(pool, one, slot)
            tok[slot] = logits[0].argmax()
        steps_ms, enqueue_ms = [], []
        for step in range(max(RWKV_BUDGETS)):
            active = torch.tensor([step < b for b in RWKV_BUDGETS],
                                  device="cuda")
            before = [{k: v.clone() for k, v in layer.items()}
                      for layer in pool["layers"]]
            t0 = time.perf_counter()
            start.record()
            logits, pool, _ = model.serve_step(pool, tok, active=active)
            end.record()
            enqueue_ms.append((time.perf_counter() - t0) * 1e3)
            end.synchronize()
            steps_ms.append(start.elapsed_time(end))
            if not bool(torch.isfinite(logits).all()):
                raise SystemExit(f"decode step {step}: logits not finite")
            idle = ~active
            for old, new in zip(before, pool["layers"]):
                if not all(torch.equal(new[k][idle], old[k][idle])
                           for k in old):
                    raise SystemExit(f"decode step {step}: an inactive "
                                     "row's state/tm/cm changed")
            tok = torch.where(active, logits.argmax(-1), tok)
        torch.cuda.synchronize()
        launches = _counts()
        # one more step with every row inactive (the pool is unchanged)
        # under the profiler: what the device does in a step
        idle_rows = torch.zeros(B, dtype=torch.bool, device="cuda")
        busy_ms, n_kernels, n_ops, _, _ = profile_step(
            lambda: model.serve_step(pool, tok, active=idle_rows))
    n_steps = len(steps_ms)
    want = dict.fromkeys(launches, 0)
    want["wkv6"] = cfg.n_layers * (B + n_steps)
    pos = [int(p) for p in pool["pos"]]
    print(f"  prompts {list(RWKV_PROMPTS)} prefilled at B=1 into a pool of "
          f"{B}; {n_steps} pooled decode steps, budgets "
          f"{list(RWKV_BUDGETS)}; positions {pos}; inactive rows unchanged")
    print(f"  launches: wkv6 {launches['wkv6']} (expected {cfg.n_layers} "
          f"layers x ({B} prefills + {n_steps} decode steps) = "
          f"{want['wkv6']}); others {launches}")
    if launches != want:
        raise SystemExit("launch counts differ from the rwkv path's calls")
    if pos != [S + b for S, b in zip(RWKV_PROMPTS, RWKV_BUDGETS)]:
        raise SystemExit("pool positions differ from prompts + budgets")
    steps = np.asarray(steps_ms)
    weight_bytes = sum(p.numel() * p.element_size()
                       for name, p in model.named_parameters()
                       if name != "embed")
    floor_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    print("  prefill (B=1, CUDA events): " + ", ".join(
        f"{S} tokens {ms:.3f} ms" for S, ms in zip(RWKV_PROMPTS, prefill_ms))
        + f" [{card}]")
    print(f"  decode step (pool of {B}, CUDA events): mean {steps.mean():.3f}"
          f" ms, median {np.median(steps):.3f} ms, min {steps.min():.3f} ms "
          f"over {n_steps} steps; weight-read floor {floor_ms:.3f} ms "
          f"({weight_bytes} B of weights but the embedding table, which a "
          f"step reads {B} rows of, over 3.35 TB/s) [{card}]")
    print(f"  host enqueue of a decode step (perf_counter around the call, "
          f"no sync inside): median {np.median(enqueue_ms):.3f} ms; "
          f"torch.profiler over one more step: {n_ops} top-level aten ops, "
          f"{n_kernels} device kernels/copies, device busy {busy_ms:.3f} ms"
          f" = {busy_ms / np.median(steps):.1%} of the median step [{card}]")
    print(f"  card memory: peak {torch.cuda.max_memory_allocated()} B, pool "
          f"state {sum(t.nbytes for l in pool['layers'] for t in l.values())}"
          f" B")
    del model, pool, before, logits, one
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def rwkv_vs_cpu():
    """Phase 6b: reduced rwkv6-7b in fp32 on the card (B4) against the same
    weights on the CPU (plain version)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    print("phase 6b: rwkv port on the card vs the same weights on the CPU "
          "(rwkv6-7b reduced, fp32)")
    cfg = get_config("rwkv6-7b").reduced()
    gpu = Model(cfg, device="cuda").init(5)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    gen = torch.Generator().manual_seed(1)
    worst = 0.0

    def close(name, got, want):
        nonlocal worst
        err = (got.cpu() - want).abs()
        worst = max(worst, float(err.max()))
        if not bool(torch.all(err <= 1e-4 + 1e-4 * want.abs())):
            raise SystemExit(f"{name}: card and CPU differ (max_abs_err "
                             f"{float(err.max()):.3e})")
    with torch.inference_mode():
        toks = torch.randint(0, cfg.vocab, (2, 37), generator=gen)
        close("forward logits", gpu.forward({"tokens": toks.cuda()})[0],
              cpu.forward({"tokens": toks})[0])
        caches = [m.init_cache(2, 8) for m in (gpu, cpu)]
        first = torch.zeros((2, 2), dtype=torch.long)    # (model, slot)
        for slot, S in enumerate((40, 512)):
            prompt = torch.randint(0, cfg.vocab, (1, S), generator=gen)
            outs = [m.prefill({"tokens": prompt.to(m.device)},
                              m.init_cache(1, 8)) for m in (gpu, cpu)]
            close(f"prefill of {S} logits", outs[0][0], outs[1][0])
            for i, (m, c, o) in enumerate(zip((gpu, cpu), caches, outs)):
                m.write_slot(c, o[1], slot)
                first[i, slot] = int(o[0][0].argmax())
        if not torch.equal(first[0], first[1]):
            raise SystemExit("prefill: greedy tokens differ")
        tok = [first[0], first[1]]
        for step in range(8):
            active = torch.tensor([True, step < 5])
            outs = [m.serve_step(c, t.to(m.device), active=active.to(m.device))
                    for m, c, t in zip((gpu, cpu), caches, tok)]
            close(f"decode step {step} logits", outs[0][0], outs[1][0])
            tok = [torch.where(active.to(o[0].device), o[0].argmax(-1),
                               t.to(o[0].device))
                   for o, t in zip(outs, tok)]
            if not torch.equal(tok[0].cpu(), tok[1]):
                raise SystemExit(f"decode step {step}: greedy tokens differ")
    print(f"  forward, prefill (40 and 512 tokens) and 8 pooled decode steps:"
          f" greedy tokens equal, max_abs_err={worst:.3e} (atol 1e-4, rtol "
          f"1e-4)")


GEMMA2, QWEN2_VL, WHISPER = "gemma2-2b", "qwen2-vl-72b", "whisper-small"
# phases 9-9c: prompts prefilled at B = 1 into a pool of 4, and the decode
# steps each pool row stays active. Gemma's 4080-token row crosses position
# 4096, where its local layers' rings wrap; cache_len 4112 holds it to the
# last step in the global layers.
FAMILY_RUNS = {
    GEMMA2: dict(depth=None, prompts=(16, 512, 2048, 4080),
                 budgets=(32, 20, 26, 32), cache_len=4112),
    QWEN2_VL: dict(depth=4, prompts=(160, 512, 1024, 2048),
                   budgets=(32, 20, 26, 32), cache_len=2112),
    WHISPER: dict(depth=None, prompts=(4, 9, 12, 16),
                  budgets=(16, 10, 13, 16), cache_len=64),
}
VL_GRID = (1, 8, 16)     # Qwen2-VL's stub patch grid (t, h, w): 128 patches
VL_GRID_REDUCED = (1, 2, 3)       # phase 9d's, under its 7-12 position prompts


def family_batch(model, gen, S, B=1, grid=VL_GRID):
    """A seeded prompt of S positions for ``model``'s family: tokens; for
    Qwen2-VL ``embeds`` (a stub patch grid of seeded embeddings, then text
    tokens' embedding rows) with (3, B, S) M-RoPE positions whose t/h/w
    planes differ over the grid and continue from its largest id over the
    text; for Whisper also ``enc_embeds`` (B, 1500, 768) of seeded stub
    frames."""
    import torch
    cfg, dev = model.cfg, model.device
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    if cfg.attn.mrope_sections:
        n = grid[0] * grid[1] * grid[2]
        ids = torch.stack(torch.meshgrid(
            *(torch.arange(m, device=dev) for m in grid),
            indexing="ij")).reshape(3, n)
        text = ids.max() + 1 + torch.arange(S - n, device=dev)
        pos = torch.cat([ids, text.expand(3, S - n)], 1)
        embeds = model.embed[toks]
        embeds[:, :n] = (torch.randn((B, n, cfg.d_model), generator=gen,
                                     device=dev)
                         * cfg.d_model ** -0.5).to(embeds.dtype)
        return {"embeds": embeds,
                "positions": pos[:, None].expand(3, B, S).to(torch.int32)}
    batch = {"tokens": toks}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = torch.randn(
            (B, cfg.encoder_seq_len, cfg.d_model), generator=gen,
            device=dev).to(model.dtype)
    return batch


def _family_cfg(arch, depth):
    from repro_torch.configs import get_config
    full = get_config(arch)
    cfg = full if depth is None else dataclasses.replace(full,
                                                         n_layers=depth)
    a = cfg.attn
    extra = []
    if a.sliding_window:
        extra.append(f"window {a.sliding_window} on every "
                     f"{a.local_global_period}nd layer")
    if a.logit_softcap or cfg.final_logit_softcap:
        extra.append(f"softcaps {a.logit_softcap:g}/"
                     f"{cfg.final_logit_softcap:g}")
    if a.mrope_sections:
        extra.append(f"M-RoPE {a.mrope_sections}")
    if a.qkv_bias:
        extra.append("QKV bias")
    if cfg.is_encoder_decoder:
        extra.append(f"{cfg.n_encoder_layers}-layer encoder over "
                     f"{cfg.encoder_seq_len} frames, cross-attention")
    if not a.use_rope:
        extra.append("learned positions")
    depth_s = (f"all {cfg.n_layers} layers" if depth is None else
               f"depth cut {full.n_layers} -> {cfg.n_layers} layers")
    return cfg, (f"{cfg.name} at full width (d_model {cfg.d_model}, heads "
                 f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim_}, "
                 f"{cfg.act} {cfg.d_ff}, {cfg.norm}, {', '.join(extra)}, "
                 f"vocab {cfg.vocab}, "
                 f"{'tied head' if cfg.tie_embeddings else 'head not tied'}"
                 f", {cfg.dtype}), {depth_s}")


def family_path(card, arch, phase):
    """Phases 9, 9b, 9c: ``arch`` at full width through ``Model``'s
    serving entry points: FAMILY_RUNS' prompts prefilled at B = 1 and
    written into a pool, pooled decode steps under an ``active`` mask that
    retires rows at their budgets; finite logits, inactive rows' caches
    and positions bit-frozen, B3's launches (no other kernel's); prefill
    and step times, host enqueue, one more step profiled."""
    import numpy as np
    import torch
    from repro_torch.models import Model

    run = FAMILY_RUNS[arch]
    cfg, desc = _family_cfg(arch, run["depth"])
    print(f"phase {phase}: {desc}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  init: {n_params / 1e9:.3f}e9 params, "
          f"{torch.cuda.memory_allocated()} B on the card, "
          f"{time.perf_counter() - t0:.1f} s")
    prompts, budgets = run["prompts"], run["budgets"]
    B, L = len(prompts), run["cache_len"]
    gen = torch.Generator(device="cuda").manual_seed(9)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    _reset_counts()
    with torch.inference_mode():
        pool = model.init_cache(B, L)
        tok = torch.zeros(B, dtype=torch.long, device="cuda")
        prefill_ms = []
        for slot, S in enumerate(prompts):
            batch = family_batch(model, gen, S)
            start.record()
            logits, one, _ = model.prefill(batch, model.init_cache(1, L))
            end.record()
            end.synchronize()
            prefill_ms.append(start.elapsed_time(end))
            if logits.shape != (1, cfg.vocab) or \
                    not bool(torch.isfinite(logits).all()):
                raise SystemExit(f"prefill of {S} positions: logits not "
                                 "finite")
            model.write_slot(pool, one, slot)
            tok[slot] = logits[0].argmax()
            del one, batch
        steps_ms, enqueue_ms = [], []
        for step in range(max(budgets)):
            active = torch.tensor([step < b for b in budgets], device="cuda")
            idle = ~active
            before = [{k: v[idle].clone() for k, v in layer.items()}
                      for layer in pool["layers"]]
            pos0 = pool["pos"][idle].clone()
            t0 = time.perf_counter()
            start.record()
            logits, pool, _ = model.serve_step(pool, tok, active=active)
            end.record()
            enqueue_ms.append((time.perf_counter() - t0) * 1e3)
            end.synchronize()
            steps_ms.append(start.elapsed_time(end))
            if not bool(torch.isfinite(logits).all()):
                raise SystemExit(f"decode step {step}: logits not finite")
            for old, new in zip(before, pool["layers"]):
                for key, val in old.items():
                    if not torch.equal(new[key][idle], val):
                        raise SystemExit(f"decode step {step}: an inactive "
                                         f"row's {key} changed")
            if not torch.equal(pool["pos"][idle], pos0):
                raise SystemExit(f"decode step {step}: an inactive row's "
                                 "position moved")
            tok = torch.where(active, logits.argmax(-1), tok)
        torch.cuda.synchronize()
        launches = _counts()
        # one more step with every row inactive (the pool is unchanged)
        # under the profiler: what the device does in a step
        idle_rows = torch.zeros(B, dtype=torch.bool, device="cuda")
        busy_ms, n_kernels, n_ops, top, _ = profile_step(
            lambda: model.serve_step(pool, tok, active=idle_rows))
    n_steps, per_step = len(steps_ms), _b3_per_step(cfg)
    want = dict.fromkeys(launches, 0)
    want["flash_decode"] = per_step * n_steps
    pos = [int(p) for p in pool["pos"]]
    print(f"  prompts {list(prompts)} prefilled at B=1 into a pool of {B} "
          f"(cache_len {L}); {n_steps} pooled decode steps, budgets "
          f"{list(budgets)}; positions {pos}; inactive rows' caches and "
          "positions bit-frozen at every step")
    print(f"  launches: flash_decode {launches['flash_decode']} (expected "
          f"{per_step} a step x {n_steps} steps = {want['flash_decode']});"
          f" others {launches}")
    if launches != want:
        raise SystemExit(f"launch counts differ from the {cfg.name} path's "
                         "calls")
    if pos != [S + b for S, b in zip(prompts, budgets)]:
        raise SystemExit("pool positions differ from prompts + budgets")
    steps = np.asarray(steps_ms)
    head = "embed" if cfg.tie_embeddings else "lm_head"
    weights = sum(p.numel() * p.element_size()
                  for name, p in model.named_parameters()
                  if name.startswith(("layers.", "final_norm.", head)))
    # bytes B3 reads at the last positions: each row's valid self-attention
    # positions (a ring's min(pos, L)), all of the encoder's for cross
    kv = sum(t[0].numel() * t.element_size()
             * (1 if key.startswith("cross") else
                min(int(p), t.shape[1]) / t.shape[1])
             for layer in pool["layers"] for key, t in layer.items()
             for p in pool["pos"])
    floor_ms = (weights + kv) / HBM_BYTES_PER_S * 1e3
    print("  prefill (B=1, CUDA events): " + ", ".join(
        f"{S} positions {ms:.3f} ms" for S, ms in zip(prompts, prefill_ms))
        + f" [{card}]")
    print(f"  decode step (pool of {B}, CUDA events): mean {steps.mean():.3f}"
          f" ms, median {np.median(steps):.3f} ms, min {steps.min():.3f} ms "
          f"over {n_steps} steps; read floor {floor_ms:.3f} ms ({weights} B "
          f"of decoder weights and head + {int(kv)} B of the pool's valid "
          f"K/V at the last positions, over 3.35 TB/s) [{card}]")
    print(f"  host enqueue of a decode step (no sync inside): median "
          f"{np.median(enqueue_ms):.3f} ms; torch.profiler over one more "
          f"step: {n_ops} top-level aten ops, {n_kernels} device kernels/"
          f"copies, device busy {busy_ms:.3f} ms = "
          f"{busy_ms / np.median(steps):.1%} of the median step [{card}]")
    print("  host time by top-level op (profiled, nested ops included): "
          + ", ".join(f"{name} {ms:.3f} ms in {n}" for name, n, ms in top))
    print(f"  card memory: peak {torch.cuda.max_memory_allocated()} B, pool "
          f"{sum(t.nbytes for l in pool['layers'] for t in l.values())} B")
    del model, pool, before, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# phase 9d: (arch, prompts, cache_len, decode steps, steps row 1 stays
# active). Gemma's reduced window is 128: row 0 decodes from 16 to 1.5 x
# window, row 1 is prefilled past the window (a prompt longer than the
# ring) and decodes to the same position.
FAMILY_CPU_RUNS = [(GEMMA2, (16, 150), 200, 176, 42),
                   (QWEN2_VL, (7, 12), 32, 8, 5),
                   (WHISPER, (7, 12), 32, 8, 5)]


def families_vs_cpu():
    """Phase 9d: the three reduced configs in fp32 on the card against the
    same weights on the CPU: forward logits, prefill into a pool of 2 and
    gated greedy decode; equal greedy tokens, logits within fp32 limits."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    for arch, prompts, L, n_steps, row1 in FAMILY_CPU_RUNS:
        cfg = get_config(arch).reduced()
        print(f"phase 9d: {cfg.name} ({cfg.n_layers} layers, fp32) on the "
              "card vs the same weights on the CPU")
        gpu = Model(cfg, device="cuda").init(5)
        cpu = Model(cfg, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        gen = torch.Generator(device="cuda").manual_seed(2)
        worst = 0.0

        def close(name, got, want):
            nonlocal worst
            err = (got.cpu() - want).abs()
            worst = max(worst, float(err.max()))
            if not bool(torch.all(err <= 1e-4 + 1e-4 * want.abs())):
                raise SystemExit(f"{cfg.name} {name}: card and CPU differ "
                                 f"(max_abs_err {float(err.max()):.3e})")

        def on_cpu(batch):
            return {k: v.cpu() for k, v in batch.items()}
        with torch.inference_mode():
            batch = family_batch(gpu, gen, 12, B=2, grid=VL_GRID_REDUCED)
            close("forward logits", gpu.forward(batch)[0],
                  cpu.forward(on_cpu(batch))[0])
            pools = [m.init_cache(2, L) for m in (gpu, cpu)]
            tok = torch.zeros((2, 2), dtype=torch.long)       # (model, row)
            for row, S in enumerate(prompts):
                batch = family_batch(gpu, gen, S, grid=VL_GRID_REDUCED)
                outs = [m.prefill(b, m.init_cache(1, L)) for m, b in
                        ((gpu, batch), (cpu, on_cpu(batch)))]
                close(f"prefill of {S} logits", outs[0][0], outs[1][0])
                for i, (m, pool, o) in enumerate(zip((gpu, cpu), pools,
                                                     outs)):
                    m.write_slot(pool, o[1], row)
                    tok[i, row] = int(o[0][0].argmax())
            if not torch.equal(tok[0], tok[1]):
                raise SystemExit(f"{cfg.name} prefill: greedy tokens differ")
            for step in range(n_steps):
                active = torch.tensor([True, step < row1])
                outs = [m.serve_step(pool, t.to(m.device),
                                     active=active.to(m.device))
                        for m, pool, t in zip((gpu, cpu), pools, tok)]
                close(f"decode step {step} logits", outs[0][0], outs[1][0])
                new = [torch.where(active, o[0].argmax(-1).cpu(), t)
                       for o, t in zip(outs, tok)]
                if not torch.equal(new[0], new[1]):
                    raise SystemExit(f"{cfg.name} decode step {step}: greedy "
                                     "tokens differ")
                tok = torch.stack(new)
        pos = [int(p) for p in pools[0]["pos"]]
        print(f"  forward, prefill ({' and '.join(map(str, prompts))} "
              f"positions) and {n_steps} gated decode steps to positions "
              f"{pos}: greedy tokens equal, max_abs_err={worst:.3e} (atol "
              f"1e-4, rtol 1e-4)")
        if arch == GEMMA2 and min(pos) <= cfg.attn.sliding_window:
            raise SystemExit("phase 9d: the Gemma rows did not cross the "
                             "window")
        del gpu, cpu, pools
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# training: B1 under a gradient (3a), phase 10 (full width), 10b (vs CPU)
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 4, 128     # the train launcher's defaults
TRAIN_STEPS, TIMED_STEPS = 8, 3


# B1's gradients, held per expert normwise (||got_e - want_e|| <= rtol
# ||want_e|| for each expert e): fp32 with the kernel's rtol; bf16 at
# 1.5e-2, between sound readings (3.3e-3-4.1e-3 of the whole tensor at the
# training shape) and a dropped row of xg (~1.4 % of the whole tensor at
# E 128, C 41, ~15 % of its expert's)
GRAD_RTOL = {"torch.float32": TOL["torch.float32"][1],
             "torch.bfloat16": 1.5e-2}


def compare_grad(name, got, want):
    """A gradient (E, ...) against autograd through the plain version, held
    per expert as a whole: an element sums products whose factors are
    rounded to the inputs' dtype, some of them near a zero of the
    activation's derivative, so its error does not scale with its own
    value, which cancellation can make small; a wrong product, row or
    expert moves its expert's norm by far more. An expert whose gradient
    is zero must get exactly zero. -> the worst expert's relative error."""
    import torch
    rtol = GRAD_RTOL[str(want.dtype)]
    g, w = got.float().flatten(1), want.float().flatten(1)
    err = torch.linalg.vector_norm(g - w, dim=1)
    ref_n = torch.linalg.vector_norm(w, dim=1)
    rel = torch.where(ref_n > 0, err / ref_n.clamp_min(1e-30),
                      torch.where(err > 0, float("inf"), 0.0))
    worst = float(rel.max())
    whole = float(torch.linalg.vector_norm(g - w)
                  / torch.linalg.vector_norm(w))
    ok = worst <= rtol and bool(torch.isfinite(g).all())
    print(f"  {name}: per expert ||err||/||want|| <= {worst:.3e} (limit "
          f"{rtol:g}; whole tensor {whole:.3e}), "
          f"max_abs_err={float((g - w).abs().max()):.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: B1's gradient disagrees with autograd "
                         "through the plain version")
    return worst


def routed_xg(gen, E, C, d, top_k, T):
    """xg (E, C, d) as the dispatch fills it for T tokens routed top-k by
    a seeded router: each expert's tokens in token order, the first C
    kept, every other row exactly zero."""
    import torch
    x = torch.randn((T, d), generator=gen, device="cuda")
    w = torch.randn((d, E), generator=gen, device="cuda") * d ** -0.5
    idx = torch.topk(torch.softmax(x @ w, -1), top_k, dim=-1).indices
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    e = flat[order]
    rank = torch.arange(T * top_k, device="cuda") \
        - torch.searchsorted(e, e, side="left")
    keep = rank < C
    xg = torch.zeros((E, C, d), device="cuda")
    xg[e[keep], rank[keep]] = x[order[keep] // top_k]
    return xg


def check_moe_ffn_train(gen, card, make):
    """Phase 3a under a gradient: B1's autograd Function (``MoEFFN``) at
    the training shape (E 128, C = capacity(512) at cf 1.25, d 4096, f
    1536, bf16), every row filled and routed over 512 tokens, and at a
    ragged fp32 shape: the output bit-equal to the plain launch under
    inference_mode, and the output and all four gradients against autograd
    through ``moe_ffn_ref`` on the card; the forward and the backward
    timed. -> the ``train_*`` keys of B1's row."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_ffn import MoEFFN, moe_ffn, moe_ffn_backward
    from repro_torch.models.moe import capacity

    m = get_config(QWEN3).moe
    C = capacity(TRAIN_BATCH * TRAIN_SEQ, m)
    nums = {}
    cases = [("filled", 128, C, 4096, 1536, "swiglu", torch.bfloat16),
             ("routed", 128, C, 4096, 1536, "swiglu", torch.bfloat16)]
    cases += [("ragged", 3, 13, 520, 700, act, torch.float32)
              for act in ("swiglu", "geglu", "relu2", "gelu")]
    for what, E, C, d, f, act, dtype in cases:
        xg, wg, wu, wd = make(E, C, d, f, act, dtype)
        if what == "routed":
            xg = routed_xg(gen, E, C, d, m.top_k,
                           TRAIN_BATCH * TRAIN_SEQ).to(dtype)
        elif what == "ragged":
            xg[0, 5:] = 0           # unrouted rows and a whole empty expert
            xg[2] = 0
        dy = torch.randn(xg.shape, generator=gen, device="cuda").to(dtype)
        tag = f"{what} E={E} C={C} d={d} f={f} {act} {dtype}"
        with torch.inference_mode():
            same = torch.equal(MoEFFN.apply(xg, wg, wu, wd, act),
                               moe_ffn(xg, wg, wu, wd, act=act))
        if not same:
            raise SystemExit(f"{tag}: MoEFFN's output is not the plain "
                             "launch's, bit for bit")
        def leaves():
            return [None if t is None else t.detach().clone()
                    .requires_grad_() for t in (xg, wg, wu, wd)]
        ins, rins = leaves(), leaves()
        y = MoEFFN.apply(*ins, act)
        y.backward(dy)
        want = ref.moe_ffn_ref(*rins, act=act)
        want.backward(dy)
        torch.cuda.synchronize()
        print(f"  B1 Function {tag}: output bit-equal to the plain launch "
              "under inference_mode")
        err = compare(f"{tag} output", y.detach(), want.detach())
        del y, want
        gerr = max(compare_grad(f"{tag} {n}", a.grad, b.grad)
                   for n, a, b in zip(("dxg", "dW_gate", "dW_up", "dW_down"),
                                      ins, rins) if a is not None)
        del ins, rins
        torch.cuda.empty_cache()
        if what == "ragged":
            continue
        ms = time_ms(lambda: moe_ffn(xg, wg, wu, wd, act=act), 10)
        bwd_ms = time_ms(lambda: moe_ffn_backward(xg, wg, wu, wd, dy,
                                                  act=act), 5)

        def plain_bwd():
            ins = [None if t is None else t.detach().requires_grad_()
                   for t in (xg, wg, wu, wd)]
            torch.autograd.grad(ref.moe_ffn_ref(*ins, act=act),
                                [t for t in ins if t is not None], dy)
        plain_ms = time_ms(lambda: ref.moe_ffn_ref(xg, wg, wu, wd, act=act),
                           3, ahead=False)
        bwd_plain_ms = time_ms(plain_bwd, 2, ahead=False)
        lib_ms = time_ms(lambda: library_ffn(xg, wg, wu, wd), 10)
        routed = (xg != 0).any(-1)
        n_exp = int(routed.any(-1).sum())
        esz, w1 = xg.element_size(), d * f
        # forward: xg and y once, the weights of experts with a routed row;
        # backward, the function's least traffic: xg, dy and dxg once, the
        # three weights of each routed expert read once, three dW written
        # (every expert); flops of 8 products over the routed rows (h for
        # dW_down needs the gate and up products). This design also reads
        # W_gate and W_up a second time for its recompute of h.
        fwd_bound, fwd_by = bound(esz * (2 * xg.numel() + n_exp * 3 * w1),
                                  2 * int(routed.sum()) * w1 * 3, dtype)
        bwd_flops = 2 * int(routed.sum()) * w1 * 8
        bwd_bound, bwd_by = bound(
            esz * (3 * xg.numel() + n_exp * 3 * w1 + E * 3 * w1),
            bwd_flops, dtype)
        bwd_design_ms, _ = bound(
            esz * (3 * xg.numel() + n_exp * 5 * w1 + E * 3 * w1),
            bwd_flops, dtype)
        print(f"  time {tag}: forward kernel {ms:.4f} ms (bound "
              f"{fwd_bound:.4f}, {fwd_by}; plain {plain_ms:.4f}; "
              f"library (3x torch.bmm + silu) {lib_ms:.4f}); backward "
              f"products {bwd_ms:.4f} ms (bound {bwd_bound:.4f}, {bwd_by}; "
              f"this design's own traffic {bwd_design_ms:.4f}; plain "
              f"autograd {bwd_plain_ms:.4f}); {n_exp} of {E} experts "
              f"routed [{card}]")
        nums.update({f"train_{what}_{k}": v for k, v in dict(
            max_abs_err=err, grad_rel_err=gerr, ms=ms,
            plain_ms=plain_ms, bound_ms=fwd_bound, bound_by=fwd_by,
            library_ms=lib_ms,
            bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms, bwd_bound_ms=bwd_bound,
            bwd_bound_by=bwd_by, bwd_design_bytes_ms=bwd_design_ms,
            bwd_library_ms=None).items()})
        del xg, wg, wu, wd, dy
        torch.cuda.empty_cache()
    return nums


def _moe_launches_per_step(model):
    """B1 launches of one training step with remat: one forward for each
    MoE layer, and a recompute in the backward for those of the periodic
    tail (the reference's scan groups; prefix layers are not
    rematerialized)."""
    return sum(2 if i >= model.n_prefix else 1 for i in model.moe_layers)


def _params_close_after_steps(init, got, want, lr):
    """Parameters after AdamW steps on two devices from the same weights:
    where a gradient is near eps its rounding moves that element's update
    by a fraction of lr (Adam divides by √v̂ + eps), so each element within
    0.25 lr, and each tensor's update within 2e-3 of the other's in L2
    norm. -> the worst relative update difference."""
    import torch
    worst = 0.0
    for n, p in got.items():
        g, w, i = p.detach().cpu(), want[n].detach(), init[n]
        if not bool(torch.all((g - w).abs() <= 0.25 * lr)):
            worst_abs = float((g - w).abs().max())
            raise SystemExit(f"phase 10b: {n} differs from the CPU by more "
                             f"than 0.25 lr ({worst_abs:.3e})")
        rel = float(torch.linalg.vector_norm(g - w)) / max(
            float(torch.linalg.vector_norm(w - i)), 1e-30)
        if rel > 2e-3:
            raise SystemExit(f"phase 10b: {n}'s update differs from the CPU's"
                             f" by {rel:.3e} of its norm")
        worst = max(worst, rel)
    return worst


def train_path(card):
    """Phase 10: full-width qwen3-moe cut to 1 layer, bf16, trained for 8
    steps through ``make_train_step`` (remat on, AdamW), then 3 more steps
    timed part by part. -> (the launch counts of the 8 steps, {step_ms
    (median of steps 2-8), peak_gb, fb_ms, adam_ms})."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import DATA_VOCAB
    from repro_torch.models import Model
    from repro_torch.train.data import DataConfig, TokenStream
    from repro_torch.train.loop import make_train_step, to_batch
    from repro_torch.train.optim import OptConfig, adamw_init

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    cfg = _full_cfg("phase 10: training, remat on, AdamW", QWEN3, depth=1)
    model = Model(cfg, device="cuda").init(0)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    step_fn = make_train_step(model, opt_cfg, remat=True)
    state = adamw_init(params)
    data = TokenStream(DataConfig(vocab=min(cfg.vocab, DATA_VOCAB),
                                  seq_len=TRAIN_SEQ, batch=TRAIN_BATCH))
    batches = [to_batch(b, "cuda")
               for b in data.batches(TRAIN_STEPS + TIMED_STEPS)]
    torch.cuda.synchronize()
    print(f"  {n_params / 1e9:.3f}e9 params + fp32 moments: "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card "
          f"({left / 1e9:.2f} GB held before); batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ} from TokenStream over {min(cfg.vocab, DATA_VOCAB)} "
          f"ids; {opt_cfg}")
    moe = [f"layers.{i}.moe.{k}" for i in model.moe_layers
           for k in ("w_gate", "w_up", "w_down")]

    before = {n: p.detach().clone() for n, p in params.items()}
    _reset_counts()
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
          for _ in range(TRAIN_STEPS)]
    losses, gnorms, enqueue = [], [], []
    for i, batch in enumerate(batches[:TRAIN_STEPS]):
        if i == 1:
            del before
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ev[i][0].record()
        t0 = time.perf_counter()
        loss, gnorm = step_fn(state, batch)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        ev[i][1].record()
        losses.append(loss)
        gnorms.append(gnorm)
        if i == 0:
            for n, p in params.items():
                if p.grad is None or not bool(torch.isfinite(p.grad).all()):
                    raise SystemExit(f"phase 10: {n} has no finite gradient")
            for n in moe:
                if not bool(params[n].grad.any()):
                    raise SystemExit(f"phase 10: {n}'s gradient is zero")
            moved = {n: float((p != before[n]).float().mean())
                     for n, p in params.items()}
            still = [n for n, v in moved.items() if v == 0]
            if still:
                raise SystemExit(f"phase 10: step 1 left {still} unchanged")
            print("  step 1: every parameter has a finite gradient, the "
                  f"expert gradients ({', '.join(moe)}) are non-zero, and "
                  "every parameter changed (share of elements changed: "
                  + ", ".join(f"{n} {v:.3f}" for n, v in moved.items()
                              if n in ("embed", "lm_head", *moe[:1])) + ")")
    torch.cuda.synchronize()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    gnorms = [float(v) for v in gnorms]
    if not all(np.isfinite(losses + gnorms)):
        raise SystemExit(f"phase 10: non-finite loss or gnorm: {losses} "
                         f"{gnorms}")
    per_step = _moe_launches_per_step(model)
    want = {"moe_ffn": per_step * TRAIN_STEPS, "moe_ffn_quant": 0,
            "flash_decode": 0, "wkv6": 0, "selective_scan": 0}
    print(f"  losses {', '.join(f'{v:.4f}' for v in losses)}; gnorms "
          f"{', '.join(f'{v:.3f}' for v in gnorms)}")
    print(f"  launches over {TRAIN_STEPS} steps: {launches} (expected "
          f"moe_ffn {per_step} a step: {len(model.moe_layers)} MoE layer(s),"
          f" {model.n_prefix} prefix layer(s) not rematerialized, "
          f"{model.n_groups} scan group(s); no other kernel)")
    if launches != want:
        raise SystemExit("phase 10: launch counts differ from the training "
                         "step's")
    steps = [a.elapsed_time(b) for a, b in ev]
    print(f"  step ms (CUDA events): {', '.join(f'{v:.1f}' for v in steps)};"
          f" host enqueue ms: {', '.join(f'{v:.1f}' for v in enqueue)}; "
          f"peak memory (steps 2-{TRAIN_STEPS}) {peak / 1e9:.2f} GB [{card}]")
    summary = {"step_ms": float(np.median(steps[1:])), "peak_gb": peak / 1e9}

    # 3 more steps, timed part by part through the same public functions
    med = _timed_parts(model, state, opt_cfg, batches[TRAIN_STEPS:])
    adam_bytes = sum(p.numel() * (3 * p.element_size() + 16)
                     for p in params.values())
    fb_bytes = sum(p.numel() * p.element_size() * (1 if n == "embed" else 3)
                   for n, p in params.items())
    b1_bytes = sum(params[n].numel() * params[n].element_size() for n in moe)
    print(f"  fwd+bwd median {med[0]:.3f} ms (host enqueue {med[2]:.3f} ms);"
          f" AdamW median {med[1]:.3f} ms (host enqueue {med[3]:.3f} ms), "
          f"over steps {TRAIN_STEPS + 1}-{TRAIN_STEPS + TIMED_STEPS} "
          f"[{card}]")
    print(f"  bytes floors at 3.35 TB/s: AdamW {adam_bytes / 1e9:.2f} GB "
          f"(reads p, g, m, v; writes p, m, v) = "
          f"{adam_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; fwd+bwd "
          f"{fb_bytes / 1e9:.2f} GB (each weight but the embedding table "
          f"read forward and backward, each gradient written) = "
          f"{fb_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; B1's forward reads "
          f"{b1_bytes / 1e9:.2f} GB of experts = "
          f"{b1_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms")
    summary.update(fb_ms=float(med[0]), adam_ms=float(med[1]))
    del model, params, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    remat_at_full_width(card, batches[0])
    return launches, summary


def remat_at_full_width(card, batch):
    """Phase 10's remat check: the same model cut to 2 layers, which
    ``split_periodic`` makes two scan groups of one layer, so remat
    recomputes each layer in the backward, through B1. One loss +
    backward, no optimizer (2 layers' bf16 weights and gradients fit;
    their fp32 moments would not)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config(QWEN3), n_layers=2)
    model = Model(cfg, device="cuda").init(0).trainable()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    loss = model.loss(batch, remat=True)
    loss.backward()
    ev[1].record()
    torch.cuda.synchronize()
    launches = _counts()
    per_layer = launches["moe_ffn"] / len(model.moe_layers)
    finite = all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                 for p in model.parameters())
    print(f"  remat at full width: {cfg.n_layers} layers ({model.n_groups} "
          f"scan groups of {model.period}), one loss + backward: B1 "
          f"{launches['moe_ffn']} launches ({per_layer:g} a MoE layer: the "
          f"forward and its recompute), other kernels "
          f"{sum(launches.values()) - launches['moe_ffn']}; loss "
          f"{float(loss.detach()):.4f}, every gradient finite: {finite}; "
          f"{ev[0].elapsed_time(ev[1]):.3f} ms, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")
    if per_layer != 2 or sum(launches.values()) != launches["moe_ffn"] \
            or not finite:
        raise SystemExit("phase 10: remat did not recompute every layer "
                         "through B1")
    del model, loss
    gc.collect()
    torch.cuda.empty_cache()


TRAIN_CPU_ARCHS = (QWEN3, DEEPSEEK_V2)


def train_vs_cpu():
    """Phase 10b: reduced qwen3-moe (every layer in a scan group, so every
    MoE layer is rematerialized) and reduced DeepSeek-V2 (a dense prefix
    layer, then an MoE one) in fp32, 5 AdamW steps on the card and on the
    CPU from the same weights; then a checkpoint round trip on the card."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train.checkpoint import restore, save
    from repro_torch.train.data import DataConfig, TokenStream
    from repro_torch.train.loop import make_train_step, to_batch
    from repro_torch.train.optim import OptConfig, adamw_init

    for arch in TRAIN_CPU_ARCHS:
        cfg = get_config(arch).reduced()
        print(f"phase 10b: {cfg.name} ({cfg.n_layers} layers, fp32) trained "
              "5 steps on the card vs the same weights on the CPU")
        gpu = Model(cfg, device="cuda").init(1)
        cpu = Model(cfg, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        init = {n: p.detach().clone() for n, p in cpu.named_parameters()}
        opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=5)
        data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=16, batch=2))
        out = {}
        _reset_counts()
        for m in (gpu, cpu):
            step = make_train_step(m, opt_cfg)
            state = adamw_init(dict(m.named_parameters()))
            out[m.device.type] = [tuple(float(v) for v in step(
                state, to_batch(b, m.device))) for b in data.batches(5)]
            if m is gpu:
                launches = _counts()
        got, want = np.asarray(out["cuda"]), np.asarray(out["cpu"])
        if not np.allclose(got, want, rtol=1e-4, atol=0):
            raise SystemExit(f"phase 10b: losses/gnorms differ: card {got} "
                             f"cpu {want}")
        rel = _params_close_after_steps(
            init, dict(gpu.named_parameters()),
            dict(cpu.named_parameters()), opt_cfg.lr)
        per_step = _moe_launches_per_step(gpu)
        if launches["moe_ffn"] != 5 * per_step or \
                sum(launches.values()) != launches["moe_ffn"]:
            raise SystemExit(f"phase 10b: launches {launches}, expected "
                             f"moe_ffn {5 * per_step} only")
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/ckpt.npz"
            save(path, gpu)
            back = restore(path, Model(cfg, device="cuda"))
        batch = to_batch(next(iter(data.batches(1, seed=99))), "cuda")
        with torch.no_grad():
            l1, l2 = float(gpu.loss(batch)), float(back.loss(batch))
        same = all(torch.equal(a, b) for a, b in
                   zip(gpu.parameters(), back.parameters()))
        if not same or abs(l1 - l2) >= 1e-6:
            raise SystemExit(f"phase 10b: checkpoint round trip: parameters "
                             f"equal {same}, loss {l1} vs {l2}")
        print(f"  losses card {', '.join(f'{v:.6f}' for v in got[:, 0])}, "
              f"max |Δ|/|cpu| {np.max(np.abs(got - want) / want):.2e} over "
              f"losses and gnorms (rtol 1e-4); parameters within 0.25 lr, "
              f"worst update difference {rel:.2e} of its norm (limit 2e-3); "
              f"moe_ffn launches {launches['moe_ffn']} = 5 steps x "
              f"{per_step}; checkpoint save -> restore on the card: "
              f"parameters bit-equal, loss {l1:.6f} == {l2:.6f}")
        del gpu, cpu, back
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the launch-time variants: grouped MoE dispatch in training (11), blocked
# attention at prefill (11b), and the dry run (11c)
# ---------------------------------------------------------------------------

GROUPED_STEPS = 5
BLOCKED_PROMPTS = (4080, 8192)      # phase 9's longest prompt, and twice it
BLOCKED_CPU_PROMPT = 1100           # > block_q 512 and block_kv 1024
# bf16 blocked prefill's distance from the fp32 logits, relative to bf16
# naive's: sound readings 0.97-1.03 (2 and 26 layers, 512-8192 tokens); a
# wrong mask or block moves whole rows of attention, O(1)
BF16_DRIFT = 1.25


def _timed_parts(model, state, opt_cfg, batches):
    """Training steps timed part by part through the public functions:
    loss + backward, then AdamW. -> medians (fwd+bwd ms, AdamW ms, their
    host enqueue ms)."""
    import numpy as np
    import torch
    from repro_torch.train.optim import adamw_update, decay_mask

    params = dict(model.named_parameters())
    decay = decay_mask(model)
    parts = []
    for batch in batches:
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e[0].record()
        for p in params.values():
            p.grad = None
        model.loss(batch, remat=True).backward()
        e[1].record()
        t1 = time.perf_counter()
        adamw_update(opt_cfg, params, {n: p.grad for n, p in params.items()},
                     state, decay)
        e[2].record()
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        parts.append((e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2]),
                      (t1 - t0) * 1e3, (t2 - t1) * 1e3))
    return np.median(np.asarray(parts), axis=0)


def grouped_b1(gen, card, moe):
    """B1 at the grouped training shape: each of TRAIN_BATCH sequences
    routed over its own TRAIN_SEQ tokens into C_g rows per expert, the (B,
    E, C_g, d) blocks as one (E, B·C_g, d) call over the model's experts;
    output against the plain version on the card; kernel, plain version,
    3x ``torch.bmm`` and the bound timed. -> B1's ``grouped_*`` keys."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_ffn import moe_ffn
    from repro_torch.models.moe import capacity

    from repro_torch.configs import get_config
    m = get_config(QWEN3).moe
    E, d, f = moe.w_up.shape
    C_g = capacity(TRAIN_SEQ, m)
    xe = torch.stack([routed_xg(gen, E, C_g, d, m.top_k, TRAIN_SEQ)
                      for _ in range(TRAIN_BATCH)], 1) \
        .reshape(E, TRAIN_BATCH * C_g, d).to(moe.w_up.dtype)
    wg, wu, wd = (w.detach() for w in (moe.w_gate, moe.w_up, moe.w_down))
    with torch.inference_mode():
        got = moe_ffn(xe, wg, wu, wd)
        want = ref.moe_ffn_ref(xe, wg, wu, wd)
        torch.cuda.synchronize()
        tag = f"grouped E={E} B*C_g={TRAIN_BATCH}*{C_g} d={d} f={f} swiglu"
        err = compare(f"{tag} {xe.dtype}", got, want)
        ms = time_ms(lambda: moe_ffn(xe, wg, wu, wd), 10)
        plain_ms = time_ms(lambda: ref.moe_ffn_ref(xe, wg, wu, wd), 3,
                           ahead=False)
        lib_ms = time_ms(lambda: library_ffn(xe, wg, wu, wd), 10)
    routed = (xe != 0).any(-1)
    n_exp = int(routed.any(-1).sum())
    esz = xe.element_size()
    bound_ms, by = bound(esz * (2 * xe.numel() + n_exp * 3 * d * f),
                         2 * int(routed.sum()) * d * f * 3, xe.dtype)
    print(f"  time {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library (3x torch.bmm + silu) {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}); {int(routed.sum())} of "
          f"{routed.numel()} rows and {n_exp} of {E} experts routed "
          f"[{card}]")
    return {f"grouped_{k}": v for k, v in dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=by, library_ms=lib_ms).items()}


def grouped_train_path(card, train10):
    """Phase 11: phase 10's model and batch (full-width qwen3-moe cut to 1
    layer, 4 x 128) under ``moe_dispatch="grouped"``: GROUPED_STEPS steps
    through ``make_train_step`` with B1 once a step (its forward over every
    sequence's blocks as one (E, B·C_g, d) call), then 3 more timed part
    by part; finite loss and gradients, non-zero expert gradients; B1 at
    the grouped shape against its plain version; the step's model FLOPs
    as an MFU; the dry run's traced FLOPs for the same step against
    ``torch.utils.flop_counter`` on the card, and its roofline against the
    measured step. -> (launch counts of the GROUPED_STEPS steps, B1's
    ``grouped_*`` keys)."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.config import InputShape
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.serve import DATA_VOCAB
    from repro_torch.models import Model
    from repro_torch.models.moe import capacity
    from repro_torch.train.data import DataConfig, TokenStream
    from repro_torch.train.loop import make_train_step, to_batch
    from repro_torch.train.optim import OptConfig, adamw_init

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(
        _full_cfg("phase 11: training with grouped MoE dispatch, remat on, "
                  "AdamW", QWEN3, depth=1), moe_dispatch="grouped")
    model = Model(cfg, device="cuda").init(0)
    params = dict(model.named_parameters())
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=GROUPED_STEPS)
    step_fn = make_train_step(model, opt_cfg, remat=True)
    state = adamw_init(params)
    data = TokenStream(DataConfig(vocab=min(cfg.vocab, DATA_VOCAB),
                                  seq_len=TRAIN_SEQ, batch=TRAIN_BATCH))
    batches = [to_batch(b, "cuda")
               for b in data.batches(GROUPED_STEPS + TIMED_STEPS + 1)]
    C_g = capacity(TRAIN_SEQ, cfg.moe)
    print(f"  moe_dispatch=grouped: {TRAIN_BATCH} sequences x {TRAIN_SEQ} "
          f"tokens, capacity C_g = {C_g} per expert and sequence, B1 over "
          f"(E, B*C_g, d) = ({cfg.moe.n_experts}, {TRAIN_BATCH * C_g}, "
          f"{cfg.d_model})")
    moe = [f"layers.{i}.moe.{k}" for i in model.moe_layers
           for k in ("w_gate", "w_up", "w_down")]
    torch.cuda.synchronize()
    _reset_counts()
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
          for _ in range(GROUPED_STEPS)]
    losses = []
    for i, batch in enumerate(batches[:GROUPED_STEPS]):
        if i == 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ev[i][0].record()
        loss, gnorm = step_fn(state, batch)
        ev[i][1].record()
        losses.append((loss, gnorm))
        if i == 0:
            for n, p in params.items():
                if p.grad is None or not bool(torch.isfinite(p.grad).all()):
                    raise SystemExit(f"phase 11: {n} has no finite gradient")
            for n in moe:
                if not bool(params[n].grad.any()):
                    raise SystemExit(f"phase 11: {n}'s gradient is zero")
    torch.cuda.synchronize()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = np.asarray([[float(a), float(b)] for a, b in losses])
    if not np.isfinite(losses).all():
        raise SystemExit(f"phase 11: non-finite loss or gnorm: {losses}")
    want = {"moe_ffn": GROUPED_STEPS * len(model.moe_layers),
            "moe_ffn_quant": 0, "flash_decode": 0, "wkv6": 0,
            "selective_scan": 0}
    if launches != want:
        raise SystemExit(f"phase 11: launches {launches}, expected {want}")
    steps = [a.elapsed_time(b) for a, b in ev]
    step_ms = float(np.median(steps[1:]))
    print(f"  step 1: every gradient finite, the expert gradients non-zero; "
          f"losses {', '.join(f'{v:.4f}' for v in losses[:, 0])}; gnorms "
          f"{', '.join(f'{v:.3f}' for v in losses[:, 1])}; launches "
          f"{launches} (B1 once a step: 1 MoE layer, not rematerialized)")
    med = _timed_parts(model, state, opt_cfg,
                       batches[GROUPED_STEPS:GROUPED_STEPS + TIMED_STEPS])
    print(f"  grouped step ms (CUDA events): "
          f"{', '.join(f'{v:.1f}' for v in steps)}; median of steps 2-"
          f"{GROUPED_STEPS} {step_ms:.3f} ms; fwd+bwd median {med[0]:.3f} "
          f"ms, AdamW median {med[1]:.3f} ms; peak {peak:.2f} GB; phase 10 "
          f"(global dispatch) in this run: step {train10['step_ms']:.3f} ms,"
          f" fwd+bwd {train10['fb_ms']:.3f} ms, AdamW "
          f"{train10['adam_ms']:.3f} ms, peak {train10['peak_gb']:.2f} GB "
          f"[{card}]")

    shape = InputShape("phase11", TRAIN_SEQ, TRAIN_BATCH, "train")
    model_flops = roofline.model_flops_for(cfg, shape, "train")
    with FlopCounterMode(display=False) as fc:
        step_fn(state, batches[-1])
    torch.cuda.synchronize()
    fn, args, meta_model = dryrun.build_step(cfg, shape, with_optimizer=True)
    rec = dryrun.trace(fn, args, meta_model)
    E, d, f = model.layers[model.moe_layers[0]].moe.w_up.shape
    b1_fwd = len(model.moe_layers) * 3 * 2.0 * E * TRAIN_BATCH * C_g * d * f
    counted = fc.get_total_flops()
    print(f"  mfu {model_flops / (step_ms * 1e-3 * roofline.PEAK_FLOPS):.4f}"
          f": model_flops_for {model_flops:.6e} over the grouped step "
          f"{step_ms:.3f} ms x 989 TFLOP/s [{card}]")
    print(f"  dry run (meta) of the same step: dot FLOPs {rec['dot_flops']:.6e}"
          f", bytes {rec['bytes_accessed']:.6e}, {rec['n_ops']} aten ops, "
          f"kernels {rec['kernels']}, traced in {rec['t_trace_s']} s; "
          f"torch.utils.flop_counter on the card {counted:.6e} + B1's "
          f"forward products {b1_fwd:.6e} (a ctypes launch it cannot see) "
          f"= {counted + b1_fwd:.6e}")
    if abs(counted + b1_fwd - rec["dot_flops"]) > 1e-9 * rec["dot_flops"]:
        raise SystemExit("phase 11: the dry run's FLOPs are not the card "
                         "step's")
    r = roofline.analyze({"n_devices": 1, "cost_corrected": {
        "dot_flops": rec["dot_flops"],
        "bytes_accessed": rec["bytes_accessed"]}}, model_flops)
    print(f"  dry-run roofline of the step on one H100: compute "
          f"{r.compute_s * 1e3:.3f} ms, memory {r.memory_s * 1e3:.3f} ms "
          f"({r.dominant}); measured step {step_ms:.3f} ms = "
          f"{step_ms / (max(r.compute_s, r.memory_s) * 1e3):.2f}x the "
          f"roofline [{card}]")
    row = grouped_b1(torch.Generator(device="cuda").manual_seed(11), card,
                     model.layers[model.moe_layers[0]].moe)
    row.update(grouped_step_ms=step_ms, grouped_peak_gb=peak,
               grouped_mfu=model_flops / (step_ms * 1e-3
                                          * roofline.PEAK_FLOPS))
    del model, params, state, step_fn, batches
    gc.collect()
    torch.cuda.empty_cache()
    return launches, row


def _rel_l2(got, want):
    import torch
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def blocked_prefill_path(card):
    """Phase 11b: full-width gemma2-2b (all 26 layers) prefilled at
    BLOCKED_PROMPTS tokens with ``attn_impl="blocked"`` and ``"naive"`` on
    the same weights, in bf16 (timed: prefill ms and peak memory above the
    weights) and in fp32 (the same weights widened). Checks: fp32 blocked
    against fp32 naive within fp32 limits (the algorithm at full size);
    bf16 blocked no further from the fp32 logits than bf16 naive is
    (relative L2 within BF16_DRIFT x naive's). 26 bf16 layers put either
    bf16 path ~0.08 from the fp32 logits at worst, past the kernels' bf16
    limits, so the two bf16 paths are compared through the fp32 logits.
    Prefill attention is plain tensor code: no kernel launches. -> the
    launch counts."""
    import torch
    from repro_torch.models import Model

    cfg, desc = _family_cfg(GEMMA2, None)
    print(f"phase 11b: blocked attention at prefill, {desc}")
    gc.collect()
    torch.cuda.empty_cache()
    models = {("bf16", "naive"): Model(cfg, device="cuda").init(0)}
    weights = models[("bf16", "naive")].state_dict()
    for dt, impl in (("bf16", "blocked"), ("fp32", "naive"),
                     ("fp32", "blocked")):
        m = Model(dataclasses.replace(
            cfg, attn_impl=impl,
            dtype="float32" if dt == "fp32" else cfg.dtype), device="cuda")
        m.load_state_dict(weights)
        models[(dt, impl)] = m
    gen = torch.Generator(device="cuda").manual_seed(3)
    _reset_counts()
    for S in BLOCKED_PROMPTS:
        toks = torch.randint(0, cfg.vocab, (1, S), generator=gen,
                             device="cuda")
        out = {}
        for (dt, impl), m in models.items():
            with torch.inference_mode():
                if dt == "bf16":                                 # warm-up
                    m.prefill({"tokens": toks}, m.init_cache(1, S))
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                e[0].record()
                logits, _, _ = m.prefill({"tokens": toks},
                                         m.init_cache(1, S))
                e[1].record()
                torch.cuda.synchronize()
            out[(dt, impl)] = (logits, e[0].elapsed_time(e[1]),
                               (torch.cuda.max_memory_allocated() - held)
                               / 1e9)
        ref = out[("fp32", "naive")][0]
        err = compare(f"prefill of {S} tokens, fp32: blocked vs naive "
                      "logits", out[("fp32", "blocked")][0], ref,
                      {"torch.float32": (1e-4, 1e-4)})
        drift = {impl: _rel_l2(out[("bf16", impl)][0], ref)
                 for impl in ("naive", "blocked")}
        diff = (out[("bf16", "blocked")][0] - out[("bf16", "naive")][0]) \
            .abs()
        over = int((diff > 5e-2 + 5e-2 * out[("bf16", "naive")][0].abs())
                   .sum())
        print(f"  prefill {S} tokens: bf16 naive {out[('bf16', 'naive')][1]:.3f}"
              f" ms, peak {out[('bf16', 'naive')][2]:.2f} GB above the "
              f"weights; bf16 blocked {out[('bf16', 'blocked')][1]:.3f} ms, "
              f"peak {out[('bf16', 'blocked')][2]:.2f} GB [{card}]")
        print(f"  logits: fp32 blocked vs naive max_abs_err {err:.3e}; bf16 "
              f"vs fp32 relative L2 naive {drift['naive']:.3e}, blocked "
              f"{drift['blocked']:.3e} (limit {BF16_DRIFT} x naive's); bf16 "
              f"blocked vs bf16 naive max_abs_err {float(diff.max()):.3e}, "
              f"{over} of {diff.numel()} past (5e-2, 5e-2)")
        if drift["blocked"] > BF16_DRIFT * drift["naive"]:
            raise SystemExit(f"phase 11b: bf16 blocked prefill of {S} "
                             "tokens is further from the fp32 logits than "
                             "bf16 naive")
        del out, ref
    launches = _counts()
    del models, weights
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def blocked_vs_cpu():
    """Phase 11b's fp32 check: reduced gemma2-2b with blocked attention, a
    prompt of BLOCKED_CPU_PROMPT tokens (several query and KV blocks,
    padded, past the reduced window) on the card against the same weights
    on the CPU, and against the naive path on each: forward and prefill
    logits within fp32 limits."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config(GEMMA2).reduced(),
                              attn_impl="blocked")
    print(f"phase 11b: {cfg.name} ({cfg.n_layers} layers, fp32, window "
          f"{cfg.attn.sliding_window}) with blocked attention on the card vs "
          f"the same weights on the CPU, {BLOCKED_CPU_PROMPT} tokens")
    gpu = Model(cfg, device="cuda").init(5)
    weights = {k: v.cpu() for k, v in gpu.state_dict().items()}
    models = {("card", "blocked"): gpu}
    for where, impl in (("cpu", "blocked"), ("card", "naive"),
                        ("cpu", "naive")):
        m = Model(dataclasses.replace(cfg, attn_impl=impl),
                  device="cuda" if where == "card" else "cpu")
        m.load_state_dict(weights)
        models[(where, impl)] = m
    toks = torch.randint(0, cfg.vocab, (1, BLOCKED_CPU_PROMPT),
                         generator=torch.Generator().manual_seed(4))
    errs = []
    with torch.inference_mode():
        for name, fn in (
                ("forward", lambda m: m.forward(
                    {"tokens": toks.to(m.device)})[0]),
                ("prefill", lambda m: m.prefill(
                    {"tokens": toks.to(m.device)},
                    m.init_cache(1, BLOCKED_CPU_PROMPT))[0])):
            out = {k: fn(m).cpu() for k, m in models.items()}
            for a, b in ((("card", "blocked"), ("cpu", "blocked")),
                         (("card", "naive"), ("cpu", "naive")),
                         (("card", "blocked"), ("card", "naive"))):
                err = (out[a] - out[b]).abs()
                errs.append(f"{name} {'/'.join(a)} vs {'/'.join(b)} "
                            f"{float(err.max()):.3e}")
                if not bool(torch.all(err <= 1e-4 + 1e-4 * out[b].abs())):
                    print("  " + "; ".join(errs))
                    raise SystemExit(f"phase 11b: {errs[-1]}: past the fp32 "
                                     "limits")
    print(f"  logits within fp32 limits (atol 1e-4, rtol 1e-4), max_abs_err: "
          f"{'; '.join(errs)}")
    del gpu, models
    gc.collect()
    torch.cuda.empty_cache()


def dryrun_sweep():
    """Phase 11c: ``python -m repro_torch.launch.dryrun --all`` in a
    subprocess on this machine (meta tensors: no card): the seconds it
    takes, the records by status (an error record fails the phase), and
    the roofline of qwen3-moe's decode_32k and train_4k records."""
    import collections
    import tempfile
    from repro_torch.config import INPUT_SHAPES
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline

    print("phase 11c: the dry run, --all over meta tensors, in a subprocess")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--out", tmp], env=env, capture_output=True, text=True,
            timeout=900)
        secs = time.perf_counter() - t0
        recs = roofline.load_records(tmp)
    status = collections.Counter(r["status"] for r in recs)
    print(f"  {len(recs)} records in {secs:.1f} s: {dict(status)}; exit "
          f"code {res.returncode}")
    if res.returncode or status["error"] or not status["ok"]:
        print(res.stdout[-3000:], res.stderr[-3000:], sep="\n")
        raise SystemExit("phase 11c: the dry run wrote error records")
    for shape in ("decode_32k", "train_4k"):
        rec = next(r for r in recs if r["arch"] == QWEN3
                   and r["shape"] == shape and r["mesh"] == "16x16")
        sh_ = INPUT_SHAPES[shape]
        r = roofline.analyze(rec, roofline.model_flops_for(
            get_config(QWEN3), sh_, sh_.kind))
        print(f"  {QWEN3} {shape} on {rec['n_devices']} H100s (an even "
              f"split): dominant {r.dominant}; compute {r.compute_s:.4e} s, "
              f"memory {r.memory_s:.4e} s; dot FLOPs {r.flops:.4e}, bytes "
              f"{r.bytes_accessed:.4e}, model FLOPs / traced "
              f"{r.useful_ratio:.3f}; argument bytes per device "
              f"{rec['argument_bytes_per_device']:.4e}; traced in "
              f"{rec['t_trace_s']} s")


# ---------------------------------------------------------------------------
# phase 12: expert-parallel serving over D shards of one card
# ---------------------------------------------------------------------------

# (path, D, wire or None for all-resident, the phase whose tokens it must
# print)
EP_PATHS = (("ep_streaming_d2", 2, "int8", "streaming"),
            ("ep_streaming_d4", 4, "int8", "streaming"),
            ("ep_all_resident_d2", 2, None, "all_resident"))
SHARED_CARD = ("the D shards share one card, its SMs and its one "
               "host link")


def one_card_mesh(D):
    from repro_torch.launch.mesh import ExpertMesh
    return ExpertMesh(["cuda:0"] * D)


def shard_bytes(xg, routed, weights, out_dtype, sl):
    """The least bytes one shard's launch moves: its xg block and output
    block once, the slot rows, and the weights (and int8 scales) of its
    experts with a routed row."""
    import torch
    E, C, d = xg[sl].shape
    busy = routed[sl].any(-1)
    per_expert = sum(w[0].numel() * w.element_size() for w in weights)
    return (xg[sl].numel() * xg.element_size() + 4 * E
            + int(busy.sum()) * per_expert
            + E * C * d * torch.finfo(out_dtype).bits // 8)


def check_sharded_exchange(gen, card):
    """Phase 12's kernel check at one MoE layer's decode shape (E 128, C 8,
    d 4096, f 1536; 4 tokens x top-8): ``moe_ffn_sharded`` (B1, bf16) and
    ``moe_ffn_sharded_slots`` (B1 through the slot table over bf16 slots,
    B2 over int8 and fp16 slots) at D = 2 and 4 over one card's shards,
    each bit-equal to the unsharded launch; each shard's launch against
    its plain version; each shard's ms beside its bytes bound and the
    unsharded launch's ms; the exchange's copies a layer.
    -> {(form, D): {"shard_ms", "shard_bound_ms", "unsharded_ms",
    "exchange_ms"}}."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.moe_ffn import (moe_ffn_sharded,
                                             moe_ffn_sharded_slots)
    E, C, d, f = (MAIN[k] for k in "ECdf")
    print(f"phase 12: the expert-parallel exchange at one MoE layer's decode "
          f"shape (E {E}, C {C}, d {d}, f {f}; {TOKENS} tokens x top-{TOP_K})"
          f", D shards of one card ({SHARED_CARD}): bit-equal to the "
          f"unsharded launch")

    def rnd(shape, std, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).to(dtype)
    xg = rnd((E, C, d), 1.0)
    routed, n_exp = route_decode(xg)
    out = {}
    forms = [("b1 dense bf16", None), ("b1 slots bf16", "bf16"),
             ("b2 slots int8", "int8"), ("b2 slots fp16", "fp16")]
    for form, wire in forms:
        if wire in (None, "bf16"):
            ws = [rnd((E, d, f), d ** -0.5), rnd((E, d, f), d ** -0.5),
                  rnd((E, f, d), f ** -0.5)]
            bufs = dict(zip(("w_gate", "w_up", "w_down"), ws))
            slots = torch.randperm(E, generator=gen, device="cuda") \
                .to(torch.int32)
            out_dtype = torch.bfloat16
        else:
            args = quant_inputs(gen, E, C, d, f, 2 * E, "swiglu", wire,
                                torch.bfloat16)
            ws, slots = list(args[1:4]), args[7]
            bufs = dict(zip(("w_gate", "w_up", "w_down"), ws))
            if wire == "int8":
                bufs.update(zip(("w_gate_scale", "w_up_scale",
                                 "w_down_scale"), args[4:7]))
            out_dtype = torch.float32
        if wire is None:
            def unsharded():
                return ops.moe_expert_ffn(xg, *ws, act="swiglu")

            def sharded(mesh):
                return moe_ffn_sharded(xg, *ws, mesh=mesh, act="swiglu")

            def shard(sl):
                return ops.moe_expert_ffn(xg[sl], *(w[sl] for w in ws),
                                          act="swiglu")

            def plain(sl):
                return ref.moe_ffn_ref(xg[sl], *(w[sl] for w in ws),
                                       act="swiglu")
        else:
            def unsharded():
                return ops.moe_expert_ffn_slots(xg, bufs, slots, act="swiglu",
                                                out_dtype=out_dtype)

            def sharded(mesh):
                D = mesh.shape["expert"]
                Eb = E // D
                return moe_ffn_sharded_slots(
                    xg, [bufs] * D,
                    [slots[i * Eb:(i + 1) * Eb] for i in range(D)],
                    mesh=mesh, act="swiglu", out_dtype=out_dtype)

            def shard(sl):
                return ops.moe_expert_ffn_slots(xg[sl], bufs, slots[sl],
                                                act="swiglu",
                                                out_dtype=out_dtype)

            def plain(sl):
                return ref.moe_ffn_quant_ref(
                    xg[sl], *(bufs.get(n) for n in ("w_gate", "w_up",
                                                    "w_down")),
                    *(bufs.get(n + "_scale") for n in ("w_gate", "w_up",
                                                       "w_down")),
                    slots[sl], act="swiglu", out_dtype=out_dtype)
        want = unsharded()
        full_ms = time_ms(unsharded, 10)
        weights = [bufs[n] for n in sorted(bufs)]
        full_bound, _ = bound(shard_bytes(xg, routed, weights, out_dtype,
                                          slice(0, E)), 0, torch.float32)
        for D in (2, 4):
            mesh = one_card_mesh(D)
            got = sharded(mesh)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"phase 12: {form} at D = {D} differs from "
                                 "the unsharded launch")
            Eb = E // D
            ms, bnd = [], []
            for i in range(D):
                sl = slice(i * Eb, (i + 1) * Eb)
                compare(f"{form} D={D} shard {i} (experts {sl.start}-"
                        f"{sl.stop - 1}, {int(routed[sl].any(-1).sum())} "
                        f"routed) vs plain", shard(sl), plain(sl))
                ms.append(time_ms(lambda: shard(sl), 10))
                bnd.append(bound(shard_bytes(xg, routed, weights, out_dtype,
                                             sl), 0, torch.float32)[0])
            # the exchange a layer as the runtime runs it on one card:
            # placement order in, the D result blocks concatenated, expert
            # order out (the shard copies are no-ops on one card)
            perm = torch.randperm(E, device="cuda")
            inv = torch.argsort(perm)
            blocks = [want[i * Eb:(i + 1) * Eb].clone() for i in range(D)]

            def exchange():
                xg.index_select(0, perm)
                return torch.cat(blocks).index_select(0, inv)
            ex_ms = time_ms(exchange, 10)
            sharded_ms = time_ms(lambda: sharded(mesh), 10)
            print(f"  {form} D={D}: bit-equal to the unsharded launch; "
                  f"per-shard kernel ms "
                  f"{', '.join(f'{t:.4f}' for t in ms)} against bytes "
                  f"bounds {', '.join(f'{b:.4f}' for b in bnd)}; the "
                  f"D launches together {sharded_ms:.4f} ms; unsharded "
                  f"launch {full_ms:.4f} ms (bound {full_bound:.4f}); "
                  f"exchange copies a layer {ex_ms:.4f} ms [{card}]")
            out[(form, D)] = dict(shard_ms=ms, shard_bound_ms=bnd,
                                  sharded_ms=sharded_ms,
                                  unsharded_ms=full_ms,
                                  unsharded_bound_ms=full_bound,
                                  exchange_ms=ex_ms)
        del want, got, bufs, ws, blocks
        args = None
        gc.collect()
        torch.cuda.empty_cache()
    return out


def check_combine_order(card, reps=20):
    """Why the MoE combine accumulates in fp32: at a prefill's shape (32
    tokens x top-8 into 33 rows of 4096) ``index_add_`` on CUDA adds with
    atomics in no fixed order. Into a bf16 accumulator every add rounds,
    so repeats may differ; into fp32 the 8 bf16 terms of a row sum
    exactly, so every repeat must give the same bits."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(3)
    T, k, d = 32, TOP_K, MAIN["d"]
    contrib = torch.randn((T * k, d), generator=gen,
                          device="cuda").to(torch.bfloat16)
    rows = torch.randperm(T * k, generator=gen, device="cuda") // k
    distinct = {}
    for acc in (torch.bfloat16, torch.float32):
        outs = []
        for _ in range(reps):
            y = torch.zeros((T + 1, d), dtype=acc, device="cuda")
            y.index_add_(0, rows, contrib.to(acc))
            outs.append(y.to(torch.bfloat16))
        distinct[acc] = 1 + sum(not torch.equal(o, outs[0]) for o in outs)
    print(f"  the combine's index_add_ at a prefill's shape ({T} tokens x "
          f"top-{k}, d {d}), {reps} repeats: {distinct[torch.bfloat16] - 1} "
          f"differ from the first with a bf16 accumulator, "
          f"{distinct[torch.float32] - 1} with fp32 (what moe_ffn uses) "
          f"[{card}]")
    if distinct[torch.float32] != 1:
        raise SystemExit("phase 12: the fp32 combine is not reproducible")


def expert_parallel_path(card, path, D, wire, want_tokens):
    """Phase 12 (a)-(c): the launcher's ``serve()`` with SERVE_FLAGS and
    ``--devices D`` over ``one_card_mesh(D)``: rf 0.5 over ``wire``, or
    all-resident (wire None: every expert a home slot, the bf16 master
    wire, B1 through each shard's slot table). Checks the tokens, the
    launch counts (the slot kernel D times a MoE layer and step), the
    per-shard accounting, the ``devices:`` line and the card memory.
    -> (launch counts, step readings)."""
    import contextlib
    import io
    import torch
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import Model

    gc.collect()
    torch.cuda.empty_cache()
    what = (f"phase 12{'abc'[[p[0] for p in EP_PATHS].index(path)]}: "
            f"expert-parallel D = {D}, "
            + (f"rf 0.5 over the {wire} wire" if wire else
               "all-resident (every expert a home slot, bf16 master wire)"))
    cfg = _full_cfg(what, QWEN3)
    model = Model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    resident_bytes = tensor_bytes()
    flags = SERVE_FLAGS + ["--devices", str(D)]
    if wire:
        flags += ["--resident-fraction", "0.5", "--transfer-dtype", wire]
    args = serve_mod.parse_args(flags)
    _reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = serve_mod.serve(args, cfg, model, mesh=one_card_mesh(D))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    report = buf.getvalue().splitlines()
    for line in report:
        if line.startswith(("slots:", "devices:")):
            print(f"  {line}")
    srv = out["server"]
    rt = srv.slot_runtime
    st = srv.stats()
    n_moe = len(model.moe_layers)
    _check_budgets(out, cfg)
    if out["tokens"] != want_tokens:
        raise SystemExit(f"{path}: tokens differ from D = 1's: "
                         f"{out['tokens']} against {want_tokens}")
    served = srv.n_prefills + srv.n_decode_steps
    slot_kernel = "moe_ffn_quant" if wire else "moe_ffn"
    want = {"moe_ffn": n_moe * out["n_warmup"], "moe_ffn_quant": 0,
            "flash_decode": _b3_per_step(cfg) * srv.n_decode_steps,
            "wkv6": 0, "selective_scan": 0}
    want[slot_kernel] += D * n_moe * served
    print(f"  tokens equal D = 1's; launches: {slot_kernel} "
          f"{launches[slot_kernel]} (expected {D} shards x {n_moe} MoE layers"
          f" x ({srv.n_prefills} prefills + {srv.n_decode_steps} decode "
          f"steps)" + (f" + {n_moe} x {out['n_warmup']} EAMC warm-up "
                       "forwards" if not wire else "")
          + f" = {want[slot_kernel]}); {launches}; serve wall {wall:.1f} s")
    if launches != want:
        raise SystemExit(f"{path}: launch counts differ from {want}")
    per = st["per_device"]
    for key in ("weight_slots", "slot_hits", "slot_misses", "demand_uploads",
                "prefetch_uploads", "slot_evictions", "upload_bytes"):
        if st[key] != sum(p[key] for p in per):
            raise SystemExit(f"{path}: the shards' {key} do not sum to "
                             "stats()")
    n_up = st["demand_uploads"] + st["prefetch_uploads"]
    if st["upload_bytes"] != n_up * st["wire_expert_bytes"]:
        raise SystemExit(f"{path}: upload bytes disagree with the uploads")
    if st["n_devices"] != D or st["placement_rebalances"] <= 0:
        raise SystemExit(f"{path}: n_devices {st['n_devices']}, "
                         f"rebalances {st['placement_rebalances']}")
    if not any(ln.startswith(f"devices: D={D} ") for ln in report):
        raise SystemExit(f"{path}: no devices: line")
    print(f"  accounting: the {D} shards' slot counters sum to stats(); "
          f"uploaded {st['upload_bytes']} B = {n_up} x "
          f"{st['wire_expert_bytes']} B; rebalances "
          f"{st['placement_rebalances']}, migrations "
          f"{st['placement_migrations']}")
    for cache in rt.slot_caches:
        cache.commit()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    slot_bytes = nbytes(t for c in rt.slot_caches for t in c.bufs.values())
    kv_bytes = nbytes(t for bc in rt.layer_caches for t in bc.values())
    expert_total = n_moe * cfg.moe.n_experts * rt.store.expert_bytes
    stream_bytes = tensor_bytes()
    print(f"  card memory: {resident_bytes} B all-resident after init, "
          f"{stream_bytes} B after serving; experts {expert_total} B, slot "
          f"buffers {slot_bytes} B over {D} caches, pooled decode cache "
          f"{kv_bytes} B")
    if resident_bytes + kv_bytes - stream_bytes < expert_total - slot_bytes:
        raise SystemExit(f"{path}: the card holds more than the slots and "
                         "the pool cache")
    steps = _steps(srv, f"expert-parallel D = {D} "
                        f"{wire or 'all-resident'} ({SHARED_CARD})", card)
    readings = stream_step_readings(srv, steps, f"D = {D}", card)
    expert = (rt.store.wire_expert(0, 0) if wire else rt.store.expert(0, 0))
    ups = []
    for i, (cache, p) in enumerate(zip(rt.slot_caches, per)):
        gbps, size = upload_gbps(cache._copy_stream, expert)
        ups.append(f"shard {i}: {p['demand_uploads']} demand + "
                   f"{p['prefetch_uploads']} prefetch uploads, "
                   f"{gbps:.2f} GB/s")
    print(f"  per-shard uploads and one expert's upload ({size} B) on each "
          f"cache's copy stream: {'; '.join(ups)} ({SHARED_CARD}) [{card}]")
    del model, srv, out, rt, expert, cache
    gc.collect()          # frees the card and unlocks the host store
    torch.cuda.empty_cache()
    return launches, readings


def expert_parallel(card, gen, tokens, d1):
    """Phase 12: the exchange's kernel check, then (a)-(c), then the step
    table beside phase 4b's D = 1. -> ({path: launch counts}, the
    exchange's readings by "<form> D=<D>")."""
    exch = check_sharded_exchange(gen, card)
    check_combine_order(card)
    paths, readings = {}, {1: d1}
    for path, D, wire, ref_path in EP_PATHS:
        paths[path], r = expert_parallel_path(card, path, D, wire,
                                              tokens[ref_path])
        if wire:
            readings[D] = r
    print(f"  rf 0.5 int8 decode step by D ({SHARED_CARD}; D = 1 is phase "
          f"4b of this run): "
          + "; ".join(f"D = {D}: median {r['median_ms']:.3f} ms, host "
                      f"{r['host_ms']:.3f} ms, device busy "
                      f"{r['busy_ms']:.3f} ms ({r['copy_ms']:.3f} copies)"
                      for D, r in sorted(readings.items()))
          + f" [{card}]")
    for D in (2, 4):
        x = exch[("b2 slots int8", D)]
        print(f"  B2 int8 per shard at D = {D}: "
              f"{', '.join(f'{t:.4f}' for t in x['shard_ms'])} ms against "
              f"{', '.join(f'{b:.4f}' for b in x['shard_bound_ms'])}; "
              f"unsharded {x['unsharded_ms']:.4f} ms; exchange "
              f"{x['exchange_ms']:.4f} ms a layer [{card}]")
    return paths, {f"{form} D={D}": x for (form, D), x in exch.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(card)
    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    card = card.splitlines()[0]

    t0 = time.perf_counter()
    build.build()
    print(f"phase 2: built {', '.join(build.KERNELS)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [check_moe_ffn(gen, card), check_moe_ffn_quant(gen, card),
            check_flash_decode(gen, card), check_wkv6(gen, card),
            check_selective_scan(gen, card)]
    paths, tokens = {}, {}
    paths["all_resident"], tokens["all_resident"] = main_path(
        card, check_syncs=True)
    paths["streaming"], tokens["streaming"], d1 = streaming_path(
        card, check_syncs=True)
    port_vs_cpu()
    streaming_vs_cpu()
    paths["rwkv"] = rwkv_path(card)
    rwkv_vs_cpu()
    paths["deepseek_all_resident"], _ = main_path(
        card, DEEPSEEK_V2, "phase 7: DeepSeek-V2, every expert resident")
    paths["deepseek_streaming"], _, _ = streaming_path(
        card, DEEPSEEK_V2, "phase 7b: DeepSeek-V2, streaming experts at rf "
                           "0.5 over the int8 wire")
    deepseek_vs_cpu()
    paths["jamba_all_resident"], _ = main_path(
        card, JAMBA, "phase 8: Jamba, every expert resident")
    paths["jamba_streaming"], _, _ = streaming_path(
        card, JAMBA, "phase 8b: Jamba, streaming experts at rf 0.5 over the "
                     "master-dtype (bf16) wire", wire="fp32")
    jamba_vs_cpu()
    paths["gemma2"] = family_path(card, GEMMA2, "9")
    paths["qwen2_vl"] = family_path(card, QWEN2_VL, "9b")
    paths["whisper"] = family_path(card, WHISPER, "9c")
    families_vs_cpu()
    paths["train"], train10 = train_path(card)
    train_vs_cpu()
    paths["train_grouped"], grouped_row = grouped_train_path(card, train10)
    rows[0].update(grouped_row)
    paths["blocked_prefill"] = blocked_prefill_path(card)
    blocked_vs_cpu()
    dryrun_sweep()
    ep_paths, sharded = expert_parallel(card, gen, tokens, d1)
    paths.update(ep_paths)
    for row, prefix in ((rows[0], "b1"), (rows[1], "b2")):
        row["sharded"] = {k: v for k, v in sharded.items()
                          if k.startswith(prefix)}
    lint_phase()
    jamba = ("flash_decode", "moe_ffn", "selective_scan")
    for path, names in (("all_resident", ("flash_decode", "moe_ffn")),
                        ("streaming", ("flash_decode", "moe_ffn_quant")),
                        ("rwkv", ("wkv6",)),
                        ("deepseek_all_resident", ("moe_ffn",)),
                        ("deepseek_streaming", ("moe_ffn_quant",)),
                        ("jamba_all_resident", jamba),
                        ("jamba_streaming", jamba),
                        ("gemma2", ("flash_decode",)),
                        ("qwen2_vl", ("flash_decode",)),
                        ("whisper", ("flash_decode",)),
                        ("train", ("moe_ffn",)),
                        ("train_grouped", ("moe_ffn",)),
                        ("ep_streaming_d2", ("flash_decode",
                                             "moe_ffn_quant")),
                        ("ep_streaming_d4", ("flash_decode",
                                             "moe_ffn_quant")),
                        ("ep_all_resident_d2", ("flash_decode",
                                                "moe_ffn"))):
        for name in names:
            if paths[path][name] <= 0:
                raise SystemExit(f"{name} was not launched on the "
                                 f"{path} path")
    for path in ("deepseek_all_resident", "deepseek_streaming"):
        if paths[path]["flash_decode"]:
            raise SystemExit(f"flash_decode was launched on the {path} path"
                             " (MLA decode never reaches it)")
    for path in ("jamba_all_resident", "jamba_streaming"):
        if paths[path]["moe_ffn_quant"]:
            raise SystemExit(f"moe_ffn_quant was launched on the {path} "
                             "path (its wire is the master dtype)")
    for path in ("train", "train_grouped"):
        for name in ("flash_decode", "moe_ffn_quant", "wkv6",
                     "selective_scan"):
            if paths[path][name]:
                raise SystemExit(f"{name} was launched on the {path} path")
    if any(paths["blocked_prefill"].values()):
        raise SystemExit("a kernel was launched on the blocked_prefill path "
                         "(prefill attention is plain tensor code)")
    for row in rows:
        # launches over every main-path run, and per run
        by_path = {path: counts[row["name"]]
                   for path, counts in paths.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
