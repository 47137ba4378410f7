"""Launch-time dry run: trace every (arch × input shape × mesh) step over
meta tensors and record its FLOPs, bytes and memory.

The port's counterpart of the reference's ``launch/dryrun.py``, which
lowers and compiles each step with XLA against a TPU mesh. Here the step
is ``Model(cfg, device="meta")`` (parameters with shapes and no data, no
``init``) run eagerly under ``cost_analysis.CostMode``: nothing is
compiled, computed or allocated, and every kernel is a stand-in that
counts its launch (``kernels.meta``). It needs no GPU and runs the same on
a CPU host and on a machine with a card:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k [--multi-pod] [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

One JSON file per combination, with the reference's keys where they have
a meaning: ``status`` (ok / skipped with the reference's ``reason`` /
error), ``kind``, ``overrides``, ``n_devices``; ``memory`` with
``argument_bytes``, ``output_bytes`` and ``temp_bytes`` (the peak held by
tensors the step made; ``code_bytes`` and ``alias_bytes`` are None: there
is no compiled program); ``cost`` and ``cost_corrected`` with the traced
dot FLOPs and bytes (the same numbers: an eager trace sees every layer,
so there is no trip count to correct); ``t_trace_s`` in place of
``t_lower_s``/``t_compile_s``; ``argument_bytes_per_device`` from
``sharding.py``'s specs over the mesh; ``kernels`` (stand-in launches)
and ``n_ops`` (aten ops). The FLOPs and bytes are counted over the whole
unplaced step, which both meshes of a pair share (one trace a pair; a
sweep traces its pairs in ``JOBS`` processes).

``collectives`` is the reference's ``{kind: {"bytes", "count"}}``, one
device's: each step is traced a second time for each mesh, placed
(``sharding.place``: every parameter a DTensor by its spec; the batch by
``batch_spec``; a serving step's cache by ``cache_shardings`` through
``sharding.place_cache``, its sequence over the batch axes when the batch
is smaller than them) on meta over a fake process group of the mesh's
size, with ``spmd.CollectiveCounter`` counting the collectives DTensor's
sharding propagation inserts and the kernel sites' merges issue
(``t_place_s`` is that trace's time). A decode step over a K/V cache
sharded on head_dim all-reduces its partial scores there (B3-qk, then
B3-pv) and gathers no cache. A step that cannot be placed (an op with no
sharding rule, or one the port refuses on a placed model:
``NotImplementedError``) keeps ``collectives`` None, and its
``collectives_reason`` names the op; any other fault is an error record.
The port updates parameters, moments and caches in place, so
``output_bytes`` counts only what the step returns besides them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import torch

from repro_torch.config import INPUT_SHAPES
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import spmd
from repro_torch.launch.cost_analysis import CostMode, nbytes
from repro_torch.launch.input_specs import (decode_inputs, decode_window,
                                            skip_reason, supports_shape,
                                            train_inputs)
from repro_torch.launch.mesh import (Mesh, axis_size, batch_axes,
                                     make_debug_mesh, make_production_mesh)
from repro_torch.launch.sharding import (batch_spec, cache_shardings,
                                         local_bytes, params_shardings, place,
                                         place_cache)
from repro_torch.models import Model
from repro_torch.models.model import layer_descs, split_periodic
from repro_torch.train.loop import make_train_step
from repro_torch.train.optim import OptConfig, adamw_init


def _apply_overrides(cfg, overrides):
    """Apply top-level ArchConfig field overrides ('key=value' strings),
    e.g. moe_dispatch=grouped attn_impl=blocked."""
    if not overrides:
        return cfg
    repl = {}
    for ov in overrides:
        k, v = ov.split("=", 1)
        cur = getattr(cfg, k)
        repl[k] = type(cur)(v) if cur is not None else v
    return dataclasses.replace(cfg, **repl)


def build_step(cfg, shape, *, with_optimizer: bool = False):
    """The step of ``shape.kind`` for ``cfg`` over meta tensors. -> (fn,
    args, model): ``fn(*args)`` runs the step; the model's parameters are
    arguments too.

    train: ``Model.loss`` (remat on) and its backward, then, with the
    optimizer, the port's AdamW (``make_train_step``); prefill:
    ``Model.prefill`` into a cache of the shape's length; decode:
    ``Model.serve_step``, over rings of the window for a sliding-window
    model at long_500k (the reference's ``decode_window`` rule)."""
    model = Model(cfg, device="meta")
    if shape.kind == "train":
        batch = train_inputs(cfg, shape)
        if with_optimizer:
            step = make_train_step(model, OptConfig(), remat=True)
            opt = adamw_init(dict(model.named_parameters()))
            return step, (opt, batch), model
        model.trainable()

        def loss_and_grad(batch):
            loss = model.loss(batch, remat=True)
            loss.backward()
            return loss, [p.grad for p in model.parameters()]
        return loss_and_grad, (batch,), model

    if shape.kind == "prefill":
        batch = train_inputs(cfg, shape)
        cache, _tok = decode_inputs(cfg, shape, model)

        @torch.no_grad()
        def prefill(batch, cache):
            logits, cache, _aux = model.prefill(batch, cache)
            return logits, cache
        return prefill, (batch, cache), model

    cache, token = decode_inputs(cfg, shape, model)
    window = decode_window(cfg, shape)

    @torch.no_grad()
    def serve_step(cache, token):
        logits, cache, _aux = model.serve_step(cache, token,
                                               decode_window=window)
        return logits, cache
    return serve_step, (cache, token), model


def build_lowerable(arch_id: str, shape_name: str, *,
                    with_optimizer: bool = False, overrides=None):
    """``build_step`` for a registered arch and input shape by name."""
    cfg = _apply_overrides(get_config(arch_id), overrides)
    return build_step(cfg, INPUT_SHAPES[shape_name],
                      with_optimizer=with_optimizer)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def trace(fn, args, model) -> dict:
    """Run ``fn(*args)`` under ``CostMode`` -> the record's counts."""
    arg_ts = list(_tensors(args)) + list(model.parameters())
    arg_keys = {t.untyped_storage()._cdata for t in arg_ts}
    t0 = time.time()
    with CostMode() as mode:
        out = fn(*args)
    t_trace = time.time() - t0
    outs = [t for t in _tensors(out)
            if t.untyped_storage()._cdata not in arg_keys]
    return {"dot_flops": mode.dot_flops,
            "bytes_accessed": mode.bytes_accessed,
            "argument_bytes": sum(map(nbytes, arg_ts)),
            "output_bytes": sum(map(nbytes, outs)),
            "temp_bytes": mode.peak_bytes,
            "kernels": dict(mode.kernels), "n_ops": mode.n_ops,
            "t_trace_s": round(t_trace, 1)}


def argument_bytes_per_device(cfg, shape, args, model, mesh,
                              sharding_mode: str = "auto") -> int:
    """One device's share of the step's arguments under ``sharding.py``'s
    specs: parameters (and AdamW's moments, laid out like them), the batch
    over the batch axes, the cache by ``cache_shardings``."""
    params = dict(model.named_parameters())
    pspec = params_shardings(params, mesh, mode=sharding_mode)
    total = sum(local_bytes(p, pspec[n], mesh) for n, p in params.items())
    baxes = batch_axes(mesh)
    bsz = math.prod(axis_size(mesh, a) for a in baxes)
    for a in args:
        if not isinstance(a, dict):                  # the decode token
            rows = (baxes if a.shape[0] % bsz == 0 and a.shape[0] > 1
                    else None)
            total += local_bytes(a, (rows,), mesh)
        elif "mu" in a:                              # AdamW's moments
            total += sum(local_bytes(a[k][n], pspec[n], mesh)
                         for k in ("mu", "nu") for n in params)
        elif "layers" in a:                          # the decode cache
            spec = cache_shardings(a, mesh, cfg,
                                   shard_seq=shape.global_batch < bsz)
            total += local_bytes(a["pos"], spec["pos"], mesh)
            total += sum(local_bytes(t, spec["layers"][i][k], mesh)
                         for i, layer in enumerate(a["layers"])
                         for k, t in layer.items())
        else:                                        # the batch
            for k, t in a.items():
                spec = ((None, baxes) if k == "positions"
                        else batch_spec(mesh))
                total += local_bytes(t, spec, mesh)
    return total


def _batch_merged(mesh):
    """``mesh`` with its batch axes ("pod", "data") as one "data" axis of
    their product (pod-major, as the batch's rows lie over them). Only the
    batch shards over them; DTensor cannot reduce-scatter into a tensor
    dim that two mesh dims shard."""
    baxes = batch_axes(mesh)
    if len(baxes) == 1:
        return mesh
    rest = [a for a in mesh.axis_names if a not in baxes]
    return Mesh(("data", *rest),
                (math.prod(axis_size(mesh, a) for a in baxes),
                 *(axis_size(mesh, a) for a in rest)))


def _placed_trace(cfg, shape, mesh, with_optimizer: bool,
                  n_prefix: int) -> dict:
    """The collectives of one placed step of ``cfg`` at ``shape``: a train
    step whose first ``n_prefix`` layers keep their activations (the rest
    are rematted), or a serving step (``Model.prefill`` into, or
    ``Model.serve_step`` over, a cache placed by ``cache_shardings``)."""
    mesh = _batch_merged(mesh)
    with spmd.fake_group(mesh.size):
        dm = spmd.device_mesh(mesh, "cpu")
        model = place(Model(cfg, device="meta"), dm, mesh)
        model.n_prefix = n_prefix
        counter = spmd.CollectiveCounter()
        if shape.kind != "train":
            rows = math.prod(axis_size(mesh, a) for a in batch_axes(mesh))
            cache, token = decode_inputs(cfg, shape, model)
            cache = place_cache(cache, dm, mesh, cfg,
                                shard_seq=shape.global_batch < rows)
            with torch.no_grad(), counter, spmd.step_context(model):
                if shape.kind == "prefill":
                    model.prefill(train_inputs(cfg, shape), cache)
                else:
                    model.serve_step(cache, token,
                                     decode_window=decode_window(cfg, shape))
        elif with_optimizer:
            step = make_train_step(model, OptConfig(), remat=True)
            opt = adamw_init(dict(model.named_parameters()))
            with counter:
                step(opt, train_inputs(cfg, shape))
        else:
            model.trainable()
            with counter, spmd.step_context(model):
                model.loss(train_inputs(cfg, shape), remat=True).backward()
    return counter.record()


def placed_collectives(cfg, shape, mesh, *,
                       with_optimizer: bool = True) -> dict:
    """One device's collectives in ``cfg``'s step at ``shape`` (train,
    prefill or decode) placed over ``mesh``: the model (and a serving
    step's cache) on meta, placed over a fake group of ``mesh.size`` ranks
    (this process is rank 0). -> the reference's ``collectives`` record.

    Every period group of the layer stack (``split_periodic``: the
    reference's scan groups) has the same parameters, shapes and
    placements, so it issues the same collectives: a stack of more than
    two groups is traced cut to one group and to two, and the counts and
    bytes are the one-group cut's plus the difference times the groups
    past the first (exact: ``tests/test_torch_spmd.py`` holds it against
    the whole stack's trace). The cuts keep the stack's remat layout. A
    multi-pod mesh places over its pod and data axes as one
    (``_batch_merged``): a batch-axis collective is one collective over
    pod × data ranks.

    The mesh is a ``cpu`` one (DTensor propagates a ``cuda`` mesh's shapes
    on fake CUDA tensors, which a host without CUDA cannot make), so the
    counts are those the gloo backend would see: where NCCL swaps a
    sharded dim with an all-to-all, DTensor on a cpu mesh all-gathers and
    slices."""
    n_prefix, period = split_periodic(layer_descs(cfg))
    groups = (cfg.n_layers - n_prefix) // period
    if groups <= 2:
        return _placed_trace(cfg, shape, mesh, with_optimizer, n_prefix)
    one, two = (_placed_trace(
        dataclasses.replace(cfg, n_layers=n_prefix + k * period), shape,
        mesh, with_optimizer, n_prefix) for k in (1, 2))
    return {kind: {f: one[kind][f] + (two[kind][f] - one[kind][f])
                   * (groups - 1) for f in ("count", "bytes")}
            for kind in one}


def _mesh_name(multi_pod: bool, debug_mesh: bool) -> str:
    return ("debug-multi" if multi_pod else "debug") if debug_mesh \
        else ("2x16x16" if multi_pod else "16x16")


_TRACES = {}
# processes a sweep of several (arch, shape) pairs traces in (each holds
# one meta model and its trace: well under a GB)
JOBS = 4


def run_one(arch_id: str, shape_name: str, *, multi_pod: bool,
            debug_mesh: bool = False, with_optimizer: bool = True,
            overrides=None, sharding_mode: str = "auto") -> dict:
    cfg = _apply_overrides(get_config(arch_id), overrides)
    shape = INPUT_SHAPES[shape_name]
    mesh_name = _mesh_name(multi_pod, debug_mesh)
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "status": "ok",
           "overrides": list(overrides or [])}
    if not supports_shape(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = skip_reason(cfg, shape)
        return rec
    mesh = (make_debug_mesh(multi_pod=multi_pod) if debug_mesh
            else make_production_mesh(multi_pod=multi_pod))
    with_opt = with_optimizer and shape.kind == "train"
    fn, args, model = build_lowerable(arch_id, shape_name,
                                      with_optimizer=with_opt,
                                      overrides=overrides)
    key = (arch_id, shape_name, tuple(overrides or ()), with_opt)
    if key not in _TRACES:
        _TRACES[key] = trace(fn, args, model)
    t = _TRACES[key]
    t0 = time.time()
    try:
        coll = placed_collectives(cfg, shape, mesh, with_optimizer=with_opt)
    except NotImplementedError as e:
        # an op DTensor has no sharding rule for, or one the port refuses
        # on a placed model (each names the op): not an error
        coll = None
        rec["collectives_reason"] = (
            f"the placed {shape.kind} step raised "
            f"{type(e).__name__}: {str(e)[:300]}")
    t_place = round(time.time() - t0, 1)
    rec.update(
        cost_corrected={"dot_flops": t["dot_flops"],
                        "bytes_accessed": t["bytes_accessed"]},
        t_trace_s=t["t_trace_s"],
        n_devices=mesh.size,
        memory={"argument_bytes": t["argument_bytes"],
                "output_bytes": t["output_bytes"],
                "temp_bytes": t["temp_bytes"],
                "code_bytes": None, "alias_bytes": None},
        cost={"flops": t["dot_flops"],
              "bytes_accessed": t["bytes_accessed"]},
        collectives=coll, t_place_s=t_place,
        argument_bytes_per_device=argument_bytes_per_device(
            cfg, shape, args, model, mesh, sharding_mode),
        kernels=t["kernels"], n_ops=t["n_ops"],
    )
    return rec


def _cached_ok(path: str) -> bool:
    """Error (or unreadable) records are not cache hits — rerun them, so a
    failed refresh can never permanently shadow a good record in --out."""
    try:
        with open(path) as f:
            return json.load(f).get("status") != "error"
    except (OSError, ValueError):
        return False


def _run_pair(a, s, meshes, opts):
    """Records of one (arch, shape) over ``meshes`` (one trace)."""
    out = []
    for mp in meshes:
        try:
            rec = run_one(a, s, multi_pod=mp, **opts)
        except Exception as e:  # noqa: BLE001
            rec = {"arch": a, "shape": s,
                   "mesh": _mesh_name(mp, opts["debug_mesh"]),
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        out.append((mp, rec))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--debug-mesh", action="store_true",
                    help="the reference's small CI meshes (8/16 devices)")
    ap.add_argument("--no-optimizer", action="store_true")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="ArchConfig override key=value (perf variants), "
                         "e.g. --set moe_dispatch=grouped")
    ap.add_argument("--sharding", default="auto",
                    choices=["auto", "dp_only"])
    ap.add_argument("--tag-suffix", default="",
                    help="suffix for the output JSON tag (variants)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multi_pod]
    opts = dict(debug_mesh=args.debug_mesh,
                with_optimizer=not args.no_optimizer,
                overrides=args.overrides, sharding_mode=args.sharding)

    def path_of(a, s, mp):
        tag = f"{a}__{s}__{'multi' if mp else 'single'}{args.tag_suffix}"
        return tag, os.path.join(args.out, tag + ".json")

    os.makedirs(args.out, exist_ok=True)
    todo = []
    for a in archs:
        for s in shapes:
            left = []
            for mp in meshes:
                tag, path = path_of(a, s, mp)
                if os.path.exists(path) and _cached_ok(path):
                    print(f"[skip] {tag} (cached)")
                else:
                    left.append(mp)
            if left:
                todo.append((a, s, left))

    failures = 0

    def write(a, s, results):
        nonlocal failures
        for mp, rec in results:
            tag, path = path_of(a, s, mp)
            failures += rec["status"] == "error"
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
                f.write("\n")
            print(f"[done] {tag}: {rec['status']}"
                  + (f" ({rec['t_trace_s']}s trace)"
                     if rec["status"] == "ok" else
                     f" — {rec.get('error', rec.get('reason', ''))[:200]}"),
                  flush=True)

    jobs = min(len(todo), JOBS, os.cpu_count() or 1)
    if jobs > 1:
        with ProcessPoolExecutor(jobs,
                                 mp_context=get_context("spawn")) as pool:
            futs = [(a, s, pool.submit(_run_pair, a, s, left, opts))
                    for a, s, left in todo]
            for a, s, fut in futs:
                write(a, s, fut.result())
    else:
        for a, s, left in todo:
            print(f"[run ] {a}__{s} ...", flush=True)
            write(a, s, _run_pair(a, s, left, opts))
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
