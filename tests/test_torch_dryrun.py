"""The port's launch-time analysis (``repro_torch.launch``: mesh,
sharding, input_specs, cost_analysis, roofline, dryrun) against the
reference's on the CPU. JAX builds the reference side only: its sharding
rules over an ``AbstractMesh`` of the same axes, its ``ShapeDtypeStruct``
inputs, and ``hlo_analysis.analyze_hlo`` of its compiled step."""
import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.config import INPUT_SHAPES, InputShape
from repro.configs import ARCH_IDS, ASSIGNED_ARCHS, get_config
from repro.launch import input_specs as jinput
from repro.launch import sharding as jsharding
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import Model as JaxModel
from repro_torch.configs import get_config as torch_get_config
from repro_torch.launch import dryrun, input_specs, mesh, roofline, sharding
from repro_torch.models import Model
from repro_torch.params import reference_leaves

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
MESHES = {"debug": mesh.make_debug_mesh(),
          "debug-multi": mesh.make_debug_mesh(multi_pod=True),
          "16x16": mesh.make_production_mesh()}


def _abstract(m):
    return AbstractMesh(m.sizes, m.axis_names)


def _spec(ps, n=None):
    """A PartitionSpec as a tuple, padded with None to ``n`` entries; an
    entry of one axis name in a tuple reads as the name (``PartitionSpec``
    stores it so)."""
    t = tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
              for a in ps)
    return t + (None,) * ((n or len(t)) - len(t))


def _by_port_name(tm, tree, leaves):
    """{port parameter name: the reference leaf at the same place} for a
    tree of the reference params' structure whose leaves are ``leaves``
    (any objects): index arrays stand in for the leaves so that
    ``reference_leaves`` can unstack them."""
    flat, treedef = jax.tree.flatten(tree)
    idx = jax.tree.unflatten(treedef, [np.full(s.shape, i, np.int64)
                                       for i, s in enumerate(flat)])
    return {n: leaves[int(np.asarray(a).flat[0])]
            for n, a in reference_leaves(tm, idx).items()}


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_shardings_equal_reference(arch, mesh_name):
    """Every parameter's spec equals the reference's (its scan-group entry
    dropped), in "auto" and "dp_only" modes."""
    m = MESHES[mesh_name]
    jm = JaxModel(get_config(arch).reduced())
    shapes = jm.init_shapes()
    tm = Model(torch_get_config(arch).reduced(), device="meta")
    params = dict(tm.named_parameters())
    for mode in ("auto", "dp_only"):
        ref = jax.tree.leaves(jsharding.params_shardings(
            shapes, _abstract(m), mode=mode))
        want = _by_port_name(tm, shapes, [s.spec for s in ref])
        got = sharding.params_shardings(params, m, mode=mode)
        assert set(got) == set(want)
        for n, p in params.items():
            w = tuple(want[n])
            if len(w) == p.dim() + 1:          # the scan-group entry
                w = w[1:]
            assert _spec(got[n], p.dim()) == _spec(w, p.dim()), \
                (n, got[n], want[n])


def _ref_cache_specs(jm, tm, cache_shapes, ref_shardings):
    """The reference cache's specs placed at the port's layers: prefix
    layer i is layer i, block position j of group g is layer n_prefix +
    g * period + j (its spec without the group entry)."""
    out = [None] * len(tm.layers)
    for i, layer in enumerate(ref_shardings["prefix"]):
        out[i] = {k: _spec(s.spec, len(cache_shapes["prefix"][i][k].shape))
                  for k, s in layer.items()}
    for j, layer in enumerate(ref_shardings["blocks"]):
        for g in range(tm.n_groups):
            out[tm.n_prefix + g * tm.period + j] = {
                k: _spec(s.spec, len(cache_shapes["blocks"][j][k].shape))[1:]
                for k, s in layer.items()}
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_equal_reference(arch, mesh_name):
    """Every cache leaf's spec equals the reference's, batch-sharded (B 16)
    and context-parallel (B 1, ``shard_seq``)."""
    m = MESHES[mesh_name]
    jcfg, cfg = get_config(arch).reduced(), torch_get_config(arch).reduced()
    jm, tm = JaxModel(jcfg), Model(cfg, device="meta")
    for B, shard_seq in ((16, False), (1, True)):
        shapes = jax.eval_shape(lambda: jm.init_cache(B, 64))
        ref = jsharding.cache_shardings(shapes, _abstract(m), jcfg,
                                        shard_seq=shard_seq)
        got = sharding.cache_shardings(tm.init_cache(B, 64), m, cfg,
                                       shard_seq=shard_seq)
        assert _spec(got["pos"], 1) == _spec(ref["pos"].spec, 1)
        want = _ref_cache_specs(jm, tm, shapes, ref)
        for i, (g, w) in enumerate(zip(got["layers"], want)):
            assert {k: _spec(v, len(w[k])) for k, v in g.items()} == w, i


def test_local_shape_and_bytes():
    m = mesh.make_production_mesh(multi_pod=True)
    assert m.size == 512 and mesh.batch_axes(m) == ("pod", "data")
    spec = (("pod", "data"), None, "model")
    assert sharding.local_shape((64, 3, 32), spec, m) == (2, 3, 2)
    t = torch.empty((64, 3, 32), dtype=torch.bfloat16, device="meta")
    assert sharding.local_bytes(t, spec, m) == 2 * 3 * 2 * 2
    assert sharding.local_bytes(t, (None,), m) == 64 * 3 * 32 * 2
    assert mesh.axis_size(mesh.make_debug_mesh(), "pod") == 1


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------


def _sds(x):
    return tuple(x.shape), str(x.dtype)


def _meta(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_inputs_equal_reference_shapes_and_dtypes(arch):
    """train_inputs / decode_inputs: every field, cache leaf and token has
    the reference's shape and dtype, for every supported input shape."""
    jcfg, cfg = get_config(arch), torch_get_config(arch)
    am = _abstract(MESHES["16x16"])
    tm = Model(cfg, device="meta")
    for name, shape in INPUT_SHAPES.items():
        assert input_specs.supports_shape(cfg, shape) == \
            jinput.supports_shape(jcfg, shape)
        assert input_specs.skip_reason(cfg, shape) == \
            jinput.skip_reason(jcfg, shape)
        if not input_specs.supports_shape(cfg, shape):
            continue
        if shape.kind != "decode":
            want = jinput.train_inputs(jcfg, shape, am)
            got = input_specs.train_inputs(cfg, shape)
            assert {k: _meta(v) for k, v in got.items()} == \
                {k: _sds(v) for k, v in want.items()}, name
        jc, jt = jinput.decode_inputs(jcfg, shape, am)
        tc, tt = input_specs.decode_inputs(cfg, shape, tm)
        assert _meta(tt) == _sds(jt) and _meta(tc["pos"]) == _sds(jc["pos"])
        for i, layer in enumerate(jc["prefix"]):
            assert {k: _meta(v) for k, v in tc["layers"][i].items()} == \
                {k: _sds(v) for k, v in layer.items()}, (name, i)
        jm = JaxModel(jcfg)
        for j, layer in enumerate(jc["blocks"]):
            want = {k: (tuple(v.shape[1:]), str(v.dtype))
                    for k, v in layer.items()}
            for g in range(tm.n_groups):
                got = tc["layers"][tm.n_prefix + g * tm.period + j]
                assert {k: _meta(v) for k, v in got.items()} == want
        assert tm.n_groups == jm.n_groups


# ---------------------------------------------------------------------------
# cost analysis against the reference's HLO analysis
# ---------------------------------------------------------------------------


def _reference_dot_flops(arch, shape):
    """``analyze_hlo`` of the reference's compiled step on one CPU device
    (the step of ``repro.launch.dryrun.build_lowerable``, at a reduced
    config and shape)."""
    jm = JaxModel(get_config(arch).reduced())
    ps = jm.init_shapes()
    B, S = shape.global_batch, shape.seq_len
    toks = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    cache = jax.eval_shape(lambda: jm.init_cache(B, S))
    if shape.kind == "train":
        fn = lambda p, b: jax.value_and_grad(          # noqa: E731
            lambda q: jm.loss(q, b, remat=True))(p)
        args = (ps, toks)
    elif shape.kind == "prefill":
        fn = lambda p, b, c: jm.prefill(p, b, c)[:2]    # noqa: E731
        args = (ps, toks, cache)
    else:
        fn = lambda p, c, t: jm.serve_step(p, c, t)[:2]  # noqa: E731
        args = (ps, cache, jax.ShapeDtypeStruct((B,), jnp.int32))
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()) \
        .dot_flops


def _train_extra(arch, shape):
    """What the port's train step computes beyond the reference's dots,
    exactly:
    - qwen3-moe: ``MoEFFN``'s backward recomputes x·W_gate and x·W_up
      (2 of B1's 3 products per expert, 2·E·C·d·f each) where the
      reference's autodiff reuses the remat's forward;
    - rwkv6: the remat recomputes each layer's forward, B4's r·S products
      included (2·BH·T·hd² a layer); XLA drops that recomputed output as
      dead code (the backward needs only the states), the port's eager
      recompute runs it; and B4's backward kernel takes 4 products a state
      element and step (S·do, A·v, Aᵀ·k, G ⊙ S's row sums: 8·BH·T·hd² a
      layer) where XLA's differentiation of the scan takes the 2
      gradients of r·S (4·BH·T·hd²);
    - qwen2-1.5b: nothing."""
    cfg = torch_get_config(arch).reduced()
    T = shape.global_batch * shape.seq_len
    if cfg.moe is not None:
        from repro_torch.models.moe import capacity
        m = cfg.moe
        C = capacity(T, m)
        return len(Model(cfg, device="meta").moe_layers) * 2 * (
            2.0 * m.n_experts * C * cfg.d_model * m.d_expert)
    if cfg.rwkv is not None:
        return cfg.n_layers * (2.0 + 4.0) * T * cfg.d_model \
            * cfg.rwkv.head_dim
    return 0.0


@pytest.mark.parametrize("kind,B,S", [("decode", 4, 32), ("prefill", 2, 32),
                                      ("train", 2, 32)])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "qwen2-1.5b",
                                  "rwkv6-7b"])
def test_dot_flops_equal_reference_hlo(arch, kind, B, S):
    """Decode and prefill: the traced dot FLOPs equal the reference's HLO
    count within 0.5 %. Train with remat: equal once ``_train_extra``
    (work the port does and the reference does not) is added, to 1e-9."""
    shape = InputShape("t", S, B, kind)
    want = _reference_dot_flops(arch, shape)
    fn, args, model = dryrun.build_step(torch_get_config(arch).reduced(),
                                        shape)
    got = dryrun.trace(fn, args, model)["dot_flops"]
    if kind == "train":
        np.testing.assert_allclose(got, want + _train_extra(arch, shape),
                                   rtol=1e-9)
    else:
        np.testing.assert_allclose(got, want, rtol=5e-3)


def test_cost_mode_counts_bytes_kernels_and_peak():
    """On a tiny decode step: the B3 stand-in counts one launch per layer;
    bytes, peak and arguments are positive and the peak is at least the
    largest tensor the step makes (the (B, V) fp32 logits); the outputs
    are what the step returns besides its in-place updates."""
    cfg = torch_get_config("qwen3-1.7b").reduced()
    shape = InputShape("t", 16, 2, "decode")
    fn, args, model = dryrun.build_step(cfg, shape)
    rec = dryrun.trace(fn, args, model)
    assert rec["kernels"] == {"flash_decode": cfg.n_layers}
    assert rec["bytes_accessed"] > rec["argument_bytes"] / 2
    assert rec["temp_bytes"] >= 2 * cfg.vocab * 4
    # the (B, V) logits and the cache's new (B,) int32 positions; the K/V
    # rows are written in place
    assert rec["output_bytes"] == 2 * cfg.vocab * 4 + 2 * 4


def _on_meta(*shape):
    return torch.empty(shape, device="meta")


# each stand-in that checks its kernel's head dims: (the module of the
# wrapper's HEAD_DIMS, a call at head dim hd)
STAND_INS = {
    "flash_decode": ("flash_decode", lambda meta, hd: meta.flash_decode(
        _on_meta(2, 8, hd), _on_meta(2, 16, 2, hd), _on_meta(2, 16, 2, hd))),
    "decode_scores": ("decode_split", lambda meta, hd: meta.decode_scores(
        _on_meta(2, 8, hd), _on_meta(2, 16, 2, hd))),
    "decode_values": ("decode_split", lambda meta, hd: meta.decode_values(
        _on_meta(2, 8, 16), _on_meta(2, 16, 2, hd))),
    "wkv6": ("wkv6", lambda meta, hd: meta.wkv6(
        *(_on_meta(4, 3, hd) for _ in "rkvw"), _on_meta(4, hd),
        _on_meta(4, hd, hd))),
}


@pytest.mark.parametrize("name", list(STAND_INS))
def test_meta_stand_in_refuses_what_its_kernel_refuses(name):
    """A kernel's meta stand-in (the dry run's) takes every head dim of
    its wrapper's ``HEAD_DIMS`` and raises the wrapper's ``ValueError``
    outside it (one below the smallest, one between, one past the
    largest), with no kernel library built or loaded."""
    import importlib
    from repro_torch.kernels import build, meta
    module, call = STAND_INS[name]
    dims = importlib.import_module(f"repro_torch.kernels.{module}").HEAD_DIMS
    for hd in dims:
        call(meta, hd)
    for hd in (dims[0] // 2, dims[0] + 1, dims[-1] * 2):
        with pytest.raises(ValueError, match=f"{name} kernel takes"):
            call(meta, hd)
    assert not build._libs


# ---------------------------------------------------------------------------
# roofline and the CLI
# ---------------------------------------------------------------------------


def _functions(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    return {n.name: ast.dump(n) for n in tree.body
            if isinstance(n, ast.FunctionDef)}


@pytest.mark.parametrize("name", ["_attn_context_flops", "model_flops_for",
                                  "load_records"])
def test_roofline_copies_are_the_reference(name):
    ref = _functions(REPO / "src/repro/launch/roofline.py")
    port = _functions(REPO / "src/repro_torch/launch/roofline.py")
    assert port[name] == ref[name]


def test_roofline_analyze_on_the_h100():
    rec = {"n_devices": 1, "cost_corrected": {"dot_flops": 989e12,
                                              "bytes_accessed": 6.7e12}}
    r = roofline.analyze(rec, 494.5e12)
    assert (r.compute_s, r.memory_s, r.dominant) == (1.0, 2.0, "memory")
    assert r.collective_s is None and r.useful_ratio == 0.5


def _main(argv):
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv)
    return e.value.code


def test_main_writes_ok_and_skipped_records(tmp_path):
    """Full-size records on meta: skipped with the reference's reason,
    ok on both meshes with the reference's keys, and a ``--set`` variant;
    a second run takes them from the cache."""
    out = str(tmp_path)
    assert _main(["--arch", "qwen3-1.7b", "--shape", "long_500k", "--out",
                  out]) == 0
    rec = json.loads((tmp_path / "qwen3-1.7b__long_500k__single.json")
                     .read_text())
    assert rec["status"] == "skipped"
    assert rec["reason"] == jinput.skip_reason(get_config("qwen3-1.7b"),
                                               INPUT_SHAPES["long_500k"])
    assert _main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                  "--both-meshes", "--out", out]) == 0
    recs = [json.loads((tmp_path / f"qwen2-1.5b__decode_32k__{m}.json")
                       .read_text()) for m in ("single", "multi")]
    for rec, n_dev, name in zip(recs, (256, 512), ("16x16", "2x16x16")):
        assert rec["status"] == "ok" and rec["n_devices"] == n_dev
        assert rec["mesh"] == name
        # the placed decode step's collectives, in the reference's kinds,
        # give the roofline a collective term
        assert set(rec["collectives"]) == {
            "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute"} and "collectives_reason" not in rec
        # its 2 KV heads do not split over the model axis's 16: the
        # cache is sharded on head_dim, and decode all-reduces the partial
        # scores (B3-qk, B3-pv) instead of gathering it; no record carries
        # a note of a gathered cache
        assert "collectives_note" not in rec
        assert rec["collectives"]["all-reduce"]["count"] > 0
        coll = sum(v["bytes"] for v in rec["collectives"].values())
        r = roofline.analyze(rec, 1.0)
        assert coll > 0 and r.collective_s == coll / roofline.LINK_BW
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes", "code_bytes",
                                      "alias_bytes"}
        assert rec["cost"] == {"flops": rec["cost_corrected"]["dot_flops"],
                               "bytes_accessed":
                                   rec["cost_corrected"]["bytes_accessed"]}
        assert 0 < rec["argument_bytes_per_device"] \
            < rec["memory"]["argument_bytes"]
        assert rec["kernels"] == {"flash_decode": 28}
    assert recs[1]["argument_bytes_per_device"] \
        < recs[0]["argument_bytes_per_device"]
    assert _main(["--arch", "qwen3-moe-235b-a22b", "--shape", "decode_32k",
                  "--set", "moe_dispatch=grouped", "--set",
                  "attn_impl=blocked", "--tag-suffix", "_var", "--out",
                  out]) == 0
    rec = json.loads((tmp_path / "qwen3-moe-235b-a22b__decode_32k__single"
                      "_var.json").read_text())
    assert rec["overrides"] == ["moe_dispatch=grouped", "attn_impl=blocked"]
    # grouped dispatch on a placed model: the record is ok, with its
    # collectives (each rank's rows, B1 over its experts' blocks)
    assert rec["status"] == "ok" and "collectives_reason" not in rec
    assert set(rec["collectives"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert rec["collectives"]["all-reduce"]["count"] > 0
    assert rec["kernels"] == {"flash_decode": 94, "moe_ffn": 94}
    before = sorted(p.stat().st_mtime_ns for p in tmp_path.iterdir())
    assert _main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                  "--both-meshes", "--out", out]) == 0
    assert sorted(p.stat().st_mtime_ns for p in tmp_path.iterdir()) == before


def test_report_prints_a_row_per_record(tmp_path, capsys):
    """``python -m repro_torch.launch.report --dir`` over records that
    ``dryrun.main`` wrote: one §Dry-run row per record, its collective
    column each record's ``collectives``, and a §Roofline row per 16x16
    record with its collective term; ``--md`` fills a file's markers."""
    from repro_torch.launch import report
    out = str(tmp_path)
    assert _main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                  "--both-meshes", "--out", out]) == 0
    assert _main(["--arch", "qwen3-1.7b", "--shape", "long_500k", "--out",
                  out]) == 0
    recs = roofline.load_records(out)
    md = tmp_path / "report.md"
    md.write_text("# x\n<!-- DRYRUN_TABLE -->\n<!-- ROOFLINE_TABLE -->\n")
    capsys.readouterr()
    report.main(["--dir", out, "--md", str(md)])
    text = capsys.readouterr().out
    rows = [line for line in text.splitlines()
            if line.startswith(("| qwen2-1.5b", "| qwen3-1.7b"))]
    dry, roof = rows[:len(recs)], rows[len(recs):]
    assert len(recs) == 3 and len(dry) == 3 and len(roof) == 1
    for rec in recs:
        row = next(r for r in dry
                   if r.startswith(f"| {rec['arch']} | {rec['shape']} | "
                                   f"{rec.get('mesh', '-')} |"))
        cell = row.rstrip(" |").rsplit("| ", 1)[1]
        if rec["status"] == "ok":
            assert cell == report.collective_cell(rec["collectives"])
            assert all(f"{k.replace('collective-', 'c-')}:"
                       f"{report.fmt_bytes(v['bytes'])}" in cell
                       for k, v in rec["collectives"].items() if v["count"])
        else:
            assert "skipped" in row
    r = roofline.analyze(next(x for x in recs if x.get("mesh") == "16x16"),
                         1.0)
    assert f"| {r.collective_s:.2e} |" in roof[0]
    assert "report: 2 ok, 1 skipped, 0 error" in text
    assert dry[0] in md.read_text() and roof[0] in md.read_text()


def test_train_record_counts_the_step_against_model_flops(tmp_path):
    """qwen2-1.5b train_4k without the optimizer: the traced dot FLOPs
    exceed ``model_flops_for`` (the remat recomputes the forward) by less
    than the forward itself, and the roofline names a dominant term; the
    placed step's collectives give it a collective term over NVLink."""
    assert _main(["--arch", "qwen2-1.5b", "--shape", "train_4k",
                  "--no-optimizer", "--out", str(tmp_path)]) == 0
    rec = roofline.load_records(str(tmp_path))[0]
    cfg = torch_get_config("qwen2-1.5b")
    mf = roofline.model_flops_for(cfg, INPUT_SHAPES["train_4k"], "train")
    r = roofline.analyze(rec, mf)
    assert 1.0 < r.flops / mf < 4 / 3 + 0.05
    assert r.dominant in ("compute", "memory", "collective")
    assert r.compute_s > 0
    coll = sum(v["bytes"] for v in rec["collectives"].values())
    assert set(rec["collectives"]) == {"all-gather", "all-reduce",
                                       "reduce-scatter", "all-to-all",
                                       "collective-permute"}
    assert coll > 0 and r.collective_bytes_per_dev == coll
    assert r.collective_s == coll / roofline.LINK_BW
