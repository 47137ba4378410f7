"""A cell, a configuration, a traffic mix and a per-layer metric are added
as files, and BENCHMARK.json entries, in a copy of the benchmark: the
harness finds each by its name, and no file already there changes. And
BENCHMARK.json's own rules: each per-layer metric moves an end-to-end
metric that its cells report; the reference refuses what it cannot
compute."""
import hashlib
import json
import shutil

import pytest

from perfbench import harness
from perfbench.tests import tiny
from perfbench.tests.common import REPO, SEED, StepClock, run_module


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    before = digests(tmp_path / "perfbench")

    bench_dir = tmp_path / "perfbench"
    (bench_dir / "configs" / "tiny-new.json").write_text(
        json.dumps(dict(tiny.QWEN, name="tiny-new")))
    (bench_dir / "traffic" / "tiny-new-mix.json").write_text(
        json.dumps(dict(tiny.MIX, clients=3)))
    (bench_dir / "cells" / "new.cell.json").write_text(json.dumps({
        "config": "tiny-new", "traffic": "tiny-new-mix", "pool_slots": 3,
        "weight_slots": 9, "transfer_dtype": "fp32", "trace_iters": 2,
        "check": {"requests": 2, "tokens": 8,
                  "limits": {"logit_gap": tiny.LIMIT}}}))
    (bench_dir / "metrics" / "tokens_in_window.py").write_text(
        '"""Output tokens in the window."""\n\n\n'
        "def read(rec):\n    return float(len(rec['tokens']))\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny-new", "source": "test",
                         "file": "perfbench/configs/tiny-new.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "new.cell", "config": "tiny-new",
                           "traffic": "tiny-new-mix", "chips": 1,
                           "why": "test"})
    b["end_to_end"].append({"name": "tokens_in_window", "unit": "tokens",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["new.cell"]})

    rec = harness.run("new.cell", SEED, 1.0, False, "cpu", root=bench_dir,
                      clock=StepClock())
    assert rec["check"]["correct"] is True
    run = run_module()
    got = run.metrics_of(b, "new.cell", False, rec, root=str(tmp_path))
    assert got["tokens_in_window"]["value"] == len(rec["tokens"]) > 0
    assert "tokens_per_s" in got
    # the listed cells never see the new metric
    assert "tokens_in_window" not in run.metrics_of(
        b, "qwen3moe.offload.chat16", False, rec, root=str(tmp_path))
    after = digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before
    assert len(after) == len(before) + 4


def test_every_per_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        listed = set(m.get("workloads", cells))
        assert listed and listed <= cells, m["name"]
        assert listed <= e2e[m["moves"]], m["name"]


@pytest.mark.parametrize("change", [{"n_group": 8, "topk_group": 3},
                                    {"rope_scaling": {"type": "yarn"}}])
def test_a_configuration_the_reference_does_not_compute_is_refused(change):
    from perfbench.reference.dims import dims
    dims(tiny.DSV2)
    with pytest.raises(ValueError, match="reference does not compute"):
        dims(dict(tiny.DSV2, **change))
