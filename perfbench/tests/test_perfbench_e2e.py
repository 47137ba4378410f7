"""The closed-loop driver, the metric readers and the check, end to end on
tiny cells of both families on the CPU, through the harness's entry."""
import json
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests import tiny
from perfbench.tests.common import (REPO, SEED, StepClock, as_listed,
                                    run_module)

# tiny cell -> the listed cell whose metrics it stands in for (no listed
# cell serves DeepSeek-V2 or keeps every expert resident; their tiny cells
# drive the MLA path and the fused step under the offload cell's metrics,
# whose slot-cache readers find nothing in an all-resident run)
STANDS_IN = {"tiny.qwen3.offload": "qwen3moe.offload.chat16",
             "tiny.dsv2.offload": "qwen3moe.offload.chat16",
             "tiny.qwen3.resident": "qwen3moe.offload.chat16"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(STANDS_IN))
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_serves_measures_and_checks(root, cell, trace):
    rec = harness.run(cell, SEED, 1.0, trace, "cpu", root=root,
                      clock=StepClock())
    run = run_module()
    out = run.result(as_listed(cell, STANDS_IN[cell]), cell, trace, rec,
                     "cpu", 1)
    json.dumps(out)
    assert out["correct"] is True
    assert list(out)[-1] == "check"
    (name, (value, limit)), = rec["check"]["numbers"].items()
    assert name == ("logit_gap_mean" if "resident" in cell else "logit_gap")
    assert out["check"] == {name: {"value": value, "limit": limit}}
    assert 0.0 <= value <= limit
    assert rec["check"]["tokens"] >= 12 and rec["check"]["requests"] >= 1
    assert out["attempted"] > 0 and out["failed"] == 0
    got = set(out["metrics"])
    if not trace:
        assert got == {"tokens_per_s", "tpot_ms", "itl_p98_ms",
                       "ttft_p50_ms", "setup_s"}
        assert all(m["value"] > 0 for m in out["metrics"].values())
    else:
        # no device on the CPU: the device's readers find nothing
        want = {"decode_rows_mean", "prefill_iter_ms"}
        if "offload" in cell:
            want.add("slot_hit_pct")
        assert got == want
        assert 0 < out["metrics"]["decode_rows_mean"]["value"] <= 2
        t = rec["trace"]
        assert t["n_device_events"] == 0 and t["window_s"] > 0
        # every B1 launch of the slice paired with its layer's routing
        assert t["b1_launches"] > 0 and t["b1_least_ms"] > 0
        assert (t["b3_launches"] > 0) == ("qwen3" in cell)


def test_every_client_keeps_one_request_in_flight(root):
    rec = harness.run("tiny.qwen3.resident", SEED + 1, 1.0, False, "cpu",
                      root=root, clock=StepClock())
    # the window's rows average close to the pool: a finished request's
    # client submits its next one at once
    rows = rec["decode_rows"]
    assert rows and sum(rows) / len(rows) > 1.5
    firsts = [t for t in rec["tokens"] if t[1] == 0]
    assert firsts, "no request started inside the window"


def test_the_same_seed_serves_the_same_tokens(root):
    a, b = (harness.run("tiny.dsv2.offload", SEED, 0.5, False, "cpu",
                        root=root, clock=StepClock()) for _ in range(2))
    assert a["check"]["numbers"] == b["check"]["numbers"]


def test_run_refuses_to_measure_without_a_card():
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "qwen3moe.offload.chat16", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "not measuring" in p.stderr
