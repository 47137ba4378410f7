"""The readers of the program's spans (``perfbench/telemetry.py`` and the
four metrics over it) on a tiny offload cell on the CPU: found on the
harness's own clock, and None, without raising, where the spans cannot be
read (a clock that is not ``time.perf_counter``, a program without the
telemetry module)."""
import sys
import time

import pytest

from perfbench import harness
from perfbench.telemetry import ms, window
from perfbench.tests import tiny
from perfbench.tests.common import SEED, StepClock, as_listed, run_module

CELL = "tiny.qwen3.offload"
SPANS = ("engine_host_ms", "decode_issue_ms", "upload_wait_ms",
         "prefetch_used_pct")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def timed(root):
    """A traced run of the tiny offload cell on the harness's clock."""
    return harness.run(CELL, SEED + 2, 1.0, True, "cpu", root=root,
                       clock=time.perf_counter)


def _metrics(rec):
    return run_module().metrics_of(as_listed(CELL, "qwen3moe.offload.chat16"),
                                   CELL, True, rec)


def test_the_readers_find_the_window_s_spans(timed):
    got = _metrics(timed)
    # no card: no CUDA events around the commits
    assert "upload_wait_ms" not in got
    host, issue, used = (got[k]["value"] for k in
                         ("engine_host_ms", "decode_issue_ms",
                          "prefetch_used_pct"))
    assert host > 0 and issue > 0 and 0 <= used <= 100
    w = window(timed)
    steps = w.named("serve.step")
    assert len(steps) == len(timed["iters"])
    # an iteration's span lies inside the harness's iteration, and the
    # host share plus the device work is the iteration's span
    for s, (t0, t1, _, _) in zip(steps, timed["iters"]):
        assert t0 <= s.t0 <= s.t1 <= t1
    work = sum(ms(c) for s in steps for name in ("serve.prefill",
                                                 "serve.decode")
               for c in w.under(s, name))
    assert host * len(steps) + work == pytest.approx(
        sum(ms(s) for s in steps))
    assert len(w.named("serve.decode")) == len(timed["decode_rows"])


def test_the_readers_read_none_on_another_clock(root):
    rec = harness.run(CELL, SEED, 0.5, True, "cpu", root=root,
                      clock=StepClock())
    assert window(rec) is None
    assert not set(_metrics(rec)) & set(SPANS)


def test_the_readers_read_none_without_the_module(timed, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.serving.telemetry", None)
    assert window(timed) is None
    assert not set(_metrics(timed)) & set(SPANS)
