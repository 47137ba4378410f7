"""The window arithmetic on synthetic host-clock timestamps."""
import importlib.util
from pathlib import Path

import pytest

from perfbench import window

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def read(name, rec):
    spec = importlib.util.spec_from_file_location(f"m_{name}",
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def record(tokens, submit, first, t_open=10.0, t_close=20.0, **kw):
    """A run record holding only the window's tokens, as the harness
    makes it."""
    rec = {"t_open": t_open, "t_close": t_close,
           "tokens": [t for t in tokens if t_open < t[2] <= t_close],
           "submit_t": submit, "first_t": first, "setup_s": 1.0,
           "iters": [], "decode_ms": [], "decode_least_ms": [],
           "decode_rows": [], "slot": None, "trace": None}
    rec.update(kw)
    return rec


def test_tail_is_taken_over_every_gap_of_every_request():
    # request 0: 20 gaps of 0.1 s; request 1: 2 gaps of 1.0 s
    toks = [(0, j, 10.5 + 0.1 * j) for j in range(21)]
    toks += [(1, j, 11.0 + 1.0 * j) for j in range(3)]
    rec = record(toks, {}, {})
    gaps = sorted(window.token_gaps(rec))
    assert len(gaps) == 22
    assert gaps[-2:] == pytest.approx([1.0, 1.0])
    # the mean and the 98th percentile pool all 22 gaps: not a mean of
    # per-request means (0.55 s), nor request 0's tail
    assert read("tpot_ms", rec) == pytest.approx(1e3 * (2.0 + 2.0) / 22)
    assert read("itl_p98_ms", rec) == pytest.approx(
        1e3 * window.percentile(gaps, 98))
    assert 100.0 < read("itl_p98_ms", rec) <= 1000.0


def test_gaps_and_tokens_are_clipped_to_the_window():
    toks = [(0, j, 9.0 + 1.0 * j) for j in range(14)]   # 9.0 .. 22.0
    rec = record(toks, {}, {})
    # tokens at 11..20 are in (10, 20]; gaps need both ends inside
    assert [t[2] for t in rec["tokens"]] == [float(x) for x in range(11, 21)]
    assert len(window.token_gaps(rec)) == 9
    assert read("tokens_per_s", rec) == pytest.approx(10 / 10.0)
    assert read("tpot_ms", rec) == pytest.approx(1000.0)


def test_ttft_counts_from_submission_and_only_inside_the_window():
    submit = {0: 9.0, 1: 12.0, 2: 15.0, 3: 19.5}
    first = {0: 10.5, 1: 12.25, 2: 15.75, 3: 21.0}
    toks = [(r, 0, t) for r, t in first.items()]
    rec = record(toks, submit, first)
    # 0 was submitted before the window, 3 answered after it
    assert sorted(window.ttfts(rec)) == pytest.approx([0.25, 0.75])
    assert read("ttft_p50_ms", rec) == pytest.approx(500.0)


def test_readers_find_nothing_where_there_is_nothing_to_read():
    rec = record([], {}, {})
    for name in ("tpot_ms", "itl_p98_ms", "ttft_p50_ms", "decode_rows_mean",
                 "prefill_iter_ms", "decode_step_ms", "decode_mfu_pct",
                 "slot_hit_pct", "link_busy_pct", "moe_ffn_roofline",
                 "flash_decode_roofline", "device_idle_pct"):
        assert read(name, rec) is None, name
    # a trace with no device event gives no device share, never a 0
    rec["trace"] = {"n_device_events": 0, "window_s": 1.0, "busy_s": 0.0,
                    "link_busy_s": 0.0, "b1_device_ms": 0.0,
                    "b1_least_ms": 1.0, "b3_device_ms": 0.0,
                    "b3_least_ms": 1.0}
    for name in ("link_busy_pct", "moe_ffn_roofline", "flash_decode_roofline",
                 "device_idle_pct"):
        assert read(name, rec) is None, name


def test_shares_from_a_trace_and_the_decode_steps():
    rec = record([], {}, {}, decode_ms=[10.0, 30.0],
                 decode_least_ms=[2.0, 6.0], decode_rows=[3, 4],
                 iters=[(0.0, 0.5, 1, 3), (0.5, 0.6, 0, 4)],
                 slot={"hits": 30, "misses": 10},
                 trace={"n_device_events": 5, "window_s": 2.0,
                        "busy_s": 1.5, "link_busy_s": 0.5,
                        "b1_device_ms": 4.0, "b1_least_ms": 3.0,
                        "b3_device_ms": 2.0, "b3_least_ms": 0.5})
    assert read("decode_mfu_pct", rec) == pytest.approx(20.0)
    assert read("decode_step_ms", rec) == pytest.approx(20.0)
    assert read("decode_rows_mean", rec) == pytest.approx(3.5)
    assert read("prefill_iter_ms", rec) == pytest.approx(500.0)
    assert read("slot_hit_pct", rec) == pytest.approx(75.0)
    assert read("device_idle_pct", rec) == pytest.approx(25.0)
    assert read("link_busy_pct", rec) == pytest.approx(25.0)
    assert read("moe_ffn_roofline", rec) == pytest.approx(75.0)
    assert read("flash_decode_roofline", rec) == pytest.approx(25.0)
