"""Shared pieces of the benchmark's CPU tests."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 11          # seeds run past 32 signed bits


class StepClock:
    """A clock that advances one fixed tick at every reading, so that a
    window of s seconds is a fixed number of engine steps however loaded
    the machine is."""

    def __init__(self, tick: float = 0.01):
        self.t, self.tick = 0.0, tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t


def run_module():
    """``perfbench/run.py`` as a module (its result and metric readers)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_run", REPO / "perfbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def as_listed(cell: str, as_: str) -> dict:
    """BENCHMARK.json with every metric's cell list naming ``cell`` in the
    place of ``as_`` (a tiny stand-in for a listed cell)."""
    b = bench()
    for m in b["end_to_end"] + b["per_layer"]:
        if as_ in m.get("workloads", [as_]):
            m["workloads"] = [cell]
        else:
            m["workloads"] = []
    return b
