"""The program's own spans over the measured window: the benchmark's one
reader of ``repro_torch.serving.telemetry``.

The program keeps its latest spans in a process-wide ring, each with a
name, a start and an end on ``time.perf_counter`` (the harness's clock),
its id, its parent's id and its counters. ``window(rec)`` gives the
spans of the window's iterations: each ``serve.step`` that lies inside
``[t_open, t_close]`` and every span under it. It gives None, and never
raises, where they cannot be read whole: a program without the telemetry
module, a ring that no longer reaches back to the window's opening, or a
number of ``serve.step`` spans other than the window's iterations (as
under a clock that is not ``time.perf_counter``).
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Set

STEP = "serve.step"


def ms(s) -> float:
    return 1e3 * (s.t1 - s.t0)


class Window:
    """The window's spans by name, and which iteration or span each lies
    under."""

    def __init__(self, spans: list):
        by_id = {s.id: s for s in spans}
        self._up: Dict[int, Set[int]] = {}
        self._named: Dict[str, list] = {}
        for s in spans:
            up, p = set(), s.parent
            while p in by_id:
                up.add(p)
                p = by_id[p].parent
            if s.name == STEP or any(by_id[u].name == STEP for u in up):
                self._up[s.id] = up
                self._named.setdefault(s.name, []).append(s)

    def named(self, name: str) -> List:
        return self._named.get(name, [])

    def under(self, top, name: str) -> List:
        """The spans called ``name`` nested, at any depth, in ``top``."""
        return [s for s in self.named(name) if top.id in self._up[s.id]]


def window(rec: dict) -> Optional[Window]:
    try:
        telemetry = importlib.import_module("repro_torch.serving.telemetry")
    except ImportError:
        return None
    ring = telemetry.spans()
    lo, hi = rec["t_open"], rec["t_close"]
    if not ring or (len(ring) >= telemetry.RING_SIZE and ring[0].t1 > lo):
        return None
    inside = [s for s in ring if lo <= s.t0 and s.t1 <= hi]
    if sum(s.name == STEP for s in inside) != len(rec["iters"]):
        return None
    return Window(inside)
