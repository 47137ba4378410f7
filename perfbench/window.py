"""Window arithmetic over a run's host-clock record.

A token belongs to the window when it appeared after the window opened
and no later than it closed (``rec["tokens"]`` holds only those). A gap is
the time between two successive tokens of one request, both in the
window. A time to first token runs from a request's submission, in the
window, to its first token, in the window. Every statistic is over the
whole window.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def window_s(rec) -> float:
    return rec["t_close"] - rec["t_open"]


def token_gaps(rec) -> List[float]:
    by_rid: Dict[int, Dict[int, float]] = {}
    for rid, j, t in rec["tokens"]:
        by_rid.setdefault(rid, {})[j] = t
    out = []
    for toks in by_rid.values():
        for j, t in toks.items():
            if j - 1 in toks:
                out.append(t - toks[j - 1])
    return out


def ttfts(rec) -> List[float]:
    lo, hi = rec["t_open"], rec["t_close"]
    return [rec["first_t"][rid] - t for rid, t in rec["submit_t"].items()
            if t >= lo and rid in rec["first_t"]
            and rec["first_t"][rid] <= hi]


def percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))
