"""Reading a ``torch.profiler`` trace of the traced slice.

The slice runs from the first iteration's start to the last one's end,
as the harness's ``perfbench.step`` spans mark them on the profiler's own
clock. Device work is every event the profiler puts on the card: kernels,
copies and fills. What falls outside the slice is clipped.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

STEP = "perfbench.step"


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _length(iv) -> float:
    return sum(b - a for a, b in iv)


def _clip(iv, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in iv if b > lo and a < hi]


def _named(name: str, keys: Sequence[str]) -> bool:
    return any(k in name for k in keys)


def analyse(prof, b1_names: Sequence[str], b3_names: Sequence[str]) -> Dict:
    """-> {"window_s", "busy_s", "link_busy_s", "b1_device_ms",
    "b3_device_ms", "breakdown"} of the slice in ``prof``; with no device
    event, {"window_s"} and zeros that the readers leave out."""
    from torch.autograd import DeviceType
    events = prof.events()
    steps = [e for e in events if e.name == STEP]
    lo = min(e.time_range.start for e in steps)
    hi = max(e.time_range.end for e in steps)
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.name != STEP]
    spans = _clip([(e.time_range.start, e.time_range.end) for e in dev],
                  lo, hi)
    busy = _union(spans)
    link = _union(_clip([(e.time_range.start, e.time_range.end)
                         for e in dev if "HtoD" in e.name], lo, hi))
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us()
    b1 = sum(us for n, us in by_name.items() if _named(n, b1_names))
    b3 = sum(us for n, us in by_name.items() if _named(n, b3_names))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": _length(busy) / 1e6,
        "link_busy_s": _length(link) / 1e6,
        "n_device_events": len(dev),
        "b1_device_ms": b1 / 1e3,
        "b3_device_ms": b3 / 1e3,
        "breakdown": {
            "device_ops": [[n, us / 1e6] for n, us in top],
            "idle_gaps": _idle_gaps(events, busy, lo, hi, DeviceType),
        },
    }


def _idle_gaps(events, busy, lo, hi, DeviceType, n_gaps: int = 400):
    """The device's idle time in the slice by what the host was doing:
    each of the ``n_gaps`` longest gaps named after the innermost host
    event running at its middle, summed by name, the 10 largest."""
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n_gaps]
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: e.time_range.start)
    by_name: Dict[str, float] = {}
    # one sweep in time order: a stack of the host events open at each
    # gap's middle, innermost on top
    stack: List[Tuple[float, str]] = []
    j = 0
    for mid, length in sorted((0.5 * (a + b), b - a) for a, b in gaps):
        while j < len(host) and host[j].time_range.start <= mid:
            e = host[j]
            while stack and stack[-1][0] < e.time_range.start:
                stack.pop()
            stack.append((e.time_range.end, e.name))
            j += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        name = stack[-1][1] if stack else "(no host event)"
        by_name[name] = by_name.get(name, 0.0) + length
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return [[n, us / 1e6] for n, us in top]
