"""Prefetch precision: of the experts the slot cache staged ahead of use
and then either routed to or evicted in the window, the share routed to
(the window's deltas of ``prefetch_used`` / (``prefetch_used`` +
``prefetch_unused_evicted``), from the program's ``serve.step`` spans;
offload cells only)."""
from perfbench.telemetry import window


def read(rec):
    w = window(rec)
    counts = [s.counters for s in w.named("serve.step")
              if s.counters] if w else []
    used = sum(c["prefetch_used"] for c in counts)
    unused = sum(c["prefetch_unused_evicted"] for c in counts)
    if not used + unused:
        return None
    return 100.0 * used / (used + unused)
