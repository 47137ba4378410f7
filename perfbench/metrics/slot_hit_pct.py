"""Slot-cache hits over hits and misses, the window's deltas of the
slot cache's counters (offload cells only)."""


def read(rec):
    s = rec["slot"]
    if not s or not s["hits"] + s["misses"]:
        return None
    return 100.0 * s["hits"] / (s["hits"] + s["misses"])
