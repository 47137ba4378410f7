"""Median time from a request's submission to its first token, over the
requests submitted and answered in the window (host clock)."""
from perfbench.window import percentile, ttfts


def read(rec):
    xs = ttfts(rec)
    return 1e3 * percentile(xs, 50) if xs else None
