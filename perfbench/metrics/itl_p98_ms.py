"""98th percentile of the gaps between successive output tokens, over
every gap in the window (host clock)."""
from perfbench.window import percentile, token_gaps


def read(rec):
    gaps = token_gaps(rec)
    return 1e3 * percentile(gaps, 98) if gaps else None
