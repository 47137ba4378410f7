"""Mean gap between successive output tokens of a request, over every
gap in the window (host clock)."""
from perfbench.window import token_gaps


def read(rec):
    gaps = token_gaps(rec)
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
