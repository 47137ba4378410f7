"""Output tokens emitted in the window over the window's length (host
clock)."""
from perfbench.window import window_s


def read(rec):
    return len(rec["tokens"]) / window_s(rec)
