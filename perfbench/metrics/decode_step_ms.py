"""Mean time of the window's pooled decode steps, between the CUDA
events the server records around each (``decode_ms``)."""


def read(rec):
    ms = rec["decode_ms"]
    return sum(ms) / len(ms) if ms else None
