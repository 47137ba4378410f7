"""The whole decode step's share of the chip's roofline: the least time of
the window's decode steps (``roofline.decode_step_ms``: the larger of
their operations at 989 TFLOP/s and the bytes they must read at 3.35
TB/s) over their measured time (``decode_ms``)."""


def read(rec):
    ms, least = rec["decode_ms"], rec["decode_least_ms"]
    if not ms or len(least) != len(ms):
        return None
    return 100.0 * sum(least) / sum(ms)
