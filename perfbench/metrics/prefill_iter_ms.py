"""Mean host-clock time of the window's iterations that ran a prefill
(with the pooled decode step they carry)."""


def read(rec):
    ts = [t1 - t0 for t0, t1, first, _ in rec["iters"] if first]
    return 1e3 * sum(ts) / len(ts) if ts else None
