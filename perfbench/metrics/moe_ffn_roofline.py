"""B1's share of its roofline in the traced slice: the least time of its
launches (``roofline.b1_ms``, from each launch's own routing) over the
device time of its kernels."""


def read(rec):
    t = rec["trace"]
    if not t or not t["b1_device_ms"] or not t["b1_least_ms"]:
        return None
    return 100.0 * t["b1_least_ms"] / t["b1_device_ms"]
