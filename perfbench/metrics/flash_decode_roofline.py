"""B3's share of its roofline in the traced slice: the least time of its
launches (``roofline.b3_ms``: the valid K/V of the active rows, q in, the
output out) over the device time of its kernels."""


def read(rec):
    t = rec["trace"]
    if not t or not t["b3_device_ms"] or not t["b3_least_ms"]:
        return None
    return 100.0 * t["b3_least_ms"] / t["b3_device_ms"]
