"""Share of the traced slice in which a host-to-device copy runs on the
card (device trace)."""


def read(rec):
    t = rec["trace"]
    if not t or not t["n_device_events"] or not t["link_busy_s"]:
        return None
    return 100.0 * t["link_busy_s"] / t["window_s"]
