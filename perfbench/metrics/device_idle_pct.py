"""Share of the traced slice with no kernel, copy or fill on the card
(device trace)."""


def read(rec):
    t = rec["trace"]
    if not t or not t["n_device_events"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
