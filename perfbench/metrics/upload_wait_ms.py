"""Device time a decode step's compute stream spends in the slot cache's
commits, waiting for staged host-to-device copies and landing them: the
mean over the window's decode steps of their ``slot.commit`` device ms
(the program's CUDA events; offload cells on the card only)."""
from perfbench.telemetry import window


def read(rec):
    w = window(rec)
    steps = w.named("serve.decode") if w else []
    commits = [w.under(d, "slot.commit") for d in steps]
    if not steps or not all(commits):
        return None
    return sum(c.counters["device_ms"] for cs in commits
               for c in cs) / len(steps)
