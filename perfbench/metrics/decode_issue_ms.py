"""Host time inside a decode step spent not waiting for the card: the mean
over the window's decode steps of the program's ``serve.decode`` span
minus its ``slot.route_wait`` and ``step.readback`` spans (op issue, the
slot cache's demand and planned uploads, the routed ids' bookkeeping)."""
from perfbench.telemetry import ms, window


def read(rec):
    w = window(rec)
    steps = w.named("serve.decode") if w else []
    if not steps:
        return None
    return sum(ms(d) - sum(ms(c) for name in ("slot.route_wait",
                                              "step.readback")
                           for c in w.under(d, name))
               for d in steps) / len(steps)
