"""Host time of an engine iteration outside its device work: the mean over
the window's iterations of the program's ``serve.step`` span minus its
``serve.prefill`` and ``serve.decode`` spans (the offload engine's
Algorithm-1 walk, the residency sync, retirement, admission)."""
from perfbench.telemetry import ms, window


def read(rec):
    w = window(rec)
    steps = w.named("serve.step") if w else []
    if not steps:
        return None
    return sum(ms(s) - sum(ms(c) for name in ("serve.prefill", "serve.decode")
                           for c in w.under(s, name))
               for s in steps) / len(steps)
