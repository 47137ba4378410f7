"""Runtime counterpart of the static recompile-hazard rule (R1).

The linter proves the *shape* of the code can't retrace; this guard proves
the *run* didn't. Both servers count jit traces with a trace-time side
effect (``_count(key)`` inside the jitted impl — it executes only while
XLA is tracing, never on the compiled fast path). ``recompile_guard``
arms a per-key trace limit on the server (and its slot runtime, which
shares the same counts dict): any key traced more than
``max_traces_per_key`` times raises :class:`RecompileError` at the exact
trace that violated the budget, with the offending entry-point key in the
message.

Default limit 1 means "every entry point compiles at most once, ever" —
wrap the whole request loop (warmup included) and distinct prefill buckets
each get their one legitimate trace while any steady-state retrace
(a dtype flip, a weak-type promotion, a shape leak) fails loudly.
``max_traces_per_key=0`` asserts a fully-warmed region compiles nothing.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional


class RecompileError(RuntimeError):
    """A jit entry point traced more often than the armed guard allows."""


def bump_trace_count(counts: Dict, key, limit: Optional[int]) -> None:
    """Record one trace of ``key``; raise if an armed guard is exceeded.

    Runs at trace time inside jit, so the raise aborts the offending
    compile and propagates to the caller that triggered it.
    """
    counts[key] = counts.get(key, 0) + 1
    if limit is not None and counts[key] > limit:
        raise RecompileError(
            f"jit entry {key!r} traced {counts[key]} times under "
            f"recompile_guard (limit {limit}) — a steady-state recompile; "
            "see the recompile-hazard rule (DESIGN.md §9.1) for the usual "
            "causes")


@contextlib.contextmanager
def recompile_guard(server, max_traces_per_key: int = 1):
    """Arm ``server`` (and its slot runtime, if any) against recompiles.

    The limit applies to a key's *total* trace count, including traces
    from before the guard was entered — wrapping only the steady state
    with the default limit therefore still catches a warmup-then-retrace.
    """
    targets = [server]
    rt = getattr(server, "slot_runtime", None)
    if rt is not None:
        targets.append(rt)
    prev = [getattr(t, "_trace_limit", None) for t in targets]
    for t in targets:
        t._trace_limit = max_traces_per_key
    try:
        yield server
    finally:
        for t, p in zip(targets, prev):
            t._trace_limit = p
