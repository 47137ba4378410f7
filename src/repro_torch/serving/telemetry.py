"""Spans and counters inside the server and the slot runtime.

A span is one stretch of host time inside the program: its name, its start
and end on ``time.perf_counter`` (the clock a benchmark's host timings run
on), its ``id``, the id of the span open around it (``parent``; None for an
iteration's root), the request that caused it (``rid``; None where no one
request did) and the counters recorded on it (``counters``; None or a
dict). A closed span goes to :data:`RING`, a bounded ring of the process's
latest spans. The ring is the process's, not a server's: a reader takes an
iteration window from it after the server that recorded it is gone.

The spans the program records (every one nested under an iteration's
``serve.step``):

* ``serve.step``: one engine iteration (``TorchModelServer.step``), with the
  deltas of the slot caches' upload counters (:data:`SLOT_COUNTERS`);
* ``serve.residency``: the slot runtime's ``sync_residency`` at the
  iteration boundary;
* ``serve.prefill`` (rid) and ``serve.decode``: the iteration's device
  work, its read-backs included;
* ``serve.policy``: the offload engine's Algorithm-1 walk on the virtual
  clock (``_execute_iteration``);
* ``serve.retire`` (rid): a finished request's retirement;
* ``slot.route_wait``: the host waiting for a MoE layer's routed ids;
* ``slot.ensure``: issuing a layer's demand uploads (only where it misses);
* ``slot.stage``: issuing the next MoE layer's planned uploads;
* ``step.readback``: the host waiting for a step's last kernels;
* ``slot.commit``: a point (start = end) whose ``counters["device_ms"]``
  is the device time the compute stream spent in the step's slot-cache
  commits, waiting for staged copies and landing them (CUDA only).

With the profiler off a span costs two clock reads and the append of
itself to the ring. Under ``torch.profiler`` each span also enters
``record_function(name)``, so the profiler's trace carries the program's
spans on its own clock beside the device's kernels and copies.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import List, Optional

import torch
from torch.profiler import record_function

RING_SIZE = 1 << 16
RING: deque = deque(maxlen=RING_SIZE)
# the slot caches' counters a ``serve.step`` records the deltas of
SLOT_COUNTERS = ("demand_uploads", "prefetch_uploads", "prefetch_used",
                 "prefetch_unused_evicted")

_open: List[int] = []               # ids of the open spans, innermost last
_ids = itertools.count()
# True while a torch profiler records; a flag read, where entering
# ``record_function`` costs microseconds with the profiler off too
_profiling = torch._C._autograd._profiler_enabled


class Span:
    """One span; enter it with ``with``. It is its own ring entry."""

    __slots__ = ("name", "rid", "id", "parent", "t0", "t1", "counters",
                 "_rf")

    def __init__(self, name: str, rid: Optional[int] = None):
        self.name, self.rid, self.counters = name, rid, None

    def __enter__(self) -> "Span":
        self.id = next(_ids)
        self.parent = _open[-1] if _open else None
        _open.append(self.id)
        self._rf = None
        if _profiling():
            self._rf = record_function(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _open.pop()
        RING.append(self)


def note(name: str, **counters) -> None:
    """Record ``counters`` as a span of no length under the open span."""
    s = Span(name)
    s.id = next(_ids)
    s.parent = _open[-1] if _open else None
    s.t0 = s.t1 = time.perf_counter()
    s.counters, s._rf = counters, None
    RING.append(s)


def spans() -> List[Span]:
    """The ring's spans, oldest closed first."""
    return list(RING)
