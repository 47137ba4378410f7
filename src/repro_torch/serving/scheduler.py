"""Request schedulers.

Two scheduling models share one engine-facing protocol:

* :class:`ContinuousScheduler` — iteration-level (Orca/vLLM-style)
  scheduling, the default. Admission happens at every token boundary: an
  arrived request joins the running set as soon as a slot is free, runs its
  prefill inside the next iteration, and leaves on completion. A ``policy``
  knob trades time-to-first-token against decode-iteration jitter.
* :class:`StaticBatchScheduler` — the seed engine's AlpaServe-style model
  (max batch 16 OR 1 s wait) kept reachable for regression and as the
  queueing-delay baseline: a formed batch runs to completion while later
  arrivals queue.

The engine drives either through three calls: ``next_event(now)`` (when can
new work start, used to jump virtual time when idle), ``admit(now)`` (which
requests join the running set at this token boundary) and ``on_finish(rid)``.
:class:`Scheduler` is the underlying static batch former (pure event logic
over arrival timestamps).
"""
from __future__ import annotations

from bisect import insort
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.serving.request import Batch, Request

_EPS = 1e-12

# SLA admission lattice (DESIGN.md §11): lower rank admits first. Aging
# promotes a waiting request one rank per ``sla_aging_s`` seconds queued,
# so ``batch`` traffic is delayed by bursts of ``interactive`` work but
# never starved: after 2 x sla_aging_s in the queue a batch request
# outranks a freshly arrived interactive one.
SLA_RANK = {"interactive": 0, "standard": 1, "batch": 2}


@dataclass
class SchedulerConfig:
    max_batch: int = 16
    max_wait: float = 1.0       # static mode: batch-formation deadline
    # continuous mode: "prefill" admits every arrived request that fits
    # (prefill-priority, minimizes TTFT); "decode" admits at most one new
    # request per iteration so an arrival burst cannot blow up a decode
    # iteration (decode-priority, minimizes decode jitter); "stall" defers
    # a prefill while its predicted cold-expert union against the current
    # GPU cache exceeds ``stall_budget`` (stall-aware admission — the
    # DESIGN.md §1 open item: in expert-transfer-bound regimes a churning
    # running set unions more cold experts per iteration, inflating every
    # request's service time)
    policy: str = "prefill"
    stall_budget: int = 0       # "stall": budget on (predicted cold experts
    #                             x running-set size) a joining prefill may
    #                             impose (0 = auto: the engine uses
    #                             gpu_cache_experts // 5)
    stall_max_wait: float = 0.75  # "stall" aging: admit anyway after this
    #                               long in the queue (starvation bound)
    sla_aging_s: float = 1.5    # SLA lattice: queue seconds per rank
    #                             promotion (batch -> standard -> interactive)


class Scheduler:
    """Static batch former: max batch OR max-wait deadline (AlpaServe)."""

    def __init__(self, cfg: SchedulerConfig, requests: List[Request]):
        self.cfg = cfg
        self.pending = sorted(requests, key=lambda r: r.arrival)
        self.cursor = 0

    def done(self) -> bool:
        return self.cursor >= len(self.pending)

    def next_batch(self, now: float) -> Optional[Batch]:
        """Form the next batch. ``now`` = engine's current virtual time (it
        may be behind the next arrival; we then jump forward)."""
        if self.done():
            return None
        first = self.pending[self.cursor]
        start = max(now, first.arrival)
        deadline = first.arrival + self.cfg.max_wait
        batch = Batch(t_formed=start)
        i = self.cursor
        while i < len(self.pending) and len(batch.requests) < self.cfg.max_batch:
            r = self.pending[i]
            # requests that have arrived by the time the batch must launch
            if r.arrival <= max(start, deadline):
                batch.requests.append(r)
                i += 1
            else:
                break
        # launch when full, else at the waiting deadline (if still waiting)
        if len(batch.requests) >= self.cfg.max_batch:
            t_launch = max(start, batch.requests[-1].arrival)
        else:
            t_launch = max(start, min(deadline,
                                      max(r.arrival for r in batch.requests)))
        batch.t_formed = t_launch
        self.cursor = i
        return batch


class ContinuousScheduler:
    """Iteration-level scheduler: running set + waiting queue, join at any
    token boundary, leave on completion.

    ``cold_cost_fn`` (``policy="stall"``): callable ``(request) -> int``
    returning the predicted number of cold experts — experts the joining
    request is expected to activate that are not GPU-resident right now —
    supplied by the engine (the ``ExpertPredictor.cold_union()`` admission
    prior vs. live cache contents — DESIGN.md §10). A prefill
    whose predicted cold union, weighted by the running-set size it would
    stall, exceeds ``stall_budget`` waits at the head of the queue:
    admitting it would force every running request to stall behind its
    expert transfers. Admission order is FIFO within an SLA class, with
    classes ordered by the :data:`SLA_RANK` lattice plus queue-age
    promotions; with a single class this reduces to pure FIFO. An empty
    running set or ``stall_max_wait`` aging always unblocks a request.

    Deferral aging is **per-rid**, not per-queue-position: ``_age_base``
    pins each rid's aging clock at first submission, so a deferred request
    that is re-queued (or reordered behind another tenant's traffic) keeps
    its original bound — ``stall_max_wait`` measures total time since the
    request first entered the scheduler, whatever its queue position did
    in between.

    ``stall_budgets`` maps ``tenant_id -> stall budget``, overriding the
    global budget for that tenant's joins (TenantSpec.stall_budget)."""

    def __init__(self, cfg: SchedulerConfig, requests: List[Request] = (), *,
                 cold_cost_fn=None, stall_budget: Optional[int] = None,
                 stall_budgets: Optional[Dict[str, int]] = None):
        self.cfg = cfg
        self.waiting: List[Request] = sorted(requests,
                                             key=lambda r: r.arrival)
        self.n_running = 0
        self.cold_cost_fn = cold_cost_fn
        self.stall_budget = (cfg.stall_budget if stall_budget is None
                             else stall_budget)
        self.stall_budgets: Dict[str, int] = dict(stall_budgets or {})
        self.deferrals = 0          # stall policy: admission decisions vetoed
        self.deferrals_by_class: Dict[str, int] = {}
        self.deferrals_by_tenant: Dict[str, int] = {}
        # per-rid aging base: pinned at first sight of the rid, surviving
        # re-queues (the aging bound is a property of the request, not of
        # its current queue position)
        self._age_base: Dict[int, float] = {}
        for r in self.waiting:
            self._age_base.setdefault(r.rid, r.arrival)

    def add(self, request: Request) -> None:
        """Dynamic arrival (online serving front-ends). Re-adding a rid
        (re-queue) keeps its original aging base."""
        self._age_base.setdefault(request.rid, request.arrival)
        insort(self.waiting, request, key=lambda r: r.arrival)

    def done(self) -> bool:
        return not self.waiting and self.n_running == 0

    def next_event(self, now: float) -> Optional[float]:
        """Earliest time at which a waiting request can be admitted. The
        head's arrival is always it: the stall gate only defers joins onto
        a *live* running set, and an idle engine admits unconditionally, so
        an engine consulting this while idle never spins on a deferred
        head."""
        return self.waiting[0].arrival if self.waiting else None

    def _defer(self, head: Request, now: float) -> bool:
        if self.cfg.policy != "stall" or self.cold_cost_fn is None:
            return False
        base = self._age_base.get(head.rid, head.arrival)
        if now - base >= self.cfg.stall_max_wait - _EPS:
            return False                     # aging: bounded deferral
        budget = self.stall_budgets.get(
            getattr(head, "tenant_id", "") or "", self.stall_budget)
        # the joiner's cold-expert transfers stall every running request's
        # iterations, so the marginal cost scales with the running-set size
        return self.cold_cost_fn(head) * self.n_running > budget

    def _admit_key(self, r: Request, now: float):
        """SLA lattice order: (class rank - age promotions, aging base,
        rid). Within one class this is FIFO — older requests have at least
        as many promotions AND an earlier base — so a single-class
        workload admits in exactly the legacy arrival order."""
        rank = SLA_RANK.get(getattr(r, "sla_class", "standard"), 1)
        base = self._age_base.get(r.rid, r.arrival)
        aging = self.cfg.sla_aging_s
        promo = int((now - base) / aging) if aging > 0 else 0
        return (rank - promo, base, r.rid)

    def admit(self, now: float) -> List[Request]:
        free = self.cfg.max_batch - self.n_running
        if free <= 0:
            return []
        if self.cfg.policy == "decode":
            free = min(free, 1)
        # Stall-aware admission: an idle engine admits the whole arrived
        # burst unconditionally (the cohort pays its cold working-set
        # transfer once, amortized across members — the property that makes
        # batch-to-completion win transfer-bound regimes), while joining a
        # *live* running set is gated on the predicted cold-expert union
        # weighted by how many running requests the joiner's transfers
        # would stall.
        gate = self.n_running > 0
        n_arrived = 0
        while (n_arrived < len(self.waiting)
               and self.waiting[n_arrived].arrival <= now + _EPS):
            n_arrived += 1
        if n_arrived == 0:
            return []
        arrived = self.waiting[:n_arrived]
        order = sorted(range(n_arrived),
                       key=lambda i: self._admit_key(arrived[i], now))
        admitted: List[Request] = []
        taken = set()
        # a deferred candidate blocks its whole SLA class (FIFO within a
        # class is preserved: nothing behind it in-class may jump it), but
        # lower-priority classes are still tried — admission stays
        # work-conserving across classes
        blocked_classes = set()
        for i in order:
            if len(admitted) >= free:
                break
            r = arrived[i]
            cls = getattr(r, "sla_class", "standard")
            if cls in blocked_classes:
                continue
            if gate and self._defer(r, now):
                self.deferrals += 1
                self.deferrals_by_class[cls] = (
                    self.deferrals_by_class.get(cls, 0) + 1)
                tid = getattr(r, "tenant_id", "")
                if tid:
                    self.deferrals_by_tenant[tid] = (
                        self.deferrals_by_tenant.get(tid, 0) + 1)
                blocked_classes.add(cls)
                continue
            admitted.append(r)
            taken.add(i)
        if taken:
            self.waiting = [r for j, r in enumerate(self.waiting)
                            if j not in taken]
            for r in admitted:
                self._age_base.pop(r.rid, None)
        self.n_running += len(admitted)
        return admitted

    def on_finish(self, rid: int) -> None:
        self.n_running -= 1


class StaticBatchScheduler:
    """Seed-engine semantics behind the continuous-scheduler protocol: a
    batch formed by :class:`Scheduler` is admitted whole once the engine is
    idle and runs to completion; no joins mid-flight."""

    def __init__(self, cfg: SchedulerConfig, requests: List[Request]):
        self._inner = Scheduler(cfg, requests)
        self._batch: Optional[Batch] = None
        self.n_running = 0

    def done(self) -> bool:
        return (self._batch is None and self._inner.done()
                and self.n_running == 0)

    def _form(self, now: float) -> None:
        if self._batch is None and not self._inner.done():
            self._batch = self._inner.next_batch(now)

    def next_event(self, now: float) -> Optional[float]:
        if self.n_running:
            return None
        self._form(now)
        return self._batch.t_formed if self._batch is not None else None

    def admit(self, now: float) -> List[Request]:
        if self.n_running:
            return []
        self._form(now)
        if self._batch is None or self._batch.t_formed > now + _EPS:
            return []
        reqs = self._batch.requests
        self._batch = None
        self.n_running = len(reqs)
        return reqs

    def on_finish(self, rid: int) -> None:
        self.n_running -= 1


def make_scheduler(scheduling: str, cfg: SchedulerConfig,
                   requests: List[Request], *, cold_cost_fn=None,
                   stall_budget: Optional[int] = None,
                   stall_budgets: Optional[Dict[str, int]] = None):
    if scheduling == "continuous":
        return ContinuousScheduler(cfg, requests, cold_cost_fn=cold_cost_fn,
                                   stall_budget=stall_budget,
                                   stall_budgets=stall_budgets)
    if scheduling == "static":
        return StaticBatchScheduler(cfg, requests)
    raise ValueError(f"unknown scheduling mode: {scheduling!r}")
