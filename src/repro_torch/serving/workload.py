"""Synthetic serving workloads.

The paper drives its evaluation with FLAN / BIGBench / MMLU requests arriving
per an Azure-trace-shaped process. Offline here, we synthesize the same
*structure*: a mixture of tasks, each with its own token distribution (so a
randomly initialized router produces task-clustered expert activations — the
property EAMC clustering exploits), and arrival processes with Azure-like
burstiness.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from repro_torch.serving.request import Request


@dataclass
class WorkloadConfig:
    vocab: int = 512
    n_tasks: int = 3                      # FLAN/BIGBench/MMLU-like mixture
    prompt_len: tuple = (16, 64)          # uniform range
    output_len: tuple = (8, 64)
    zipf_a: float = 1.3                   # within-task token skew
    task_vocab_frac: float = 0.35         # fraction of vocab each task uses


def _task_token_sampler(cfg: WorkloadConfig, task: int,
                        rng: np.random.Generator):
    """Each task draws tokens Zipf-skewed from its own vocab slice."""
    width = max(8, int(cfg.vocab * cfg.task_vocab_frac))
    start = (task * (cfg.vocab - width)) // max(1, cfg.n_tasks - 1) \
        if cfg.n_tasks > 1 else 0
    ranks = np.arange(1, width + 1, dtype=np.float64)
    probs = ranks ** -cfg.zipf_a
    probs /= probs.sum()
    perm = rng.permutation(width)  # fixed per task via rng seeding

    def sample(n: int, r: np.random.Generator) -> np.ndarray:
        local = r.choice(width, size=n, p=probs)
        return (start + perm[local]).astype(np.int32)
    return sample


def make_dataset(cfg: WorkloadConfig, n: int, seed: int = 0,
                 tasks: List[int] | None = None) -> List[Request]:
    """n requests with arrival=0 (benchmarks attach arrivals separately)."""
    rng = np.random.default_rng(seed)
    samplers = [_task_token_sampler(cfg, t, np.random.default_rng(1000 + t))
                for t in range(cfg.n_tasks)]
    out = []
    for i in range(n):
        task = tasks[i % len(tasks)] if tasks else int(rng.integers(cfg.n_tasks))
        plen = int(rng.integers(cfg.prompt_len[0], cfg.prompt_len[1] + 1))
        olen = int(rng.integers(cfg.output_len[0], cfg.output_len[1] + 1))
        prompt = samplers[task](plen, rng)
        out.append(Request(rid=i, arrival=0.0, prompt=prompt,
                           max_new_tokens=olen, task_id=task))
    return out


def poisson_arrivals(n: int, rps: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rps, size=n)
    return np.cumsum(gaps)


def azure_like_arrivals(n: int, rps: float, seed: int = 0,
                        cv: float = 2.5) -> np.ndarray:
    """Bursty arrivals (Gamma renewal with CV>1), the shape of the Azure
    serverless trace used by AlpaServe/Clockwork-style studies."""
    rng = np.random.default_rng(seed)
    shape = 1.0 / (cv * cv)
    scale = 1.0 / (rps * shape)
    gaps = rng.gamma(shape, scale, size=n)
    return np.cumsum(gaps)


def attach_arrivals(reqs: List[Request], arrivals: np.ndarray) -> List[Request]:
    for r, t in zip(reqs, arrivals):
        r.arrival = float(t)
    return reqs


# ---------------------------------------------------------------------------
# Mixed multi-tenant workloads (DESIGN.md §11)
# ---------------------------------------------------------------------------

# canonical tenant task mixes for the mixed-workload replay: a translation
# tenant (nllb_moe_128-style long-input batchy traffic), an interactive chat
# tenant, and a speech tenant. Task ids index the RoutingOracle's
# task-conditioned routing distributions, so each tenant activates its own
# expert cluster — the structure per-tenant EAMCs isolate.
TENANT_TASK_MIXES = {
    "translation": (0, 1),
    "chat": (2, 3),
    "speech": (4, 5),
}


def make_multitenant_dataset(tenants, n: int, *,
                             cfg: WorkloadConfig | None = None,
                             seed: int = 0, rps: float = 2.0,
                             tenant_tasks=None) -> List[Request]:
    """One interleaved Poisson replay over several tenants' workloads.

    ``tenants``: TenantSpec-shaped objects (``tenant_id``, ``sla_class``,
    ``tasks``, ``rps``). Each tenant gets its own request stream — tasks
    drawn round-robin from its task mix (``tenant_tasks[tenant_id]`` or
    ``TENANT_TASK_MIXES``-style tuples on the spec), arrivals an independent
    Poisson process at its share of ``rps`` (weighted by ``t.rps`` when set,
    else split evenly) — and the streams merge into one arrival-sorted
    replay with sequential rids. ``n`` is the total request count, divided
    proportionally to the rate weights."""
    tenants = list(tenants)
    if not tenants:
        return []
    weights = np.array([max(float(getattr(t, "rps", 0.0) or 0.0), 0.0)
                        for t in tenants])
    if weights.sum() <= 0:
        weights = np.ones(len(tenants))
    weights = weights / weights.sum()
    all_tasks = []
    for i, t in enumerate(tenants):
        tasks = tuple(getattr(t, "tasks", ()) or ())
        if not tasks and tenant_tasks:
            tasks = tuple(tenant_tasks.get(t.tenant_id, ()))
        if not tasks:
            tasks = (i,)
        all_tasks.append(tasks)
    if cfg is None:
        n_tasks = max(max(ts) for ts in all_tasks) + 1
        cfg = WorkloadConfig(n_tasks=n_tasks)
    # per-tenant counts: largest-remainder split of n by rate weight
    counts = np.floor(weights * n).astype(int)
    rem = n - counts.sum()
    for i in np.argsort(-(weights * n - counts))[:rem]:
        counts[i] += 1
    merged: List[Request] = []
    for i, t in enumerate(tenants):
        if counts[i] <= 0:
            continue
        reqs = make_dataset(cfg, int(counts[i]), seed=seed + 101 * i,
                            tasks=list(all_tasks[i]))
        attach_arrivals(reqs, poisson_arrivals(
            len(reqs), rps * float(weights[i]), seed=seed + 577 * i))
        tid = str(t.tenant_id)
        cls = getattr(t, "sla_class", "standard") or "standard"
        for r in reqs:
            r.tenant_id = tid
            r.sla_class = cls
        merged.extend(reqs)
    merged.sort(key=lambda r: r.arrival)
    for rid, r in enumerate(merged):
        r.rid = rid
    return merged
