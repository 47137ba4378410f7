"""One run of one cell: set-up, the measured window, the traced slice and
the check of what the window served.

A cell (``cells/<name>.json``) names a configuration (``configs/``), a
traffic mix (``traffic/``) and the server's settings. ``run`` builds the
program from the seed, warms the cell's prefill buckets, lets every
client finish one request (outputs staggered over the mix's shortest,
``Traffic.warm_outputs``), then drives the closed loop through the
server's ``submit``/``step`` for ``seconds`` of wall clock. Each step ends
in a device sync (the server reads its tokens back), so the host clock
after a step is when its tokens exist. With ``trace`` the loop then runs
the cell's ``trace_iters`` more iterations under ``torch.profiler``. Last,
the program is freed and the plain reference judges a sample of the
requests the run finished (``check.py``).

``run`` returns the run's record: what the metric readers
(``metrics/<name>.py``) read.
"""
from __future__ import annotations

import gc
import json
import time
from pathlib import Path
from typing import Callable, Dict, List

import torch

from perfbench import check, roofline, trace
from perfbench.reference.dims import Dims, dims
from perfbench.traffic import Traffic

ROOT = Path(__file__).resolve().parent


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's file with its configuration and traffic files, parsed."""
    cell = json.loads((root / "cells" / f"{name}.json").read_text())
    cfg = json.loads((root / "configs" / f"{cell['config']}.json")
                     .read_text())
    mix = json.loads((root / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    return {"name": name, "cell": cell, "config": cfg, "traffic": mix}


class Loop:
    """The closed loop of the traffic's clients over the server: each
    client sends its next request when its last one completes, arriving
    at the server's current clock. Records every token's host time."""

    def __init__(self, P, srv, traffic: Traffic, seed: int,
                 clock: Callable[[], float]):
        self.P, self.srv, self.clock = P, srv, clock
        self.streams = [traffic.stream(seed, c)
                        for c in range(traffic.clients)]
        self.n_clients = traffic.clients
        self.reqs: Dict[int, object] = {}
        self.client: Dict[int, int] = {}
        self.seen: Dict[int, int] = {}
        self.inflight: List[int] = []
        self.submit_t: Dict[int, float] = {}
        self.tokens: List[tuple] = []       # (rid, index, host time)
        self.iters: List[tuple] = []        # (t0, t1, first tokens, rows)
        self.finished: List[int] = []
        self.finish_t: Dict[int, float] = {}
        self.done_by_client: Dict[int, int] = {}
        self.ctx_sum = 0                    # the coming decode's positions
        self.next_rid = 0

    def submit(self, prompt, max_new: int, task: int, client: int) -> int:
        rid = self.next_rid
        self.next_rid += 1
        r = self.P.request(rid, prompt, max_new, task, self.srv)
        self.srv.submit(r)
        self.reqs[rid], self.client[rid], self.seen[rid] = r, client, 0
        self.inflight.append(rid)
        self.submit_t[rid] = self.clock()
        return rid

    def _next(self, client: int) -> None:
        spec = next(self.streams[client])
        self.submit(spec.prompt, spec.max_new_tokens, spec.task, client)

    def start(self, first_outputs: List[int]) -> None:
        """Each client's first request, its output cut to
        ``first_outputs[client]``."""
        for c, n in enumerate(first_outputs):
            spec = next(self.streams[c])
            self.submit(spec.prompt, n, spec.task, c)

    def step(self) -> None:
        decoding = [self.reqs[i] for i in self.inflight
                    if self.seen[i] > 0]
        self.ctx_sum = sum(r.prompt_len + r.n_generated for r in decoding)
        t0 = self.clock()
        self.srv.step()
        t1 = self.clock()
        first = rows = 0
        for rid in list(self.inflight):
            r = self.reqs[rid]
            for j in range(self.seen[rid], r.n_generated):
                self.tokens.append((rid, j, t1))
                if j == 0:
                    first += 1
                else:
                    rows += 1
            self.seen[rid] = r.n_generated
            if self.P.done(r):
                self.inflight.remove(rid)
                self.finished.append(rid)
                self.finish_t[rid] = t1
                c = self.client[rid]
                if c >= 0:
                    self.done_by_client[c] = \
                        self.done_by_client.get(c, 0) + 1
                    self._next(c)
        self.iters.append((t0, t1, first, rows))

    def drain(self) -> None:
        while self.inflight:
            self.step()


def run(cell_name: str, seed: int, seconds: float, trace_on: bool, device,
        *, root: Path = ROOT, t_start: float | None = None,
        clock: Callable[[], float] = time.perf_counter, P=None,
        control: bool = False) -> dict:
    """One run of ``cell_name``. ``P``: the program adapter (default
    ``perfbench.program``; the tests pass a broken one). ``control``: the
    check also reads the fp8 control (``control.py``; never in a
    run of ``run.py``)."""
    if P is None:
        from perfbench import program as P
    t_start = clock() if t_start is None else t_start
    spec = load_cell(cell_name, root)
    cell, cfg = spec["cell"], spec["config"]
    D: Dims = dims(cfg)
    dev = torch.device(device)
    traffic = Traffic(spec["traffic"], D.vocab)
    cache_len = 32
    while cache_len < traffic.max_len():
        cache_len *= 2

    # -- set-up: weights, EAMC, server, warm buckets, one request a client
    phases = {}

    def phase(name):
        _sync(dev)
        phases[name] = clock() - t_start - sum(phases.values())

    phase("start")
    A = P.arch(cfg, D)
    model = P.model(A, D, seed, dev)
    phase("weights")
    brain = P.eamc(model, traffic.eamc_prompts(seed),
                   int(cell.get("eamc_capacity", 8)))
    phase("eamc")
    srv = P.server(model, A, cell, brain, cache_len, dev)
    phase("server")
    steps: List[tuple] = []                 # (rows, distinct, ctx_sum)
    loop = Loop(P, srv, traffic, seed, clock)
    P.watch_decode(srv, lambda n, dist: steps.append(
        (n, dist, loop.ctx_sum)))
    for j, prompt in enumerate(traffic.bucket_prompts(seed)):
        loop.submit(prompt, 2, j % traffic.n_tasks, -1)
    loop.drain()
    phase("buckets")
    loop.start(traffic.warm_outputs())
    while len(loop.done_by_client) < loop.n_clients:
        loop.step()
    phase("first_requests")

    # -- the measured window
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    n_iter0, n_dec0, n_step0 = len(loop.iters), len(srv.decode_ms), \
        len(steps)
    slot0 = P.slot_counts(srv)
    t_open = clock()
    setup_s = t_open - t_start
    while True:
        loop.step()
        if clock() - t_open >= seconds:
            break
    t_close = loop.iters[-1][1]
    slot1 = P.slot_counts(srv)
    decode_ms = list(srv.decode_ms[n_dec0:])
    win_steps = steps[n_step0:]
    win_iters = loop.iters[n_iter0:]
    mem_peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)

    # -- the traced slice, after the window
    traced = None
    if trace_on:
        traced = _trace(P, srv, loop, D, int(cell["trace_iters"]), dev)

    # -- the check, once the program is freed
    finished = [(loop.reqs[i].prompt, P.served(srv, i))
                for i in loop.finished
                if t_open < loop.finish_t[i] <= t_close]
    loop.srv = None
    del srv, model, brain
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = clock()
    verdict = check.judge(D, seed, finished, cell["check"], dev,
                          control=control)
    phases["check"] = clock() - t_check

    least = [roofline.decode_step_ms(D, n, dist, ctx)
             for n, dist, ctx in win_steps]
    return {
        "cell": cell_name, "seed": seed, "device": str(dev),
        "setup_s": setup_s, "t_open": t_open, "t_close": t_close,
        "tokens": [t for t in loop.tokens if t_open < t[2] <= t_close],
        "submit_t": loop.submit_t,
        "first_t": {rid: t for rid, j, t in loop.tokens if j == 0},
        "iters": win_iters,
        "iter_mean_s": sum(b - a for a, b, _, _ in win_iters)
        / len(win_iters),
        "decode_ms": decode_ms,
        "decode_least_ms": least if decode_ms else [],
        "decode_rows": [n for n, _, _ in win_steps],
        "slot": (None if slot0 is None else
                 {k: slot1[k] - slot0[k] for k in slot0}),
        "memory_peak_bytes": mem_peak,
        "phases": phases,
        "trace": traced,
        "check": verdict,
    }


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _trace(P, srv, loop: Loop, D: Dims, n_iters: int, dev) -> dict:
    """``n_iters`` iterations of the loop under the profiler and the
    kernel probes -> the trace's numbers (``trace.analyse``)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    launches: list = []
    ctx: Dict[int, int] = {}
    step_no = [0]
    n0 = len(loop.iters)
    with P.probe(srv, launches, lambda: step_no[0]):
        with profile(activities=acts) as prof:
            for k in range(n_iters):
                step_no[0] = k
                with record_function(trace.STEP):
                    loop.step()
                    ctx[k] = loop.ctx_sum
            _sync(dev)
    iter_s = [t1 - t0 for t0, t1, _, _ in loop.iters[n0:]]
    b1 = [roofline.b1_ms(E, C, d, f, esz, counts)
          for kind, _, E, C, d, f, esz, counts in
          (x for x in launches if x[0] == "b1") if counts is not None]
    b3 = [roofline.b3_ms(B, H, Hkv, hd, esz, ctx[k])
          for kind, k, B, H, Hkv, hd, esz in
          (x for x in launches if x[0] == "b3")]
    n_b1 = sum(1 for x in launches if x[0] == "b1")
    out = trace.analyse(prof, P.B1_KERNELS, P.B3_KERNELS)
    out.update(iter_mean_s=sum(iter_s) / len(iter_s),
               b1_least_ms=sum(b1) if len(b1) == n_b1 else None,
               b1_launches=n_b1,
               b3_least_ms=sum(b3), b3_launches=len(b3))
    return out
