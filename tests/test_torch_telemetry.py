"""The server's and the slot runtime's spans (``serving.telemetry``) on a
tiny streaming ``TorchModelServer`` on the CPU: one ``serve.step`` root an
iteration with every other span under it, the slot caches' upload counters
on each root, tokens unchanged by the spans, spans entered into the
profiler only while it records, and the ring's bound and lifetime."""
import copy
import gc
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.serving import EngineConfig, SchedulerConfig, telemetry
from repro_torch.serving import TorchModelServer
from repro_torch.serving.request import Request

torch.set_num_threads(2)

ARCH = "qwen3-moe-235b-a22b"
NESTED = {"serve.residency", "serve.prefill", "serve.decode", "serve.policy",
          "serve.retire", "slot.route_wait", "slot.ensure", "slot.stage",
          "step.readback"}


@pytest.fixture(scope="module")
def model():
    """Reduced qwen3-moe (2 MoE layers x 4 experts), fp32, its weights
    drawn from a seed (norm scales about 1)."""
    m = Model(get_config(ARCH).reduced(), device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=g)
                    + float(name.endswith("scale")))
    return m


def _server(m):
    """A streaming server (4 slots for 8 experts) over a copy of ``m``."""
    cfg = EngineConfig(arch=m.cfg, gpu_cache_experts=4, dram_cache_experts=8,
                       scheduler=SchedulerConfig(max_batch=4),
                       resident_fraction=0.5)
    return TorchModelServer(cfg, copy.deepcopy(m), n_slots=4, cache_len=64,
                            device="cpu")


def _serve(srv, between=lambda: None):
    """Three requests of 6 tokens (prompts of 5, 8 and 11), submitted at
    once and stepped to the end, ``between()`` after each ``step()``.
    -> (tokens by request, number of ``step()`` calls)."""
    rng = np.random.default_rng(5)
    vocab = srv.model.cfg.vocab
    reqs = [Request(rid=i, arrival=0.0,
                    prompt=rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=6) for i, n in enumerate((5, 8, 11))]
    for r in reqs:
        srv.submit(r)
    calls = 1
    while srv.step():
        between()
        calls += 1
    return [srv.generated.pop(r.rid) for r in reqs], calls


def _ancestors(spans):
    by_id = {s.id: s for s in spans}
    out = {}
    for s in spans:
        chain, p = [], s.parent
        while p is not None:
            chain.append(by_id[p])
            p = by_id[p].parent
        out[s.id] = chain
    return out


def test_one_root_a_step_and_every_span_under_one(model):
    srv = _server(model)
    telemetry.RING.clear()
    _, calls = _serve(srv)
    spans = telemetry.spans()
    names = Counter(s.name for s in spans)
    assert names["serve.step"] == calls
    assert set(names) == NESTED | {"serve.step"}
    up = _ancestors(spans)
    for s in spans:
        assert s.t0 <= s.t1
        if s.name == "serve.step":
            assert s.parent is None and up[s.id] == []
        else:
            assert up[s.id][-1].name == "serve.step"
            assert all(a.t0 <= s.t0 and s.t1 <= a.t1 for a in up[s.id])
    # request-caused spans carry their request; the slot runtime's spans
    # sit under the device work they belong to
    assert sorted(s.rid for s in spans if s.name == "serve.prefill") \
        == [0, 1, 2]
    assert sorted(s.rid for s in spans if s.name == "serve.retire") \
        == [0, 1, 2]
    for s in spans:
        if s.name in ("slot.route_wait", "step.readback"):
            assert up[s.id][0].name in ("serve.prefill", "serve.decode")
    # the CPU has no device time to note
    assert names["slot.commit"] == 0
    assert srv.slot_runtime.slot_cache.commit_ms() is None


def test_step_counters_are_the_slot_caches_deltas(model):
    srv = _server(model)
    sc = srv.slot_runtime.slot_cache
    before = sc.stats()
    telemetry.RING.clear()
    _serve(srv)
    after = sc.stats()
    steps = [s for s in telemetry.spans() if s.name == "serve.step"]
    total = {k: sum(s.counters[k] for s in steps)
             for k in telemetry.SLOT_COUNTERS}
    for k in ("demand_uploads", "prefetch_uploads"):
        assert total[k] == after[k] - before[k]
    assert total["demand_uploads"] > 0 and total["prefetch_uploads"] > 0
    assert total["prefetch_used"] > 0
    assert total["prefetch_used"] + total["prefetch_unused_evicted"] \
        <= total["prefetch_uploads"]
    assert (total["prefetch_used"], total["prefetch_unused_evicted"]) \
        == (sc.prefetch_used, sc.prefetch_unused_evicted)
    # the new counters are attributes only: stats() keeps its keys
    assert "prefetch_used" not in after
    assert "prefetch_used" not in srv.stats()


def test_spans_change_no_token(model):
    kept, _ = _serve(_server(model))
    srv = _server(model)
    cleared, _ = _serve(srv, telemetry.RING.clear)
    assert cleared == kept
    assert len(set(map(tuple, kept))) > 1


def test_spans_reach_the_profiler_only_while_it_records(model, monkeypatch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    entered = []
    inner = telemetry.record_function

    def counted(name):
        entered.append(name)
        return inner(name)
    monkeypatch.setattr(telemetry, "record_function", counted)
    srv = _server(model)
    _serve(srv)
    assert entered == []
    telemetry.RING.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(srv)
    recorded = Counter(s.name for s in telemetry.spans())
    assert Counter(entered) == recorded
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU
              and e.name in recorded]
    assert Counter(e.name for e in events) == recorded
    roots = [e.time_range for e in events if e.name == "serve.step"]
    for e in events:
        assert any(r.start <= e.time_range.start
                   and e.time_range.end <= r.end for r in roots), e.name


def test_the_ring_is_bounded_and_outlives_the_server(model):
    srv = _server(model)
    telemetry.RING.clear()
    _serve(srv)
    mine = telemetry.spans()
    del srv
    gc.collect()
    assert telemetry.spans() == mine
    for _ in range(telemetry.RING_SIZE + 10):
        with telemetry.Span("filler"):
            pass
    ring = telemetry.spans()
    assert len(ring) == telemetry.RING_SIZE
    assert {s.name for s in ring} == {"filler"}
