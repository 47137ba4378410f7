"""Streaming model mode on the port: ``TorchModelServer`` with device weight
slots (``SlotStreamRuntime`` over ``ExpertSlotCache``) against the
reference's ``JaxModelServer`` on the same weights, on the CPU, for every
wire and both upload schedules; the slot path against the port's own fused
path; and the cache mechanics of ``tests/test_slot_cache.py``.

Reduced qwen3-moe: 2 MoE layers x 4 experts, fp32. The card runs of the
same path are in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import copy

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import Model as JaxModel
from repro.serving import EngineConfig, SchedulerConfig
from repro.serving.engine import JaxModelServer
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.slot_cache import EXPERT_WEIGHT_NAMES
from repro_torch.models import Model
from repro_torch.params import from_reference
from repro_torch.serving import EngineConfig as TorchEngineConfig
from repro_torch.serving import SchedulerConfig as TorchSchedulerConfig
from repro_torch.serving import TorchModelServer

torch.set_num_threads(2)

ARCH = "qwen3-moe-235b-a22b"
N_MOE, N_EXPERTS = 2, 4
TOTAL = N_MOE * N_EXPERTS
WALL_CLOCK = ("demand_stall_s", "demand_stall_per_token_s")


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(get_config(ARCH).reduced())
    params = jm.init(jax.random.PRNGKey(0))
    tm = Model(torch_get_config(ARCH).reduced(), device="cpu")
    from_reference(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _torch_server(tm, **kw):
    """A server over a copy of ``tm`` (a streaming server moves the
    experts of the model it is given into its host store)."""
    cfg = TorchEngineConfig(arch=tm.cfg, gpu_cache_experts=4,
                            dram_cache_experts=8,
                            scheduler=TorchSchedulerConfig(max_batch=4),
                            **kw)
    return TorchModelServer(cfg, copy.deepcopy(tm), n_slots=4, cache_len=64,
                            device="cpu")


def _generate(srv, vocab, n=3, new=6, seed=5):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, vocab, (n, 8)).astype(np.int32)
    return srv.generate(prompts, max_new_tokens=new)


@pytest.fixture(scope="module")
def fused_reference(models):
    tm = models[2]
    srv = _torch_server(tm)
    assert srv.slot_runtime is None
    out, stats = _generate(srv, tm.cfg.vocab)
    return out, stats["eams"]


@pytest.mark.parametrize("fenced", [False, True], ids=["overlap", "fenced"])
@pytest.mark.parametrize("wire", ["fp32", "fp16", "int8"])
def test_streaming_server_matches_jax_server(models, wire, fenced):
    """rf=0.5: identical tokens and EAMs, the same stats keys and equal
    values on every key but the wall-clock demand stall: the slot counters
    and upload bytes say the same experts moved at the same points."""
    jm, params, tm = models
    kw = dict(resident_fraction=0.5, transfer_dtype=wire,
              fenced_uploads=fenced)
    jsrv = JaxModelServer(
        EngineConfig(arch=jm.cfg, gpu_cache_experts=4, dram_cache_experts=8,
                     scheduler=SchedulerConfig(max_batch=4), **kw),
        jm, params, n_slots=4, cache_len=64)
    tsrv = _torch_server(tm, **kw)
    assert tsrv.slot_runtime.fenced is fenced
    j_out, js = _generate(jsrv, jm.cfg.vocab)
    t_out, ts = _generate(tsrv, tm.cfg.vocab)
    np.testing.assert_array_equal(t_out, j_out)
    for a, b in zip(ts.pop("eams"), js.pop("eams")):
        np.testing.assert_array_equal(a, b)
    assert ts.keys() == js.keys()
    for key in WALL_CLOCK:
        assert ts.pop(key) > 0.0
        js.pop(key)
    np.testing.assert_equal(ts, js)
    assert ts["demand_uploads"] > 0 and ts["slot_hits"] > 0
    assert ts["weight_slots"] == TOTAL // 2
    assert ts["upload_bytes"] == (ts["demand_uploads"]
                                  + ts["prefetch_uploads"]) \
        * ts["wire_expert_bytes"]
    assert ts["sim_expert_bytes"] == ts["wire_expert_bytes"]
    assert tsrv.compile_counts == {}


@pytest.mark.parametrize("slots", [{"n_weight_slots": TOTAL},
                                   {"resident_fraction": 0.5}],
                         ids=["all-slots", "rf0.5"])
def test_slot_path_bit_equal_to_fused_path(models, fused_reference, slots):
    """The layered walk over slot buffers at the fp32 wire gives the fused
    all-resident step's tokens and EAMs; with a slot for every expert
    nothing is demand-uploaded."""
    tm = models[2]
    out_ref, eams_ref = fused_reference
    srv = _torch_server(tm, **slots)
    assert srv.slot_runtime is not None
    out, stats = _generate(srv, tm.cfg.vocab)
    assert np.array_equal(out, out_ref)
    for a, b in zip(stats["eams"], eams_ref):
        assert np.array_equal(a, b)
    assert stats["slot_hits"] > 0
    if "n_weight_slots" in slots:
        assert stats["demand_uploads"] == stats["slot_misses"] == 0
    else:
        assert stats["demand_uploads"] > 0


def test_slot_table_and_residency_consistent(models):
    """slot_of / key_of stay inverse maps under churn, the resident set
    never exceeds capacity, and every resident key's slot holds its
    weights, bit-equal to the host store."""
    tm = models[2]
    srv = _torch_server(tm, resident_fraction=0.5, transfer_dtype="int8")
    _generate(srv, tm.cfg.vocab, n=4, new=5, seed=9)
    sc = srv.slot_runtime.slot_cache
    sc.fence()
    resident = sc.resident
    assert len(resident) <= sc.n_slots
    for key in resident:
        assert sc.key_of[int(sc.slot_of[key[0], key[1]])] == key
    for slot, key in enumerate(sc.key_of):
        if key is None:
            assert slot in sc._free
            continue
        assert int(sc.slot_of[key[0], key[1]]) == slot
        for name, arr in sc.store.wire_expert(*key).items():
            assert torch.equal(sc.bufs[name][slot], arr)


def test_residency_follows_engine_verdicts(models):
    tm = models[2]
    srv = _torch_server(tm, resident_fraction=0.5)
    _generate(srv, tm.cfg.vocab, n=3, new=4, seed=11)
    srv.slot_runtime.sync_residency(set(srv.offload.gpu_cache.resident))
    srv.slot_runtime.flush_pending()
    assert set(srv.slot_runtime.slot_cache.resident) \
        == set(srv.offload.gpu_cache.resident)


def test_weight_slot_floor_is_one_layer(models):
    tm = models[2]
    srv = _torch_server(tm, resident_fraction=0.01)
    assert srv.cfg.n_weight_slots == N_EXPERTS
    assert srv.cfg.gpu_cache_experts == N_EXPERTS
    out, stats = _generate(srv, tm.cfg.vocab, n=2, new=4, seed=13)
    assert out.shape == (2, 4)
    assert stats["demand_uploads"] > 0


def test_store_takes_the_experts_off_the_model(models):
    """After the server is built the model holds routers and no routed
    expert weights; the host store holds them, equal to the originals."""
    tm = models[2]
    srv = _torch_server(tm, resident_fraction=0.5)
    model, store = srv.model, srv.slot_runtime.store
    for li, i in enumerate(model.moe_layers):
        moe = model.layers[i].moe
        assert not set(EXPERT_WEIGHT_NAMES) & set(dict(moe.named_parameters()))
        assert "w_router" in dict(moe.named_parameters())
        for name in store.names:
            assert torch.equal(store.layer(li)[name],
                               getattr(tm.layers[i].moe, name))
    assert store.expert_bytes > 0


def test_server_serves_expert_parallel(models, fused_reference):
    """n_devices = 2 on the CPU: two logical shards, each with its own slot
    cache of half the slots; the fused path's tokens and EAMs, with every
    routed expert uploaded to its home shard."""
    from repro_torch.serving.slot_runtime import ShardedSlotRuntime
    tm = models[2]
    out_ref, eams_ref = fused_reference
    srv = _torch_server(tm, n_devices=2, resident_fraction=0.5)
    rt = srv.slot_runtime
    assert isinstance(rt, ShardedSlotRuntime)
    assert rt.mesh.shape == {"expert": 2}
    assert [c.n_slots for c in rt.slot_caches] == [TOTAL // 4] * 2
    out, stats = _generate(srv, tm.cfg.vocab)
    assert np.array_equal(out, out_ref)
    for a, b in zip(stats["eams"], eams_ref):
        assert np.array_equal(a, b)
    assert stats["n_devices"] == 2 and len(stats["per_device"]) == 2
    assert all(d["demand_uploads"] > 0 for d in stats["per_device"])
    for cache in rt.slot_caches:
        for key in cache.resident:
            assert rt.placement.device_of(*key) == rt.slot_caches.index(cache)
