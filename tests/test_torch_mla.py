"""DeepSeek-V2 on the port (MLA attention, shared experts, a dense first
layer) against the reference on the CPU, with the reference's weights
loaded through ``repro_torch.params.from_reference`` and the same numpy
inputs fed to both: the MLA functions, the model, the pooled decode, the
servers (all-resident and streaming over every wire) and the launcher.

    PYTHONPATH=src python -m pytest tests/test_torch_mla.py

``deepseek-v2-236b`` ``.reduced()`` in fp32: a dense layer, then one MoE
layer of 4 experts (top-2, 2 shared experts). The servers run a 3-layer,
8-expert variant (1 dense + 2 MoE layers): with one MoE layer of 4
experts the slot floor (one layer's E) keeps every expert resident, so
nothing would stream."""
import contextlib
import copy
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch import serve as jax_serve
from repro.models import Model as JaxModel
from repro.models import attention as jattn
from repro.serving import EngineConfig, SchedulerConfig
from repro.serving.engine import JaxModelServer
from repro.serving.request import Request
from repro_torch.configs import get_config as torch_get_config
from repro_torch.launch import serve as torch_serve
from repro_torch.models import Model
from repro_torch.models import attention
from repro_torch.params import from_reference
from repro_torch.serving import EngineConfig as TorchEngineConfig
from repro_torch.serving import SchedulerConfig as TorchSchedulerConfig
from repro_torch.serving import TorchModelServer
from repro_torch.serving.request import Request as TorchRequest
from repro_torch.serving.slot_runtime import SlotStreamRuntime

torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"
TOL = dict(atol=1e-4, rtol=1e-4)     # fp32, sums in other orders
MLA_KEYS = ("w_dq", "w_uq", "w_dkv", "w_kr", "w_uk", "w_uv", "w_o",
            "q_norm_scale", "kv_norm_scale")
WALL_CLOCK = ("demand_stall_s", "demand_stall_per_token_s")


def _serving_cfg(get):
    """1 dense + 2 MoE layers of 8 experts: enough experts to stream."""
    cfg = get(ARCH).reduced()
    return dataclasses.replace(
        cfg, n_layers=3, moe=dataclasses.replace(cfg.moe, n_experts=8))


def _pair(jcfg, tcfg):
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg, device="cpu")
    from_reference(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair(get_config(ARCH).reduced(), torch_get_config(ARCH).reduced())


@pytest.fixture(scope="module")
def serving_pair():
    return _pair(_serving_cfg(get_config), _serving_cfg(torch_get_config))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _unroll(tree, tm):
    """A reference tree (params or cache) as one dict per layer: the
    prefix layers, then each scan group's slice of the periodic blocks."""
    layers = list(tree["prefix"])
    for g in range(tm.n_groups):
        layers += [jax.tree.map(lambda a: a[g], blk)
                   for blk in tree["blocks"]]
    return layers


def _mla0(params):
    """The reference's MLA leaves of layer 0 (the dense prefix layer)."""
    return params["prefix"][0]["attn"]


def test_from_reference_loads_every_parameter(pair):
    jm, params, tm = pair
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert n_ref == sum(p.numel() for p in tm.parameters())
    ref_layers = _unroll(params, tm)
    assert len(ref_layers) == jm.cfg.n_layers == 2
    for mod, ref_layer in zip(tm.layers, ref_layers):
        leaves = ref_layer["attn"]
        mod = mod.attn
        assert isinstance(mod, attention.MLA)
        assert sorted(leaves) == sorted(MLA_KEYS)
        for key in MLA_KEYS:
            np.testing.assert_array_equal(_np(getattr(mod, key)),
                                          np.asarray(leaves[key]))
    assert hasattr(tm.layers[0], "ffn") and hasattr(tm.layers[1].moe,
                                                     "shared")


def test_mla_forward_matches_reference(pair):
    jm, params, tm = pair
    cfg = jm.cfg
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, cfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    out, (ckv, kr) = jattn.mla_forward(_mla0(params), cfg, x, pos)
    tout, (tckv, tkr) = attention.mla_forward(
        tm.layers[0].attn, tm.cfg, torch.from_numpy(x),
        torch.from_numpy(np.ascontiguousarray(pos)))
    np.testing.assert_allclose(_np(tout), np.asarray(out), **TOL)
    np.testing.assert_allclose(_np(tckv), np.asarray(ckv), **TOL)
    np.testing.assert_allclose(_np(tkr), np.asarray(kr), **TOL)
    assert tckv.shape == (2, 9, cfg.attn.mla.kv_lora_rank)
    assert tkr.shape == (2, 9, cfg.attn.mla.qk_rope_head_dim)


@pytest.mark.parametrize("gated", [False, True])
def test_mla_decode_per_slot(pair, gated):
    """Absorbed decode at per-slot positions: the output and the written
    latent rows match; with an ``active`` mask, inactive rows keep their
    ckv/kr bit for bit."""
    jm, params, tm = pair
    cfg = jm.cfg
    m = cfg.attn.mla
    B, T = 4, 16
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 1, cfg.d_model), np.float32)
    ckv = rng.standard_normal((B, T, m.kv_lora_rank), np.float32)
    kr = rng.standard_normal((B, T, m.qk_rope_head_dim), np.float32)
    pos = np.array([3, 0, 7, 15], np.int32)
    out, jckv, jkr = jattn.mla_decode(_mla0(params), cfg, x, ckv, kr, pos)
    active = np.array([True, False, True, True]) if gated else None
    tout, tckv, tkr = attention.mla_decode(
        tm.layers[0].attn, tm.cfg, torch.from_numpy(x),
        torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy()),
        torch.from_numpy(pos),
        active=None if active is None else torch.from_numpy(active))
    rows = np.ones(B, bool) if active is None else active
    np.testing.assert_allclose(_np(tout)[rows], np.asarray(out)[rows], **TOL)
    np.testing.assert_allclose(_np(tckv)[rows], np.asarray(jckv)[rows],
                               **TOL)
    np.testing.assert_allclose(_np(tkr)[rows], np.asarray(jkr)[rows], **TOL)
    np.testing.assert_array_equal(_np(tckv)[~rows], ckv[~rows])
    np.testing.assert_array_equal(_np(tkr)[~rows], kr[~rows])


def test_forward_logits_and_counts(serving_pair):
    """The 3-layer variant (``.reduced()`` itself is in
    ``tests/test_torch_model.py``): the dense layer, then two MoE layers
    that the reference scans as one periodic group."""
    jm, params, tm = serving_pair
    assert (tm.n_prefix, tm.n_groups) == (1, 2)
    toks = np.random.default_rng(3).integers(0, jm.cfg.vocab, (2, 12))
    logits, aux = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tlogits, taux = tm.forward({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tlogits), np.asarray(logits), **TOL)
    np.testing.assert_array_equal(_np(taux["counts"]),
                                  np.asarray(aux["counts"]))
    assert taux["counts"].shape == (2, 2, jm.cfg.moe.n_experts)


def test_padded_prefill_pool_and_gated_decode(pair):
    """Right-padded prefills of two lengths into a 3-row pool (one row
    idle), then 6 gated decode steps: logits on active rows, greedy tokens,
    counts, positions and the latent caches match the reference's; the
    idle row's ckv/kr never change."""
    jm, params, tm = pair
    rng = np.random.default_rng(4)
    B, L, P = 3, 32, 16
    jpool, tpool = jm.init_cache(B, L), tm.init_cache(B, L)
    assert tpool["layers"][0]["ckv"].shape == (B, L,
                                               jm.cfg.attn.mla.kv_lora_rank)
    tok = np.zeros(B, np.int64)
    # the reference's prefill compiled once (its eager dispatch is slow)
    prefill = jax.jit(lambda p, b, c, n: jm.prefill(p, b, c, true_len=n))
    with torch.inference_mode():
        for slot, S in ((0, 7), (2, 12)):
            padded = np.zeros((1, P), np.int64)
            padded[0, :S] = rng.integers(0, jm.cfg.vocab, S)
            jl, jone, jaux = prefill(
                params, {"tokens": jnp.asarray(padded)}, jm.init_cache(1, L),
                S)
            jpool = jm.write_slot(jpool, jone, slot)
            tl, tone, taux = tm.prefill(
                {"tokens": torch.from_numpy(padded)}, tm.init_cache(1, L),
                true_len=S)
            tm.write_slot(tpool, tone, slot)
            np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
            np.testing.assert_array_equal(_np(taux["counts"]),
                                          np.asarray(jaux["counts"]))
            tok[slot] = int(tl[0].argmax())
            assert tok[slot] == int(np.argmax(jl[0]))
        active = np.array([True, False, True])
        idle = [{k: v[1].clone() for k, v in layer.items()}
                for layer in tpool["layers"]]
        step = jax.jit(lambda p, c, t, a: jm.serve_step(p, c, t, active=a))
        for _ in range(6):
            jl, jpool, jaux = step(params, jpool, jnp.asarray(tok, jnp.int32),
                                   jnp.asarray(active))
            tl, tpool, taux = tm.serve_step(tpool, torch.from_numpy(tok),
                                            active=torch.from_numpy(active))
            np.testing.assert_allclose(_np(tl)[active],
                                       np.asarray(jl)[active], **TOL)
            np.testing.assert_array_equal(_np(taux["counts"]),
                                          np.asarray(jaux["counts"]))
            jt = np.asarray(jnp.argmax(jl, -1))
            tt = _np(tl.argmax(-1))
            np.testing.assert_array_equal(tt[active], jt[active])
            tok = np.where(active, tt, tok)
    np.testing.assert_array_equal(_np(tpool["pos"]), np.asarray(jpool["pos"]))
    for tl_, jl_, old in zip(tpool["layers"], _unroll(jpool, tm), idle,
                             strict=True):
        for key in ("ckv", "kr"):
            np.testing.assert_allclose(_np(tl_[key])[active],
                                       np.asarray(jl_[key])[active], **TOL)
            assert torch.equal(tl_[key][1], old[key])


def _requests(cls, vocab):
    """Ragged prompts and budgets, staggered arrivals (5 requests through
    4 slots: one waits for a slot to recycle)."""
    out = []
    for rid, (plen, budget, t) in enumerate([(5, 6, 0.0), (9, 4, 0.0),
                                             (3, 7, 1e-4), (12, 3, 2e-4),
                                             (6, 5, 3e-4)]):
        rng = np.random.default_rng(100 + rid)
        out.append(cls(rid=rid, arrival=t, max_new_tokens=budget,
                       prompt=rng.integers(0, vocab, plen).astype(np.int32)))
    return out


@pytest.mark.parametrize("wire", [None, "fp32", "fp16", "int8"],
                         ids=["all-resident", "fp32", "fp16", "int8"])
def test_torch_server_matches_jax_server(serving_pair, wire):
    """All-resident, and at rf 0.5 over each wire: the same tokens, the
    same stats keys and equal values on every key but the wall-clock
    demand stall."""
    jm, params, tm = serving_pair
    kw = {} if wire is None else dict(resident_fraction=0.5,
                                      transfer_dtype=wire)

    def cfg(ec, sc, arch):
        return ec(arch=arch, gpu_cache_experts=3, dram_cache_experts=6,
                  scheduler=sc(max_batch=4), **kw)

    jsrv = JaxModelServer(cfg(EngineConfig, SchedulerConfig, jm.cfg), jm,
                          params, cache_len=32)
    tsrv = TorchModelServer(cfg(TorchEngineConfig, TorchSchedulerConfig,
                                tm.cfg), copy.deepcopy(tm), cache_len=32,
                            device="cpu")
    assert (tsrv.slot_runtime is None) == (wire is None)
    for r in _requests(Request, jm.cfg.vocab):
        jsrv.submit(r)
    for r in _requests(TorchRequest, tm.cfg.vocab):
        tsrv.submit(r)
    jsrv.drain()
    tsrv.drain()
    assert tsrv.generated == jsrv.generated
    assert all(len(tsrv.generated[r]) == b
               for r, b in enumerate([6, 4, 7, 3, 5]))
    js, ts = jsrv.stats(), tsrv.stats()
    assert ts.keys() == js.keys()
    if wire is not None:
        for key in WALL_CLOCK:
            ts.pop(key), js.pop(key)
        assert ts["demand_uploads"] > 0
        assert ts["weight_slots"] == 8          # rf 0.5 of 2 x 8 experts
    np.testing.assert_equal(ts, js)
    assert tsrv.n_prefills == 5


def _report(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    keep = ("req ", "total:", "tiers:", "slots:", "eamc:", "predictor:")
    out = []
    for line in buf.getvalue().splitlines():
        if line.startswith(keep):
            line = re.sub(r", compiles=.*$", "", line)
            out.append(re.sub(r"demand-stall=\S+ \(\S+\) ", "", line))
    return out


@pytest.mark.parametrize("stream", [[], ["--resident-fraction", "0.5",
                                         "--transfer-dtype", "int8"]],
                         ids=["all-resident", "rf0.5-int8"])
def test_launcher_report_lines_match_reference(pair, stream):
    """``--arch deepseek-v2-236b --reduced``: the port's launcher prints
    the reference's report lines on the reference's weights (at rf 0.5
    the one MoE layer's 4 experts all fit the slot floor)."""
    _, params, _ = pair
    flags = ["--arch", ARCH, "--reduced", "--requests", "3", "--seed", "3",
             *stream]
    want = _report(lambda: jax_serve.main(flags))
    cfg = torch_get_config(ARCH).reduced()
    model = from_reference(Model(cfg, device="cpu"),
                           jax.tree.map(np.asarray, params))
    args = torch_serve.parse_args(flags + ["--device", "cpu"])
    got = _report(lambda: torch_serve.serve(args, cfg, model))
    assert len(want) == 3 + 5
    assert got == want


def test_model_accepts_deepseek_and_still_refuses_the_rest():
    """Every family builds (Gemma-2, Qwen2-VL and Whisper since their
    slice), and so do the dry run's hill-climb knobs (blocked attention,
    grouped dispatch) since theirs; what is still refused is grouped
    dispatch in the streaming slot runtime."""
    for arch in (ARCH, "jamba-1.5-large-398b", "whisper-small",
                 "qwen2-vl-72b", "gemma2-2b"):
        Model(torch_get_config(arch).reduced(), device="cpu")
    cfg = torch_get_config(ARCH).reduced()
    for knob in (dict(attn_impl="blocked"), dict(moe_dispatch="grouped")):
        Model(dataclasses.replace(cfg, **knob), device="cpu")
    grouped = Model(dataclasses.replace(cfg, moe_dispatch="grouped"),
                    device="cpu").init(0)
    with pytest.raises(NotImplementedError, match="global dispatch"):
        SlotStreamRuntime(grouped, n_pool_slots=2, n_weight_slots=16)
