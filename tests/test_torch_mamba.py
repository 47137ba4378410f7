"""Jamba on the port (Mamba blocks, attention, MoE every second layer)
against the reference on the CPU, with the reference's weights loaded
through ``repro_torch.params.from_reference`` and the same numpy inputs
fed to both: the Mamba functions, the plain selective scan (B5's oracle),
the model, the exact-length prefill into a pool with gated decode, the
servers (all-resident and streaming over every wire) and the launcher.

    PYTHONPATH=src python -m pytest tests/test_torch_mamba.py

``jamba-1.5-large-398b`` ``.reduced()`` in fp32 is (mamba, dense), (attn,
MoE of 4 experts): at rf 0.5 the slot floor (one layer's E) keeps all 4
resident. The servers run a 4-layer variant with 8 experts whose Mamba
layers carry the experts: (mamba, dense), (mamba, MoE), (attn, dense),
(mamba, MoE), so slots miss and a (mamba, MoE) block streams."""
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
from repro.models import mamba as jmamba
from repro.serving import EngineConfig, SchedulerConfig
from repro.serving.engine import JaxModelServer
from repro.serving.request import Request
from repro_torch.configs import get_config as torch_get_config
from repro_torch.kernels import ref
from repro_torch.launch import serve as torch_serve
from repro_torch.models import Model, mamba
from repro_torch.params import from_reference
from repro_torch.serving import EngineConfig as TorchEngineConfig
from repro_torch.serving import SchedulerConfig as TorchSchedulerConfig
from repro_torch.serving import TorchModelServer
from repro_torch.serving.request import Request as TorchRequest

torch.set_num_threads(2)

ARCH = "jamba-1.5-large-398b"
MAMBA_KEYS = ("w_in", "conv_w", "w_x_dbc", "w_dt", "dt_bias", "A_log", "D",
              "w_out")
WEIGHTS = ("w_in", "conv_w", "w_x_dbc", "w_dt", "w_out")  # model dtype
WALL_CLOCK = ("demand_stall_s", "demand_stall_per_token_s")


def _tol(dtype):
    # tests/test_kernels.py::_tol
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=1e-4)


# fp32 through the whole model: sums in other orders over several layers
TOL = dict(atol=1e-4, rtol=1e-4)


def _variant(get):
    """(mamba, dense), (mamba, MoE), (attn, dense), (mamba, MoE), 8
    experts: the phase-8c config of ``chip_smoke.py``."""
    cfg = get(ARCH).reduced(n_layers=4)
    return dataclasses.replace(
        cfg, attn_layer_period=4, attn_layer_offset=2,
        moe=dataclasses.replace(cfg.moe, n_experts=8))


def _periodic(get):
    """Four layers the reference scans as two groups of (mamba, dense),
    (attn, MoE): ``from_reference`` must unstack the mamba leaves."""
    return get(ARCH).reduced(n_layers=4)


CONFIGS = {"reduced": lambda get: get(ARCH).reduced(), "variant": _variant,
           "periodic": _periodic}


def _pair(name):
    jm = JaxModel(CONFIGS[name](get_config))
    params = jm.init(jax.random.PRNGKey(0))
    tm = Model(CONFIGS[name](torch_get_config), device="cpu")
    from_reference(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair("reduced")


@pytest.fixture(scope="module")
def serving_pair():
    return _pair("variant")


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _unroll(tree, tm):
    """A reference tree (params or cache) as one dict per layer: the
    prefix layers, then each scan group's slice of the periodic blocks."""
    layers = list(tree["prefix"])
    for g in range(tm.n_groups):
        layers += [jax.tree.map(lambda a: a[g], blk)
                   for blk in tree["blocks"]]
    return layers


@pytest.mark.parametrize("name,groups", [("reduced", (2, 0)),
                                         ("variant", (4, 0)),
                                         ("periodic", (0, 2))])
def test_from_reference_loads_every_parameter(name, groups):
    jm, params, tm = _pair(name)
    assert (tm.n_prefix, tm.n_groups) == groups
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert n_ref == sum(p.numel() for p in tm.parameters())
    n_mamba = 0
    for mod, desc, leaves in zip(tm.layers, tm.descs, _unroll(params, tm),
                                 strict=True):
        if desc.kind != "mamba":
            continue
        n_mamba += 1
        assert sorted(leaves["mamba"]) == sorted(MAMBA_KEYS)
        for key in MAMBA_KEYS:
            got = getattr(mod.mamba, key)
            want = np.asarray(leaves["mamba"][key])
            assert got.dtype == getattr(torch, str(want.dtype))
            np.testing.assert_array_equal(_np(got), want)
    assert n_mamba == sum(d.kind == "mamba" for d in jm.descs) > 0


def test_init_sets_the_reference_constants():
    """``Model.init`` draws the mixer weights (stds of ``init_mamba``) and
    leaves dt_bias 0, A_log = log(1..N) and D 1 in fp32."""
    cfg = torch_get_config(ARCH).reduced()
    mod = Model(cfg, device="cpu").init(3).layers[0].mamba
    d_in, dt_rank = mamba._dims(cfg)
    N = cfg.mamba.d_state
    assert mod.A_log.shape == (d_in, N) and mod.A_log.dtype == torch.float32
    np.testing.assert_allclose(_np(mod.A_log[5]), np.log(np.arange(1, N + 1)),
                               rtol=1e-6)
    assert bool((mod.dt_bias == 0).all()) and bool((mod.D == 1).all())
    assert mod.w_x_dbc.shape == (d_in, dt_rank + 2 * N)
    assert abs(float(mod.conv_w.std()) - 0.2) < 0.02
    assert abs(float(mod.w_in.std()) * cfg.d_model ** 0.5 - 1) < 0.05


def test_full_width_model_has_the_published_shapes():
    """The full config builds (on the meta device: no memory) with every
    published width; cut to 5 layers it holds every block kind."""
    cfg = dataclasses.replace(torch_get_config(ARCH), n_layers=5)
    tm = Model(cfg, device="meta")
    assert [(d.kind, d.is_moe) for d in tm.descs] == [
        ("mamba", False), ("mamba", True), ("mamba", False), ("mamba", True),
        ("attn", False)]
    m = tm.layers[0].mamba
    assert tuple(m.w_in.shape) == (8192, 2 * 16384)
    assert tuple(m.w_x_dbc.shape) == (16384, 512 + 2 * 16)
    assert tuple(tm.layers[1].moe.w_up.shape) == (16, 8192, 24576)
    n = sum(p.numel() for p in tm.parameters())
    assert 23.9e9 < n < 24.1e9


def _ssm_inputs(rng, B, L, cfg):
    d_in, _ = mamba._dims(cfg)
    return rng.standard_normal((B, L, d_in), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 7, 40])
def test_selective_scan_ref_matches_reference_scan(pair, T, dtype):
    """The plain scan (B5's oracle) on the inputs ``_ssm_inputs`` makes
    from the reference weights, against the reference's ``_ssm_params`` +
    ``_scan_chunk`` on the same post-conv activations and state."""
    jm, params, tm = pair
    cfg = jm.cfg
    rng = np.random.default_rng(T)
    xc = _ssm_inputs(rng, 2, T, cfg)
    h0 = rng.standard_normal((2, xc.shape[-1], cfg.mamba.d_state),
                             np.float32) * 0.5
    jdt = getattr(jnp, dtype)
    jp = {k: v.astype(jdt) if k in WEIGHTS else v
          for k, v in params["prefix"][0]["mamba"].items()}
    dA, dBx, Cm = jmamba._ssm_params(jp, cfg, jnp.asarray(xc, jdt))
    hN, y = jmamba._scan_chunk(jnp.asarray(h0), dA.astype(jnp.float32),
                               dBx.astype(jnp.float32),
                               Cm.astype(jnp.float32))
    p = copy.deepcopy(tm.layers[0].mamba)
    tdt = getattr(torch, dtype)
    for key in WEIGHTS:
        setattr(p, key, torch.nn.Parameter(getattr(p, key).to(tdt),
                                           requires_grad=False))
    dt, A, Bm, Cm_t = mamba._ssm_inputs(p, cfg, torch.from_numpy(xc).to(tdt))
    ty, th = ref.selective_scan_ref(torch.from_numpy(xc).to(tdt), dt, A, Bm,
                                    Cm_t, torch.from_numpy(h0))
    assert ty.dtype == th.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), np.asarray(y), **_tol(dtype))
    np.testing.assert_allclose(_np(th), np.asarray(hN), **_tol(dtype))


@pytest.mark.parametrize("given", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("S", [9, 512])
def test_mamba_forward_matches_reference(pair, S, given):
    """S < 256 (one inner scan) and S = 512 (the reference's two-chunk
    branch), from a zero or a carried state; the conv tail is the
    reference's ``_conv_tail``."""
    jm, params, tm = pair
    cfg = jm.cfg
    rng = np.random.default_rng(S + given)
    x = rng.standard_normal((2, S, cfg.d_model), np.float32)
    d_in, _ = mamba._dims(cfg)
    state = (rng.standard_normal((2, d_in, cfg.mamba.d_state), np.float32)
             if given else None)
    jp = params["prefix"][0]["mamba"]
    y, hN = jax.jit(jmamba.mamba_forward, static_argnums=1)(
        jp, cfg, jnp.asarray(x), None if state is None else jnp.asarray(state))
    with torch.inference_mode():
        ty, th, tail = mamba.mamba_forward(
            tm.layers[0].mamba, tm.cfg, torch.from_numpy(x),
            None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(_np(ty), np.asarray(y), **TOL)
    np.testing.assert_allclose(_np(th), np.asarray(hN), **TOL)
    from repro.models.model import _conv_tail
    np.testing.assert_allclose(_np(tail), np.asarray(_conv_tail(
        jnp.asarray(x), cfg, jp)), **TOL)


def test_both_packages_refuse_a_ragged_long_sequence(pair):
    jm, params, tm = pair
    x = np.zeros((1, 300, jm.cfg.d_model), np.float32)
    with pytest.raises(AssertionError, match="not divisible"):
        jmamba.mamba_forward(params["prefix"][0]["mamba"], jm.cfg,
                             jnp.asarray(x))
    with pytest.raises(ValueError, match="not divisible"):
        mamba.mamba_forward(tm.layers[0].mamba, tm.cfg, torch.from_numpy(x))


def test_mamba_decode_matches_reference(pair):
    jm, params, tm = pair
    cfg = jm.cfg
    d_in, _ = mamba._dims(cfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 1, cfg.d_model), np.float32)
    conv = rng.standard_normal((3, cfg.mamba.d_conv - 1, d_in), np.float32)
    ssm = rng.standard_normal((3, d_in, cfg.mamba.d_state), np.float32)
    y, jconv, jssm = jmamba.mamba_decode(params["prefix"][0]["mamba"], cfg,
                                         jnp.asarray(x), jnp.asarray(conv),
                                         jnp.asarray(ssm))
    with torch.inference_mode():
        ty, tconv, tssm = mamba.mamba_decode(
            tm.layers[0].mamba, tm.cfg, torch.from_numpy(x),
            torch.from_numpy(conv), torch.from_numpy(ssm))
    np.testing.assert_allclose(_np(ty), np.asarray(y), **TOL)
    np.testing.assert_allclose(_np(tconv), np.asarray(jconv), **TOL)
    np.testing.assert_allclose(_np(tssm), np.asarray(jssm), **TOL)


@pytest.mark.parametrize("name", ["reduced", "variant"])
def test_forward_logits_and_counts(name):
    jm, params, tm = _pair(name)
    toks = np.random.default_rng(3).integers(0, jm.cfg.vocab, (2, 12))
    logits, aux = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tlogits, taux = tm.forward({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tlogits), np.asarray(logits), **TOL)
    np.testing.assert_array_equal(_np(taux["counts"]),
                                  np.asarray(aux["counts"]))
    assert taux["counts"].shape == (len(tm.moe_layers), 2,
                                    jm.cfg.moe.n_experts)


def test_exact_prefill_pool_and_gated_decode(serving_pair):
    """Prompts of two lengths prefilled at their exact lengths into a
    3-row pool (one row idle), then 6 gated decode steps: logits on active
    rows, greedy tokens, counts, positions and every layer's cache match
    the reference's; the idle row's conv/ssm (and K/V) never change."""
    jm, params, tm = serving_pair
    rng = np.random.default_rng(4)
    B, L = 3, 32
    jpool, tpool = jm.init_cache(B, L), tm.init_cache(B, L)
    d_in, _ = mamba._dims(tm.cfg)
    assert tpool["layers"][0]["conv"].shape == (B, 3, d_in)
    assert tpool["layers"][0]["ssm"].dtype == torch.float32
    tok = np.zeros(B, np.int64)
    prefill = jax.jit(lambda p, b, c: jm.prefill(p, b, c))
    with torch.inference_mode():
        for slot, S in ((0, 7), (2, 12)):
            prompt = rng.integers(0, jm.cfg.vocab, (1, S))
            jl, jone, jaux = prefill(params, {"tokens": jnp.asarray(prompt)},
                                     jm.init_cache(1, L))
            jpool = jm.write_slot(jpool, jone, slot)
            tl, tone, taux = tm.prefill({"tokens": torch.from_numpy(prompt)},
                                        tm.init_cache(1, L))
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
            tt = _np(tl.argmax(-1)).astype(np.int64)
            np.testing.assert_array_equal(tt[active], jt[active])
            tok = np.where(active, tt, tok)
    np.testing.assert_array_equal(_np(tpool["pos"]), np.asarray(jpool["pos"]))
    for tl_, jl_, old in zip(tpool["layers"], _unroll(jpool, tm), idle,
                             strict=True):
        assert sorted(tl_) == sorted(jl_)
        for key in tl_:
            np.testing.assert_allclose(_np(tl_[key])[active],
                                       np.asarray(jl_[key],
                                                  np.float32)[active], **TOL)
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


@pytest.mark.parametrize("wire,fenced", [
    (None, False), ("fp32", False), ("fp32", True), ("fp16", False),
    ("fp16", True), ("int8", False), ("int8", True)],
    ids=["all-resident", "fp32", "fp32-fenced", "fp16", "fp16-fenced",
         "int8", "int8-fenced"])
def test_torch_server_matches_jax_server(serving_pair, wire, fenced):
    """All-resident, and at rf 0.5 over each wire, overlap and fenced: the
    same tokens, the same stats keys and equal values on every key but the
    wall-clock demand stall; exact-length prefills, and at least one
    demand upload when streaming."""
    jm, params, tm = serving_pair
    kw = {} if wire is None else dict(resident_fraction=0.5,
                                      transfer_dtype=wire,
                                      fenced_uploads=fenced)

    def cfg(ec, sc, arch):
        return ec(arch=arch, gpu_cache_experts=3, dram_cache_experts=6,
                  scheduler=sc(max_batch=4), **kw)

    jsrv = JaxModelServer(cfg(EngineConfig, SchedulerConfig, jm.cfg), jm,
                          params, cache_len=32)
    tsrv = TorchModelServer(cfg(TorchEngineConfig, TorchSchedulerConfig,
                                tm.cfg), copy.deepcopy(tm), cache_len=32,
                            device="cpu")
    assert (tsrv.slot_runtime is None) == (wire is None)
    assert [tsrv._bucket(S) for S in (3, 5, 12)] == [3, 5, 12]
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


@pytest.mark.parametrize("arch,want", [
    ("qwen3-moe-235b-a22b", [8, 8, 16, 32]),  # attention only: power-of-two pad
    (ARCH, [3, 8, 9, 20])])               # a recurrent layer: exact lengths
def test_bucket_pads_only_attention_only_stacks(arch, want):
    cfg = torch_get_config(arch).reduced()
    model = Model(cfg, device="cpu")
    srv = TorchModelServer(
        TorchEngineConfig(arch=cfg, gpu_cache_experts=3,
                          dram_cache_experts=6), model, cache_len=32,
        device="cpu")
    assert [srv._bucket(S) for S in (3, 8, 9, 20)] == want


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


@pytest.mark.parametrize("wire", [None, "fp32", "fp16", "int8"],
                         ids=["all-resident", "fp32", "fp16", "int8"])
def test_launcher_report_lines_match_reference(pair, wire):
    """``--arch jamba-1.5-large-398b --reduced``: the port's launcher
    prints the reference's report lines on the reference's weights,
    all-resident and at rf 0.5 over each wire (the one MoE layer's 4
    experts all fit the slot floor)."""
    _, params, _ = pair
    stream = [] if wire is None else ["--resident-fraction", "0.5",
                                      "--transfer-dtype", wire]
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
