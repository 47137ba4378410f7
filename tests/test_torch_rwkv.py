"""The port's RWKV6 path (repro_torch.models.rwkv6, the rwkv blocks of
repro_torch.models.Model, the plain version of kernel B4) against the
reference on rwkv6-7b ``.reduced()`` in fp32: 2 layers, d_model 256, 4
heads x 64, vocab 512. The reference's weights are loaded through
``repro_torch.params.from_reference`` and the same numpy-seeded inputs go
to both packages.

The reference model runs the jnp scan ``_wkv_chunk``; the port runs
``ops.wkv_scan``, whose plain version is held here against
``repro.kernels.ref.wkv6_ref`` and the Pallas ``wkv6`` in interpret mode
(the CUDA kernel itself is checked on the card by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ref as jref
from repro.kernels.wkv6 import wkv6 as pallas_wkv6
from repro.models import Model as JaxModel
from repro.models import rwkv6 as jrwkv
from repro_torch.configs import get_config as torch_get_config
from repro_torch.examples import long_context_rwkv
from repro_torch.kernels import ops, ref
from repro_torch.models import Model, rwkv6
from repro_torch.params import from_reference

torch.set_num_threads(2)

ARCH = "rwkv6-7b"
TOL = dict(atol=1e-4, rtol=1e-4)     # fp32, sums in other orders
BF16_TOL = dict(atol=5e-2, rtol=5e-2)  # o rounded to bf16 (test_kernels)


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(get_config(ARCH).reduced())
    params = jm.init(jax.random.PRNGKey(0))
    tm = Model(torch_get_config(ARCH).reduced(), device="cpu")
    from_reference(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _layer(params, i):
    return jax.tree.map(lambda a: a[i], params["blocks"][0]["rwkv"])


def _wkv_inputs(BH, T, hd, seed):
    """test_kernels.py's distributions: r/k/v N(0, 0.5^2), w = sigmoid(N),
    u N(0, 0.1^2), s0 N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((BH, T, hd), np.float32) * 0.5
               for _ in range(3))
    w = 1 / (1 + np.exp(-rng.standard_normal((BH, T, hd), np.float32)))
    u = rng.standard_normal((BH, hd), np.float32) * 0.1
    s0 = rng.standard_normal((BH, hd, hd), np.float32) * 0.1
    return r, k, v, w.astype(np.float32), u, s0


@pytest.mark.parametrize("BH,T,hd,chunk", [(2, 64, 64, 32), (4, 32, 32, 32),
                                           (1, 128, 64, 64), (3, 37, 32, 37)])
@pytest.mark.parametrize("rkv", ["float32", "bfloat16"])
def test_wkv6_plain_matches_reference_and_pallas(BH, T, hd, chunk, rkv):
    """The plain version against ``wkv6_ref`` and the Pallas kernel
    (interpret mode), r/k/v in fp32 or bf16 next to fp32 w (the model's
    mix); ``ops.wkv_scan`` takes it for CPU tensors."""
    r, k, v, w, u, s0 = _wkv_inputs(BH, T, hd, seed=T)
    jd, td = (jnp.bfloat16, torch.bfloat16) if rkv == "bfloat16" \
        else (jnp.float32, torch.float32)
    jargs = [jnp.asarray(a).astype(jd) for a in (r, k, v)] + \
        [jnp.asarray(a) for a in (w, u, s0)]
    targs = [torch.from_numpy(a).to(td) for a in (r, k, v)] + \
        [torch.from_numpy(a) for a in (w, u, s0)]
    o, sN = ref.wkv6_ref(*targs)
    assert o.dtype == td and o.shape == (BH, T, hd)
    assert sN.dtype == torch.float32 and sN.shape == (BH, hd, hd)
    o_tol = BF16_TOL if rkv == "bfloat16" else TOL
    for jo, jsN in (jref.wkv6_ref(*jargs),
                    pallas_wkv6(*jargs, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(_np(o), _np(jo), **o_tol)
        np.testing.assert_allclose(_np(sN), _np(jsN), **TOL)
    o2, sN2 = ops.wkv_scan(*targs)
    assert torch.equal(o2, o) and torch.equal(sN2, sN)


def test_from_reference_loads_every_parameter(pair):
    jm, params, tm = pair
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert n_ref == sum(p.numel() for p in tm.parameters())
    np.testing.assert_array_equal(
        _np(tm.layers[1].rwkv.decay_B),
        np.asarray(params["blocks"][0]["rwkv"]["decay_B"][1]))


def test_init_sets_the_reference_constants():
    """Model.init draws the random weights and keeps the reference's
    constant ones as constructed."""
    tm = Model(torch_get_config(ARCH).reduced(), device="cpu").init(0)
    p = tm.layers[0].rwkv
    assert torch.all(p.mix == 0.5) and torch.all(p.cm_mix == 0.5)
    assert torch.all(p.decay_base == -0.5) and torch.all(p.u == 0)
    assert float(p.w_r.std()) == pytest.approx(256 ** -0.5, rel=0.05)


def _states(B, H, hd, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, hd, hd), np.float32) * 0.1,
            rng.standard_normal((B, d), np.float32))


@pytest.mark.parametrize("S", [1, 37, 512])
@pytest.mark.parametrize("given", [False, True])
def test_time_and_channel_mix_match_reference(pair, S, given):
    """_projections, rwkv_time_mix and rwkv_channel_mix, from zero state
    and from a given state and token-shift input."""
    jm, params, tm = pair
    cfg, tcfg = jm.cfg, tm.cfg
    d, hd = cfg.d_model, cfg.rwkv.head_dim
    B = 2
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, d), np.float32)
    xs = rng.standard_normal((B, S, d), np.float32)
    jp, tp = _layer(params, 1), tm.layers[1].rwkv
    for a, b in zip(jrwkv._projections(jp, cfg, x, xs),
                    rwkv6._projections(tp, tcfg, torch.from_numpy(x),
                                       torch.from_numpy(xs))):
        np.testing.assert_allclose(_np(b), _np(a), **TOL)
    state, x_prev = _states(B, d // hd, hd, d, seed=S + 1) if given \
        else (None, None)
    t_state, t_prev = (None, None) if not given else \
        (torch.from_numpy(state), torch.from_numpy(x_prev))
    y, (sN, last) = jrwkv.rwkv_time_mix(jp, cfg, x, state, x_prev)
    ty, (tsN, tlast) = rwkv6.rwkv_time_mix(tp, tcfg, torch.from_numpy(x),
                                           t_state, t_prev)
    np.testing.assert_allclose(_np(ty), _np(y), **TOL)
    np.testing.assert_allclose(_np(tsN), _np(sN), **TOL)
    np.testing.assert_array_equal(_np(tlast), _np(last))
    y, last = jrwkv.rwkv_channel_mix(jp, cfg, x, x_prev)
    ty, tlast = rwkv6.rwkv_channel_mix(tp, tcfg, torch.from_numpy(x), t_prev)
    np.testing.assert_allclose(_np(ty), _np(y), **TOL)
    np.testing.assert_array_equal(_np(tlast), _np(last))


def test_both_packages_refuse_a_long_ragged_sequence(pair):
    """Above the reference's 256-step chunk, S must be a multiple of it."""
    jm, params, tm = pair
    x = np.zeros((1, 300, jm.cfg.d_model), np.float32)
    with pytest.raises(AssertionError, match="not divisible"):
        jrwkv.rwkv_time_mix(_layer(params, 0), jm.cfg, x)
    with pytest.raises(ValueError, match="not divisible"):
        rwkv6.rwkv_time_mix(tm.layers[0].rwkv, tm.cfg, torch.from_numpy(x))


def test_forward_logits(pair):
    jm, params, tm = pair
    toks = np.random.default_rng(3).integers(0, jm.cfg.vocab, (2, 12))
    logits, aux = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tlogits, taux = tm.forward({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tlogits), _np(logits), **TOL)
    assert aux["counts"] is None and taux["counts"] is None


def test_prefill_logits_and_every_layer_cache(pair):
    jm, params, tm = pair
    toks = np.random.default_rng(4).integers(0, jm.cfg.vocab, (2, 37))
    jl, jc, _ = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                           jm.init_cache(2, 8))
    with torch.inference_mode():
        tl, tc, taux = tm.prefill({"tokens": torch.from_numpy(toks)},
                                  tm.init_cache(2, 8))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert taux["counts"] is None
    np.testing.assert_array_equal(_np(tc["pos"]), np.asarray(jc["pos"]))
    for i, layer in enumerate(tc["layers"]):
        assert set(layer) == {"state", "tm", "cm"}
        for key, val in layer.items():
            np.testing.assert_allclose(_np(val),
                                       _np(jc["blocks"][0][key][i]), **TOL)


def test_serve_step_pool_matches_reference(pair):
    """A 3-slot pool: two rows prefilled at exact lengths and written into
    their slots, one idle; 8 decode steps under an ``active`` mask that
    retires a row halfway give the reference's logits and greedy tokens on
    active rows, and leave inactive rows' state/tm/cm bit-equal."""
    jm, params, tm = pair
    rng = np.random.default_rng(5)
    B = 3
    jpool, tpool = jm.init_cache(B, 8), tm.init_cache(B, 8)
    tok = np.zeros(B, np.int64)
    with torch.inference_mode():
        for slot, S in ((0, 7), (2, 12)):
            prompt = rng.integers(0, jm.cfg.vocab, (1, S))
            jl, jone, _ = jm.prefill(params, {"tokens": jnp.asarray(prompt)},
                                     jm.init_cache(1, 8))
            jpool = jm.write_slot(jpool, jone, slot)
            tl, tone, _ = tm.prefill({"tokens": torch.from_numpy(prompt)},
                                     tm.init_cache(1, 8))
            tm.write_slot(tpool, tone, slot)
            assert int(np.argmax(jl[0])) == int(tl[0].argmax())
            tok[slot] = int(tl[0].argmax())
        step = jax.jit(lambda p, c, t, a: jm.serve_step(p, c, t, active=a))
        for i in range(8):
            active = np.array([True, False, i < 4])
            before = [{k: v.clone() for k, v in layer.items()}
                      for layer in tpool["layers"]]
            jl, jpool, _ = step(params, jpool, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(active))
            tl, tpool, taux = tm.serve_step(tpool, torch.from_numpy(tok),
                                            active=torch.from_numpy(active))
            assert taux["counts"] is None
            np.testing.assert_allclose(_np(tl)[active], _np(jl)[active],
                                       **TOL)
            for j, (old, new) in enumerate(zip(before, tpool["layers"])):
                for key in old:
                    assert torch.equal(new[key][~torch.from_numpy(active)],
                                       old[key][~torch.from_numpy(active)])
                    np.testing.assert_allclose(
                        _np(new[key]), _np(jpool["blocks"][0][key][j]), **TOL)
            jt = np.asarray(jnp.argmax(jl, -1))
            tt = _np(tl.argmax(-1)).astype(np.int64)
            np.testing.assert_array_equal(tt[active], jt[active])
            tok = np.where(active, tt, tok)
        np.testing.assert_array_equal(_np(tpool["pos"]),
                                      np.asarray(jpool["pos"]))


def test_example_reports_the_reference_state_size(capsys):
    """The example's report lines are the JAX example's: its state size
    (the reference's formula: every cache leaf's bytes) and position."""
    cfg = get_config(ARCH).reduced(n_layers=2, d_model=256)
    cache = JaxModel(cfg).init_cache(1, cache_len=8)
    state_bytes = sum(a.nbytes for a in jax.tree.leaves(cache))
    long_context_rwkv.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == (f"decode state: {state_bytes/1e6:.2f} MB, constant "
                        "in context len")
    assert lines[1].startswith(f"decoded 200 tokens at position ~{64 + 200};")
    assert lines[1].endswith("ms/token on CPU") and len(lines) == 2
