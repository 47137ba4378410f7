"""The port's model (repro_torch.models) against the reference model in
fp32, with the reference's weights loaded through
``repro_torch.params.from_reference`` and the same numpy inputs fed to
both: the layers on qwen3-moe-235b-a22b ``.reduced()``, and the forward,
padded prefill and pooled decode on the ``.reduced()`` form of every
attention config the port's ``Model`` accepts (rwkv6-7b has its own
file; whisper-small, whose batches carry encoder inputs, is held in
``test_torch_families.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import Model as JaxModel
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import Model
from repro_torch.models import attention, layers, moe
from repro_torch.params import from_reference

torch.set_num_threads(2)

ARCH = "qwen3-moe-235b-a22b"
ARCHS = [ARCH, "qwen2-1.5b", "qwen3-1.7b", "nemotron-4-15b",
         "switch-base-128", "switch-base-256", "switch-large-128",
         "nllb-moe-128", "deepseek-v2-236b", "gemma2-2b", "qwen2-vl-72b"]
TOL = dict(atol=1e-4, rtol=1e-4)     # fp32, sums in other orders


def _pair(arch):
    jm = JaxModel(get_config(arch).reduced())
    params = jm.init(jax.random.PRNGKey(0))
    tm = Model(torch_get_config(arch).reduced(), device="cpu")
    from_reference(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair(ARCH)


@pytest.fixture(scope="module", params=ARCHS)
def arch_pair(request):
    return _pair(request.param)


def _layer0(params, key):
    return jax.tree.map(lambda a: a[0], params["blocks"][0][key])


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jit_prefill(jm):
    """The reference's prefill, compiled once per shape (its eager
    op-by-op dispatch is far slower on the CPU)."""
    return jax.jit(lambda p, b, c, true_len=None: jm.prefill(
        p, b, c, true_len=true_len))


def _same_counts(got, want):
    """Equal MoE counts, or none on either side (a dense stack)."""
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_from_reference_loads_every_parameter(pair):
    jm, params, tm = pair
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert n_ref == sum(p.numel() for p in tm.parameters())
    np.testing.assert_array_equal(
        _np(tm.layers[1].moe.w_up), np.asarray(params["blocks"][0]["moe"]
                                               ["w_up"][1]))


def test_norms_rope_and_activations():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32), np.float32)
    scale = rng.standard_normal(32, np.float32)
    bias = rng.standard_normal(32, np.float32)
    tx, ts, tb = map(torch.from_numpy, (x, scale, bias))
    np.testing.assert_allclose(
        _np(layers.apply_norm(tx, ts)),
        np.asarray(jlayers.apply_norm({"scale": scale}, x)), **TOL)
    np.testing.assert_allclose(
        _np(layers.apply_norm(tx, ts, tb)),
        np.asarray(jlayers.apply_norm({"scale": scale, "bias": bias}, x)),
        **TOL)
    np.testing.assert_allclose(
        _np(layers.rms_norm_headwise(tx, ts)),
        np.asarray(jlayers.rms_norm_headwise(x, scale)), **TOL)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        _np(layers.apply_rope(tx, torch.from_numpy(pos), 1e6)),
        np.asarray(jlayers.apply_rope(x, pos, 1e6)), **TOL)
    for act in ("swiglu", "geglu", "relu2"):
        np.testing.assert_allclose(
            _np(layers.activation(act)(tx)),
            np.asarray(jlayers.activation(act)(x)), **TOL)


@pytest.mark.parametrize("gated", [False, True])
def test_attn_decode_per_slot(pair, gated):
    """One-token decode at per-slot positions: output and the written KV
    rows match; with an ``active`` mask, inactive rows keep their cache."""
    jm, params, tm = pair
    cfg = jm.cfg
    B, T = 4, 16
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 1, cfg.d_model), np.float32)
    ck = rng.standard_normal((B, T, cfg.n_kv_heads, cfg.head_dim_),
                             np.float32)
    cv = rng.standard_normal(ck.shape, np.float32)
    pos = np.array([3, 0, 7, 15], np.int32)
    out, jk, jv = jattn.attn_decode(_layer0(params, "attn"), cfg, x, ck, cv,
                                    pos)
    active = np.array([True, False, True, True]) if gated else None
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tout, tk, tv = attention.attn_decode(
        tm.layers[0].attn, tm.cfg, torch.from_numpy(x), tk, tv,
        torch.from_numpy(pos),
        active=None if active is None else torch.from_numpy(active))
    rows = np.ones(B, bool) if active is None else active
    np.testing.assert_allclose(_np(tout)[rows], np.asarray(out)[rows], **TOL)
    np.testing.assert_allclose(_np(tk)[rows], np.asarray(jk)[rows], **TOL)
    np.testing.assert_allclose(_np(tv)[rows], np.asarray(jv)[rows], **TOL)
    np.testing.assert_array_equal(_np(tk)[~rows], ck[~rows])


@pytest.mark.parametrize("case", ["plain", "token_mask", "drops"])
def test_moe_ffn_matches_and_counts_equal(pair, case):
    jm, params, tm = pair
    cfg = jm.cfg
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, cfg.d_model), np.float32)
    kw, tkw = {}, {}
    if case == "token_mask":
        mask = np.ones((2, 9), bool)
        mask[0, 6:] = False
        mask[1, 2:] = False
        kw["token_mask"] = mask
        tkw["token_mask"] = torch.from_numpy(mask)
    if case == "drops":
        kw["capacity_factor"] = tkw["capacity_factor"] = 0.5
    y, aux = jmoe.moe_ffn(_layer0(params, "moe"), cfg, x, **kw)
    ty, taux = moe.moe_ffn(tm.layers[0].moe, tm.cfg, torch.from_numpy(x),
                           **tkw)
    np.testing.assert_allclose(_np(ty), np.asarray(y), **TOL)
    np.testing.assert_array_equal(_np(taux["counts"]),
                                  np.asarray(aux["counts"]))
    assert taux["counts"].dtype == torch.int32
    np.testing.assert_allclose(float(taux["aux_loss"]),
                               float(aux["aux_loss"]), rtol=1e-5)


def test_forward_logits_and_counts(arch_pair):
    jm, params, tm = arch_pair
    toks = np.random.default_rng(3).integers(0, jm.cfg.vocab, (2, 12))
    logits, aux = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tlogits, taux = tm.forward({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tlogits), np.asarray(logits), **TOL)
    _same_counts(taux["counts"], aux["counts"])


def test_padded_prefill_equals_exact_prefill(arch_pair):
    """Right-padded prefill with ``true_len`` gives the exact-length
    logits, counts and cache rows; both match the reference's."""
    jm, params, tm = arch_pair
    S, P = 11, 16
    toks = np.random.default_rng(4).integers(0, jm.cfg.vocab, (1, S))
    padded = np.zeros((1, P), np.int64)
    padded[:, :S] = toks
    with torch.inference_mode():
        exact = tm.prefill({"tokens": torch.from_numpy(toks)},
                           tm.init_cache(1, 32))
        pad = tm.prefill({"tokens": torch.from_numpy(padded)},
                         tm.init_cache(1, 32), true_len=S)
    np.testing.assert_allclose(_np(pad[0]), _np(exact[0]), atol=1e-5,
                               rtol=1e-5)
    _same_counts(pad[2]["counts"], exact[2]["counts"])
    assert int(pad[1]["pos"][0]) == S
    for a, b in zip(pad[1]["layers"], exact[1]["layers"]):
        for key in a:                    # k/v, or MLA's ckv/kr
            np.testing.assert_allclose(_np(a[key])[:, :S],
                                       _np(b[key])[:, :S], atol=1e-5,
                                       rtol=1e-5)
    jl, _, jaux = _jit_prefill(jm)(params, {"tokens": jnp.asarray(padded)},
                                   jm.init_cache(1, 32), true_len=S)
    np.testing.assert_allclose(_np(pad[0]), np.asarray(jl), **TOL)
    _same_counts(pad[2]["counts"], jaux["counts"])


def test_serve_step_pool_matches_reference(arch_pair):
    """A 3-slot pool: two rows prefilled at different lengths, one idle;
    several gated decode steps give the reference's logits on active rows,
    equal greedy tokens and equal (gated) counts."""
    jm, params, tm = arch_pair
    rng = np.random.default_rng(5)
    B, L = 3, 32
    jpool, tpool = jm.init_cache(B, L), tm.init_cache(B, L)
    tok = np.zeros(B, np.int64)
    prefill = _jit_prefill(jm)
    with torch.inference_mode():
        for slot, S in ((0, 7), (2, 12)):
            prompt = rng.integers(0, jm.cfg.vocab, (1, S))
            jl, jone, _ = prefill(params, {"tokens": jnp.asarray(prompt)},
                                  jm.init_cache(1, L))
            jpool = jm.write_slot(jpool, jone, slot)
            tl, tone, _ = tm.prefill({"tokens": torch.from_numpy(prompt)},
                                     tm.init_cache(1, L))
            tm.write_slot(tpool, tone, slot)
            assert int(np.argmax(jl[0])) == int(tl[0].argmax())
            tok[slot] = int(tl[0].argmax())
        active = np.array([True, False, True])
        step = jax.jit(lambda p, c, t, a: jm.serve_step(p, c, t, active=a))
        for _ in range(4):
            jl, jpool, jaux = step(params, jpool, jnp.asarray(tok, jnp.int32),
                                   jnp.asarray(active))
            tl, tpool, taux = tm.serve_step(tpool, torch.from_numpy(tok),
                                            active=torch.from_numpy(active))
            np.testing.assert_allclose(_np(tl)[active],
                                       np.asarray(jl)[active], **TOL)
            _same_counts(taux["counts"], jaux["counts"])
            jt = np.asarray(jnp.argmax(jl, -1))
            tt = _np(tl.argmax(-1))
            np.testing.assert_array_equal(tt[active], jt[active])
            tok = np.where(active, tt, tok)
        np.testing.assert_array_equal(_np(tpool["pos"]), np.asarray(
            jpool["pos"]))
