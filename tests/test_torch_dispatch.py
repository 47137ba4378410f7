"""The reference's two launch-time variants on the port, against the
reference on the CPU in fp32: blocked attention (``attn_impl="blocked"``,
``_sdpa_blocked``) and grouped MoE dispatch (``moe_dispatch="grouped"``,
``moe_ffn_grouped``), function by function and through ``Model``'s
forward, loss, every gradient, prefill and a pooled decode step, with the
reference's weights loaded through ``from_reference``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import Model as JaxModel
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import Model
from repro_torch.models import attention, moe
from repro_torch.params import from_reference, reference_leaves
from repro_torch.serving.slot_runtime import SlotStreamRuntime

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=1e-4)   # tests/test_kernels.py::_tol, fp32
QWEN3, DEEPSEEK, GEMMA2 = ("qwen3-moe-235b-a22b", "deepseek-v2-236b",
                           "gemma2-2b")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _pair(arch, **repl):
    """(reference model, its params, the port's model with them), both of
    the reduced config with ``repl`` applied."""
    jm = JaxModel(dataclasses.replace(get_config(arch).reduced(), **repl))
    params = jm.init(jax.random.PRNGKey(0))
    tm = Model(dataclasses.replace(torch_get_config(arch).reduced(), **repl),
               device="cpu")
    from_reference(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


# ---------------------------------------------------------------------------
# _sdpa_blocked
# ---------------------------------------------------------------------------

# (B, S, T, H, Hkv, hd, offset, window, causal, softcap): blocks of 8
# queries and 16 keys, so S and T pad in their last block
BLOCKED_CASES = {
    "causal-padded": (2, 21, 21, 4, 2, 16, 0, 0, True, 0.0),
    "window": (1, 40, 40, 2, 1, 16, 0, 10, True, 0.0),
    "softcap": (2, 19, 19, 4, 4, 8, 0, 0, True, 5.0),
    "offset": (1, 13, 37, 4, 2, 16, 24, 0, True, 0.0),
    "offset-window-gqa": (2, 9, 33, 8, 2, 8, 24, 12, True, 3.0),
    "noncausal": (2, 17, 35, 4, 2, 16, 0, 0, False, 0.0),
}


@pytest.mark.parametrize("case", list(BLOCKED_CASES))
def test_sdpa_blocked_matches_reference(case):
    B, S, T, H, Hkv, hd, offset, window, causal, cap = BLOCKED_CASES[case]
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32) * 2.0
               for s in ((B, S, H, hd), (B, T, Hkv, hd), (B, T, Hkv, hd)))
    kw = dict(offset=offset, window=window, causal=causal, block_q=8,
              block_kv=16)
    want = jattn._sdpa_blocked(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), cap, **kw)
    got = attention._sdpa_blocked(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), cap, **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_sdpa_blocked_equals_the_full_scores():
    """At the default blocks (one block each here), blocked attention is
    the naive (S, T) softmax with the causal window mask."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 30, 4, 16))
                         .astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 30, 2, 16))
                             .astype(np.float32)) for _ in range(2))
    mask = attention.causal_mask(30, 30, window=7)
    np.testing.assert_allclose(
        _np(attention._sdpa_blocked(q, k, v, 0.0, window=7)),
        _np(attention._sdpa(q, k, v, mask, 0.0)), **TOL)


# ---------------------------------------------------------------------------
# moe_ffn_grouped
# ---------------------------------------------------------------------------


def _moe_params(mod):
    """A port MoE module's weights as the reference's param dict."""
    out = {}
    for name, p in mod.named_parameters():
        *path, leaf = name.split(".")
        d = out
        for key in path:
            d = d.setdefault(key, {})
        d[leaf] = jnp.asarray(_np(p))
    return out


@pytest.mark.parametrize("arch", [QWEN3, DEEPSEEK])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "token_mask"])
@pytest.mark.parametrize("cf", [None, 0.5], ids=["cf-default", "cf0.5"])
def test_moe_ffn_grouped_matches_reference(arch, masked, cf):
    """y, counts and aux_loss of the grouped dispatch (3 sequences, each
    its own capacity; DeepSeek-V2 adds shared experts); cf 0.5 drops, and
    a token mask drops each row at its own real length's capacity."""
    cfg = dataclasses.replace(torch_get_config(arch).reduced(),
                              moe_dispatch="grouped")
    jcfg = dataclasses.replace(get_config(arch).reduced(),
                               moe_dispatch="grouped")
    tm = Model(cfg, device="cpu").init(3)
    mod = tm.layers[tm.moe_layers[0]].moe
    rng = np.random.default_rng(2)
    B, S = 3, 10
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    mask = (np.arange(S)[None] < np.asarray([10, 4, 7])[:, None]) \
        if masked else None
    want_y, want = jmoe.moe_ffn(
        _moe_params(mod), jcfg, jnp.asarray(x), capacity_factor=cf,
        token_mask=None if mask is None else jnp.asarray(mask))
    got_y, got = moe.moe_ffn(
        mod, cfg, torch.from_numpy(x), capacity_factor=cf,
        token_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got_y), np.asarray(want_y), **TOL)
    np.testing.assert_array_equal(_np(got["counts"]),
                                  np.asarray(want["counts"]))
    np.testing.assert_allclose(float(got["aux_loss"]),
                               float(want["aux_loss"]), **TOL)


def test_grouped_dispatch_differs_from_global_where_capacity_binds():
    """The two dispatches are different functions: at a capacity that
    drops, per-sequence clipping keeps other tokens than the global one
    (so the test above holds the grouped path, not the global one)."""
    cfg = dataclasses.replace(torch_get_config(QWEN3).reduced(),
                              moe_dispatch="grouped")
    tm = Model(cfg, device="cpu").init(3)
    mod = tm.layers[tm.moe_layers[0]].moe
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 10, cfg.d_model)).astype(np.float32))
    grouped, _ = moe.moe_ffn(mod, cfg, x, capacity_factor=0.5)
    flat, _ = moe.moe_ffn(mod, dataclasses.replace(cfg,
                                                   moe_dispatch="global"),
                          x, capacity_factor=0.5)
    assert not torch.allclose(grouped, flat, **TOL)
    one, _ = moe.moe_ffn(mod, cfg, x[:1], capacity_factor=0.5)
    np.testing.assert_allclose(
        _np(one), _np(moe.moe_ffn(mod, dataclasses.replace(
            cfg, moe_dispatch="global"), x[:1], capacity_factor=0.5)[0]),
        **TOL)


# ---------------------------------------------------------------------------
# Model with the variants
# ---------------------------------------------------------------------------

MODEL_CASES = {
    "qwen3-grouped": (QWEN3, dict(moe_dispatch="grouped")),
    "qwen3-blocked": (QWEN3, dict(attn_impl="blocked")),
    "qwen3-both": (QWEN3, dict(moe_dispatch="grouped", attn_impl="blocked")),
    "gemma2-blocked": (GEMMA2, dict(attn_impl="blocked")),
}


@pytest.fixture(scope="module", params=list(MODEL_CASES))
def variant(request):
    arch, repl = MODEL_CASES[request.param]
    return _pair(arch, **repl)


def test_forward_loss_and_every_gradient_match_reference(variant):
    jm, params, tm = variant
    tm.trainable()
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tm.cfg.vocab, (3, 12)).astype(np.int32)
    batch_j = {"tokens": jnp.asarray(toks)}
    batch_t = {"tokens": torch.from_numpy(toks).long()}
    jlog, jaux = jax.jit(jm.forward)(params, batch_j)
    tlog, taux = tm.forward(batch_t)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
    if jaux["counts"] is not None:
        np.testing.assert_array_equal(_np(taux["counts"]),
                                      np.asarray(jaux["counts"]))
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, batch_j, remat=True)))(params)
    tl = tm.loss(batch_t, remat=True)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    want = reference_leaves(tm, jax.tree.map(np.asarray, jg))
    for n, p in tm.named_parameters():
        assert p.grad is not None, n
        np.testing.assert_allclose(_np(p.grad), want[n], err_msg=n, **TOL)
    tm.trainable(False)


def test_prefill_and_pooled_decode_match_reference(variant):
    """Right-padded prefill of 3 rows (the grouped dispatch's token mask
    per row) and two pooled decode steps (grouped over the pool's rows)."""
    jm, params, tm = variant
    rng = np.random.default_rng(1)
    B, P, L = 3, 12, 16
    lens = np.asarray([12, 5, 9], np.int32)
    toks = rng.integers(0, tm.cfg.vocab, (B, P)).astype(np.int32)
    jl, jc, jaux = jax.jit(lambda p, b, c, t: jm.prefill(
        p, b, c, true_len=t))(params, {"tokens": jnp.asarray(toks)},
                              jm.init_cache(B, L), jnp.asarray(lens))
    with torch.inference_mode():
        tc = tm.init_cache(B, L)
        tl, tc, taux = tm.prefill({"tokens": torch.from_numpy(toks).long()},
                                  tc, true_len=torch.from_numpy(lens))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        if jaux["counts"] is not None:
            np.testing.assert_array_equal(_np(taux["counts"]),
                                          np.asarray(jaux["counts"]))
        step = jax.jit(jm.serve_step)
        for _ in range(2):
            tok = np.asarray(jl).argmax(-1).astype(np.int32)
            jl, jc, _ = step(params, jc, jnp.asarray(tok))
            tl, tc, _ = tm.serve_step(tc, torch.from_numpy(tok).long())
            np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)


def test_slot_runtime_refuses_grouped_dispatch():
    cfg = dataclasses.replace(torch_get_config(QWEN3).reduced(),
                              moe_dispatch="grouped")
    model = Model(cfg, device="cpu").init(0)
    with pytest.raises(NotImplementedError, match="global dispatch"):
        SlotStreamRuntime(model, n_pool_slots=2, n_weight_slots=8)
    assert model.layers[model.moe_layers[0]].moe.w_up.numel()
