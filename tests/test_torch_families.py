"""The port's Gemma-2 (sliding window over a ring cache, attention and
final softcaps, post-block norms), Qwen2-VL (M-RoPE over stub patch
embeddings) and Whisper (bidirectional encoder, cross-attention, learned
positions) against the reference in fp32, on the ``.reduced()`` configs,
with the reference's weights loaded through ``from_reference`` and the
same numpy inputs fed to both.

Past the wrap of a sliding-window ring the port is held against the
reference's ``forward``: the reference's ``serve_step`` masks the ring
with ``decode_mask(L, pos % L + 1)`` there, which hides in-window keys
(ROADMAP §3), so it is the reference only before the wrap.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import Model as JaxModel
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import ARCH_IDS
from repro_torch.kernels import ref
from repro_torch.models import Model
from repro_torch.models import attention, layers
from repro_torch.params import from_reference

torch.set_num_threads(2)

FAMILIES = ["gemma2-2b", "qwen2-vl-72b", "whisper-small"]
TOL = dict(atol=1e-4, rtol=0)             # fp32, sums in other orders
DECODE_TOL = dict(atol=2e-4, rtol=0)      # ... carried through decode steps
GRID = (1, 2, 3)                # Qwen2-VL's stub patch grid (t, h, w)


def _pair(arch):
    jm = JaxModel(get_config(arch).reduced())
    params = jm.init(jax.random.PRNGKey(0))
    tm = Model(torch_get_config(arch).reduced(), device="cpu")
    from_reference(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def gemma():
    return _pair("gemma2-2b")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _prompt(jm, params, rng, B, S, P=None):
    """A batch of B prompts of S real positions right-padded to P, as
    numpy arrays: tokens; for Qwen2-VL ``embeds`` (a stub patch grid of
    seeded embeddings, then the text tokens' embedding rows) with (3, B, P)
    M-RoPE positions whose t/h/w planes differ over the grid and continue
    from its largest id over the text; for Whisper ``enc_embeds``."""
    cfg = jm.cfg
    P = P or S
    toks = np.zeros((B, P), np.int64)
    toks[:, :S] = rng.integers(0, cfg.vocab, (B, S))
    batch = {"tokens": toks}
    if cfg.attn.mrope_sections:
        t, h, w = GRID
        n = t * h * w
        grid = np.stack(np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                                    indexing="ij")).reshape(3, n)
        text = grid.max() + 1 + np.arange(P - n)
        pos = np.concatenate([grid, np.broadcast_to(text, (3, P - n))], 1)
        embeds = np.asarray(params["embed"], np.float32)[toks]
        embeds[:, :n] = rng.standard_normal((B, n, cfg.d_model)) \
            * cfg.d_model ** -0.5
        batch = {"embeds": embeds.astype(np.float32),
                 "positions": np.broadcast_to(
                     pos[:, None], (3, B, P)).astype(np.int32).copy()}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def test_model_accepts_every_config():
    """Every config builds, and so do the dry run's hill-climb knobs
    (blocked attention, grouped dispatch) since their slice."""
    for name in ARCH_IDS:
        cfg = torch_get_config(name)
        for knobs in ({}, dict(attn_impl="blocked", moe_dispatch="grouped")):
            model = Model(dataclasses.replace(cfg, **knobs), device="meta")
            assert len(model.layers) == cfg.n_layers, name


def test_from_reference_loads_every_parameter(pair):
    jm, params, tm = pair
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert n_ref == sum(p.numel() for p in tm.parameters())
    if jm.cfg.is_encoder_decoder:
        np.testing.assert_array_equal(
            _np(tm.encoder[1].attn.w_q),
            np.asarray(params["encoder"]["attn"]["w_q"][1]))
        np.testing.assert_array_equal(_np(tm.pos_embed),
                                      np.asarray(params["pos_embed"]))


def test_forward_logits(pair):
    jm, params, tm = pair
    batch = _prompt(jm, params, np.random.default_rng(3), 2, 12)
    logits, _ = jax.jit(jm.forward)(params, _jax(batch))
    with torch.inference_mode():
        tlogits, aux = tm.forward(_torch(batch))
    assert aux["counts"] is None
    np.testing.assert_allclose(_np(tlogits), np.asarray(logits), **TOL)


def test_padded_prefill_pool_and_gated_decode(pair):
    """Right-padded prefill (``true_len``) of two prompts into a 3-row
    pool, one row idle, then 6 gated decode steps: equal greedy tokens and
    logits within the decode tolerance; the idle row's caches, the cross
    caches and its position bit-frozen."""
    jm, params, tm = pair
    rng = np.random.default_rng(5)
    B, L, P = 3, 32, 16
    jpool, tpool = jm.init_cache(B, L), tm.init_cache(B, L)
    prefill = jax.jit(lambda p, b, c, n: jm.prefill(p, b, c, true_len=n))
    tok = np.zeros(B, np.int64)
    with torch.inference_mode():
        for slot, S in ((0, 7), (2, 12)):
            batch = _prompt(jm, params, rng, 1, S, P)
            jl, jone, _ = prefill(params, _jax(batch), jm.init_cache(1, L),
                                  S)
            jpool = jm.write_slot(jpool, jone, slot)
            tl, tone, _ = tm.prefill(_torch(batch), tm.init_cache(1, L),
                                     true_len=S)
            tm.write_slot(tpool, tone, slot)
            np.testing.assert_allclose(_np(tl), np.asarray(jl), **DECODE_TOL)
            tok[slot] = int(tl[0].argmax())
            assert tok[slot] == int(np.argmax(jl[0]))
        idle = [{k: v[1].clone() for k, v in layer.items()}
                for layer in tpool["layers"]]
        active = np.array([True, False, True])
        step = jax.jit(lambda p, c, t, a: jm.serve_step(p, c, t, active=a))
        for _ in range(6):
            jl, jpool, _ = step(params, jpool, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(active))
            tl, tpool, _ = tm.serve_step(tpool, torch.from_numpy(tok),
                                         active=torch.from_numpy(active))
            np.testing.assert_allclose(_np(tl)[active],
                                       np.asarray(jl)[active], **DECODE_TOL)
            tt = _np(tl.argmax(-1))
            np.testing.assert_array_equal(
                tt[active], np.asarray(jnp.argmax(jl, -1))[active])
            tok = np.where(active, tt, tok)
    np.testing.assert_array_equal(_np(tpool["pos"]), [13, 0, 18])
    for layer, old in zip(tpool["layers"], idle):
        for key, val in old.items():
            assert torch.equal(layer[key][1], val), key


def test_decode_with_embeds(pair):
    """``serve_step`` on (B, 1, d) embeddings, as the reference takes
    them (learned positions are added at the slot's position)."""
    jm, params, tm = pair
    rng = np.random.default_rng(6)
    batch = _prompt(jm, params, rng, 2, 9)
    x = rng.standard_normal((2, 1, jm.cfg.d_model)).astype(np.float32)
    _, jc, _ = jax.jit(jm.prefill)(params, _jax(batch), jm.init_cache(2, 16))
    jl, _, _ = jax.jit(jm.serve_step)(params, jc, jnp.asarray(x))
    with torch.inference_mode():
        _, tc, _ = tm.prefill(_torch(batch), tm.init_cache(2, 16))
        tl, _, _ = tm.serve_step(tc, torch.from_numpy(x))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **DECODE_TOL)


def test_mrope_with_distinct_planes():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 4000, (3, 2, 5)).astype(np.int32)
    for sections in ((16, 8, 8), (8, 12, 12)):
        np.testing.assert_allclose(
            _np(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                  1e6, sections)),
            np.asarray(jlayers.apply_rope(x, pos, 1e6, sections)), **TOL)
    with pytest.raises(ValueError, match="M-RoPE"):
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), 1e6,
                          (16, 8, 8))


@pytest.mark.parametrize("cap", [0.0, 50.0, 5.0])
def test_flash_decode_ref_softcap_matches_sdpa(cap):
    """The plain B3 with a softcap against the reference's ``_sdpa`` over
    ``decode_mask``: per-slot lengths 0 (uniform softmax), 1, S, ragged."""
    rng = np.random.default_rng(8)
    B, H, Hkv, hd, S = 4, 8, 4, 64, 40
    q = (rng.standard_normal((B, 1, H, hd)) * 4).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    lens = np.array([0, 1, S, 23], np.int32)
    want = jattn._sdpa(q, k, v, jattn.decode_mask(S, lens), cap)[:, 0]
    got = ref.flash_decode_ref(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(lens),
                               cap)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_cross_attention_decode():
    """One cross-attention decode step over the encoder's K/V (Whisper):
    the caches stay as they are, the output is the reference's."""
    jm, params, tm = _pair("whisper-small")
    cfg = jm.cfg
    rng = np.random.default_rng(9)
    enc = rng.standard_normal((2, cfg.encoder_seq_len, cfg.d_model)) \
        .astype(np.float32)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], params["blocks"][0]["cross_attn"])
    jk, jv = jattn.cross_kv(jp, cfg, enc)
    want, _, _ = jattn.attn_decode(jp, cfg, x, jk, jv, 0, cross=True)
    p = tm.layers[0].cross_attn
    tk, tv = attention.cross_kv(p, tm.cfg, torch.from_numpy(enc))
    np.testing.assert_allclose(_np(tk), np.asarray(jk), **TOL)
    before = tk.clone()
    got, ok, _ = attention.attn_decode(p, tm.cfg, torch.from_numpy(x), tk, tv,
                                       torch.tensor([3, 0]), cross=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert ok is tk and torch.equal(tk, before)


def test_ring_decode_past_the_window(gemma):
    """Reduced Gemma-2 (window 128, local layers on even indices) decoded
    past 1.5 x window: row 0 prefilled with 16 tokens, row 1 with 150 (a
    prompt longer than the ring, stored at ``p % 128``). Teacher-forced
    ``serve_step`` logits equal the reference's ``forward`` at every
    position, on both sides of the wrap; before the wrap they also equal
    the reference's ``serve_step``."""
    jm, params, tm = gemma
    win = jm.cfg.attn.sliding_window
    end, L = win * 3 // 2, 200
    assert tm.init_cache(1, L)["layers"][0]["k"].shape[1] == win
    rng = np.random.default_rng(10)
    seqs = rng.integers(0, jm.cfg.vocab, (2, end + 1))
    full, _ = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(seqs)})
    full = np.asarray(full)                           # (2, end + 1, V)
    starts = (16, 150)
    pool = tm.init_cache(2, L)
    jstep = jax.jit(jm.serve_step)
    with torch.inference_mode():
        for row, S in enumerate(starts):
            tl, one, _ = tm.prefill(
                {"tokens": torch.from_numpy(seqs[row:row + 1, :S])},
                tm.init_cache(1, L))
            np.testing.assert_allclose(_np(tl)[0], full[row, S - 1],
                                       **DECODE_TOL)
            tm.write_slot(pool, one, row)
        _, jc, _ = jax.jit(jm.prefill)(
            params, {"tokens": jnp.asarray(seqs[:1, :starts[0]])},
            jm.init_cache(1, L))
        for p in range(starts[0], end + 1):
            active = np.array([True, p >= starts[1]])
            tok = np.where(active, seqs[:, p], 0)
            tl, pool, _ = tm.serve_step(pool, torch.from_numpy(tok),
                                        active=torch.from_numpy(active))
            np.testing.assert_allclose(_np(tl)[active], full[active, p],
                                       **DECODE_TOL)
            if p < win:
                jl, jc, _ = jstep(params, jc, jnp.asarray(seqs[:1, p]))
                np.testing.assert_allclose(_np(tl)[:1], np.asarray(jl),
                                           **DECODE_TOL)
    np.testing.assert_array_equal(_np(pool["pos"]), [end + 1, end + 1])


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-236b"])
def test_decode_window_ring(arch):
    """``init_cache``/``serve_step`` with ``decode_window`` W: every
    attention layer decodes over a ring of W positions. Before the wrap the
    logits equal the reference's ``serve_step`` with the same window (GQA
    and MLA). Past it (GQA), they equal the reference's ``forward`` of the
    same weights with a W-position sliding window on every layer."""
    jm, params, tm = _pair(arch)
    W, L, S, end = 16, 64, 8, 40
    rng = np.random.default_rng(11)
    seq = rng.integers(0, jm.cfg.vocab, (1, end + 1))
    full = None
    if jm.cfg.attn.mla is None:
        wcfg = dataclasses.replace(jm.cfg, attn=dataclasses.replace(
            jm.cfg.attn, sliding_window=W, local_global_period=1))
        full, _ = jax.jit(JaxModel(wcfg).forward)(
            params, {"tokens": jnp.asarray(seq)})
        full = np.asarray(full)[0]
    jstep = jax.jit(lambda p, c, t: jm.serve_step(p, c, t, decode_window=W))
    _, jc, _ = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(seq[:, :S])},
                                   jm.init_cache(1, L, decode_window=W))
    with torch.inference_mode():
        cache = tm.init_cache(1, L, decode_window=W)
        assert all(c.shape[1] == W for layer in cache["layers"]
                   for c in layer.values())
        _, cache, _ = tm.prefill({"tokens": torch.from_numpy(seq[:, :S])},
                                 cache)
        for p in range(S, end + 1):
            tl, cache, _ = tm.serve_step(cache, torch.from_numpy(seq[:, p]),
                                         decode_window=W)
            assert bool(torch.isfinite(tl).all())
            if p < W:
                jl, jc, _ = jstep(params, jc, jnp.asarray(seq[:, p]))
                np.testing.assert_allclose(_np(tl), np.asarray(jl),
                                           **DECODE_TOL)
            if full is not None:
                np.testing.assert_allclose(_np(tl)[0], full[p], **DECODE_TOL)
