"""The port keeps fp32 inside a bf16 model where the reference does, held
op by op: the router's softmax and top-k, the norms' statistics, RoPE's
angles, the attention softmax, and the recurrent states of RWKV6 and
Mamba.

A single misplaced cast hides under the whole-model criterion of
``test_torch_bf16.py``: its one extra rounding is smaller than the bf16
noise that both runs carry through a model. So each of these cast points
is also held on its own, on bf16 inputs made from a seed, against the same
op of the reference run in fp32 on those inputs upcast (the yardstick):

- an fp32 output (router probabilities and gates, recurrent states,
  Mamba's scan output) lies within fp32 tolerance of the yardstick;
- a bf16 output that is computed in fp32 and rounded once (norms, RoPE,
  the RWKV6 output) lies within half a bf16 ulp of the yardstick, element by
  element, with fp32 slack: what one rounding allows and a second one
  does not. The reference's own bf16 output is held to the same bound.

Attention rounds its scores to bf16 in the reference (the q.k einsum), so
the port's ``_sdpa`` is held to the reference's own bf16 output instead:
at most one bf16 ulp apart, element by element."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models.mamba import _scan_chunk
from repro.models.rwkv6 import _wkv_chunk
from repro_torch.kernels import ops
from repro_torch.models import attention, layers, moe

torch.set_num_threads(2)

FP32 = dict(atol=1e-6, rtol=1e-5)


def _bf16(rng, shape, scale=1.0, shift=0.0):
    """A seeded normal array rounded to bf16: (numpy fp32 of the bf16
    values, the torch bf16 tensor, the jax bf16 array)."""
    a = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    t = torch.from_numpy(a).bfloat16()
    return t.float().numpy(), t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def half_ulps(got, want):
    """Largest |got - want| in half bf16 ulps of ``want`` (after fp32
    slack: 1e-5 relative, 1e-6 of the output's rms)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    a = np.abs(want)
    ulp = np.exp2(np.floor(np.log2(np.maximum(a, 2.0 ** -126))) - 7)
    slack = 1e-5 * a + 1e-6 * np.sqrt(np.mean(want ** 2))
    return float((np.maximum(np.abs(got - want) - slack, 0) / (ulp / 2))
                 .max())


def assert_rounded_once(what, got, want):
    n = half_ulps(got, want)
    assert n <= 1, f"{what}: {n:.2f} half-ulps from the fp32 yardstick"


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v2-236b",
                                  "switch-base-128"])
def test_router_softmax_and_topk_in_fp32(arch):
    """``route`` on bf16 tokens: probabilities and gates in fp32 within
    fp32 tolerance of the yardstick (the reference's bf16 run equals it),
    the same top-k."""
    m = get_config(arch).reduced().moe
    rng = np.random.default_rng(0)
    x32, xt, xj = _bf16(rng, (64, 256))
    w = (rng.standard_normal((256, m.n_experts)) * 0.06).astype(np.float32)
    g, idx, probs = moe.route(types.SimpleNamespace(
        w_router=torch.from_numpy(w)), m, xt)
    ref = jmoe.route({"w_router": jnp.asarray(w)}, m, xj)
    want = jmoe.route({"w_router": jnp.asarray(w)}, m, jnp.asarray(x32))
    for a, b in zip(ref, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert g.dtype == probs.dtype == torch.float32
    np.testing.assert_array_equal(_np(idx), np.asarray(want[1]))
    np.testing.assert_allclose(_np(g), np.asarray(want[0]), **FP32)
    np.testing.assert_allclose(_np(probs), np.asarray(want[2]), **FP32)


@pytest.mark.parametrize("kind", ["rms", "layer", "headwise"])
def test_norms_round_once(kind):
    """The norms' statistics in fp32: one rounding of the output."""
    rng = np.random.default_rng(1)
    shape = (4, 7, 4, 64) if kind == "headwise" else (4, 7, 256)
    x32, xt, xj = _bf16(rng, shape, 3.0, 0.5)
    s32, st, sj = _bf16(rng, shape[-1:], 0.1, 1.0)
    b32, bt, bj = _bf16(rng, shape[-1:], 0.1)
    if kind == "headwise":
        got = layers.rms_norm_headwise(xt, st)
        ref = jlayers.rms_norm_headwise(xj, sj)
        want = jlayers.rms_norm_headwise(jnp.asarray(x32), jnp.asarray(s32))
    else:
        bias = kind == "layer"
        got = layers.apply_norm(xt, st, bt if bias else None)
        p16 = {"scale": sj, **({"bias": bj} if bias else {})}
        p32 = {"scale": jnp.asarray(s32),
               **({"bias": jnp.asarray(b32)} if bias else {})}
        ref = jlayers.apply_norm(p16, xj)
        want = jlayers.apply_norm(p32, jnp.asarray(x32))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert_rounded_once("reference", _np(ref), np.asarray(want))
    assert_rounded_once("port", _np(got), np.asarray(want))


@pytest.mark.parametrize("sections", [(), (16, 8, 8)],
                         ids=["rope", "mrope"])
def test_rope_rounds_once(sections):
    """RoPE's angles, cos and sin in fp32 at positions up to 4000: one
    rounding of the rotated bf16 output."""
    rng = np.random.default_rng(5)
    x32, xt, xj = _bf16(rng, (2, 9, 4, 64))
    shape = (3, 2, 9) if sections else (2, 9)
    pos = rng.integers(0, 4000, shape).astype(np.int32)
    got = layers.apply_rope(xt, torch.from_numpy(pos), 1e6, sections)
    ref = jlayers.apply_rope(xj, jnp.asarray(pos), 1e6, sections)
    want = jlayers.apply_rope(jnp.asarray(x32), jnp.asarray(pos), 1e6,
                              sections)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert_rounded_once("reference", _np(ref), np.asarray(want))
    assert_rounded_once("port", _np(got), np.asarray(want))


@pytest.mark.parametrize("cap,hd", [(0.0, 64), (0.0, 128), (50.0, 128)])
def test_attention_softmax_in_fp32(cap, hd):
    """``_sdpa`` on bf16 q, k, v under a causal mask: scores rounded once
    by the q.k product, the softmax in fp32, its weights rounded once, as
    the reference does; at most one bf16 ulp from the reference's own
    bf16 output."""
    rng = np.random.default_rng(2)
    B, S, H, Hkv = 2, 24, 8, 2
    _, qt, qj = _bf16(rng, (B, S, H, hd), 2.0)
    _, kt, kj = _bf16(rng, (B, S, Hkv, hd))
    _, vt, vj = _bf16(rng, (B, S, Hkv, hd))
    mask = jattn.causal_mask(S, S)
    got = attention._sdpa(qt, kt, vt, torch.from_numpy(np.array(mask)),
                          cap)
    ref = jattn._sdpa(qj, kj, vj, mask, cap)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    n = half_ulps(_np(got), _np(ref))
    assert n <= 2, f"{n:.2f} half-ulps from the reference's bf16 output"


def test_wkv_state_in_fp32():
    """RWKV6's recurrence over 64 steps of bf16 r, k, v, w: an fp32 state
    (the final one within fp32 tolerance of the yardstick) and an output
    rounded once."""
    rng = np.random.default_rng(3)
    B, H, T, hd = 2, 4, 64, 64
    r32, rt, _ = _bf16(rng, (B, H, T, hd), 0.5)
    k32, kt, _ = _bf16(rng, (B, H, T, hd), 0.5)
    v32, vt, _ = _bf16(rng, (B, H, T, hd), 0.5)
    # decays in (0, 1), as exp(-exp(.)) of the model's w
    wt = torch.from_numpy(np.exp(-np.exp(rng.standard_normal(
        (B, H, T, hd)) - 2.0)).astype(np.float32)).bfloat16()
    w32 = wt.float().numpy()
    u32, ut, _ = _bf16(rng, (H, hd), 0.5)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)

    def rows(t):
        return t.reshape(B * H, *t.shape[2:]).contiguous()
    o, sN = ops.wkv_scan(rows(rt), rows(kt), rows(vt), rows(wt),
                         ut.expand(B, H, hd).reshape(B * H, hd).contiguous(),
                         torch.from_numpy(s0).reshape(B * H, hd, hd))
    assert o.dtype == torch.bfloat16 and sN.dtype == torch.float32

    def heads_last(a):                     # (B, H, T, hd) -> (B, T, H, hd)
        return jnp.asarray(np.moveaxis(a, 1, 2))
    want_s, want_o = _wkv_chunk(jnp.asarray(s0), heads_last(r32),
                                heads_last(k32), heads_last(v32),
                                heads_last(w32), jnp.asarray(u32))
    want_o = np.moveaxis(np.asarray(want_o), 2, 1).reshape(B * H, T, hd)
    assert_rounded_once("output", _np(o), want_o)
    np.testing.assert_allclose(_np(sN), np.asarray(want_s).reshape(
        B * H, hd, hd), atol=1e-4, rtol=1e-4)


def test_mamba_scan_in_fp32():
    """The selective scan over 64 steps of bf16 x, B, C and fp32 dt, A:
    an fp32 state and output within fp32 tolerance of the yardstick."""
    rng = np.random.default_rng(4)
    B, T, D, N = 2, 64, 32, 16
    x32, xt, _ = _bf16(rng, (B, T, D))
    b32, bt, _ = _bf16(rng, (B, T, N))
    c32, ct, _ = _bf16(rng, (B, T, N))
    dt = np.log1p(np.exp(rng.standard_normal((B, T, D)) - 1.0)) \
        .astype(np.float32)
    A = -np.exp(rng.standard_normal((D, N)) * 0.5).astype(np.float32)
    h0 = (rng.standard_normal((B, D, N)) * 0.1).astype(np.float32)
    y, hT = ops.selective_scan(xt, torch.from_numpy(dt), torch.from_numpy(A),
                               bt, ct, torch.from_numpy(h0))
    assert y.dtype == hT.dtype == torch.float32
    dA = np.exp(dt[..., None] * A)
    dBx = (dt * x32)[..., None] * b32[..., None, :]
    want_h, want_y = _scan_chunk(jnp.asarray(h0), jnp.asarray(dA),
                                 jnp.asarray(dBx), jnp.asarray(c32))
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(y), np.asarray(want_y), **tol)
    np.testing.assert_allclose(_np(hT), np.asarray(want_h), **tol)
