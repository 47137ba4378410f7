"""The plain backwards of B4 and B5 (``kernels.ref.wkv6_bwd_ref``,
``selective_scan_bwd_ref``: explicit reverse-time fp32 loops, the CPU side
of the autograd Functions ``WKV6`` and ``SelectiveScan``) against
``jax.grad`` through the reference's scans, and against autograd through
the port's plain forwards, at small sizes in fp32. Every gradient is held,
the initial states' included, with decays near 0 (some exactly 0) and near
1, and a Mamba dt large enough that exp(dt * A) underflows. T = 40 spans
five of the CUDA backwards' 8-step checkpoint chunks (their kernels are
held against these plain versions on the card by ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` phases 3f/3g)."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import mamba as jmamba
from repro.models import rwkv6 as jrwkv
from repro_torch.configs import get_config as torch_get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.selective_scan import SelectiveScan
from repro_torch.kernels.wkv6 import WKV6
from repro_torch.models import mamba

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=1e-4)     # tests/test_kernels.py::_tol, fp32


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, name):
    """``TOL`` for a gradient of O(1) elements; a larger one (dt ~60 scales
    a Mamba gradient to O(100)) takes atol times its RMS: its elements
    are sums of terms of that size, whose fp32 rounding does not shrink
    where they cancel."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.sqrt(np.mean(want * want))))
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                               atol=TOL["atol"] * scale, err_msg=name)


def _wkv_case(B, H, T, hd, decay, seed):
    """(B, T, H, hd) r/k/v N(0, 0.5^2), w by ``decay`` (sigmoid(N(0, 1));
    "near0": in [0, 1e-3) with a quarter exactly 0; "near1": in [0.99,
    1)), u (H, hd) and s0 N(0, 0.1^2), and upstream gradients N(0, 1)."""
    rng = np.random.default_rng(seed)

    def n(*shape, std=1.0):
        return rng.standard_normal(shape, np.float32) * std
    r, k, v = (n(B, T, H, hd, std=0.5) for _ in range(3))
    if decay == "near0":
        w = rng.uniform(0, 1e-3, (B, T, H, hd)).astype(np.float32)
        w[rng.random(w.shape) < 0.25] = 0.0
    elif decay == "near1":
        w = rng.uniform(0.99, 1.0, (B, T, H, hd)).astype(np.float32)
    else:
        w = 1 / (1 + np.exp(-n(B, T, H, hd)))
    return dict(r=r, k=k, v=v, w=w, u=n(H, hd, std=0.1),
                s0=n(B, H, hd, hd, std=0.1), do=n(B, T, H, hd),
                dsN=n(B, H, hd, hd))


def _rows(a):
    """(B, T, H, hd) -> the kernel's (B*H, T, hd) rows."""
    B, T, H, hd = a.shape
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 2, 1, 3).reshape(B * H, T, hd)))


def _unrows(t, B):
    """(B*H, T, hd) -> (B, T, H, hd)."""
    BH, T, hd = t.shape
    return _np(t).reshape(B, BH // B, T, hd).transpose(0, 2, 1, 3)


def _jax_wkv_grads(c):
    """jax.grad of <o, do> + <sN, dsN> through the reference's
    ``_wkv_chunk``, w.r.t. s0, r, k, v, w, u."""
    def loss(s0, r, k, v, w, u):
        sN, out = jrwkv._wkv_chunk(s0, r, k, v, w, u)
        return jnp.sum(out * c["do"]) + jnp.sum(sN * c["dsN"])
    names = ("s0", "r", "k", "v", "w", "u")
    grads = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(c[n]) for n in names))
    return {n: np.asarray(g) for n, g in zip(names, grads)}


def _port_wkv_args(c):
    B, _, H, hd = c["r"].shape
    u = torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(c["u"], (B, H, hd)).reshape(B * H, hd)))
    return (_rows(c["r"]), _rows(c["k"]), _rows(c["v"]), _rows(c["w"]), u,
            torch.from_numpy(c["s0"].reshape(B * H, hd, hd)))


@pytest.mark.parametrize("decay", ["sigmoid", "near0", "near1"])
@pytest.mark.parametrize("T,hd", [(1, 64), (7, 32), (40, 64)])
def test_wkv6_bwd_ref_matches_jax_grad(T, hd, decay):
    """Every gradient of the RWKV6 recurrence, s0's and u's (summed over
    the batch, as the model's ``expand`` does) included, against jax.grad
    through the reference's ``_wkv_chunk``; B 2 x H 3 rows."""
    B, H = 2, 3
    c = _wkv_case(B, H, T, hd, decay, seed=T * hd)
    want = _jax_wkv_grads(c)
    dr, dk, dv, dw, du, ds0 = ref.wkv6_bwd_ref(
        *_port_wkv_args(c), _rows(c["do"]),
        torch.from_numpy(c["dsN"].reshape(B * H, hd, hd)))
    for name, got in (("r", dr), ("k", dk), ("v", dv), ("w", dw)):
        _close(_unrows(got, B), want[name], name)
    _close(_np(du).reshape(B, H, hd).sum(0), want["u"], "u")
    _close(_np(ds0).reshape(B, H, hd, hd), want["s0"], "s0")


@pytest.mark.parametrize("decay", ["sigmoid", "near0", "near1"])
def test_wkv6_function_matches_autograd_through_plain(decay):
    """``ops.wkv_scan`` under a gradient goes through ``WKV6`` (the plain
    forward, then ``wkv6_bwd_ref``): outputs equal ``wkv6_ref``'s, and
    every gradient equals autograd through ``wkv6_ref``."""
    B, H, T, hd = 2, 2, 40, 32
    c = _wkv_case(B, H, T, hd, decay, seed=7)
    args = _port_wkv_args(c)
    do = _rows(c["do"])
    dsN = torch.from_numpy(c["dsN"].reshape(B * H, hd, hd))
    got_in = [t.clone().requires_grad_() for t in args]
    o, sN = ops.wkv_scan(*got_in)
    assert type(o.grad_fn).__name__ == f"{WKV6.__name__}Backward"
    torch.autograd.backward((o, sN), (do, dsN))
    want_in = [t.clone().requires_grad_() for t in args]
    o_ref, sN_ref = ref.wkv6_ref(*want_in)
    torch.autograd.backward((o_ref, sN_ref), (do, dsN))
    assert torch.equal(o.detach(), o_ref.detach())
    assert torch.equal(sN.detach(), sN_ref.detach())
    for name, a, b in zip("rkvwus", got_in, want_in):
        _close(_np(a.grad), _np(b.grad), name)


def _scan_case(B, T, D, N, big_dt, seed):
    """x/B/C N(0, 1), dt = softplus(N(0, 1)) (a third of it 40-100 with
    ``big_dt``: exp(dt * A) underflows to 0 for every state), A = -(1..N)
    per channel, h0 N(0, 0.5^2), upstream gradients N(0, 1)."""
    rng = np.random.default_rng(seed)

    def n(*shape, std=1.0):
        return rng.standard_normal(shape, np.float32) * std
    dt = np.log1p(np.exp(n(B, T, D))).astype(np.float32)
    if big_dt:
        big = rng.random(dt.shape) < 1 / 3
        dt[big] = rng.uniform(40, 100, int(big.sum()))
    A = -np.broadcast_to(np.arange(1, N + 1, dtype=np.float32),
                         (D, N)).copy()
    return dict(x=n(B, T, D), dt=dt, A=A, Bm=n(B, T, N), Cm=n(B, T, N),
                h0=n(B, D, N, std=0.5), dy=n(B, T, D), dhT=n(B, D, N))


SCAN_INPUTS = ("x", "dt", "A", "Bm", "Cm", "h0")


def _jax_scan_loss(x, dt, A, Bm, Cm, h0, dy, dhT):
    # dA and dBx formed as the reference's ``_ssm_params`` forms them
    dA = jnp.exp(dt[..., None] * A)
    dBx = (dt * x)[..., None] * Bm[..., None, :]
    hN, y = jmamba._scan_chunk(h0, dA, dBx, Cm)
    return jnp.sum(y * dy) + jnp.sum(hN * dhT)


@pytest.mark.parametrize("T,N,big_dt", [(1, 8, False), (7, 16, False),
                                        (40, 16, False), (40, 8, True)])
def test_selective_scan_bwd_ref_matches_jax_grad(T, N, big_dt):
    """Every gradient of the selective scan (x, dt, A, B, C and h0)
    against jax.grad through the reference's ``_scan_chunk`` over dA/dBx
    formed as in ``_ssm_params``; B 2, d_in 64."""
    c = _scan_case(2, T, 64, N, big_dt, seed=T + N)
    grads = jax.grad(_jax_scan_loss, argnums=tuple(range(6)))(
        *(jnp.asarray(c[n]) for n in SCAN_INPUTS + ("dy", "dhT")))
    got = ref.selective_scan_bwd_ref(
        *(torch.from_numpy(c[n]) for n in SCAN_INPUTS + ("dy", "dhT")))
    for name, g, w in zip(SCAN_INPUTS, got, grads):
        assert bool(torch.isfinite(g).all()), name
        _close(_np(g), w, name)


@pytest.mark.parametrize("big_dt", [False, True])
def test_selective_scan_function_matches_autograd_through_plain(big_dt):
    """``ops.selective_scan`` under a gradient goes through
    ``SelectiveScan`` (the plain forward, then ``selective_scan_bwd_ref``):
    outputs equal ``selective_scan_ref``'s, and every gradient equals
    autograd through ``selective_scan_ref``."""
    c = _scan_case(2, 40, 48, 16, big_dt, seed=11)
    args = [torch.from_numpy(c[n]) for n in SCAN_INPUTS]
    dy, dhT = torch.from_numpy(c["dy"]), torch.from_numpy(c["dhT"])
    got_in = [t.clone().requires_grad_() for t in args]
    y, hT = ops.selective_scan(*got_in)
    assert type(y.grad_fn).__name__ == f"{SelectiveScan.__name__}Backward"
    torch.autograd.backward((y, hT), (dy, dhT))
    want_in = [t.clone().requires_grad_() for t in args]
    y_ref, hT_ref = ref.selective_scan_ref(*want_in)
    torch.autograd.backward((y_ref, hT_ref), (dy, dhT))
    assert torch.equal(y.detach(), y_ref.detach())
    assert torch.equal(hT.detach(), hT_ref.detach())
    for name, a, b in zip(SCAN_INPUTS, got_in, want_in):
        assert bool(torch.isfinite(a.grad).all()), name
        _close(_np(a.grad), _np(b.grad), name)


MAMBA_PARAMS = ("w_x_dbc", "w_dt", "dt_bias", "A_log")


@pytest.mark.parametrize("N,dt_bias", [(8, 0.0), (16, 60.0)])
def test_mamba_scan_gradients_match_jax_through_ssm_params(N, dt_bias):
    """The layer's scan under a gradient, from the post-conv activations:
    the port's ``_ssm_inputs`` + ``ops.selective_scan`` (through
    ``SelectiveScan``) against jax.grad through the reference's
    ``_ssm_params`` + ``_scan_chunk``, w.r.t. xc, w_x_dbc, w_dt, dt_bias,
    A_log and h0; jamba reduced to d_model 32 (d_in 64). dt_bias 60 makes
    dt ~60, so exp(dt * A) underflows for every state but the first."""
    def cfg_of(get):
        cfg = get("jamba-1.5-large-398b").reduced()
        return dataclasses.replace(cfg, d_model=32, mamba=dataclasses.replace(
            cfg.mamba, d_state=N))
    jcfg, tcfg = cfg_of(get_config), cfg_of(torch_get_config)
    d_in, dt_rank = jmamba._dims(jcfg)
    B, T = 2, 40
    rng = np.random.default_rng(N)

    def n(*shape, std=1.0):
        return rng.standard_normal(shape, np.float32) * std
    c = {"xc": n(B, T, d_in),
         "w_x_dbc": n(d_in, dt_rank + 2 * N, std=d_in ** -0.5),
         "w_dt": n(dt_rank, d_in, std=dt_rank ** -0.5),
         "dt_bias": np.full(d_in, dt_bias, np.float32),
         "A_log": np.log(np.broadcast_to(
             np.arange(1, N + 1, dtype=np.float32), (d_in, N))).copy(),
         "h0": n(B, d_in, N, std=0.5)}
    dy, dhT = n(B, T, d_in), n(B, d_in, N)

    def jloss(xc, w_x_dbc, w_dt, dt_b, A_log, h0):
        p = dict(w_x_dbc=w_x_dbc, w_dt=w_dt, dt_bias=dt_b, A_log=A_log)
        dA, dBx, Cm = jmamba._ssm_params(p, jcfg, xc)
        hN, y = jmamba._scan_chunk(h0, dA, dBx, Cm)
        return jnp.sum(y * dy) + jnp.sum(hN * dhT)
    names = ("xc",) + MAMBA_PARAMS + ("h0",)
    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(c[k]) for k in names))

    t = {k: torch.from_numpy(c[k]).requires_grad_() for k in names}
    p = types.SimpleNamespace(**{k: t[k] for k in MAMBA_PARAMS})
    dt, A, Bm, Cm = mamba._ssm_inputs(p, tcfg, t["xc"])
    y, hT = ops.selective_scan(t["xc"], dt, A, Bm, Cm, t["h0"])
    assert type(y.grad_fn).__name__ == f"{SelectiveScan.__name__}Backward"
    torch.autograd.backward((y, hT), (torch.from_numpy(dy),
                                      torch.from_numpy(dhT)))
    for k, w in zip(names, want):
        assert bool(torch.isfinite(t[k].grad).all()), k
        _close(_np(t[k].grad), w, k)
