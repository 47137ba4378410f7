"""RWKV6 "Finch" block in PyTorch: time-mix with data-dependent decay, and
channel-mix.

Port of ``repro.models.rwkv6``, with the same simplifications (one shared
token-shift mix per projection, silu gating) and the same dtype behaviour:
the mix coefficients are cast to x's dtype, the decay
``w = exp(-exp(decay_base + LoRA(x)))`` is fp32, the recurrence runs in
fp32 and its output is cast to x's dtype before the gate. The recurrence
goes through ``ops.wkv_scan`` over (B*H, T, hd) rows: on CUDA tensors that
is the hand-written kernel B4, one launch for the whole sequence; the
reference scans ``_wkv_chunk`` over chunks of ``CHUNK`` steps instead, and
its length rule is kept.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.kernels import ops
from repro_torch.launch import spmd

CHUNK = 256


class RWKV(nn.Module):
    """The reference's ``init_rwkv`` parameters, by name and shape.
    ``stds`` names the randomly drawn ones (``Model.init``); the constants
    (mix 0.5, decay_base -0.5, u 0, cm_mix 0.5) are set here."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        r = cfg.rwkv
        d = cfg.d_model
        H = d // r.head_dim

        def param(shape, dt=dtype, fill=None):
            t = (torch.empty(shape, dtype=dt, device=device) if fill is None
                 else torch.full(shape, fill, dtype=dt, device=device))
            return nn.Parameter(t, requires_grad=False)

        f32 = torch.float32
        self.mix = param((5, d), f32, 0.5)        # r,k,v,g,w token-shift mix
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, param((d, d)))
        self.decay_base = param((d,), f32, -0.5)
        self.decay_A = param((d, r.decay_lora))
        self.decay_B = param((r.decay_lora, d))
        self.u = param((H, r.head_dim), f32, 0.0)  # bonus for current token
        self.cm_mix = param((d,), f32, 0.5)
        self.cm_k = param((d, cfg.d_ff))
        self.cm_v = param((cfg.d_ff, d))
        self.stds = {name: d ** -0.5
                     for name in ("w_r", "w_k", "w_v", "w_g", "w_o",
                                  "decay_A", "cm_k")}
        self.stds["decay_B"] = r.decay_lora ** -0.5
        self.stds["cm_v"] = cfg.d_ff ** -0.5


def _mix(x, x_prev, coef):
    coef = coef.to(x.dtype)
    return x * coef + x_prev * (1 - coef)


def _shift(x, x_prev):
    """(B,S,d) -> the sequence shifted right by one, ``x_prev`` (B,d) first
    (zeros when None)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, 0])
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _projections(p: RWKV, cfg: ArchConfig, x, x_shift):
    """x, x_shift (B,L,d) -> per-head r,k,v,w (B,L,H,hd) and g (B,L,d)."""
    hd = cfg.rwkv.head_dim
    B, L, d = x.shape

    def heads(t):
        return t.reshape(B, L, d // hd, hd)
    r = heads(_mix(x, x_shift, p.mix[0]) @ p.w_r)
    k = heads(_mix(x, x_shift, p.mix[1]) @ p.w_k)
    v = heads(_mix(x, x_shift, p.mix[2]) @ p.w_v)
    g = _mix(x, x_shift, p.mix[3]) @ p.w_g
    xw = _mix(x, x_shift, p.mix[4])
    w_log = p.decay_base + (torch.tanh(xw @ p.decay_A) @ p.decay_B).float()
    w = torch.exp(-torch.exp(w_log))                      # (B,L,d) in (0,1)
    return r, k, v, g, heads(w)


def _rows(t):
    """(B,L,H,hd) -> (B*H, L, hd): a view at L = 1, one copy otherwise."""
    B, L, H, hd = t.shape
    return t.transpose(1, 2).reshape(B * H, L, hd).contiguous()


def _recurrence(r, k, v, w, u, state):
    """The WKV6 recurrence of r, k, v, w (B,S,H,hd) with bonus u (H,hd)
    from ``state`` (B,H,hd,hd) fp32 or None (zeros) -> (out (B,S,H,hd),
    final state (B,H,hd,hd)): ``ops.wkv_scan`` over (B*H, S, hd) rows."""
    B, S, H, hd = r.shape
    s0 = (torch.zeros((B * H, hd, hd), dtype=torch.float32, device=r.device)
          if state is None else state.reshape(B * H, hd, hd).contiguous())
    uu = u.expand(B, H, hd).reshape(B * H, hd).contiguous()
    out, sN = ops.wkv_scan(_rows(r), _rows(k), _rows(v), _rows(w), uu, s0)
    return (out.reshape(B, H, S, hd).transpose(1, 2),
            sN.reshape(B, H, hd, hd))


def rwkv_time_mix(p: RWKV, cfg: ArchConfig, x, state=None, x_prev=None):
    """x (B,S,d); state (B,H,hd,hd) fp32 or None (zeros); x_prev (B,d) or
    None. Returns (y (B,S,d), (state, last_x)). As the reference, S above
    ``CHUNK`` must be a multiple of it."""
    B, S, d = x.shape
    if S > CHUNK and S % CHUNK:
        raise ValueError(f"seq {S} not divisible by rwkv chunk {CHUNK}")
    r, k, v, g, w = _projections(p, cfg, x, _shift(x, x_prev))
    # B4 over heads: on a placed model each rank runs its heads' rows (of
    # its batch rows; u's gradient sums over the batch shards)
    rows, st = (2, 0), (1, 0)
    out, sN = spmd.site(_recurrence, (rows, rows, rows, rows, 0, st),
                        (rows, st), r, k, v, w, p.u, state,
                        grad_specs=(rows, rows, rows, rows, (0, "partial"),
                                    st))
    out = out.reshape(B, S, d)
    y = out.to(x.dtype) * F.silu(g)
    return y @ p.w_o, (sN, x[:, -1])


def rwkv_channel_mix(p: RWKV, cfg: ArchConfig, x, x_prev=None):
    """Squared-relu channel mix with token shift. Returns (y, last_x)."""
    xk = _mix(x, _shift(x, x_prev), p.cm_mix)
    h = torch.square(F.relu(xk @ p.cm_k))
    return h @ p.cm_v, x[:, -1]

