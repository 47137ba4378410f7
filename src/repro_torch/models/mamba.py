"""Mamba-1 selective SSM block (Jamba's recurrent layer) in PyTorch.

Port of ``repro.models.mamba`` with the same dtype path: the causal
depthwise conv is a sum of the ``d_conv`` shifted products in the model
dtype, ``dt = softplus(dt @ w_dt + dt_bias)`` is fp32, the scan runs in
fp32 and its output is cast to the model dtype before the ``D`` skip and
the ``silu(z)`` gate. The scan goes through ``ops.selective_scan``: on CUDA
tensors that is the hand-written kernel B5, one launch for the whole
sequence (decode is T = 1); the reference scans 256-step chunks instead,
and its length rule is kept.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.kernels import ops
from repro_torch.launch import spmd

CHUNK = 256


def _dims(cfg: ArchConfig):
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    dt_rank = m.dt_rank or -(-cfg.d_model // 16)
    return d_in, dt_rank


class Mamba(nn.Module):
    """The reference's ``init_mamba`` parameters, by name, shape and dtype.
    ``stds`` names the randomly drawn ones (``Model.init``); the constants
    (``dt_bias`` 0, ``A_log`` = log(1..N) per channel, ``D`` 1, all fp32)
    are set here."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        m = cfg.mamba
        d = cfg.d_model
        d_in, dt_rank = _dims(cfg)
        f32 = torch.float32

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        def empty(*shape):
            return param(torch.empty(shape, dtype=dtype, device=device))

        self.w_in = empty(d, 2 * d_in)
        self.conv_w = empty(m.d_conv, d_in)
        self.w_x_dbc = empty(d_in, dt_rank + 2 * m.d_state)
        self.w_dt = empty(dt_rank, d_in)
        self.dt_bias = param(torch.zeros(d_in, dtype=f32, device=device))
        # S4D-real init: A = -(1..N) per channel
        self.A_log = param(torch.log(
            torch.arange(1, m.d_state + 1, dtype=f32, device=device)
        ).expand(d_in, m.d_state).contiguous())
        self.D = param(torch.ones(d_in, dtype=f32, device=device))
        self.w_out = empty(d_in, d)
        self.stds = {"w_in": d ** -0.5, "conv_w": 0.2,
                     "w_x_dbc": d_in ** -0.5, "w_dt": dt_rank ** -0.5,
                     "w_out": d_in ** -0.5}


def _ssm_inputs(p: Mamba, cfg: ArchConfig, xc):
    """xc (B, L, d_in) post-conv activations -> the scan's inputs: dt
    (B, L, d_in) fp32, A (d_in, N) fp32, Bm and Cm (B, L, N) in xc's dtype,
    contiguous, as B5 takes them (the reference's ``_ssm_params`` before
    it forms dA/dBx)."""
    d_in, dt_rank = _dims(cfg)
    # on a placed model w_x_dbc is row-parallel: its partial sums are
    # reduced before the split (torch 2.11's DTensor picks a strategy for
    # dt @ w_dt over a partial dt that it cannot redistribute into)
    dbc = spmd.reduced(xc @ p.w_x_dbc)
    dt, Bm, Cm = torch.split(dbc, [dt_rank, cfg.mamba.d_state,
                                   cfg.mamba.d_state], dim=-1)
    dt = F.softplus(dt @ p.w_dt + p.dt_bias)                 # fp32
    A = -torch.exp(p.A_log)
    return dt.contiguous(), A, Bm.contiguous(), Cm.contiguous()


def _gate_out(p: Mamba, y, xr, z, dtype):
    y = y.to(dtype) + xr * p.D.to(dtype)
    return (y * F.silu(z)) @ p.w_out


def _scan(x, dt, A, Bm, Cm, h0):
    """``ops.selective_scan`` over contiguous inputs (a rank's channel
    slice of a placed model's is strided)."""
    return ops.selective_scan(x.contiguous(), dt.contiguous(), A.contiguous(),
                              Bm.contiguous(), Cm.contiguous(),
                              h0.contiguous())


def mamba_forward(p: Mamba, cfg: ArchConfig, x, state=None):
    """x (B, S, d) -> (y (B, S, d), final state (B, d_in, N) fp32, conv
    tail (B, d_conv - 1, d_in)): the last d_conv - 1 conv *inputs* (rows of
    ``norm(x) @ w_in``'s x half, zero-padded in front when S is shorter),
    which decode continues the conv window from. As in the reference, S
    must be at most ``CHUNK`` or a multiple of it."""
    m = cfg.mamba
    B, S, _ = x.shape
    if S > CHUNK and S % CHUNK:
        raise ValueError(f"seq {S} not divisible by mamba chunk {CHUNK}")
    d_in, _ = _dims(cfg)
    xr, z = torch.split(x @ p.w_in, d_in, dim=-1)            # (B, S, d_in)
    pad = torch.zeros((B, m.d_conv - 1, d_in), dtype=xr.dtype,
                      device=xr.device)
    xp = torch.cat([pad, xr], dim=1)
    # causal depthwise conv: the products summed in order i = 0..d_conv-1
    xc = F.silu(sum(xp[:, i:i + S] * p.conv_w[i]
                    for i in range(m.d_conv))).contiguous()
    dt, A, Bm, Cm = _ssm_inputs(p, cfg, xc)
    h0 = (torch.zeros((B, d_in, m.d_state), dtype=torch.float32,
                      device=x.device) if state is None else state)
    # B5 over channels: on a placed model each rank scans its d_in
    # channels (of its batch rows); B and C feed every channel, so their
    # gradients are partial, as A's over the batch shards
    ch, bc = (2, 0), (None, 0)
    y, hN = spmd.site(_scan, (ch, ch, 0, bc, bc, (1, 0)), (ch, (1, 0)),
                      xc, dt, A, Bm, Cm, h0,
                      grad_specs=(ch, ch, (0, "partial"), ("partial", 0),
                                  ("partial", 0), (1, 0)))
    return _gate_out(p, y, xr, z, x.dtype), hN, xp[:, S:]


def mamba_decode(p: Mamba, cfg: ArchConfig, x, conv_state, ssm_state):
    """One token. x (B, 1, d); conv_state (B, d_conv - 1, d_in); ssm_state
    (B, d_in, N) fp32. -> (y (B, 1, d), new conv_state, new ssm_state)."""
    d_in, _ = _dims(cfg)
    xr, z = torch.split(x[:, 0] @ p.w_in, d_in, dim=-1)      # (B, d_in)
    window = torch.cat([conv_state, xr[:, None]], dim=1)      # (B, conv, d_in)
    xc = F.silu(torch.einsum("bcd,cd->bd", window, p.conv_w))[:, None] \
        .contiguous()
    dt, A, Bm, Cm = _ssm_inputs(p, cfg, xc)
    # B5 over channels, as in mamba_forward: on a placed model each rank
    # steps its d_in channels' states
    ch, bc = (2, 0), (None, 0)
    y, h = spmd.site(_scan, (ch, ch, 0, bc, bc, (1, 0)), (ch, (1, 0)),
                     xc, dt, A, Bm, Cm, ssm_state)
    y = _gate_out(p, y[:, 0], xr, z, x.dtype)
    return y[:, None], window[:, 1:], h
