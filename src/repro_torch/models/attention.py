"""GQA attention (qk-norm, bias, softcap, sliding window) with an explicit
per-slot KV cache. MLA and cross-attention are not ported yet.

Prefill attention is plain tensor code (the reference leaves it to XLA);
one-token decode goes through ``kernels.ops.decode_attention``, i.e. the
hand-written flash-decode kernel on CUDA. Caches keep the reference layout
``(B, S, Hkv, hd)``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rms_norm_headwise, softcap

NEG_INF = -2.0e38


class Attention(nn.Module):
    """GQA projection weights in the reference layout: w_q (d, H, hd),
    w_k/w_v (d, Hkv, hd), w_o (H, hd, d); qk-norm scales in fp32."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_

        def param(*shape, dt=dtype, fill=None):
            t = torch.empty(shape, dtype=dt, device=device)
            if fill is not None:
                t.fill_(fill)
            return nn.Parameter(t, requires_grad=False)

        self.w_q = param(d, H, hd)
        self.w_k = param(d, Hkv, hd)
        self.w_v = param(d, Hkv, hd)
        self.w_o = param(H, hd, d)
        self.stds = {"w_q": d ** -0.5, "w_k": d ** -0.5, "w_v": d ** -0.5,
                     "w_o": (H * hd) ** -0.5}
        if cfg.attn.qkv_bias:
            self.b_q = param(H, hd, fill=0.0)
            self.b_k = param(Hkv, hd, fill=0.0)
            self.b_v = param(Hkv, hd, fill=0.0)
        if cfg.attn.qk_norm:
            self.q_norm_scale = param(hd, dt=torch.float32, fill=1.0)
            self.k_norm_scale = param(hd, dt=torch.float32, fill=1.0)


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def _sdpa(q, k, v, mask, logit_cap: float):
    """q (B,S,H,hd), k/v (B,T,Hkv,hd); mask (B,1,S,T) or (1,1,S,T) additive.
    GQA groups the q heads (B,S,Hkv,rep,hd); K/V are never repeated."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, S, Hkv, rep, hd)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg, k).float()
    scores = scores * (hd ** -0.5)
    scores = softcap(scores, logit_cap)
    scores = scores + (mask[:, :, None] if mask.dim() == 4 else mask)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", w, v)
    return out.reshape(B, S, H, hd)


def causal_mask(S: int, T: int, offset: int = 0, window: int = 0,
                device=None):
    """Additive (1,1,S,T) mask. ``offset`` = absolute position of query 0."""
    qpos = torch.arange(S, device=device)[:, None] + offset
    kpos = torch.arange(T, device=device)[None, :]
    ok = kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF)[None, None].float()


def decode_mask(T: int, cache_len, window: int = 0):
    """Additive mask for one query over a cache of physical length T filled
    to ``cache_len`` ((B,) tensor of per-slot lengths) -> (B, 1, 1, T)."""
    cache_len = cache_len.reshape(-1, 1, 1, 1)
    kpos = torch.arange(T, device=cache_len.device)[None, None, None, :]
    ok = kpos < cache_len
    if window:
        ok &= kpos >= cache_len - window
    return torch.where(ok, 0.0, NEG_INF).float()


def update_rows(buf, upd, pos, active=None):
    """Write ``upd`` (B, n, ...) into ``buf`` (B, T, ...) at per-row
    positions ``pos`` ((B,) int tensor), **in place**, and return ``buf``.
    Start indices are clamped so the update fits, as the reference's
    ``dynamic_update_slice`` does. With ``active`` ((B,) bool) only active
    rows change; inactive rows are rewritten with their own old values."""
    B, T = buf.shape[:2]
    n = upd.shape[1]
    start = pos.to(torch.long).clamp(0, T - n)
    idx = start[:, None] + torch.arange(n, device=buf.device)[None, :]
    rows = torch.arange(B, device=buf.device)[:, None]
    new = upd.to(buf.dtype)
    if active is not None:
        keep = active.reshape((B, 1) + (1,) * (buf.dim() - 2))
        new = torch.where(keep, new, buf[rows, idx])
    buf[rows, idx] = new
    return buf


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


def _project_qkv(p, cfg: ArchConfig, x, positions):
    a = cfg.attn
    q = torch.einsum("bsd,dhk->bshk", x, p.w_q)
    k = torch.einsum("bsd,dhk->bshk", x, p.w_k)
    v = torch.einsum("bsd,dhk->bshk", x, p.w_v)
    if a.qkv_bias:
        q, k, v = q + p.b_q, k + p.b_k, v + p.b_v
    if a.qk_norm:
        q = rms_norm_headwise(q, p.q_norm_scale)
        k = rms_norm_headwise(k, p.k_norm_scale)
    if a.use_rope:
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    return q, k, v


def attn_forward(p, cfg: ArchConfig, x, positions, *, window: int = 0):
    """Full-sequence (prefill) causal self-attention.
    Returns (out, (k, v)) so prefill can seed the cache."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    mask = causal_mask(x.shape[1], k.shape[1], window=window, device=x.device)
    out = _sdpa(q, k, v, mask, cfg.attn.logit_softcap)
    out = torch.einsum("bshk,hkd->bsd", out, p.w_o)
    return out, (k, v)


def attn_decode(p, cfg: ArchConfig, x, cache_k, cache_v, pos, *,
                window: int = 0, active=None):
    """One-token decode. x (B,1,d); cache_k/v (B,T,Hkv,hd); ``pos`` (B,)
    per-slot index of the new token. The new K/V rows are written into the
    caches in place (only ``active`` rows when given). Returns
    (out, cache_k, cache_v)."""
    a = cfg.attn
    positions = pos[:, None]
    q, k, v = _project_qkv(p, cfg, x, positions)
    update_rows(cache_k, k, pos, active)
    update_rows(cache_v, v, pos, active)
    if window or a.logit_softcap:
        if x.device.type == "cuda":
            raise NotImplementedError(
                "the flash-decode kernel has no sliding window or logit "
                "softcap yet")
        mask = decode_mask(cache_k.shape[1], pos + 1, window=window)
        out = _sdpa(q, cache_k, cache_v, mask, a.logit_softcap)
    else:
        out = ops.decode_attention(q[:, 0].contiguous(), cache_k, cache_v,
                                   pos + 1)[:, None]
    return torch.einsum("bshk,hkd->bsd", out, p.w_o), cache_k, cache_v
