"""GQA attention (qk-norm, bias, softcap, sliding window, M-RoPE),
encoder-decoder cross-attention and DeepSeek-V2 MLA, each with an explicit
per-slot cache.

Prefill attention is plain tensor code (the reference leaves it to XLA):
the (S, T) scores, or ``_sdpa_blocked``'s online softmax over KV blocks
under ``attn_impl="blocked"``;
GQA's one-token decode, self or cross, goes through
``kernels.ops.decode_attention``, i.e. the hand-written flash-decode kernel
(with the logit softcap) on CUDA, and over a head_dim-sharded cache on a
placed model through its two halves (``ops.decode_scores``,
``ops.decode_values``) with an all-reduce of the scores between them. A sliding-window layer decodes over a
ring of ``window`` positions (``ring=True``): every stored position is
inside the window, so the kernel needs no window of its own. MLA decode is
the reference's absorbed-matrix einsums over the latent cache (the
reference has no kernel for it), as tensor ops on whichever device holds
x. Caches
keep the reference layouts: GQA ``(B, S, Hkv, hd)``, MLA ``c_kv`` ``(B, S,
kv_lora_rank)`` and ``k_rope`` ``(B, S, qk_rope_head_dim)``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.config import ArchConfig
from repro_torch.kernels import ops
from repro_torch.launch import spmd
from repro_torch.models.layers import apply_rope, rms_norm_headwise, softcap

NEG_INF = -2.0e38


def _param(shape, dtype, device, fill=None):
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


class Attention(nn.Module):
    """GQA projection weights in the reference layout: w_q (d, H, hd),
    w_k/w_v (d, Hkv, hd), w_o (H, hd, d); qk-norm scales in fp32."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_

        def param(*shape, dt=dtype, fill=None):
            return _param(shape, dt, device, fill)

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


class MLA(nn.Module):
    """DeepSeek-V2 multi-head latent attention weights in the reference
    layout: down-projections w_dq (d, q_lora), w_dkv (d, r) and w_kr (d,
    rope); up-projections w_uq (q_lora, H, nope+rope), w_uk (r, H, nope),
    w_uv (r, H, v); w_o (H, v, d); latent norm scales in fp32."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, H, m = cfg.d_model, cfg.n_heads, cfg.attn.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim

        def param(*shape, dt=dtype, fill=None):
            return _param(shape, dt, device, fill)

        self.w_dq = param(d, m.q_lora_rank)
        self.w_uq = param(m.q_lora_rank, H, qk)
        self.w_dkv = param(d, m.kv_lora_rank)
        self.w_kr = param(d, m.qk_rope_head_dim)
        self.w_uk = param(m.kv_lora_rank, H, m.qk_nope_head_dim)
        self.w_uv = param(m.kv_lora_rank, H, m.v_head_dim)
        self.w_o = param(H, m.v_head_dim, d)
        self.q_norm_scale = param(m.q_lora_rank, dt=torch.float32, fill=1.0)
        self.kv_norm_scale = param(m.kv_lora_rank, dt=torch.float32,
                                   fill=1.0)
        self.stds = {"w_dq": d ** -0.5, "w_uq": m.q_lora_rank ** -0.5,
                     "w_dkv": d ** -0.5, "w_kr": d ** -0.5,
                     "w_uk": m.kv_lora_rank ** -0.5,
                     "w_uv": m.kv_lora_rank ** -0.5,
                     "w_o": (H * m.v_head_dim) ** -0.5}


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def _sdpa(q, k, v, mask, logit_cap: float):
    """q (B,S,H,hd), k/v (B,T,Hkv,hd); mask (B,1,S,T) or (1,1,S,T) additive.
    GQA groups the q heads (B,S,Hkv,rep,hd); K/V are never repeated. On a
    placed model each rank attends over its batch rows and, where the
    model axis divides Hkv, its KV groups' heads (else every head)."""
    heads = 2 if k.shape[2] % spmd.axis_size(q, "model") == 0 else None
    rows = (heads, 0)
    return spmd.site(_sdpa_local, (rows, rows, rows, None, None), (rows,),
                     q, k, v, mask, logit_cap)


def _sdpa_local(q, k, v, mask, logit_cap: float):
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


def _sdpa_blocked(q, k, v, logit_cap: float, *, offset: int = 0,
                  window: int = 0, causal: bool = True,
                  block_q: int = 512, block_kv: int = 1024):
    """Flash-style blocked attention (the reference's ``_sdpa_blocked``):
    query blocks outside, an online softmax over KV blocks inside, so the
    (S, T) score matrix is never formed; at most a (block_q, block_kv)
    tile of it per (batch, head). ``offset`` is the absolute position of
    query 0; ``window`` > 0 keeps keys in (qpos - window, qpos]. q
    (B,S,H,hd), k/v (B,T,Hkv,hd) -> (B,S,H,hd).

    A KV block that every query of the block masks is skipped: the
    reference's pass over it leaves the running max, sum and accumulator
    as they were (after a valid block) or is wiped by the first valid
    block's rescale by exp(-2e38 - m) = 0 (before one), so skipping gives
    the same bits while every query has a valid key, which causal
    self-attention always does."""
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    dev = q.device
    nkv = -(-T // block_kv)
    nq = -(-S // block_q)
    qb = q.reshape(B, S, Hkv, rep, hd)
    scale = hd ** -0.5
    outs = []
    for iq in range(nq):
        q0 = iq * block_q
        qc = qb[:, q0:q0 + block_q]
        if qc.shape[1] < block_q:                  # pad the last block
            qc = torch.cat([qc, qc.new_zeros(
                (B, block_q - qc.shape[1]) + qc.shape[2:])], 1)
        qpos = q0 + offset + torch.arange(block_q, device=dev)
        lo, hi = q0 + offset, q0 + offset + block_q - 1
        m = torch.full((B, block_q, Hkv, rep, 1), NEG_INF,
                       dtype=torch.float32, device=dev)
        l = torch.zeros((B, block_q, Hkv, rep, 1), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((B, block_q, Hkv, rep, hd), dtype=torch.float32,
                          device=dev)
        for j in range(nkv):
            k0 = j * block_kv
            if (causal and k0 > hi) or (window and
                                        k0 + block_kv - 1 <= lo - window):
                continue
            kc, vc = k[:, k0:k0 + block_kv], v[:, k0:k0 + block_kv]
            kpos = k0 + torch.arange(kc.shape[1], device=dev)
            scores = torch.einsum("bsgrd,btgd->bsgrt", qc, kc).float()
            scores = softcap(scores * scale, logit_cap)
            ok = torch.ones((block_q, kc.shape[1]), dtype=torch.bool,
                            device=dev)
            if causal:
                ok = ok & (kpos[None, :] <= qpos[:, None])
            if window:
                ok = ok & (kpos[None, :] > qpos[:, None] - window)
            scores = torch.where(ok[None, :, None, None, :], scores,
                                 NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
            p = torch.exp(scores - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bsgrt,btgd->bsgrd", p.to(vc.dtype), vc).float()
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)).to(q.dtype))
    out = torch.cat(outs, 1)[:, :S]
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


def decode_mask(T: int, cache_len):
    """Additive mask for one query over a cache of physical length T filled
    to ``cache_len`` ((B,) tensor of per-slot lengths) -> (B, 1, 1, T)."""
    cache_len = cache_len.reshape(-1, 1, 1, 1)
    kpos = torch.arange(T, device=cache_len.device)[None, None, None, :]
    return torch.where(kpos < cache_len, 0.0, NEG_INF).float()


def update_rows(buf, upd, pos, active=None):
    """Write ``upd`` (B, n, ...) into ``buf`` (B, T, ...) at per-row
    positions ``pos`` ((B,) int tensor), **in place**, and return ``buf``.
    Start indices are clamped so the update fits, as the reference's
    ``dynamic_update_slice`` does. With ``active`` ((B,) bool) only active
    rows change; inactive rows are rewritten with their own old values.
    On a placed cache each rank writes its own block (``spmd.block_site``):
    its batch rows, and on a sequence-sharded cache only the positions its
    block holds."""
    n = upd.shape[1]
    start = pos.to(torch.long).clamp(0, buf.shape[1] - n)
    return spmd.block_site(_write_rows, buf, upd, start, active, seq_dim=1)


def _write_rows(buf, upd, start, active, off):
    """``update_rows`` on one block: the whole sequence (``off`` None), or
    a block of a sequence-sharded cache whose first position is ``off``."""
    B, T = buf.shape[:2]
    n = upd.shape[1]
    rows = torch.arange(B, device=buf.device)[:, None]
    new = upd.to(buf.dtype)
    if off is None:
        idx = start[:, None] + torch.arange(n, device=buf.device)[None, :]
        if active is not None:
            keep = active.reshape((B, 1) + (1,) * (buf.dim() - 2))
            new = torch.where(keep, new, buf[rows, idx])
        buf[rows, idx] = new
        return buf
    # a block of a sequence-sharded cache: one position at a time, each
    # written only where this block holds it
    for j in range(n):
        at = start + j - off
        keep = (at >= 0) & (at < T)
        if active is not None:
            keep = keep & active
        at = at.clamp(0, T - 1)[:, None]
        keep = keep.reshape((B, 1) + (1,) * (buf.dim() - 2))
        buf[rows, at] = torch.where(keep, new[:, j:j + 1], buf[rows, at])
    return buf


def store_rows(buf, full, rows=slice(None)):
    """A prefill's full-sequence rows ``full`` (B, S, ...) into rows
    ``rows`` of cache ``buf`` (L positions), in place: ``full[:, :S]`` at
    0..S-1 when S <= L, else its last L positions, position p at ``p % L``
    (a ring). On a placed cache each rank writes its own block
    (``spmd.block_site``)."""
    return spmd.block_site(_store_block, buf, full, buf.shape[1], rows,
                           seq_dim=1)


def _store_block(buf, full, L: int, rows, off):
    """``store_rows`` on one block: the whole sequence (``off`` None), or
    a block of a sequence-sharded cache whose first position is ``off``."""
    S, T = full.shape[1], buf.shape[1]
    off = off or 0
    if S <= L:
        hi = min(S, off + T)
        if hi > off:
            buf[rows, :hi - off] = full[:, off:hi].to(buf.dtype)
    else:
        buf[rows] = torch.roll(full[:, S - L:], S % L,
                               dims=1)[:, off:off + T].to(buf.dtype)
    return buf


def _attend(q, k, v, lens, cap: float):
    """B3 (``ops.decode_attention``) of q (B, H, hd) over the cache k/v
    (B, T, Hkv, hd) filled to ``lens`` -> (B, H, hd). On a placed cache,
    a site over its batch rows and KV heads: each rank's query heads are
    those of its KV heads. A cache sharded on hd (its KV heads do not
    split over the model axis) decodes through B3's two halves, as GSPMD
    partitions the reference's decode there: each rank runs B3-qk
    (``ops.decode_scores``) over its head_dim slice of q and K, the
    partial scores are all-reduced over the model axis, and each rank runs
    B3-pv (``ops.decode_values``) over its V slice; the output stays
    sharded on hd, and nothing gathers the cache. On a sequence-sharded
    cache each rank runs over its block at lengths ``clamp(lens - offset,
    0, T/N)`` with the log-sum-exp, and ``spmd.merge_blocks`` merges the
    blocks."""
    if not spmd.is_placed(k, v):
        return ops.decode_attention(q, k, v, lens, cap)
    mesh = k.device_mesh
    kpl = list(k.placements)
    qpl = [Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(2)
           else Shard(2) if p.is_shard(3) else Replicate() for p in kpl]
    lpl = [Shard(0) if p.is_shard(0) else Replicate() for p in kpl]
    if not isinstance(lens, torch.Tensor):
        lens = torch.full((q.shape[0],), lens, dtype=torch.int32,
                          device=q.device)
    q, lens = (spmd.on_mesh(t, mesh, p) for t, p in ((q, qpl), (lens, lpl)))
    seq = any(p.is_shard(1) for p in kpl)
    off = spmd.offset(k, 1) if seq else None

    def block_lens(lens, T):
        return (lens if off is None else
                torch.clamp(lens - off, 0, T).to(torch.int32))

    # each rank's (out, lse) of its sequence block stacked on a new dim 0
    # that the sequence's mesh dims shard
    # (the output's head_dim slices; lse is every slice's)
    def stacked(p, lse: bool):
        if p.is_shard(1):
            return Shard(0)
        if p.is_shard(0):
            return Shard(1)
        if p.is_shard(2) or (p.is_shard(3) and not lse):
            return Shard(p.dim)
        return Replicate()
    opl, lsepl = ([stacked(p, lse) for p in kpl] for lse in (False, True))
    if not any(p.is_shard(3) for p in kpl):
        ins = (qpl, kpl, kpl, lpl)
        if not seq:
            def local(q, k, v, lens):
                return ops.decode_attention(q, k, v, lens, cap)
            return local_map(local, qpl, in_placements=ins,
                             device_mesh=mesh)(q, k, v, lens)

        def block(q, k, v, lens):
            out, lse = ops.decode_attention(q, k, v, block_lens(lens,
                                                                k.shape[1]),
                                            cap, return_lse=True)
            return out[None], lse[None]
        out, lse = local_map(block, (opl, lsepl), in_placements=ins,
                             device_mesh=mesh)(q, k, v, lens)
        return spmd.merge_blocks(out, lse).to(q.dtype)
    # partial scores (B, H, T) of each head_dim slice: rows as q's, the
    # positions as the cache's sequence, a pending sum over hd's mesh dims
    scale = q.shape[-1] ** -0.5
    spl = [Shard(0) if p.is_shard(0) else Shard(2) if p.is_shard(1)
           else Partial() if p.is_shard(3) else Replicate() for p in kpl]

    def qk(q, k, lens):
        return ops.decode_scores(q.contiguous(), k,
                                 block_lens(lens, k.shape[1]), scale)
    scores = local_map(qk, spl, in_placements=(qpl, kpl, lpl),
                       device_mesh=mesh)(q, k, lens)
    scores = spmd.reduced(scores)               # all-reduce over the slices
    ins = (list(scores.placements), kpl, lpl)
    if not seq:
        def pv(s, v, lens):
            return ops.decode_values(s, v, lens, cap)
        return local_map(pv, qpl, in_placements=ins,
                         device_mesh=mesh)(scores, v, lens)

    def pv_block(s, v, lens):
        out, lse = ops.decode_values(s, v, block_lens(lens, v.shape[1]), cap,
                                     return_lse=True)
        return out[None], lse[None]
    out, lse = local_map(pv_block, (opl, lsepl), in_placements=ins,
                         device_mesh=mesh)(scores, v, lens)
    return spmd.merge_blocks(out, lse).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


def _heads(w, hd_dim: int):
    """A GQA projection weight (or bias) as einsum takes it: on a placed
    model, gathered over the model axis when it is sharded on its head_dim
    (its heads do not split over the axis): torch 2.11's DTensor cannot
    flatten (heads, head_dim) with head_dim sharded, as einsum and its
    backward do. Else as it is."""
    return spmd.gathered(w) if spmd.sharded_on(w, hd_dim) else w


def _decode_out(p, out):
    """w_o's projection of a decode step's attention output (B, 1, H, hd).
    An output sharded on hd (a decode over a head_dim-sharded cache) meets
    w_o as it is placed, in a row-parallel site over the local blocks
    (``spmd.project``): no flatten of a sharded head_dim, so nothing is
    gathered for it. Otherwise as every projection: ``_heads``."""
    w = p.w_o if spmd.sharded_on(out, 3) else _heads(p.w_o, 1)
    return spmd.project("bshk,hkd->bsd", out, w)


def _project_qkv(p, cfg: ArchConfig, x, positions):
    a = cfg.attn
    q = spmd.project("bsd,dhk->bshk", x, _heads(p.w_q, 2))
    k = spmd.project("bsd,dhk->bshk", x, _heads(p.w_k, 2))
    v = spmd.project("bsd,dhk->bshk", x, _heads(p.w_v, 2))
    if a.qkv_bias:
        q, k, v = (q + _heads(p.b_q, 1), k + _heads(p.b_k, 1),
                   v + _heads(p.b_v, 1))
    if a.qk_norm:
        q = rms_norm_headwise(q, p.q_norm_scale)
        k = rms_norm_headwise(k, p.k_norm_scale)
    if a.use_rope:
        q = apply_rope(q, positions, a.rope_theta, a.mrope_sections)
        k = apply_rope(k, positions, a.rope_theta, a.mrope_sections)
    return q, k, v


def _project_q(p, cfg: ArchConfig, x):
    """Cross-attention's query: no norm, no rotation."""
    q = spmd.project("bsd,dhk->bshk", x, _heads(p.w_q, 2))
    return q + _heads(p.b_q, 1) if cfg.attn.qkv_bias else q


def attn_forward(p, cfg: ArchConfig, x, positions, *, window: int = 0,
                 kv=None, mask=None):
    """Full-sequence (prefill) self-attention, causal unless ``mask`` (an
    additive (1,1,S,T) mask, e.g. the encoder's zeros) is given; with
    ``kv`` (projected encoder K/V, ``cross_kv``) cross-attention over every
    encoder position. Causal self-attention under ``cfg.attn_impl ==
    "blocked"`` runs ``_sdpa_blocked`` in place of the (S, T) scores.
    Returns (out, (k, v)) so prefill can seed the cache."""
    if kv is None:
        q, k, v = _project_qkv(p, cfg, x, positions)
        if mask is None and cfg.attn_impl == "blocked":
            out = _sdpa_blocked(q, k, v, cfg.attn.logit_softcap,
                                window=window)
            return (spmd.project("bshk,hkd->bsd", out, _heads(p.w_o, 1)),
                    (k, v))
        if mask is None:
            mask = causal_mask(x.shape[1], k.shape[1], window=window,
                               device=x.device)
    else:
        q = _project_q(p, cfg, x)
        k, v = kv
        if mask is None:
            mask = torch.zeros((1, 1, 1, 1), device=x.device)
    out = _sdpa(q, k, v, mask, cfg.attn.logit_softcap)
    out = spmd.project("bshk,hkd->bsd", out, _heads(p.w_o, 1))
    return out, (k, v)


def cross_kv(p, cfg: ArchConfig, enc_out):
    """Project the encoder output once into cross-attention K/V, each
    (B, S_enc, Hkv, hd)."""
    k = spmd.project("bsd,dhk->bshk", enc_out, _heads(p.w_k, 2))
    v = spmd.project("bsd,dhk->bshk", enc_out, _heads(p.w_v, 2))
    if cfg.attn.qkv_bias:
        k, v = k + _heads(p.b_k, 1), v + _heads(p.b_v, 1)
    return k, v


def attn_decode(p, cfg: ArchConfig, x, cache_k, cache_v, pos, *,
                window: int = 0, active=None, ring: bool = False,
                cross: bool = False):
    """One-token decode. x (B,1,d); cache_k/v (B,T,Hkv,hd); ``pos`` (B,)
    per-slot position of the new token. The new K/V rows are written into
    the caches in place (only ``active`` rows when given).

    ``ring``: the cache is a ring of the layer's T = window positions:
    the new row goes to ``pos % T`` and every one of the ``min(pos + 1,
    T)`` stored positions is attended (each is inside the window), which
    is the window the reference's ``forward`` computes; positions rotate
    at ``pos`` itself. ``window`` > 0 over a cache longer than it raises:
    the kernel has no window, and ``Model`` decodes every windowed layer
    over a ring. ``cross``: attend over the whole of the encoder's K/V in
    the caches, which are left as they are. Returns (out, cache_k,
    cache_v)."""
    a = cfg.attn
    T = cache_k.shape[1]
    if window and T > window:
        raise NotImplementedError(
            "decode has no sliding-window mask: decode a windowed layer "
            "over a ring of its window (ring=True)")
    if cross:
        q = _project_q(p, cfg, x)
        out = _attend(q[:, 0].contiguous(), cache_k, cache_v, T,
                      a.logit_softcap)[:, None]
        return _decode_out(p, out), cache_k, cache_v
    positions = pos[:, None]
    if a.mrope_sections:
        positions = positions.expand(3, *positions.shape)
    q, k, v = _project_qkv(p, cfg, x, positions)
    wpos = pos % T if ring else pos
    cache_k = update_rows(cache_k, k, wpos, active)
    cache_v = update_rows(cache_v, v, wpos, active)
    lens = torch.clamp(pos + 1, max=T) if ring else pos + 1
    out = _attend(q[:, 0].contiguous(), cache_k, cache_v, lens,
                  a.logit_softcap)[:, None]
    return _decode_out(p, out), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------


def _mla_q(p, cfg: ArchConfig, x, positions):
    m = cfg.attn.mla
    cq = rms_norm_headwise(x @ p.w_dq, p.q_norm_scale)
    q = spmd.project("bsr,rhk->bshk", cq, p.w_uq)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.attn.rope_theta)
    return q_nope, q_rope


def _mla_latents(p, cfg: ArchConfig, x, positions):
    """-> (c_kv (B,S,r), k_rope (B,S,rope)): k_rope is roped as one head."""
    c_kv = rms_norm_headwise(x @ p.w_dkv, p.kv_norm_scale)
    k_rope = apply_rope((x @ p.w_kr)[..., None, :], positions,
                        cfg.attn.rope_theta)[..., 0, :]
    return c_kv, k_rope


def _mla_scale(cfg: ArchConfig) -> float:
    m = cfg.attn.mla
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def mla_forward(p, cfg: ArchConfig, x, positions):
    """Full-sequence causal MLA (prefill): the latent KV is materialized
    per head. Returns (out, (c_kv, k_rope)) so prefill can seed the
    cache."""
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_latents(p, cfg, x, positions)
    k_nope = spmd.project("bsr,rhk->bshk", c_kv, p.w_uk)
    v = spmd.project("bsr,rhk->bshk", c_kv, p.w_uv)
    mask = causal_mask(x.shape[1], x.shape[1], device=x.device)
    # on a placed model each rank attends over its batch rows and, where
    # the model axis divides H, its heads; k_rope is every head's, so its
    # gradient is partial
    heads = (2 if q_nope.shape[2] % spmd.axis_size(q_nope, "model") == 0
             else None)
    rows, shared = (heads, 0), (None, 0)
    out = spmd.site(_mla_core, (rows, rows, rows, shared, rows, None, None),
                    (rows,), q_nope, q_rope, k_nope, k_rope, v, mask,
                    _mla_scale(cfg),
                    grad_specs=(rows, rows, rows,
                                ("partial" if heads is not None else None,
                                 0), rows, None, None))
    out = spmd.project("bshk,hkd->bsd", out, _heads(p.w_o, 1))
    return out, (c_kv, k_rope)


def _mla_core(q_nope, q_rope, k_nope, k_rope, v, mask, scale: float):
    """MLA's causal attention over materialized heads -> (B,S,H,v)."""
    scores = (torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
              + torch.einsum("bshk,btk->bhst", q_rope, k_rope)).float()
    w = torch.softmax(scores * scale + mask, dim=-1).to(q_nope.dtype)
    return torch.einsum("bhst,bthk->bshk", w, v)


def mla_decode(p, cfg: ArchConfig, x, cache_ckv, cache_kr, pos, *,
               active=None, ring: bool = False):
    """Absorbed-matrix one-token decode in the compressed latent space.
    x (B,1,d); cache_ckv (B,T,r), cache_kr (B,T,rope); ``pos`` (B,)
    per-slot position of the new token. The new latent rows are written
    into the caches in place (only ``active`` rows when given); ``ring``
    as in ``attn_decode``. Returns (out, cache_ckv, cache_kr)."""
    T = cache_ckv.shape[1]
    positions = pos[:, None]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)            # (B,1,H,*)
    c_kv, k_rope = _mla_latents(p, cfg, x, positions)        # (B,1,r/rope)
    wpos = pos % T if ring else pos
    cache_ckv = update_rows(cache_ckv, c_kv, wpos, active)
    cache_kr = update_rows(cache_kr, k_rope, wpos, active)
    lens = torch.clamp(pos + 1, max=T) if ring else pos + 1
    out = _mla_attend(q_nope, q_rope, p.w_uk, p.w_uv, cache_ckv, cache_kr,
                      lens, _mla_scale(cfg))
    return (spmd.project("bshk,hkd->bsd", out, _heads(p.w_o, 1)), cache_ckv,
            cache_kr)


def _mla_absorbed(q_nope, q_rope, w_uk, w_uv, ckv, kr, lens, scale: float,
                  off=None):
    """The absorbed-matrix attention of one query over the latent cache
    ckv (B,T,r) / kr (B,T,rope) filled to ``lens`` -> (B,1,H,v). With
    ``off`` (a block of a sequence-sharded cache whose first position is
    ``off``) -> (out[None], lse[None] (1,B,1,H)): the block's normalised
    output and log-sum-exp, for ``spmd.merge_blocks``."""
    T = ckv.shape[1]
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, w_uk)     # absorb W_uk
    scores = (torch.einsum("bshr,btr->bhst", q_abs, ckv)
              + torch.einsum("bshk,btk->bhst", q_rope, kr)).float()
    if off is None:
        mask = decode_mask(T, lens)
        w = torch.softmax(scores * scale + mask, dim=-1).to(q_nope.dtype)
    else:
        n = torch.clamp(lens - off, 0, T).reshape(-1, 1, 1, 1)
        kpos = torch.arange(T, device=ckv.device)
        s = torch.where(kpos < n, scores * scale, -torch.inf)
        lse = torch.logsumexp(s, dim=-1)                     # (B,H,1)
        w = torch.exp(s - torch.where(lse == -torch.inf, 0.0, lse)[..., None])
        w = w.to(q_nope.dtype)
    ctx = torch.einsum("bhst,btr->bshr", w, ckv)             # (B,1,H,r)
    out = torch.einsum("bshr,rhk->bshk", ctx, w_uv)          # absorb W_uv
    if off is None:
        return out
    return out[None], lse.transpose(1, 2)[None]


def _mla_attend(q_nope, q_rope, w_uk, w_uv, ckv, kr, lens, scale: float):
    """``_mla_absorbed`` over the cache; on a placed model a site over
    the cache's batch rows and, where the model axis divides them, the
    heads; on a sequence-sharded cache each rank takes its block and
    ``spmd.merge_blocks`` merges them (the plain einsum form of B3's
    context-parallel decode)."""
    if not spmd.is_placed(q_nope, ckv, w_uk):
        return _mla_absorbed(q_nope, q_rope, w_uk, w_uv, ckv, kr, lens,
                             scale)
    mesh = spmd.mesh_of(q_nope, ckv, w_uk)
    names = mesh.mesh_dim_names
    H = q_nope.shape[2]
    cpl = (list(ckv.placements) if spmd.is_placed(ckv)
           else [Replicate()] * mesh.ndim)
    heads = [n == "model" and mesh.size(i) > 1
             and H % mesh.size(i) == 0 for i, n in enumerate(names)]
    qpl = [Shard(0) if c.is_shard(0) else Shard(2) if h else Replicate()
           for c, h in zip(cpl, heads)]
    wpl = [Shard(1) if h else Replicate() for h in heads]
    lpl = [Shard(0) if c.is_shard(0) else Replicate() for c in cpl]
    ins = (qpl, qpl, wpl, wpl, cpl, cpl, lpl)
    args = [spmd.on_mesh(t, mesh, p) for t, p in
            zip((q_nope, q_rope, w_uk, w_uv, ckv, kr, lens), ins)]
    if not any(c.is_shard(1) for c in cpl):
        def local(*a):
            return _mla_absorbed(*a, scale)
        return local_map(local, qpl, in_placements=ins,
                         device_mesh=mesh)(*args)
    off = spmd.offset(ckv, 1)

    def block(*a):
        return _mla_absorbed(*a, scale, off)
    opl = [Shard(0) if c.is_shard(1) else Shard(q.dim + 1)
           if q.is_shard() else Replicate() for c, q in zip(cpl, qpl)]
    out, lse = local_map(block, (opl, opl), in_placements=ins,
                         device_mesh=mesh)(*args)
    return spmd.merge_blocks(out, lse).to(q_nope.dtype)
