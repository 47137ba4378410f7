"""Plain PyTorch reference of the benchmark's models, in float32.

It follows the published equations of Qwen3-MoE (GQA with a per-head
RMSNorm of q and k), which the cells serve, and of DeepSeek-V2's layers
(multi-head latent attention, a leading dense layer, shared experts),
which the CPU tests drive, with the departures that each configuration
file lists under ``assumed``:

* routing is a softmax over every expert and a plain top-k, scaled by
  ``routed_scaling_factor``, renormalised where ``norm_topk_prob`` says
  so; a configuration that limits routing to groups is refused
  (``dims.dims``), as is one that scales RoPE;
* RoPE is the split-half form;
* a prompt's tokens take MoE capacity: per expert, in order of position,
  the first ``floor(S * k / E * f) + 1`` (clamped to [k, S]) of the S
  prompt tokens routed to it are kept and the rest add nothing, with ``f``
  = ``prefill_capacity_factor``; tokens after the prompt are never dropped.

It takes its weights from ``perfbench.weights`` (the same seeded leaves the
program serves, upcast to float32) and computes a whole sequence at once,
causally, with no cache and no batching. TF32 is switched off. It imports
nothing of the program.

``fp8`` gives the check's control: every matrix of the served dtype
rounded to fp8 (e4m3) with one fp32 scale per output channel (the
absolute maximum over its contraction axes, mapped to 448), then computed
in float32.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F

from perfbench import weights as W
from perfbench.reference.dims import Dims


def exact_matmuls() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def _rope(x, pos, theta):
    """x (N, H, hd) rotated at positions ``pos`` (N,), split-half form."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _causal_softmax(scores):
    """scores (..., N, N) -> causal softmax over the last axis."""
    N = scores.shape[-1]
    mask = torch.ones(N, N, dtype=torch.bool, device=scores.device).tril()
    return torch.softmax(scores.masked_fill(~mask, -torch.inf), dim=-1)


def _gqa(w, D: Dims, h, pos):
    H, Hkv, hd = D.n_heads, D.n_kv_heads, D.head_dim
    p = "attn."
    q = torch.einsum("nd,dhk->nhk", h, w[p + "w_q"])
    k = torch.einsum("nd,dhk->nhk", h, w[p + "w_k"])
    v = torch.einsum("nd,dhk->nhk", h, w[p + "w_v"])
    if D.qk_norm:
        q = _rms(q, w[p + "q_norm_scale"], D.eps)
        k = _rms(k, w[p + "k_norm_scale"], D.eps)
    q, k = _rope(q, pos, D.rope_theta), _rope(k, pos, D.rope_theta)
    rep = H // Hkv
    qg = q.reshape(-1, Hkv, rep, hd)
    s = torch.einsum("ngrk,mgk->grnm", qg, k) * hd ** -0.5
    o = torch.einsum("grnm,mgk->ngrk", _causal_softmax(s), v)
    return torch.einsum("nhk,hkd->nd", o.reshape(-1, H, hd), w[p + "w_o"])


def _mla(w, D: Dims, h, pos):
    m, p = D.mla, "attn."
    cq = _rms(h @ w[p + "w_dq"], w[p + "q_norm_scale"], D.eps)
    q = torch.einsum("nr,rhk->nhk", cq, w[p + "w_uq"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = _rope(q[..., m.qk_nope_head_dim:], pos, D.rope_theta)
    ckv = _rms(h @ w[p + "w_dkv"], w[p + "kv_norm_scale"], D.eps)
    k_rope = _rope((h @ w[p + "w_kr"])[:, None, :], pos, D.rope_theta)[:, 0]
    k_nope = torch.einsum("nr,rhk->nhk", ckv, w[p + "w_uk"])
    v = torch.einsum("nr,rhk->nhk", ckv, w[p + "w_uv"])
    s = (torch.einsum("nhk,mhk->hnm", q_nope, k_nope)
         + torch.einsum("nhk,mk->hnm", q_rope, k_rope))
    s = s * (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    o = torch.einsum("hnm,mhk->nhk", _causal_softmax(s), v)
    return torch.einsum("nhk,hkd->nd", o, w[p + "w_o"])


def _ffn(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def capacity(S: int, D: Dims) -> int:
    c = math.floor(S * D.top_k / D.n_experts * D.prefill_capacity_factor) + 1
    return max(D.top_k, min(c, S))


def _keep(idx, S: int, D: Dims):
    """(N, k) bool: which of a sequence's routed (token, expert) pairs are
    computed. Prompt tokens (the first S) keep, per expert and in order of
    position, the first ``capacity(S)``; later tokens keep all."""
    keep = torch.ones_like(idx, dtype=torch.bool)
    C = capacity(S, D)
    flat = idx[:S].reshape(-1)                   # token-major, as ranked
    order = torch.argsort(flat, stable=True)
    ranked = flat[order]
    first = torch.searchsorted(ranked, ranked, side="left")
    rank = torch.arange(flat.numel(), device=idx.device) - first
    kept = torch.empty_like(flat, dtype=torch.bool)
    kept[order] = rank < C
    keep[:S] = kept.reshape(S, -1)
    return keep


def _moe(w, D: Dims, hs: List[torch.Tensor], prompt_lens: Sequence[int]):
    """The MoE FFN of every sequence's normed rows ``hs`` at once."""
    x = torch.cat(hs)
    probs = torch.softmax(x @ w["moe.w_router"], dim=-1)
    gates, idx = torch.topk(probs, D.top_k, dim=-1)
    if D.norm_topk:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    keep, at = [], 0
    for h, S in zip(hs, prompt_lens):
        keep.append(_keep(idx[at:at + len(h)], S, D))
        at += len(h)
    keep = torch.cat(keep)
    y = torch.zeros_like(x)
    tok, slot = torch.nonzero(keep, as_tuple=True)
    exp = idx[tok, slot]
    for e in torch.unique(exp).tolist():
        sel = exp == e
        t = tok[sel]
        out = _ffn(x[t], w["moe.w_gate"][e], w["moe.w_up"][e],
                   w["moe.w_down"][e])
        y.index_add_(0, t, out * gates[t, slot[sel]][:, None])
    y = y * D.routed_scale
    if D.n_shared:
        y = y + _ffn(x, w["moe.shared.w_gate"], w["moe.shared.w_up"],
                     w["moe.shared.w_down"])
    out, at = [], 0
    for h in hs:
        out.append(y[at:at + len(h)])
        at += len(h)
    return out


def _fp8(t: torch.Tensor, in_axes) -> torch.Tensor:
    scale = t.abs().amax(dim=in_axes, keepdim=True) / 448.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _leaves(leaves, D: Dims, seed: int, device, fp8: bool, prefix: str):
    out = {}
    for lf in leaves:
        t = W.make(lf, seed, device).float()
        if fp8 and lf.std and lf.dtype == D.dtype:
            t = _fp8(t, lf.in_axes)
        out[lf.name[len(prefix):]] = t
    return out


@torch.no_grad()
def logits(D: Dims, seed: int, seqs: Sequence[torch.Tensor],
           prompt_lens: Sequence[int], device, *, fp8: bool = False,
           rows_from: Sequence[int] | None = None) -> List[torch.Tensor]:
    """Full-sequence causal forward of each of ``seqs`` (token ids (N,),
    each ``prompt_lens[i]`` of them its prompt) -> per sequence the fp32
    logits (N - r, V) of its rows from ``rows_from[i]`` = r (default 0)
    on. Layer by layer: each layer's weights are made once and freed."""
    exact_matmuls()
    seqs = [torch.as_tensor(s, dtype=torch.long, device=device)
            for s in seqs]
    rows_from = list(rows_from or [0] * len(seqs))
    top = _leaves(W.top_leaves(D), D, seed, device, fp8, "")
    xs = [top["embed"][s] for s in seqs]
    del top["embed"]
    pos = [torch.arange(len(s), device=device) for s in seqs]
    for i in range(D.n_layers):
        w = _leaves(W.layer_leaves(D, i), D, seed, device, fp8,
                    f"layers.{i}.")
        attn = _mla if D.mla is not None else _gqa
        xs = [x + attn(w, D, _rms(x, w["norm1.scale"], D.eps), p)
              for x, p in zip(xs, pos)]
        hs = [_rms(x, w["norm2.scale"], D.eps) for x in xs]
        if D.is_moe(i):
            ys = _moe(w, D, hs, prompt_lens)
        else:
            ys = [_ffn(h, w["ffn.w_gate"], w["ffn.w_up"], w["ffn.w_down"])
                  for h in hs]
        xs = [x + y for x, y in zip(xs, ys)]
        del w, hs, ys
    return [_rms(x[r:], top["final_norm.scale"], D.eps) @ top["lm_head"]
            for x, r in zip(xs, rows_from)]
