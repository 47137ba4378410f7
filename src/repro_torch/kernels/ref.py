"""Plain PyTorch versions of the kernels (the CPU path and the kernels'
oracle). Same arithmetic as ``repro.kernels.ref`` and the Pallas kernels:
fp32 accumulation, the expert FFN's hidden activation rounded to the input
dtype before the down-projection (kept in fp32 over dequantized wire
weights), masked decode positions at -1e30, the RWKV6 and Mamba states in
fp32."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _act(name: str, u, g=None):
    if g is not None:
        if name == "swiglu":
            return F.silu(g) * u
        return F.gelu(g, approximate="tanh") * u            # geglu
    if name == "relu2":
        return torch.square(F.relu(u))
    return F.gelu(u, approximate="tanh")                     # gelu


def moe_ffn_ref(xg, w_gate, w_up, w_down, *, act: str = "swiglu"):
    """(E, C, d) grouped expert FFN, dense einsum formulation."""
    xf = xg.float()
    up = torch.einsum("ecd,edf->ecf", xf, w_up.float())
    gate = (torch.einsum("ecd,edf->ecf", xf, w_gate.float())
            if w_gate is not None else None)
    h = _act(act, up, gate)
    y = torch.einsum("ecf,efd->ecd", h.to(xg.dtype).float(), w_down.float())
    return y.to(xg.dtype)


def moe_ffn_quant_ref(xg, w_gate, w_up, w_down, s_gate, s_up, s_down,
                      slot_ids, *, act: str = "swiglu", out_dtype=None):
    """Slot-indexed grouped expert FFN over wire-dtype weights (the plain
    version of ``moe_ffn_quant`` as ``moe_ffn_slots`` reaches it).

    ``w_*``: (n_slots, d, f) / (n_slots, f, d) slot buffers in int8, fp16
    or the master dtype; ``s_*``: (n_slots, f) / (n_slots, d) fp32
    per-output-channel scales (int8) or None; ``slot_ids``: (E,) expert ->
    slot. Dequantized weights, x, gate, up and h are fp32
    (h is not rounded to x's dtype); with no scales and weights in x's
    dtype this is ``moe_ffn_ref`` on the gathered weights. -> (E, C, d) in
    ``out_dtype`` (default x's dtype)."""
    out_dtype = xg.dtype if out_dtype is None else out_dtype

    idx = slot_ids.to(device=w_up.device, dtype=torch.long)

    def take(w):
        return None if w is None else w.index_select(0, idx)
    wg, wu, wd = take(w_gate), take(w_up), take(w_down)
    if s_up is None and wu.dtype == xg.dtype:
        return moe_ffn_ref(xg, wg, wu, wd, act=act).to(out_dtype)

    def deq(w, s):
        w = w.float()
        return w if s is None else w * take(s)[:, None, :]
    xf = xg.float()
    up = torch.einsum("ecd,edf->ecf", xf, deq(wu, s_up))
    gate = (torch.einsum("ecd,edf->ecf", xf, deq(wg, s_gate))
            if wg is not None else None)
    h = _act(act, up, gate)
    y = torch.einsum("ecf,efd->ecd", h, deq(wd, s_down))
    return y.to(out_dtype)


def lengths(cache_len, B: int, device) -> torch.Tensor:
    """``cache_len`` (int, 0-d or (B,) tensor) -> (B,) int32 on ``device``."""
    if isinstance(cache_len, torch.Tensor):
        return cache_len.to(device=device, dtype=torch.int32) \
            .reshape(-1).expand(B).contiguous()
    return torch.full((B,), int(cache_len), dtype=torch.int32, device=device)


def flash_decode_ref(q, k, v, cache_len, softcap: float = 0.0, *,
                     return_lse: bool = False):
    """q: (B, H, hd); k/v: (B, S, Hkv, hd); cache_len scalar or (B,)
    per-slot lengths; ``softcap`` > 0 caps the scaled scores at
    ``softcap * tanh(s / softcap)`` before the length mask, in the order of
    the reference's ``_sdpa``. ``return_lse``: also each row's fp32
    log-sum-exp of its scaled, capped scores over the valid positions (B,
    H); a row with none gives out 0 and lse -inf (without it, a uniform
    softmax over all S, as the reference)."""
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", q.float(), kf) * hd ** -0.5
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    lens = lengths(cache_len, B, q.device)
    pos = torch.arange(S, device=q.device)
    mask = pos[None, None, :] < lens[:, None, None]
    if return_lse:
        scores = torch.where(mask, scores, -torch.inf)
        lse = torch.logsumexp(scores, dim=-1)
        empty = (lse == -torch.inf)[..., None]
        wts = torch.exp(scores - torch.where(empty, 0.0, lse[..., None]))
        out = torch.einsum("bhs,bshd->bhd", wts, vf)
        return out.to(q.dtype), lse
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    wts = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bshd->bhd", wts, vf).to(q.dtype)


def decode_scores_ref(q, k, cache_len, scale: float):
    """B3-qk's plain version: q (B, H, hd_l) against k (B, S, Hkv, hd_l),
    one head_dim slice of each, times ``scale`` (1/sqrt of the whole
    head_dim) -> the partial scores (B, H, S) fp32, 0 past each row's
    length. The slices' partial scores sum to ``flash_decode_ref``'s scaled
    scores."""
    B, H, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // Hkv, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", q.float(), kf) * scale
    lens = lengths(cache_len, B, q.device)
    mask = torch.arange(S, device=q.device)[None, None, :] \
        < lens[:, None, None]
    return torch.where(mask, scores, 0.0)


def decode_values_ref(scores, v, cache_len, softcap: float = 0.0, *,
                      return_lse: bool = False):
    """B3-pv's plain version: the summed scores (B, H, S) fp32, softcapped
    as ``flash_decode_ref`` caps them, softmaxed over each row's valid
    positions, times v (B, S, Hkv, hd_l), one head_dim slice -> (B, H,
    hd_l) in v's dtype; ``return_lse``: also each row's fp32 log-sum-exp
    (B, H). A row with no valid position gives out 0 and lse -inf."""
    B, H, S = scores.shape
    Hkv = v.shape[2]
    s = scores.float()
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    lens = lengths(cache_len, B, scores.device)
    mask = torch.arange(S, device=scores.device)[None, None, :] \
        < lens[:, None, None]
    s = torch.where(mask, s, -torch.inf)
    lse = torch.logsumexp(s, dim=-1)
    empty = (lse == -torch.inf)[..., None]
    wts = torch.exp(s - torch.where(empty, 0.0, lse[..., None]))
    vf = v.float().repeat_interleave(H // Hkv, dim=2)
    out = torch.einsum("bhs,bshd->bhd", wts, vf).to(v.dtype)
    return (out, lse) if return_lse else out


def wkv6_ref(r, k, v, w, u, s0):
    """RWKV6 recurrence, a sequential fp32 loop over T. r/k/v/w: (BH, T,
    hd); u: (BH, hd); s0: (BH, hd, hd). Per step
    ``o_t = r_t (S + diag(u) k_t v_t^T)``, ``S = diag(w_t) S + k_t v_t^T``.
    -> (o (BH, T, hd) in r's dtype, sN (BH, hd, hd) fp32)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[..., None]                                # (BH, K, 1)
    s = s0.float()
    out = []
    for t in range(r.shape[1]):
        a = kf[:, t, :, None] * vf[:, t, None, :]            # (BH, K, V)
        out.append(torch.einsum("bk,bkv->bv", rf[:, t], s + uf * a))
        s = wf[:, t, :, None] * s + a
    return torch.stack(out, 1).to(r.dtype), s


def selective_scan_ref(x, dt, A, Bm, Cm, h0):
    """Mamba selective scan, a sequential fp32 loop over T in the
    reference's order (``repro.models.mamba._ssm_params`` +
    ``_scan_chunk``). x: (B, T, D); dt: (B, T, D) fp32; A: (D, N) fp32;
    Bm, Cm: (B, T, N); h0: (B, D, N) fp32. Per step
    ``h = exp(dt_t A) h + (dt_t x_t) B_t``, ``y_t = h C_t``.
    -> (y (B, T, D) fp32, hT (B, D, N) fp32)."""
    dtx = dt * x.float()
    Bf, Cf = Bm.float(), Cm.float()
    h = h0.float()
    ys = []
    for t in range(x.shape[1]):
        dA = torch.exp(dt[:, t, :, None] * A)
        h = dA * h + dtx[:, t, :, None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    return torch.stack(ys, 1), h


def wkv6_bwd_ref(r, k, v, w, u, s0, do, dsN):
    """Gradients of ``wkv6_ref`` for the upstream ``do`` (BH, T, hd) and
    ``dsN`` (BH, hd, hd), as explicit fp32 loops: the forward's states
    S_t (before step t) kept from a forward pass, then in reverse time, with
    G the gradient of the state after step t (``dsN`` after the last) and
    ``A_t = G + diag(u) r_t do_tᵀ``: ``dr_t = (S_t + diag(u) k_t v_tᵀ) do_t``,
    ``dk_t = A_t v_t``, ``dv_t = A_tᵀ k_t``, ``dw_t = rowsum(G ⊙ S_t)``,
    ``du += r_t k_t (do_t · v_t)``, ``G = diag(w_t) G + r_t do_tᵀ``;
    ``ds0`` is the last G. -> (dr, dk, dv in r's dtype, dw in w's dtype,
    du and ds0 fp32)."""
    rf, kf, vf, wf, dof = (t.float() for t in (r, k, v, w, do))
    uf = u.float()
    s = s0.float()
    states = []
    for t in range(r.shape[1]):
        states.append(s)
        s = wf[:, t, :, None] * s + kf[:, t, :, None] * vf[:, t, None, :]
    G = dsN.float()
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    for t in reversed(range(r.shape[1])):
        r_t, k_t, v_t, w_t, do_t = (x[:, t] for x in (rf, kf, vf, wf, dof))
        a = k_t[:, :, None] * v_t[:, None, :]
        dr[:, t] = torch.einsum("bkv,bv->bk", states[t] + uf[..., None] * a,
                                do_t)
        A = G + (uf * r_t)[..., None] * do_t[:, None, :]
        dk[:, t] = torch.einsum("bkv,bv->bk", A, v_t)
        dv[:, t] = torch.einsum("bkv,bk->bv", A, k_t)
        dw[:, t] = (G * states[t]).sum(-1)
        du += r_t * k_t * (do_t * v_t).sum(-1, keepdim=True)
        G = w_t[..., None] * G + r_t[..., None] * do_t[:, None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du, G)


def selective_scan_bwd_ref(x, dt, A, Bm, Cm, h0, dy, dhT):
    """Gradients of ``selective_scan_ref`` for the upstream ``dy`` (B, T, D)
    and ``dhT`` (B, D, N), as explicit fp32 loops: the forward's states h_t
    kept from a forward pass (h_{-1} = h0), then in reverse time, with
    ``dA_t = exp(dt_t A)`` and g the gradient of h_t (``dhT`` added at the
    last step): ``g = dA_{t+1} g_{t+1} + dy_t C_t``,
    ``dx_t = dt_t Σ_n g B_t``, ``ddt_t = Σ_n g (A dA_t h_{t-1} + x_t B_t)``,
    ``dB_t = Σ_d g dt_t x_t``, ``dC_t = Σ_d dy_t h_t``,
    ``dA += Σ_b g dt_t dA_t h_{t-1}``; ``dh0 = dA_0 g_0``.
    -> (dx in x's dtype, ddt fp32, dA fp32, dB, dC in their dtypes, dh0
    fp32)."""
    xf, Bf, Cf, dyf = x.float(), Bm.float(), Cm.float(), dy.float()
    dtf, Af = dt.float(), A.float()
    dtx = dtf * xf
    h = h0.float()
    hs = [h]
    for t in range(x.shape[1]):
        h = torch.exp(dtf[:, t, :, None] * Af) * h \
            + dtx[:, t, :, None] * Bf[:, t, None, :]
        hs.append(h)
    gn = dhT.float()
    dx, ddt = torch.empty_like(xf), torch.empty_like(dtf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    for t in reversed(range(x.shape[1])):
        d_t = dtf[:, t, :, None]
        dA_t = torch.exp(d_t * Af)
        g = gn + dyf[:, t, :, None] * Cf[:, t, None, :]
        dC[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dyf[:, t])
        dB[:, t] = torch.einsum("bdn,bd->bn", g, dtx[:, t])
        dx[:, t] = dtf[:, t] * (g * Bf[:, t, None, :]).sum(-1)
        ddt[:, t] = (g * (Af * dA_t * hs[t]
                          + xf[:, t, :, None] * Bf[:, t, None, :])).sum(-1)
        dA += (g * d_t * dA_t * hs[t]).sum(0)
        gn = dA_t * g
    return (dx.to(x.dtype), ddt, dA, dB.to(Bm.dtype), dC.to(Cm.dtype), gn)
